// Grouped expert matmul for Hopper: out[e] = x[e] @ w[e] for every expert
// e, f32 sums, stored in x's dtype.  Rows c >= group_sizes[e] of out[e] are
// exactly 0.  Two hand-written kernels, chosen by dtype:
//   bf16: gmm_wgmma_kernel, tensor cores fed by a TMA ring (below);
//   f32:  gmm_kernel, f32 FMAs.  Hopper's tensor cores have no full-f32
//         product and TF32 keeps only 10 mantissa bits, which would break
//         the f32 path's 1e-4 agreement with its plain version and the
//         token-exact f32 card-vs-CPU serve; so f32 stays on FMAs.
// Neither is a fallback for the other: a dtype reaches one kernel only.
//
// Replaces: src/repro/kernels/moe_gmm.py, moe_gmm_pallas / _gmm_kernel (the
// Pallas TPU kernel).  Same function, not the same blocks: the TPU kernel
// keeps a whole (d, f) weight slab in VMEM per (expert, row block).
//
// What bounds it on an H100: the weights.  With a top-2 router each active
// expert's w[e] is read once per call: at phimini-moe's widths (16 experts,
// d 4096, f 960, bf16) that is 16 * 4096 * 960 * 2 B = 126 MB per gate/up/
// down call when all experts are active, 37.6 us at 3.35 TB/s.  The FLOPs
// at capacity C = 40 are 2 * 16 * 40 * 4096 * 960 = 5 GFLOP, 5 us at
// 989 TFLOP/s: bound by bytes at every shape of the serving path (C = 1 at
// batch-8 decode up to C = 40 at a 256-token chunk).
//
// The bf16 design (gmm_wgmma_kernel): A and B are swapped, out[e]^T (f x C)
// = w[e]^T (f x d) . x[e]^T (d x C), so the weight's f fills wgmma's fixed
// M = 64 and the serve's small C is N, rounded up to 8 (C = 1 at decode
// wastes 7/8 of a tiny N, not 63/64 of M).  w[e] is (d, f) row-major: A is
// MN-major, read with the transpose bit; x[e] is (C, d): B is K-major.
// One block per (64 columns of f, N tile of up to 64 rows of C, expert);
// warpgroup 1 is the producer: one thread streams 128 x 64 weight boxes and
// the matching x boxes by TMA (128-byte swizzle) into a ring of 4 stages,
// 16 KB of weights each, so a block keeps 64 KB in flight; warpgroup 0 runs
// 8 wgmma k16 steps per stage into f32 registers and hands the stage back
// through an mbarrier.  A block whose N tile starts at or past its expert's
// group size writes zeros and returns before any weight load: an idle
// expert costs no weight byte.  Every block walks all of d in one fixed
// order (the serve's shapes give 240 blocks and more for 132 SMs), so there
// is no reduction across blocks and the result is bitwise the same run to
// run.  Widths whose rows are not a multiple of 16 bytes (d or f not a
// multiple of 8), which TMA cannot describe, are loaded by the producer
// warpgroup with masked element loads into the same swizzled layout, in
// the same kernel.
#include "hopper.cuh"

namespace repro_gmm {

// ------------------------------------------------------------ f32: FMAs

constexpr int kThreads = 256;
constexpr int kBN = 64;   // output columns per block

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }

// V consecutive elements at p into out[0..V) as f32; V > 1 is one 16-byte
// load (p 16-byte aligned).
template <int V>
__device__ __forceinline__ void load_n(const float* p, float* out) {
  if constexpr (V == 1) {
    out[0] = *p;
  } else {
    const float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
  }
}

template <typename T, int BM, int BK, bool VEC>
__global__ void __launch_bounds__(kThreads)
gmm_kernel(const T* __restrict__ x, const T* __restrict__ w,
           const int* __restrict__ group_sizes, T* __restrict__ out, int C,
           int d, int f) {
  constexpr int V = VEC ? 16 / int(sizeof(T)) : 1;
  constexpr int W_VECS = BK * kBN / V;
  constexpr int X_VECS = BM * BK / V;
  constexpr int W_LOADS = (W_VECS + kThreads - 1) / kThreads;
  constexpr int X_LOADS = (X_VECS + kThreads - 1) / kThreads;
  constexpr int RPT = BM / 16;        // output rows per thread
  __shared__ float xs[BM][BK + 1];
  __shared__ __align__(16) float ws[BK][kBN];

  const int e = blockIdx.z;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * kBN;
  const int tid = threadIdx.x;
  const int tr = tid / 16;            // rows tr, tr + 16, ...
  const int col0 = n0 + (tid % 16) * 4;   // 4 consecutive columns
  const int size = min(max(group_sizes[e], 0), C);
  const T* xe = x + int64_t(e) * C * d;
  const T* we = w + int64_t(e) * d * f;
  T* oe = out + int64_t(e) * C * f;

  if (m0 >= size) {                   // past the group: zeros, no weights
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const int row = m0 + tr + 16 * r;
      if (row >= C) continue;
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (col0 + c < f) oe[int64_t(row) * f + col0 + c] = from_f32<T>(0.f);
    }
    return;
  }

  float acc[RPT][4];
#pragma unroll
  for (int r = 0; r < RPT; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
  float wr[W_LOADS * V];
  float xr[X_LOADS * V];

  // global -> registers for the K step at k0; out-of-range elements are 0
  auto fetch = [&](int k0) {
#pragma unroll
    for (int i = 0; i < W_LOADS; ++i) {
      const int idx = tid + i * kThreads;
      const int r = idx / (kBN / V), col = n0 + (idx % (kBN / V)) * V;
      const int k = k0 + r;
      if (idx < W_VECS && k < d && col < f) {
        load_n<V>(we + int64_t(k) * f + col, &wr[i * V]);
      } else {
#pragma unroll
        for (int j = 0; j < V; ++j) wr[i * V + j] = 0.f;
      }
    }
#pragma unroll
    for (int i = 0; i < X_LOADS; ++i) {
      const int idx = tid + i * kThreads;
      const int r = idx / (BK / V), k = k0 + (idx % (BK / V)) * V;
      const int row = m0 + r;
      if (idx < X_VECS && row < size && k < d) {
        load_n<V>(xe + int64_t(row) * d + k, &xr[i * V]);
      } else {
#pragma unroll
        for (int j = 0; j < V; ++j) xr[i * V + j] = 0.f;
      }
    }
  };
  // registers -> shared memory
  auto stash = [&]() {
#pragma unroll
    for (int i = 0; i < W_LOADS; ++i) {
      const int idx = tid + i * kThreads;
      if (idx < W_VECS) {
        const int r = idx / (kBN / V), c = (idx % (kBN / V)) * V;
#pragma unroll
        for (int j = 0; j < V; ++j) ws[r][c + j] = wr[i * V + j];
      }
    }
#pragma unroll
    for (int i = 0; i < X_LOADS; ++i) {
      const int idx = tid + i * kThreads;
      if (idx < X_VECS) {
        const int r = idx / (BK / V), c = (idx % (BK / V)) * V;
#pragma unroll
        for (int j = 0; j < V; ++j) xs[r][c + j] = xr[i * V + j];
      }
    }
  };

  fetch(0);
  for (int k0 = 0; k0 < d; k0 += BK) {
    stash();
    __syncthreads();
    if (k0 + BK < d) fetch(k0 + BK);     // in flight while we sum
#pragma unroll 16
    for (int kk = 0; kk < BK; ++kk) {
      const float4 b = *reinterpret_cast<const float4*>(&ws[kk][col0 - n0]);
#pragma unroll
      for (int r = 0; r < RPT; ++r) {
        const float a = xs[tr + 16 * r][kk];
        acc[r][0] = fmaf(a, b.x, acc[r][0]);
        acc[r][1] = fmaf(a, b.y, acc[r][1]);
        acc[r][2] = fmaf(a, b.z, acc[r][2]);
        acc[r][3] = fmaf(a, b.w, acc[r][3]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const int row = m0 + tr + 16 * r;
    if (row >= C) continue;
    const bool live = row < size;
#pragma unroll
    for (int c = 0; c < 4; ++c)
      if (col0 + c < f)
        oe[int64_t(row) * f + col0 + c] = from_f32<T>(live ? acc[r][c] : 0.f);
  }
}

template <typename T, int BM, int BK, bool VEC>
static int launch(const void* x, const void* w, const int* gs, void* out,
                  int E, int C, int d, int f, cudaStream_t stream) {
  dim3 grid((f + kBN - 1) / kBN, (C + BM - 1) / BM, E);
  gmm_kernel<T, BM, BK, VEC><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), gs,
      static_cast<T*>(out), C, d, f);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
static int dispatch(const void* x, const void* w, const int* gs, void* out,
                    int E, int C, int d, int f, cudaStream_t st) {
  constexpr int V = 16 / int(sizeof(T));
  const bool vec = d % V == 0 && f % V == 0;
  if (C <= 16)
    return vec ? launch<T, 16, 128, true>(x, w, gs, out, E, C, d, f, st)
               : launch<T, 16, 128, false>(x, w, gs, out, E, C, d, f, st);
  return vec ? launch<T, 64, 64, true>(x, w, gs, out, E, C, d, f, st)
             : launch<T, 64, 64, false>(x, w, gs, out, E, C, d, f, st);
}


// ------------------------------------------------ bf16: tensor cores, TMA

constexpr int kTcBK = 128;        // d rows per stage
constexpr int kTcBM = 64;         // f columns per block (wgmma's M)
constexpr int kTcStages = 4;
constexpr int kTcThreads = 256;   // warpgroup 0 computes, 1 loads
constexpr int kTcA = kTcBK * kTcBM * 2;   // weight bytes per stage (16 KB)

template <int BN>
struct TcLayout {
  // stage s at s * kStage: the weight tile (kTcBK rows of d, 64 f each,
  // 128-byte rows), then the x tile as two chunks of BN rows x 64 d
  static constexpr int kB = 2 * BN * 128;
  static constexpr int kStage = kTcA + kB;          // a multiple of 1024
  static constexpr int kSmem = kTcStages * kStage + 2 * kTcStages * 8 + 1024;
};

// Byte offset of element (row, col) in a tile of 128-byte rows under the
// 128-byte swizzle (16-byte group col / 8 XOR row % 8), as TMA writes it.
__device__ __forceinline__ int swz128(int row, int col) {
  return row * 128 + ((((col >> 3) ^ row) & 7) << 4) + (col & 7) * 2;
}

template <int BN, bool TMA>
__global__ void __launch_bounds__(kTcThreads)
gmm_wgmma_kernel(const __grid_constant__ CUtensorMap wmap,
                 const __grid_constant__ CUtensorMap xmap,
                 const __nv_bfloat16* __restrict__ x,
                 const __nv_bfloat16* __restrict__ w,
                 const int* __restrict__ group_sizes,
                 __nv_bfloat16* __restrict__ out, int C, int d, int f) {
  using namespace repro_hopper;
  using L = TcLayout<BN>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kTcStages * L::kStage);
  uint64_t* empty = full + kTcStages;

  const int f0 = blockIdx.x * kTcBM;
  const int n0 = blockIdx.y * BN;
  const int e = blockIdx.z;
  const int size = min(max(group_sizes[e], 0), C);
  const int tid = threadIdx.x;

  if (n0 >= size) {            // past the group: no weight byte is read
    const int rows = min(BN, C - n0);
    for (int i = tid; i < rows * kTcBM; i += kTcThreads) {
      const int c = n0 + i / kTcBM, col = f0 + i % kTcBM;
      if (col < f)
        out[(int64_t(e) * C + c) * f + col] = __float2bfloat16(0.f);
    }
    return;
  }
  const int nk = (d + kTcBK - 1) / kTcBK;

  if (tid == 0) {
    for (int s = 0; s < kTcStages; ++s) {
      mbar_init(&full[s], TMA ? 1 : 128);
      mbar_init(&empty[s], 128);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (tid >= 128) {                               // ---- producer
    const int pt = tid - 128;
    if (TMA && pt != 0) return;
    for (int t = 0; t < nk; ++t) {
      const int s = t % kTcStages;
      if (t >= kTcStages) mbar_wait(&empty[s], ((t / kTcStages) + 1) & 1);
      uint8_t* a = smem + s * L::kStage;
      uint8_t* b = a + kTcA;
      const int k0 = t * kTcBK;
      if constexpr (TMA) {
        mbar_expect_tx(&full[s], L::kStage);
        tma_load_3d(a, &wmap, &full[s], f0, k0, e);
        tma_load_3d(b, &xmap, &full[s], k0, n0, e);
        tma_load_3d(b + BN * 128, &xmap, &full[s], k0 + 64, n0, e);
      } else {
        const __nv_bfloat16 zero = __float2bfloat16(0.f);
        const __nv_bfloat16* we = w + int64_t(e) * d * f;
        const __nv_bfloat16* xe = x + int64_t(e) * C * d;
        for (int i = pt; i < kTcBK * kTcBM; i += 128) {
          const int r = i / kTcBM, col = i % kTcBM;
          const int k = k0 + r, fc = f0 + col;
          *reinterpret_cast<__nv_bfloat16*>(a + swz128(r, col)) =
              k < d && fc < f ? we[int64_t(k) * f + fc] : zero;
        }
        for (int i = pt; i < BN * kTcBK; i += 128) {
          const int n = i / kTcBK, kd = i % kTcBK;
          const int c = n0 + n, k = k0 + kd;
          *reinterpret_cast<__nv_bfloat16*>(
              b + (kd / 64) * BN * 128 + swz128(n, kd % 64)) =
              c < C && k < d ? xe[int64_t(c) * d + k] : zero;
        }
        fence_proxy_async();
        mbar_arrive(&full[s]);
      }
    }
    return;
  }

  // ---- consumer: warpgroup 0
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  for (int t = 0; t < nk; ++t) {
    const int s = t % kTcStages;
    mbar_wait(&full[s], (t / kTcStages) & 1);
    const uint8_t* a = smem + s * L::kStage;
    const uint8_t* b = a + kTcA;
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kTcBK / 16; ++kk) {
      // A: 16 rows of d further per step (MN-major, one 64-wide chunk);
      // B: 32 bytes further into the 128-byte rows, next chunk every 4
      const uint64_t da = smem_desc(a + kk * 16 * 128, kTcA, 1024, 1);
      const uint64_t db = smem_desc(b + (kk / 4) * BN * 128 + (kk % 4) * 32,
                                    16, 1024, 1);
      wgmma_ss<BN, 1, 0>(acc, da, db);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    mbar_arrive(&empty[s]);
  }

  // accumulator i of thread (warp wq, lane l): f row wq*16 + l/4 (+8 for
  // i & 2), C column (i / 4) * 8 + (l % 4) * 2 + (i & 1)
  const int wq = tid / 32, l = tid % 32;
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) {
    const int col = f0 + wq * 16 + (l >> 2) + ((i & 2) ? 8 : 0);
    const int c = n0 + (i >> 2) * 8 + (l & 3) * 2 + (i & 1);
    if (col < f && c < C)
      out[(int64_t(e) * C + c) * f + col] =
          __float2bfloat16(c < size ? acc[i] : 0.f);
  }
}

template <int BN, bool TMA>
static int launch_tc(const CUtensorMap& wmap, const CUtensorMap& xmap,
                     const void* x, const void* w, const int* gs, void* out,
                     int E, int C, int d, int f, cudaStream_t stream) {
  using L = TcLayout<BN>;
  int err = repro_hopper::allow_smem<gmm_wgmma_kernel<BN, TMA>>(L::kSmem);
  if (err) return err;
  dim3 grid((f + kTcBM - 1) / kTcBM, (C + BN - 1) / BN, E);
  gmm_wgmma_kernel<BN, TMA><<<grid, kTcThreads, L::kSmem, stream>>>(
      wmap, xmap, static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(w), gs,
      static_cast<__nv_bfloat16*>(out), C, d, f);
  return static_cast<int>(cudaGetLastError());
}

// N tile: C rounded up to 8, or 64 (one wgmma N) with C in several tiles
template <bool TMA>
static int dispatch_tc(const CUtensorMap& wmap, const CUtensorMap& xmap,
                       const void* x, const void* w, const int* gs,
                       void* out, int E, int C, int d, int f, int bn,
                       cudaStream_t st) {
#define REPRO_GMM_TC(N)                                                     \
  case N:                                                                   \
    return launch_tc<N, TMA>(wmap, xmap, x, w, gs, out, E, C, d, f, st);
  switch (bn) {
    REPRO_GMM_TC(8) REPRO_GMM_TC(16) REPRO_GMM_TC(24) REPRO_GMM_TC(32)
    REPRO_GMM_TC(40) REPRO_GMM_TC(48) REPRO_GMM_TC(56) REPRO_GMM_TC(64)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef REPRO_GMM_TC
}

static int run_tc(const void* x, const void* w, const int* gs, void* out,
                  int E, int C, int d, int f, cudaStream_t st) {
  const int bn = C > 64 ? 64 : (C + 7) / 8 * 8;
  CUtensorMap wmap{}, xmap{};
  // TMA needs 16-byte row strides: d and f multiples of 8 bf16
  const bool tma = d > 0 && d % 8 == 0 && f % 8 == 0;
  if (!tma)
    return dispatch_tc<false>(wmap, xmap, x, w, gs, out, E, C, d, f, bn, st);
  {
    // w (E, d, f): dims {f, d, E}; box 64 f x 128 d
    const uint64_t dims[3] = {uint64_t(f), uint64_t(d), uint64_t(E)};
    const uint64_t strides[2] = {uint64_t(f) * 2, uint64_t(d) * f * 2};
    const uint32_t box[3] = {kTcBM, kTcBK, 1};
    const int err = repro_hopper::make_tensor_map(&wmap, w, 3, dims, strides,
                                                  box, 128);
    if (err) return err;
  }
  {
    // x (E, C, d): dims {d, C, E}; box 64 d x bn rows
    const uint64_t dims[3] = {uint64_t(d), uint64_t(C), uint64_t(E)};
    const uint64_t strides[2] = {uint64_t(d) * 2, uint64_t(C) * d * 2};
    const uint32_t box[3] = {64, uint32_t(bn), 1};
    const int err = repro_hopper::make_tensor_map(&xmap, x, 3, dims, strides,
                                                  box, 128);
    if (err) return err;
  }
  return dispatch_tc<true>(wmap, xmap, x, w, gs, out, E, C, d, f, bn, st);
}

}  // namespace repro_gmm

// x (E,C,d), w (E,d,f), group_sizes (E,) int32 on the device, out (E,C,f);
// all contiguous and 16-byte aligned.  dtype: 0 = float32 (FMA kernel),
// 1 = bfloat16 (tensor-core kernel).  Returns a cudaError_t: the launch's
// own, or cudaErrorInvalidValue for a dtype or a grid it does not take.
extern "C" int moe_gmm_fwd(const void* x, const void* w,
                           const int* group_sizes, void* out, int E, int C,
                           int d, int f, int dtype, void* stream) {
  using namespace repro_gmm;
  if (E <= 0 || C <= 0 || f <= 0 || d < 0 || E > 65535 ||
      (C + 15) / 16 > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(x, w, group_sizes, out, E, C, d, f, st);
  if (dtype == 1)
    return run_tc(x, w, group_sizes, out, E, C, d, f, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
