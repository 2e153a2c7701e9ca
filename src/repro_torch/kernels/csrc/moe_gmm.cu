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
//
// The backward (moe_gmm_bwd): given dy (E, C, f), dx[e] = (dy[e] . mask)
// w[e]^T and dw[e] = x[e]^T (dy[e] . mask), mask = [c < group_sizes[e]],
// both in the inputs' dtype with f32 sums; rows c >= size of dx are exactly
// 0, and rows c >= size of x and dy take no part whatever they hold.
// Replaces XLA's autodiff of the einsum branch at src/repro/models/moe.py:
// 125-137 (the JAX package trains through plain einsums, not through a
// Pallas kernel).  What bounds it on an H100 at phimini-moe's training shape
// (B2 S1024: 2048 tokens top-2 over 16 experts, capacity 320, ~256 live
// rows an expert): bytes.  dx of gate/up reads the 126 MB of weights and
// writes 42 MB, 0.052 ms at 3.35 TB/s against 0.033 ms for its 32 GFLOP
// at 989 TFLOP/s; dw writes the 126 MB weight gradient, ~0.050 ms.  The
// bf16 design: two persistent kernels, one block an SM, each walking
// 128 x 128 output tiles with two consumer warpgroups on wgmma fed by one
// TMA producer warp through a ring that runs across tiles, and epilogues
// through shared memory and TMA stores (see gmm_dx_wgmma_kernel and
// gmm_dw_wgmma_kernel below).  Tiles that share an operand run next to
// each other, so each weight slab (dx) and each x tile (dw) comes from
// device memory about once.  f32: the forward's FMA kernel with the
// weight read transposed (template flag WT) for dx, gmm_dw_kernel for dw.
// No atomics: every output element is summed by one block in one order.
#include <algorithm>

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

// out[e] (C x f) = x[e] (C x d) . W[e] (d x f): W[e] is w[e] stored (d, f),
// or with WT (the backward's dx) w[e] stored (f, d) and read transposed.
template <typename T, int BM, int BK, bool VEC, bool WT>
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

  // global -> registers for the K step at k0; out-of-range elements are 0.
  // W: vectors along f (row-major (d, f)), or along d under WT.
  auto fetch = [&](int k0) {
#pragma unroll
    for (int i = 0; i < W_LOADS; ++i) {
      const int idx = tid + i * kThreads;
      int k, col;
      if constexpr (WT) {
        col = n0 + idx / (BK / V);
        k = k0 + (idx % (BK / V)) * V;
      } else {
        k = k0 + idx / (kBN / V);
        col = n0 + (idx % (kBN / V)) * V;
      }
      if (idx < W_VECS && k < d && col < f) {
        load_n<V>(WT ? we + int64_t(col) * d + k : we + int64_t(k) * f + col,
                  &wr[i * V]);
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
        if constexpr (WT) {
          const int c = idx / (BK / V), r = (idx % (BK / V)) * V;
#pragma unroll
          for (int j = 0; j < V; ++j) ws[r + j][c] = wr[i * V + j];
        } else {
          const int r = idx / (kBN / V), c = (idx % (kBN / V)) * V;
#pragma unroll
          for (int j = 0; j < V; ++j) ws[r][c + j] = wr[i * V + j];
        }
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

template <typename T, int BM, int BK, bool VEC, bool WT>
static int launch(const void* x, const void* w, const int* gs, void* out,
                  int E, int C, int d, int f, cudaStream_t stream) {
  dim3 grid((f + kBN - 1) / kBN, (C + BM - 1) / BM, E);
  gmm_kernel<T, BM, BK, VEC, WT><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), gs,
      static_cast<T*>(out), C, d, f);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool WT>
static int dispatch(const void* x, const void* w, const int* gs, void* out,
                    int E, int C, int d, int f, cudaStream_t st) {
  constexpr int V = 16 / int(sizeof(T));
  const bool vec = d % V == 0 && f % V == 0;
  if (C <= 16)
    return vec ? launch<T, 16, 128, true, WT>(x, w, gs, out, E, C, d, f, st)
               : launch<T, 16, 128, false, WT>(x, w, gs, out, E, C, d, f, st);
  return vec ? launch<T, 64, 64, true, WT>(x, w, gs, out, E, C, d, f, st)
             : launch<T, 64, 64, false, WT>(x, w, gs, out, E, C, d, f, st);
}

// dw[e] (d x f) = x[e]^T (d x C) . dy[e] (C x f) over the rows c < size:
// one block per (64 rows of d, 64 columns of f, expert), 16 rows of C a
// step, each thread a 4 x 4 tile of f32 FMAs.
constexpr int kDwF32Tile = 64;
constexpr int kDwF32BK = 16;

__global__ void __launch_bounds__(kThreads)
gmm_dw_kernel(const float* __restrict__ x, const float* __restrict__ dy,
              const int* __restrict__ group_sizes, float* __restrict__ dw,
              int C, int d, int f) {
  constexpr int T = kDwF32Tile, BK = kDwF32BK;
  __shared__ __align__(16) float xs[BK][T];
  __shared__ __align__(16) float ys[BK][T];
  const int e = blockIdx.z;
  const int m0 = blockIdx.x * T, n0 = blockIdx.y * T;
  const int tid = threadIdx.x;
  const int tm = (tid / 16) * 4, tn = (tid % 16) * 4;
  const int size = min(max(group_sizes[e], 0), C);
  const float* xe = x + int64_t(e) * C * d;
  const float* ye = dy + int64_t(e) * C * f;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int k0 = 0; k0 < size; k0 += BK) {
#pragma unroll
    for (int i = 0; i < BK * T / kThreads; ++i) {
      const int idx = tid + i * kThreads;
      const int r = idx / T, c = idx % T, row = k0 + r;
      xs[r][c] = row < size && m0 + c < d ? xe[int64_t(row) * d + m0 + c]
                                          : 0.f;
      ys[r][c] = row < size && n0 + c < f ? ye[int64_t(row) * f + n0 + c]
                                          : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&xs[kk][tm]);
      const float4 b = *reinterpret_cast<const float4*>(&ys[kk][tn]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + tm + i;
    if (m >= d) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (n0 + tn + j < f)
        dw[(int64_t(e) * d + m) * f + n0 + tn + j] = acc[i][j];
  }
}

static int launch_dw_f32(const void* x, const void* dy, const int* gs,
                         void* dw, int E, int C, int d, int f,
                         cudaStream_t stream) {
  dim3 grid((d + kDwF32Tile - 1) / kDwF32Tile,
            (f + kDwF32Tile - 1) / kDwF32Tile, E);
  gmm_dw_kernel<<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(dy), gs,
      static_cast<float*>(dw), C, d, f);
  return static_cast<int>(cudaGetLastError());
}


// ------------------------------------------------ bf16: tensor cores, TMA

constexpr int kTcBK = 128;        // K (reduction) elements per stage
constexpr int kTcBM = 64;         // output columns per block (wgmma's M)
constexpr int kTcStages = 4;
constexpr int kTcThreads = 256;   // warpgroup 0 computes, 1 loads
constexpr int kTcA = kTcBK * kTcBM * 2;   // weight bytes per stage (16 KB)

template <int BN>
struct TcLayout {
  // stage s at s * kStage: the weight tile (16 KB: kTcBK rows of 64 M,
  // 128-byte rows), then the x tile as two chunks of BN rows x 64 K
  static constexpr int kB = 2 * BN * 128;
  static constexpr int kStage = kTcA + kB;          // a multiple of 1024
  static constexpr int kSmem = kTcStages * kStage + 2 * kTcStages * 8 + 1024;
};

// Byte offset of element (row, col) in a tile of 128-byte rows under the
// 128-byte swizzle (16-byte group col / 8 XOR row % 8), as TMA writes it.
__device__ __forceinline__ int swz128(int row, int col) {
  return row * 128 + ((((col >> 3) ^ row) & 7) << 4) + (col & 7) * 2;
}

// out[e] (C x M) = x[e] (C x K) . w[e] (K x M), computed transposed as
// above: K = d, M = f, w[e] stored (K, M), an MN-major A.
template <int BN, bool TMA>
__global__ void __launch_bounds__(kTcThreads)
gmm_wgmma_kernel(const __grid_constant__ CUtensorMap wmap,
                 const __grid_constant__ CUtensorMap xmap,
                 const __nv_bfloat16* __restrict__ x,
                 const __nv_bfloat16* __restrict__ w,
                 const int* __restrict__ group_sizes,
                 __nv_bfloat16* __restrict__ out, int C, int K, int M) {
  using namespace repro_hopper;
  using L = TcLayout<BN>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kTcStages * L::kStage);
  uint64_t* empty = full + kTcStages;

  const int m0 = blockIdx.x * kTcBM;
  const int n0 = blockIdx.y * BN;
  const int e = blockIdx.z;
  const int size = min(max(group_sizes[e], 0), C);
  const int tid = threadIdx.x;

  if (n0 >= size) {            // past the group: no weight byte is read
    const int rows = min(BN, C - n0);
    for (int i = tid; i < rows * kTcBM; i += kTcThreads) {
      const int c = n0 + i / kTcBM, col = m0 + i % kTcBM;
      if (col < M)
        out[(int64_t(e) * C + c) * M + col] = __float2bfloat16(0.f);
    }
    return;
  }
  const int nk = (K + kTcBK - 1) / kTcBK;

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
        tma_load_3d(a, &wmap, &full[s], m0, k0, e);
        tma_load_3d(b, &xmap, &full[s], k0, n0, e);
        tma_load_3d(b + BN * 128, &xmap, &full[s], k0 + 64, n0, e);
      } else {
        const __nv_bfloat16 zero = __float2bfloat16(0.f);
        const __nv_bfloat16* we = w + int64_t(e) * K * M;
        const __nv_bfloat16* xe = x + int64_t(e) * C * K;
        for (int i = pt; i < kTcBK * kTcBM; i += 128) {
          const int r = i / kTcBM, col = i % kTcBM;
          const int k = k0 + r, m = m0 + col;
          *reinterpret_cast<__nv_bfloat16*>(a + swz128(r, col)) =
              k < K && m < M ? we[int64_t(k) * M + m] : zero;
        }
        for (int i = pt; i < BN * kTcBK; i += 128) {
          const int n = i / kTcBK, kd = i % kTcBK;
          const int c = n0 + n, k = k0 + kd;
          *reinterpret_cast<__nv_bfloat16*>(
              b + (kd / 64) * BN * 128 + swz128(n, kd % 64)) =
              c < C && k < K ? xe[int64_t(c) * K + k] : zero;
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
      // A: MN-major, 16 rows of K further per step (one 64-wide chunk of
      // M).  B: K-major, 32 bytes further into the 128-byte rows, the next
      // chunk every 4 steps.
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

  // accumulator i of thread (warp wq, lane l): M row wq*16 + l/4 (+8 for
  // i & 2), C column (i / 4) * 8 + (l % 4) * 2 + (i & 1)
  const int wq = tid / 32, l = tid % 32;
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) {
    const int col = m0 + wq * 16 + (l >> 2) + ((i & 2) ? 8 : 0);
    const int c = n0 + (i >> 2) * 8 + (l & 3) * 2 + (i & 1);
    if (col < M && c < C)
      out[(int64_t(e) * C + c) * M + col] =
          __float2bfloat16(c < size ? acc[i] : 0.f);
  }
}

template <int BN, bool TMA>
static int launch_tc(const CUtensorMap& wmap, const CUtensorMap& xmap,
                     const void* x, const void* w, const int* gs, void* out,
                     int E, int C, int K, int M, cudaStream_t stream) {
  using L = TcLayout<BN>;
  int err = repro_hopper::allow_smem<gmm_wgmma_kernel<BN, TMA>>(L::kSmem);
  if (err) return err;
  dim3 grid((M + kTcBM - 1) / kTcBM, (C + BN - 1) / BN, E);
  gmm_wgmma_kernel<BN, TMA><<<grid, kTcThreads, L::kSmem, stream>>>(
      wmap, xmap, static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(w), gs,
      static_cast<__nv_bfloat16*>(out), C, K, M);
  return static_cast<int>(cudaGetLastError());
}

// N tile: C rounded up to 8, or 64 (one wgmma N) with C in several tiles
template <bool TMA>
static int dispatch_tc(const CUtensorMap& wmap, const CUtensorMap& xmap,
                       const void* x, const void* w, const int* gs,
                       void* out, int E, int C, int K, int M, int bn,
                       cudaStream_t st) {
#define REPRO_GMM_TC(N)                                                     \
  case N:                                                                   \
    return launch_tc<N, TMA>(wmap, xmap, x, w, gs, out, E, C, K, M, st);
  switch (bn) {
    REPRO_GMM_TC(8) REPRO_GMM_TC(16) REPRO_GMM_TC(24) REPRO_GMM_TC(32)
    REPRO_GMM_TC(40) REPRO_GMM_TC(48) REPRO_GMM_TC(56) REPRO_GMM_TC(64)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef REPRO_GMM_TC
}

// TMA needs 16-byte row strides: both widths multiples of 8 bf16
static bool tma_widths(int a, int b) {
  return a > 0 && b > 0 && a % 8 == 0 && b % 8 == 0;
}

// A bf16 (E, rows, cols) tensor's TMA map with a box of bx cols x by rows.
static int map_3d(CUtensorMap* map, const void* base, int E, int rows,
                  int cols, int bx, int by) {
  const uint64_t dims[3] = {uint64_t(cols), uint64_t(rows), uint64_t(E)};
  const uint64_t strides[2] = {uint64_t(cols) * 2,
                               uint64_t(rows) * cols * 2};
  const uint32_t box[3] = {uint32_t(bx), uint32_t(by), 1};
  return repro_hopper::make_tensor_map(map, base, 3, dims, strides, box, 128);
}

// out (E, C, M) = x (E, C, K) . w (E, K, M)
static int run_tc(const void* x, const void* w, const int* gs, void* out,
                  int E, int C, int K, int M, cudaStream_t st) {
  const int bn = C > 64 ? 64 : (C + 7) / 8 * 8;
  CUtensorMap wmap{}, xmap{};
  if (!tma_widths(K, M))
    return dispatch_tc<false>(wmap, xmap, x, w, gs, out, E, C, K, M, bn, st);
  // w: (E, K, M) in boxes of 64 M x 128 K rows; x (E, C, K) in boxes of
  // 64 K x bn rows
  int err = map_3d(&wmap, w, E, K, M, kTcBM, kTcBK);
  if (!err) err = map_3d(&xmap, x, E, C, K, 64, bn);
  if (err) return err;
  return dispatch_tc<true>(wmap, xmap, x, w, gs, out, E, C, K, M, bn, st);
}

// ----------------------------- bf16 backward: persistent dx and dw kernels
//
// Both kernels: one block an SM, 384 threads: warpgroups 0 and 1 consume,
// each 64 rows of a 128-row output tile on wgmma; warpgroup 2 produces
// (one thread issues TMA loads, or all 128 load masked elements when a
// width is not a multiple of 8).  A block walks tiles blockIdx.x,
// + gridDim.x, ...; its ring of 64-K-element stages runs on one iteration
// count over all of its tiles, so the producer fills the next tile's
// stages while the consumers finish the last one's epilogue.  A consumer
// keeps one commit group of products in flight and hands a stage back when
// the next stage's products are issued.  Epilogue: the f32 accumulators
// become bf16 in the warpgroup's staging tile (chunks of 64 columns x 64
// rows, 128-byte swizzle), then one TMA store a chunk, clipped at the
// tensor's bounds (element stores without TMA); the staging tile is
// written again only after those stores have read it.
//
// What holds them on an H100 at phimini-moe's training shape (measured
// with knock-out builds, PERF.md): dx streams its stages through L2 at
// L2's rate (each weight tile feeds the 2-3 C tiles of its expert, each
// dy tile the expert's d tiles), so it takes a 128 x 256 tile, which reads
// a quarter less than 128 x 128 for the same output, wherever that still
// leaves two tiles an SM (dx_width).  dw's K loops are short (ceil(size /
// 64) stages), so it overlaps each tile's epilogue with the next tile's
// first products, and its 126 MB of output share the memory with the
// loads.

constexpr int kBwBK = 64;         // K elements a stage (128-byte rows)
constexpr int kBwThreads = 384;
constexpr int kBwChunk = 64 * 64 * 2;             // 8 KB: 64 rows x 128 B

// A stage: A (128 rows) and B (BN rows or columns), 64 K elements each;
// each consumer warpgroup stages 64 x BN outputs.
template <int BN>
struct BwLayout {
  static constexpr int kOpA = 128 * kBwBK * 2;    // 16 KB
  static constexpr int kStage = kOpA + BN * kBwBK * 2;
  static constexpr int kStages = BN == 128 ? 5 : 3;  // what fits beside
                                                     // the staging tiles
  static constexpr int kStaging = 64 * BN * 2;
  static constexpr int kSmem =
      kStages * kStage + 2 * kStaging + 2 * kStages * 8 + 1024;
  static_assert(kSmem <= 232448, "shared memory of one block");
};

__device__ __forceinline__ int clamp_size(const int* gs, int e, int C) {
  return min(max(gs[e], 0), C);
}

// Set up the ring's barriers: ``full`` completes when a stage has landed
// (one arrival with its TMA bytes, or the 128 loading threads), ``empty``
// when the 256 consumer threads are done with it.
template <bool TMA>
__device__ __forceinline__ void bw_init(uint64_t* full, uint64_t* empty,
                                        int stages) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      repro_hopper::mbar_init(&full[s], TMA ? 1 : 128);
      repro_hopper::mbar_init(&empty[s], 256);
    }
    repro_hopper::fence_barrier_init();
  }
  __syncthreads();
}

// Registers (dw holds two accumulator sets): the producer warpgroup keeps
// 40 a thread, the consumers take 232 (128 x 40 + 256 x 232 <= 65,536).
// Every thread of a warpgroup runs its side's call.
__device__ __forceinline__ void producer_regs() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
}
__device__ __forceinline__ void consumer_regs() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
}

// Stage k0 .. k0 + 63 of rows r0 .. r0 + rows - 1 of an (E, R, K) tensor,
// K-major (``rows`` rows of 128 bytes at dst), by the producer warpgroup's
// 128 threads with masked element loads: rows at or past ``rlim`` and
// columns past K load as zero.
__device__ __forceinline__ void load_kmajor(uint8_t* dst,
                                            const __nv_bfloat16* src, int e,
                                            int R, int K, int r0, int rows,
                                            int rlim, int k0, int pt) {
  const __nv_bfloat16* base = src + int64_t(e) * R * K;
  for (int i = pt; i < rows * kBwBK; i += 128) {
    const int r = i / kBwBK, k = k0 + i % kBwBK;
    *reinterpret_cast<__nv_bfloat16*>(dst + swz128(r, i % kBwBK)) =
        r0 + r < rlim && k < K ? base[int64_t(r0 + r) * K + k]
                               : __float2bfloat16(0.f);
  }
}

// The same for an MN-major stage: rows k0 .. k0 + 63 (capacity rows, live
// below ``size``) of columns c0 .. c0 + 127 of an (E, C, N) tensor, as two
// chunks of 64 columns.
__device__ __forceinline__ void load_mnmajor(uint8_t* dst,
                                             const __nv_bfloat16* src, int e,
                                             int C, int N, int size, int c0,
                                             int k0, int pt) {
  const __nv_bfloat16* base = src + int64_t(e) * C * N;
  for (int i = pt; i < kBwBK * 128; i += 128) {
    const int r = i / 128, col = i % 128, k = k0 + r;
    *reinterpret_cast<__nv_bfloat16*>(dst + (col / 64) * kBwChunk +
                                      swz128(r, col % 64)) =
        k < size && c0 + col < N ? base[int64_t(k) * N + c0 + col]
                                 : __float2bfloat16(0.f);
  }
}

// Warpgroup wg's 64 x BN share of a tile, first row row0 and column col0
// of out[e] (an (E, R, N) tensor; map omap, boxes of 64 x 64), from its
// accumulators through its staging tile st: rows at or past ``live`` are 0
// by a select, so nothing of a row past a group (NaN included) gets
// through.  t: the thread's index in the warpgroup.
template <int BN, bool TMA>
__device__ __forceinline__ void bw_store(const float (&acc)[BN / 2],
                                         uint8_t* st, const CUtensorMap* omap,
                                         __nv_bfloat16* out, int e, int row0,
                                         int col0, int R, int N, int live,
                                         int wg, int t) {
  using namespace repro_hopper;
  if (TMA && t == 0) bulk_wait_read<0>();     // the last stores have read st
  named_barrier(2 + wg, 128);
  // accumulator i of thread (warp wq, lane l): row wq*16 + l/4 (+8 for
  // i & 2), column (i / 4) * 8 + (l % 4) * 2 + (i & 1)
  const int wq = t / 32, l = t % 32;
#pragma unroll
  for (int i = 0; i < BN / 2; i += 2) {
    const int r = wq * 16 + (l >> 2) + ((i & 2) ? 8 : 0);
    const int c = (i >> 2) * 8 + (l & 3) * 2;
    const bool keep = row0 + r < live;
    *reinterpret_cast<__nv_bfloat162*>(st + (c >> 6) * kBwChunk +
                                       swz128(r, c & 63)) =
        __floats2bfloat162_rn(keep ? acc[i] : 0.f, keep ? acc[i + 1] : 0.f);
  }
  if constexpr (TMA) {
    fence_proxy_async();
    named_barrier(2 + wg, 128);
    if (t == 0) {
      for (int j = 0; j < BN / 64; ++j)
        if (row0 < R && col0 + 64 * j < N)
          tma_store_3d(omap, st + j * kBwChunk, col0 + 64 * j, row0, e);
      bulk_commit();
    }
  } else {
    named_barrier(2 + wg, 128);
#pragma unroll 1
    for (int i = t; i < 64 * BN; i += 128) {
      const int r = i / BN, c = i % BN;
      if (row0 + r < R && col0 + c < N)
        out[(int64_t(e) * R + row0 + r) * N + col0 + c] =
            *reinterpret_cast<const __nv_bfloat16*>(
                st + (c >> 6) * kBwChunk + swz128(r, c & 63));
    }
  }
}

// dx's tiles: 128 rows of C (m) x BN columns of d (n) of one expert.
// The list holds first every live tile (m * 128 below the expert's size),
// expert by expert, each expert's (n, m) with m fastest, so tiles next to
// each other share a weight slab in L2; then every other tile (its rows
// all past the size: zeros, no load).  A thread asks for its tiles in
// rising order, so the cursor over experts only moves forward.
struct DxTile {
  int e, m, n, size;
  bool live;
};

struct DxWalk {
  const int* gs;
  int E, C, MT, NT;
  int e = 0, base = 0, pass = 0;   // expert e's tiles of this pass: base..

  __device__ DxWalk(const int* g, int E_, int C_, int MT_, int NT_)
      : gs(g), E(E_), C(C_), MT(MT_), NT(NT_) {}

  __device__ int live_m(int x) const {
    return (clamp_size(gs, x, C) + 127) / 128;
  }

  __device__ DxTile at(int t) {
    for (;;) {
      if (e == E) {
        if (pass) __trap();        // t past the list: a fault in the caller
        e = 0;
        pass = 1;
      }
      const int L = live_m(e);
      const int n = (pass ? MT - L : L) * NT;
      if (t < base + n) break;
      base += n;
      ++e;
    }
    const int L = live_m(e);
    const int per = pass ? MT - L : L;
    const int r = t - base;
    return DxTile{e, (pass ? L : 0) + r % per, r / per, clamp_size(gs, e, C),
                  pass == 0};
  }
};

// dx[e] (C x d) = (dy[e] . mask) (C x f) . w[e]^T: M = rows of C, N = d,
// K = f, both operands K-major.  A stage: dy rows c0 .. c0 + 127 (the A of
// both warpgroups, 64 rows each) and w rows n0 .. n0 + BN - 1 (B), 64 f
// columns each, 128-byte rows.  A row of dx depends on the same row of dy
// only, so dy's rows past the size (NaN included) reach only rows that the
// epilogue's select sets to 0; a warpgroup whose 64 rows all lie past the
// size issues no product.
template <int BN, bool TMA>
__global__ void __launch_bounds__(kBwThreads, 1)
gmm_dx_wgmma_kernel(const __grid_constant__ CUtensorMap ymap,
                    const __grid_constant__ CUtensorMap wmap,
                    const __grid_constant__ CUtensorMap omap,
                    const __nv_bfloat16* __restrict__ dy,
                    const __nv_bfloat16* __restrict__ w,
                    const int* __restrict__ group_sizes,
                    __nv_bfloat16* __restrict__ dx, int E, int C, int d,
                    int f) {
  using namespace repro_hopper;
  using L = BwLayout<BN>;
  constexpr int S = L::kStages;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = align1024(smem_raw);
  uint8_t* staging = ring + S * L::kStage;
  uint64_t* full = reinterpret_cast<uint64_t*>(staging + 2 * L::kStaging);
  uint64_t* empty = full + S;
  const int MT = (C + 127) / 128;
  const int NT = (d + BN - 1) / BN;
  const int tiles = E * MT * NT;
  const int nk = (f + kBwBK - 1) / kBwBK;
  const int tid = threadIdx.x;
  bw_init<TMA>(full, empty, S);
  DxWalk walk(group_sizes, E, C, MT, NT);
  uint32_t it = 0;                 // the ring's iteration, over all tiles

  if (tid >= 256) {                               // ---- producer
    const int pt = tid - 256;
    if (TMA && pt != 0) return;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const DxTile T = walk.at(t);
      if (!T.live) continue;
      const int c0 = T.m * 128, n0 = T.n * BN;
      for (int k = 0; k < nk; ++k, ++it) {
        const int s = it % S;
        if (it >= S) mbar_wait(&empty[s], ((it / S) + 1) & 1);
        uint8_t* a = ring + s * L::kStage;
        uint8_t* b = a + L::kOpA;
        const int k0 = k * kBwBK;
        if constexpr (TMA) {
          mbar_expect_tx(&full[s], L::kStage);
          tma_load_3d(a, &ymap, &full[s], k0, c0, T.e);
          tma_load_3d(b, &wmap, &full[s], k0, n0, T.e);
        } else {
          load_kmajor(a, dy, T.e, C, f, c0, 128, T.size, k0, pt);
          load_kmajor(b, w, T.e, d, f, n0, BN, d, k0, pt);
          fence_proxy_async();
          mbar_arrive(&full[s]);
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroups 0 and 1, 64 rows each of every tile
  const int wg = tid / 128, t128 = tid % 128;
  uint8_t* st = staging + wg * L::kStaging;
  float acc[BN / 2];
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const DxTile T = walk.at(t);
    const int row0 = T.m * 128 + 64 * wg;
    const int n0 = T.n * BN;
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    if (T.live) {
      const bool busy = row0 < T.size;
      int prev = -1;
      for (int k = 0; k < nk; ++k, ++it) {
        const int s = it % S;
        mbar_wait(&full[s], (it / S) & 1);
        if (busy) {
          const uint8_t* a = ring + s * L::kStage + wg * 64 * 128;
          const uint8_t* b = ring + s * L::kStage + L::kOpA;
          fence_regs(acc);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < kBwBK / 16; ++kk)  // 32 bytes into the rows
            wgmma_ss<BN, 0, 0>(acc, smem_desc(a + kk * 32, 16, 1024, 1),
                               smem_desc(b + kk * 32, 16, 1024, 1));
          wgmma_commit();
          wgmma_wait<1>();         // the last stage's products are done
          fence_regs(acc);
        }
        if (prev >= 0) mbar_arrive(&empty[prev]);
        prev = s;
      }
      wgmma_wait<0>();
      fence_regs(acc);
      mbar_arrive(&empty[prev]);
    }
    bw_store<BN, TMA>(acc, st, &omap, dx, T.e, row0, n0, C, d, T.size, wg,
                      t128);
  }
  if (TMA && t128 == 0) bulk_wait<0>();
}

// dw[e] (d x f) = x[e]^T (d x C) . (dy[e] . mask) (C x f): M = d, N = f,
// K = the capacity rows, both operands MN-major.  Tiles: 128 of d (m) x
// 128 of f (n) of one expert, (e, m, n) with n fastest, so tiles next to
// each other share x's tile in L2.  A stage: rows k0 .. k0 + 63 of x (two
// chunks of 64 d columns, one a warpgroup) and of dy (two chunks of 64 f
// columns, B of both); the K loop stops after ceil(size / 64) stages, and
// an idle expert's tiles load nothing and store zeros.  The last stage's
// rows past the size (TMA loads them from inside the buffer, any data) are
// zeroed in both operands in shared memory by both warpgroups, made
// visible to the tensor cores, and joined by a barrier of all 256
// consumer threads before either warpgroup issues a product: zeroing one
// operand would let 0 x NaN through.  A tile's sums are copied aside when
// its K loop ends, and its epilogue runs once the next tile's first
// products are issued, so the tensor cores have work through most of it.
template <bool TMA>
__global__ void __launch_bounds__(kBwThreads, 1)
gmm_dw_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                    const __grid_constant__ CUtensorMap ymap,
                    const __grid_constant__ CUtensorMap omap,
                    const __nv_bfloat16* __restrict__ x,
                    const __nv_bfloat16* __restrict__ dy,
                    const int* __restrict__ group_sizes,
                    __nv_bfloat16* __restrict__ dw, int E, int C, int d,
                    int f) {
  using namespace repro_hopper;
  using L = BwLayout<128>;
  constexpr int S = L::kStages;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = align1024(smem_raw);
  uint8_t* staging = ring + S * L::kStage;
  uint64_t* full = reinterpret_cast<uint64_t*>(staging + 2 * L::kStaging);
  uint64_t* empty = full + S;
  const int MT = (d + 127) / 128;
  const int NT = (f + 127) / 128;
  const int tiles = E * MT * NT;
  const int tid = threadIdx.x;
  bw_init<TMA>(full, empty, S);
  uint32_t it = 0;                 // the ring's iteration, over all tiles

  if (tid >= 256) {                               // ---- producer
    producer_regs();
    const int pt = tid - 256;
    if (TMA && pt != 0) return;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int e = t / (MT * NT), r = t % (MT * NT);
      const int m0 = (r / NT) * 128, n0 = (r % NT) * 128;
      const int size = clamp_size(group_sizes, e, C);
      const int nk = (size + kBwBK - 1) / kBwBK;
      for (int k = 0; k < nk; ++k, ++it) {
        const int s = it % S;
        if (it >= S) mbar_wait(&empty[s], ((it / S) + 1) & 1);
        uint8_t* a = ring + s * L::kStage;
        uint8_t* b = a + L::kOpA;
        const int k0 = k * kBwBK;
        if constexpr (TMA) {
          mbar_expect_tx(&full[s], L::kStage);
          tma_load_3d(a, &xmap, &full[s], m0, k0, e);
          tma_load_3d(a + kBwChunk, &xmap, &full[s], m0 + 64, k0, e);
          tma_load_3d(b, &ymap, &full[s], n0, k0, e);
          tma_load_3d(b + kBwChunk, &ymap, &full[s], n0 + 64, k0, e);
        } else {
          // masked element loads: rows past the size load as zero here
          load_mnmajor(a, x, e, C, d, size, m0, k0, pt);
          load_mnmajor(b, dy, e, C, f, size, n0, k0, pt);
          fence_proxy_async();
          mbar_arrive(&full[s]);
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroups 0 and 1, 64 rows of d each of every tile
  consumer_regs();
  const int wg = tid / 128, t128 = tid % 128;
  uint8_t* st = staging + wg * L::kStaging;
  float acc[64], done[64];         // this tile's sums; the last tile's
  bool owed = false;               // the last tile's epilogue, and where
  int oe = 0, om0 = 0, on0 = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int e = t / (MT * NT), r = t % (MT * NT);
    const int m0 = (r / NT) * 128, n0 = (r % NT) * 128;
    const int size = clamp_size(group_sizes, e, C);
    const int nk = (size + kBwBK - 1) / kBwBK;
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    int prev = -1;
    for (int k = 0; k < nk; ++k, ++it) {
      const int s = it % S;
      mbar_wait(&full[s], (it / S) & 1);
      uint8_t* a = ring + s * L::kStage;
      uint8_t* b = a + L::kOpA;
      const int live = size - k * kBwBK;
      if (TMA && live < kBwBK) {
        // rows live .. 63 of the stage's four chunks (x's two, dy's two)
        const uint4 z = make_uint4(0, 0, 0, 0);
        const int n16 = (kBwBK - live) * 8;         // 16-byte units a chunk
        for (int i = tid; i < 4 * n16; i += 256)
          reinterpret_cast<uint4*>(a + (i / n16) * kBwChunk +
                                   live * 128)[i % n16] = z;
        fence_proxy_async();
        named_barrier(1, 256);
      }
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBwBK / 16; ++kk)       // 16 rows further a step
        wgmma_ss<128, 1, 1>(
            acc, smem_desc(a + wg * kBwChunk + kk * 16 * 128, kBwChunk, 1024,
                           1),
            smem_desc(b + kk * 16 * 128, kBwChunk, 1024, 1));
      wgmma_commit();
      if (owed) {                  // while the first stage's products run
        bw_store<128, TMA>(done, st, &omap, dw, oe, om0 + 64 * wg, on0, d, f,
                           d, wg, t128);
        owed = false;
      }
      wgmma_wait<1>();             // the last stage's products are done
      fence_regs(acc);
      if (prev >= 0) mbar_arrive(&empty[prev]);
      prev = s;
    }
    wgmma_wait<0>();
    fence_regs(acc);
    if (nk > 0) mbar_arrive(&empty[prev]);
    if (owed)                      // an idle expert's tile ran no product
      bw_store<128, TMA>(done, st, &omap, dw, oe, om0 + 64 * wg, on0, d, f, d,
                         wg, t128);
#pragma unroll
    for (int i = 0; i < 64; ++i) done[i] = acc[i];
    owed = true;
    oe = e;
    om0 = m0;
    on0 = n0;
  }
  if (owed)
    bw_store<128, TMA>(done, st, &omap, dw, oe, om0 + 64 * wg, on0, d, f, d,
                       wg, t128);
  if (TMA && t128 == 0) bulk_wait<0>();
}

// The card's SM count, asked once per device.
static int sm_count() {
  static int counts[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (dev < 64 && counts[dev] > 0) return counts[dev];
  int n = 0;
  if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
      cudaSuccess)
    return 0;
  if (dev < 64) counts[dev] = n;
  return n;
}

// dx's tile width (with TMA): 256 where that still gives at least two
// tiles an SM, else 128.
static int dx_width(int E, int C, int d, int sms) {
  const int64_t tiles256 =
      int64_t(E) * ((C + 127) / 128) * ((d + 255) / 256);
  return tiles256 >= 2 * int64_t(sms) ? 256 : 128;
}

template <int BN, bool TMA>
static int launch_dx(const void* dy, const void* w, const int* gs, void* dx,
                     int E, int C, int d, int f, int sms, cudaStream_t st) {
  using bf = __nv_bfloat16;
  using L = BwLayout<BN>;
  CUtensorMap ymap{}, wmap{}, omap{};
  if constexpr (TMA) {
    // dy (E, C, f) in boxes of 64 f x 128 rows, w (E, d, f) of 64 f x BN
    // rows; dx (E, C, d) stored in boxes of 64 d x 64 rows
    int err = map_3d(&ymap, dy, E, C, f, 64, 128);
    if (!err) err = map_3d(&wmap, w, E, d, f, 64, BN);
    if (!err) err = map_3d(&omap, dx, E, C, d, 64, 64);
    if (err) return err;
  }
  const int64_t tiles = int64_t(E) * ((C + 127) / 128) * ((d + BN - 1) / BN);
  if (tiles > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  int err = repro_hopper::allow_smem<gmm_dx_wgmma_kernel<BN, TMA>>(L::kSmem);
  if (err) return err;
  gmm_dx_wgmma_kernel<BN, TMA>
      <<<int(std::min<int64_t>(tiles, sms)), kBwThreads, L::kSmem, st>>>(
          ymap, wmap, omap, static_cast<const bf*>(dy),
          static_cast<const bf*>(w), gs, static_cast<bf*>(dx), E, C, d, f);
  return static_cast<int>(cudaGetLastError());
}

template <bool TMA>
static int launch_dw(const void* x, const void* dy, const int* gs, void* dw,
                     int E, int C, int d, int f, int sms, cudaStream_t st) {
  using bf = __nv_bfloat16;
  using L = BwLayout<128>;
  CUtensorMap xmap{}, ymap{}, omap{};
  if constexpr (TMA) {
    // x (E, C, d) and dy (E, C, f) in boxes of 64 columns x 64 rows; dw
    // (E, d, f) stored in boxes of 64 f x 64 rows
    int err = map_3d(&xmap, x, E, C, d, 64, kBwBK);
    if (!err) err = map_3d(&ymap, dy, E, C, f, 64, kBwBK);
    if (!err) err = map_3d(&omap, dw, E, d, f, 64, 64);
    if (err) return err;
  }
  const int64_t tiles = int64_t(E) * ((d + 127) / 128) * ((f + 127) / 128);
  if (tiles > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  int err = repro_hopper::allow_smem<gmm_dw_wgmma_kernel<TMA>>(L::kSmem);
  if (err) return err;
  gmm_dw_wgmma_kernel<TMA>
      <<<int(std::min<int64_t>(tiles, sms)), kBwThreads, L::kSmem, st>>>(
          xmap, ymap, omap, static_cast<const bf*>(x),
          static_cast<const bf*>(dy), gs, static_cast<bf*>(dw), E, C, d, f);
  return static_cast<int>(cudaGetLastError());
}

// Both products of the bf16 backward, dx then dw, as two persistent
// launches on ``st``.
static int launch_bw(const void* x, const void* w, const int* gs,
                     const void* dy, void* dx, void* dw, int E, int C, int d,
                     int f, cudaStream_t st) {
  const int sms = sm_count();
  if (sms <= 0) return static_cast<int>(cudaErrorInvalidDevice);
  if (!tma_widths(d, f)) {
    const int err = launch_dx<128, false>(dy, w, gs, dx, E, C, d, f, sms, st);
    return err ? err : launch_dw<false>(x, dy, gs, dw, E, C, d, f, sms, st);
  }
  const int err =
      dx_width(E, C, d, sms) == 256
          ? launch_dx<256, true>(dy, w, gs, dx, E, C, d, f, sms, st)
          : launch_dx<128, true>(dy, w, gs, dx, E, C, d, f, sms, st);
  return err ? err : launch_dw<true>(x, dy, gs, dw, E, C, d, f, sms, st);
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
    return dispatch<float, false>(x, w, group_sizes, out, E, C, d, f, st);
  if (dtype == 1)
    return run_tc(x, w, group_sizes, out, E, C, d, f, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The backward of moe_gmm_fwd: given dy (E,C,f), dx (E,C,d) and dw (E,d,f)
// as the file's note says, in x's dtype; x, w, group_sizes as above, all
// contiguous and 16-byte aligned.  Two launches on ``stream`` (dx, then
// dw).  Returns the first cudaError_t, or cudaErrorInvalidValue for a dtype
// or a grid it does not take.
extern "C" int moe_gmm_bwd(const void* x, const void* w,
                           const int* group_sizes, const void* dy, void* dx,
                           void* dw, int E, int C, int d, int f, int dtype,
                           void* stream) {
  using namespace repro_gmm;
  if (E <= 0 || C <= 0 || f <= 0 || d <= 0 || E > 65535 ||
      (C + 15) / 16 > 65535 || (f + kDwF32Tile - 1) / kDwF32Tile > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    const int err =
        dispatch<float, true>(dy, w, group_sizes, dx, E, C, f, d, st);
    return err ? err
               : launch_dw_f32(x, dy, group_sizes, dw, E, C, d, f, st);
  }
  if (dtype == 1)
    return launch_bw(x, w, group_sizes, dy, dx, dw, E, C, d, f, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
