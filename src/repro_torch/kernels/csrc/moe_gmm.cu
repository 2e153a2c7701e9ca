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
// at 989 TFLOP/s; dw writes the 126 MB weight gradient, ~0.050 ms.  What the
// design does about it: each product reads its weights or writes its weight
// gradient once per tile of the other dimension, in fixed order, from a
// TMA ring, and stops at the group's size.
//   dx: the forward's kernels with the weight read the other way (template
//       flag WT): dx[e]^T (d x C) = w[e] (d x f) . dy[e]^T, so w is a
//       K-major A operand (two 64 x 64 TMA boxes a stage), dy the K-major B
//       operand x is in the forward; N tiles past the group write zeros and
//       the epilogue zeroes rows past it, which is dx's row contract.
//   dw: gmm_dw_wgmma_kernel, one block per (64 rows of d, 128 columns of f,
//       expert): A = x[e]^T and B = dy[e] are both MN-major (transpose bits
//       set), 64 capacity rows a stage, two wgmma N = 64 a k16 step; the K
//       loop stops after ceil(size / 64) stages, an expert of size 0 writes
//       zeros and loads nothing, and the last stage's rows past the size are
//       zeroed in shared memory in both operands before its products.  f32:
//       gmm_dw_kernel, the same blocking on FMAs.
// No atomics: every output element is summed by one block in one order.
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
  // stage s at s * kStage: the weight tile (16 KB: kTcBK rows of 64 M, or
  // under WT two chunks of 64 M rows x 64 K, 128-byte rows each), then the
  // x tile as two chunks of BN rows x 64 K
  static constexpr int kB = 2 * BN * 128;
  static constexpr int kStage = kTcA + kB;          // a multiple of 1024
  static constexpr int kSmem = kTcStages * kStage + 2 * kTcStages * 8 + 1024;
};

// Byte offset of element (row, col) in a tile of 128-byte rows under the
// 128-byte swizzle (16-byte group col / 8 XOR row % 8), as TMA writes it.
__device__ __forceinline__ int swz128(int row, int col) {
  return row * 128 + ((((col >> 3) ^ row) & 7) << 4) + (col & 7) * 2;
}

// out[e] (C x M) = x[e] (C x K) . W[e] (K x M), computed transposed as
// above.  The forward: K = d, M = f, w[e] stored (K, M), an MN-major A.
// WT (the backward's dx, x = dy): K = f, M = d, w[e] stored (M, K) and read
// as a K-major A.
template <int BN, bool TMA, bool WT>
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
        if constexpr (WT) {
          tma_load_3d(a, &wmap, &full[s], k0, m0, e);
          tma_load_3d(a + kTcBM * 128, &wmap, &full[s], k0 + 64, m0, e);
        } else {
          tma_load_3d(a, &wmap, &full[s], m0, k0, e);
        }
        tma_load_3d(b, &xmap, &full[s], k0, n0, e);
        tma_load_3d(b + BN * 128, &xmap, &full[s], k0 + 64, n0, e);
      } else {
        const __nv_bfloat16 zero = __float2bfloat16(0.f);
        const __nv_bfloat16* we = w + int64_t(e) * K * M;
        const __nv_bfloat16* xe = x + int64_t(e) * C * K;
        for (int i = pt; i < kTcBK * kTcBM; i += 128) {
          if constexpr (WT) {
            const int r = i / kTcBK, kd = i % kTcBK;
            const int m = m0 + r, k = k0 + kd;
            *reinterpret_cast<__nv_bfloat16*>(
                a + (kd / 64) * kTcBM * 128 + swz128(r, kd % 64)) =
                m < M && k < K ? we[int64_t(m) * K + k] : zero;
          } else {
            const int r = i / kTcBM, col = i % kTcBM;
            const int k = k0 + r, m = m0 + col;
            *reinterpret_cast<__nv_bfloat16*>(a + swz128(r, col)) =
                k < K && m < M ? we[int64_t(k) * M + m] : zero;
          }
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
      // M); under WT K-major, 32 bytes further into the 128-byte rows, the
      // next chunk every 4 steps.  B: K-major, as the WT A.
      const uint64_t da =
          WT ? smem_desc(a + (kk / 4) * kTcBM * 128 + (kk % 4) * 32, 16,
                         1024, 1)
             : smem_desc(a + kk * 16 * 128, kTcA, 1024, 1);
      const uint64_t db = smem_desc(b + (kk / 4) * BN * 128 + (kk % 4) * 32,
                                    16, 1024, 1);
      wgmma_ss<BN, WT ? 0 : 1, 0>(acc, da, db);
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

template <int BN, bool TMA, bool WT>
static int launch_tc(const CUtensorMap& wmap, const CUtensorMap& xmap,
                     const void* x, const void* w, const int* gs, void* out,
                     int E, int C, int K, int M, cudaStream_t stream) {
  using L = TcLayout<BN>;
  int err = repro_hopper::allow_smem<gmm_wgmma_kernel<BN, TMA, WT>>(L::kSmem);
  if (err) return err;
  dim3 grid((M + kTcBM - 1) / kTcBM, (C + BN - 1) / BN, E);
  gmm_wgmma_kernel<BN, TMA, WT><<<grid, kTcThreads, L::kSmem, stream>>>(
      wmap, xmap, static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(w), gs,
      static_cast<__nv_bfloat16*>(out), C, K, M);
  return static_cast<int>(cudaGetLastError());
}

// N tile: C rounded up to 8, or 64 (one wgmma N) with C in several tiles
template <bool TMA, bool WT>
static int dispatch_tc(const CUtensorMap& wmap, const CUtensorMap& xmap,
                       const void* x, const void* w, const int* gs,
                       void* out, int E, int C, int K, int M, int bn,
                       cudaStream_t st) {
#define REPRO_GMM_TC(N)                                                     \
  case N:                                                                   \
    return launch_tc<N, TMA, WT>(wmap, xmap, x, w, gs, out, E, C, K, M, st);
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

// out (E, C, M) = x (E, C, K) . W, W as gmm_wgmma_kernel says
template <bool WT>
static int run_tc(const void* x, const void* w, const int* gs, void* out,
                  int E, int C, int K, int M, cudaStream_t st) {
  const int bn = C > 64 ? 64 : (C + 7) / 8 * 8;
  CUtensorMap wmap{}, xmap{};
  if (!tma_widths(K, M))
    return dispatch_tc<false, WT>(wmap, xmap, x, w, gs, out, E, C, K, M, bn,
                                  st);
  // w: (E, K, M) in boxes of 64 M x 128 K rows, or under WT (E, M, K) in
  // boxes of 64 K x 64 M rows; x (E, C, K) in boxes of 64 K x bn rows
  int err = WT ? map_3d(&wmap, w, E, M, K, 64, kTcBM)
               : map_3d(&wmap, w, E, K, M, kTcBM, kTcBK);
  if (!err) err = map_3d(&xmap, x, E, C, K, 64, bn);
  if (err) return err;
  return dispatch_tc<true, WT>(wmap, xmap, x, w, gs, out, E, C, K, M, bn, st);
}

// ------------------------------------- bf16 backward: dw on tensor cores

constexpr int kDwBM = 64;    // rows of d a block (wgmma's M)
constexpr int kDwBN = 128;   // columns of f a block: two wgmma N = 64
constexpr int kDwBK = 64;    // capacity rows a stage
constexpr int kDwStages = 4;
constexpr int kDwA = kDwBK * kDwBM * 2;                  // 8 KB
constexpr int kDwB = kDwBK * kDwBN * 2;                  // 16 KB, 2 chunks
constexpr int kDwStage = kDwA + kDwB;                    // 24 KB
constexpr int kDwSmem = kDwStages * kDwStage + 2 * kDwStages * 8 + 1024;

// dw[e] (d x f) = x[e]^T . dy[e] over rows c < size.  A stage holds rows
// k0 .. k0 + 63 of x[e] (64 columns of d, 128-byte rows: A read MN-major)
// and of dy[e] (two chunks of 64 columns of f: B read MN-major).
template <bool TMA>
__global__ void __launch_bounds__(kTcThreads)
gmm_dw_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                    const __grid_constant__ CUtensorMap ymap,
                    const __nv_bfloat16* __restrict__ x,
                    const __nv_bfloat16* __restrict__ dy,
                    const int* __restrict__ group_sizes,
                    __nv_bfloat16* __restrict__ dw, int C, int d, int f) {
  using namespace repro_hopper;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kDwStages * kDwStage);
  uint64_t* empty = full + kDwStages;

  const int m0 = blockIdx.x * kDwBM;
  const int n0 = blockIdx.y * kDwBN;
  const int e = blockIdx.z;
  const int size = min(max(group_sizes[e], 0), C);
  const int tid = threadIdx.x;
  __nv_bfloat16* dwe = dw + int64_t(e) * d * f;

  if (size == 0) {             // an idle expert: zeros, nothing loaded
    for (int i = tid; i < kDwBM * kDwBN; i += kTcThreads) {
      const int m = m0 + i / kDwBN, n = n0 + i % kDwBN;
      if (m < d && n < f)
        dwe[int64_t(m) * f + n] = __float2bfloat16(0.f);
    }
    return;
  }
  const int nk = (size + kDwBK - 1) / kDwBK;

  if (tid == 0) {
    for (int s = 0; s < kDwStages; ++s) {
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
      const int s = t % kDwStages;
      if (t >= kDwStages) mbar_wait(&empty[s], ((t / kDwStages) + 1) & 1);
      uint8_t* a = smem + s * kDwStage;
      uint8_t* b = a + kDwA;
      const int k0 = t * kDwBK;
      if constexpr (TMA) {
        mbar_expect_tx(&full[s], kDwStage);
        tma_load_3d(a, &xmap, &full[s], m0, k0, e);
        tma_load_3d(b, &ymap, &full[s], n0, k0, e);
        tma_load_3d(b + kDwBK * 128, &ymap, &full[s], n0 + 64, k0, e);
      } else {
        // masked element loads: rows past the size load as zero here
        const __nv_bfloat16 zero = __float2bfloat16(0.f);
        const __nv_bfloat16* xe = x + int64_t(e) * C * d;
        const __nv_bfloat16* ye = dy + int64_t(e) * C * f;
        for (int i = pt; i < kDwBK * kDwBM; i += 128) {
          const int r = i / kDwBM, col = i % kDwBM;
          const int c = k0 + r, m = m0 + col;
          *reinterpret_cast<__nv_bfloat16*>(a + swz128(r, col)) =
              c < size && m < d ? xe[int64_t(c) * d + m] : zero;
        }
        for (int i = pt; i < kDwBK * kDwBN; i += 128) {
          const int r = i / kDwBN, col = i % kDwBN;
          const int c = k0 + r, n = n0 + col;
          *reinterpret_cast<__nv_bfloat16*>(
              b + (col / 64) * kDwBK * 128 + swz128(r, col % 64)) =
              c < size && n < f ? ye[int64_t(c) * f + n] : zero;
        }
        fence_proxy_async();
        mbar_arrive(&full[s]);
      }
    }
    return;
  }

  // ---- consumer: warpgroup 0
  float acc0[32], acc1[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc0[i] = acc1[i] = 0.f;
  for (int t = 0; t < nk; ++t) {
    const int s = t % kDwStages;
    mbar_wait(&full[s], (t / kDwStages) & 1);
    uint8_t* a = smem + s * kDwStage;
    uint8_t* b = a + kDwA;
    const int live = size - t * kDwBK;
    if (TMA && live < kDwBK) {
      // the last stage: TMA loaded rows live .. 63 (inside the buffer, any
      // data); zero them in both operands, then make the writes visible to
      // the tensor cores before any thread of the warpgroup issues wgmma
      const uint4 z = make_uint4(0, 0, 0, 0);
      const int n16 = (kDwBK - live) * 8;          // 16-byte units a chunk
      for (int i = tid; i < 3 * n16; i += 128) {
        const int chunk = i / n16, j = i % n16;
        uint8_t* base = chunk == 0 ? a : b + (chunk - 1) * kDwBK * 128;
        reinterpret_cast<uint4*>(base + live * 128)[j] = z;
      }
      fence_proxy_async();
      asm volatile("bar.sync 1, 128;\n" ::: "memory");
    }
    fence_regs(acc0);
    fence_regs(acc1);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kDwBK / 16; ++kk) {
      // all MN-major: 16 rows of C further per k16 step
      const uint64_t da = smem_desc(a + kk * 16 * 128, kDwBK * 128, 1024, 1);
      const uint64_t db0 = smem_desc(b + kk * 16 * 128, kDwBK * 128, 1024, 1);
      const uint64_t db1 = smem_desc(b + kDwBK * 128 + kk * 16 * 128,
                                     kDwBK * 128, 1024, 1);
      wgmma_ss<64, 1, 1>(acc0, da, db0);
      wgmma_ss<64, 1, 1>(acc1, da, db1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc0);
    fence_regs(acc1);
    mbar_arrive(&empty[s]);
  }

  // accumulator i of thread (warp wq, lane l): d row wq*16 + l/4 (+8 for
  // i & 2), f column (i / 4) * 8 + (l % 4) * 2 + (i & 1) of its 64-chunk
  const int wq = tid / 32, l = tid % 32;
  const bool pairs = (f & 1) == 0;
  auto store = [&](const float (&acc)[32], int n1) {
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int m = m0 + wq * 16 + (l >> 2) + ((i & 2) ? 8 : 0);
      const int n = n1 + (i >> 2) * 8 + (l & 3) * 2;
      if (m >= d || n >= f) continue;
      __nv_bfloat16* p = dwe + int64_t(m) * f + n;
      if (pairs) {             // n even, f even: a 4-byte aligned pair
        *reinterpret_cast<__nv_bfloat162*>(p) =
            __floats2bfloat162_rn(acc[i], acc[i + 1]);
      } else {
        p[0] = __float2bfloat16(acc[i]);
        if (n + 1 < f) p[1] = __float2bfloat16(acc[i + 1]);
      }
    }
  };
  store(acc0, n0);
  store(acc1, n0 + 64);
}

template <bool TMA>
static int launch_dw_tc(const CUtensorMap& xmap, const CUtensorMap& ymap,
                        const void* x, const void* dy, const int* gs,
                        void* dw, int E, int C, int d, int f,
                        cudaStream_t stream) {
  int err = repro_hopper::allow_smem<gmm_dw_wgmma_kernel<TMA>>(kDwSmem);
  if (err) return err;
  dim3 grid((d + kDwBM - 1) / kDwBM, (f + kDwBN - 1) / kDwBN, E);
  gmm_dw_wgmma_kernel<TMA><<<grid, kTcThreads, kDwSmem, stream>>>(
      xmap, ymap, static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(dy), gs,
      static_cast<__nv_bfloat16*>(dw), C, d, f);
  return static_cast<int>(cudaGetLastError());
}

static int run_dw_tc(const void* x, const void* dy, const int* gs, void* dw,
                     int E, int C, int d, int f, cudaStream_t st) {
  CUtensorMap xmap{}, ymap{};
  if (!tma_widths(d, f))
    return launch_dw_tc<false>(xmap, ymap, x, dy, gs, dw, E, C, d, f, st);
  // x (E, C, d) in boxes of 64 d x 64 rows, dy (E, C, f) of 64 f x 64 rows
  int err = map_3d(&xmap, x, E, C, d, kDwBM, kDwBK);
  if (!err) err = map_3d(&ymap, dy, E, C, f, 64, kDwBK);
  if (err) return err;
  return launch_dw_tc<true>(xmap, ymap, x, dy, gs, dw, E, C, d, f, st);
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
    return run_tc<false>(x, w, group_sizes, out, E, C, d, f, st);
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
      (C + 15) / 16 > 65535 || (f + kDwBN - 1) / kDwBN > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int err;
  if (dtype == 0) {
    err = dispatch<float, true>(dy, w, group_sizes, dx, E, C, f, d, st);
    return err ? err
               : launch_dw_f32(x, dy, group_sizes, dw, E, C, d, f, st);
  }
  if (dtype == 1) {
    err = run_tc<true>(dy, w, group_sizes, dx, E, C, f, d, st);
    return err ? err : run_dw_tc(x, dy, group_sizes, dw, E, C, d, f, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
