// Grouped expert matmul for Hopper: out[e] = x[e] @ w[e] for every expert
// e, f32 or bf16 in, f32 sums, stored in x's dtype.  Rows c >= group_sizes[e]
// of out[e] are 0.
//
// Replaces: src/repro/kernels/moe_gmm.py, moe_gmm_pallas / _gmm_kernel (the
// Pallas TPU kernel).  Same function, not the same blocks: the TPU kernel
// keeps a whole (d, f) weight slab in VMEM per (expert, row block); here a
// block owns a 64-column slice of one expert's output rows and walks d.
//
// What bounds it on an H100: the weights.  With a top-2 router each active
// expert's w[e] is read once per call: at phimini-moe's widths (16 experts,
// d 4096, f 960, bf16) that is 16 * 4096 * 960 * 2 B = 126 MB per gate/up/
// down call when all experts are active, 37.6 us at 3.35 TB/s.  The FLOPs
// at capacity C = 40 are 2 * 16 * 40 * 4096 * 960 = 5 GFLOP, 5 us at
// 989 TFLOP/s: bound by bytes at every shape of the serving path (C = 1 at
// batch-8 decode up to C = 40 at a 256-token chunk).
//
// What the design does about it: one block per (64-column tile of f, row
// tile of C, expert).  A row tile that starts at or past its expert's group
// size writes zeros and reads no weights, so an expert with an empty group
// costs no byte of w[e] (the TPU kernel does this with @pl.when).  The row
// tile is 16 rows when C <= 16 (decode) and 64 otherwise, so every C of the
// serving path takes one row tile and w[e] is streamed once.  The K loop
// stages a K-step x 64 weight tile and a rows x K-step activation tile in
// shared memory as f32, loading the next tiles into registers (16-byte
// loads where the widths allow) while the current ones are summed with f32
// FMAs.  The K step is 128 for the 16-row tile (decode: each weight is used
// once, so the loop is bound by load latency and wants more bytes in
// flight per step) and 64 for the 64-row tile.
// Tensor cores (mma.sync / wgmma) and TMA are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro_gmm {

constexpr int kThreads = 256;
constexpr int kBN = 64;   // output columns per block

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

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
template <int V>
__device__ __forceinline__ void load_n(const __nv_bfloat16* p, float* out) {
  if constexpr (V == 1) {
    out[0] = __bfloat162float(*p);
  } else {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
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

}  // namespace repro_gmm

// x (E,C,d), w (E,d,f), group_sizes (E,) int32 on the device, out (E,C,f);
// all contiguous and 16-byte aligned.  dtype: 0 = float32, 1 = bfloat16.
// Returns a cudaError_t: the launch's own, or cudaErrorInvalidValue for a
// dtype or a grid it does not take.
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
    return dispatch<__nv_bfloat16>(x, w, group_sizes, out, E, C, d, f, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
