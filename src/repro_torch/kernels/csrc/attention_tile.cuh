// Shared device code of the f32 FMA attention kernels (flash prefill, paged
// extend): one query row per group of kLanes threads, an f32 online softmax
// carried in registers, and K/V staged through shared memory in tiles of
// kTile key rows.  The paged decode kernel uses its loads and conversions.
//
// Row layout: lane t of a row group owns head dims {i * kLanes + t}, so the
// eight lanes of a group read eight consecutive shared-memory words (no
// bank conflict) and the four groups of a warp read the same words
// (broadcast).  A score is the lanes' partial dot products summed with
// three warp shuffles.
//
// Masking follows the TPU kernels exactly: a masked score is the -1e30
// sentinel (never -inf), and the output divides by max(l, 1e-20), so rows
// with nothing to attend to stay finite.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro_attn {

constexpr int kLanes = 8;                   // threads sharing one query row
constexpr int kRows = 16;                   // query rows per block
constexpr int kThreads = kLanes * kRows;    // 128
constexpr int kTile = 32;                   // key rows staged per step
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float x, float* p) { *p = x; }
__device__ __forceinline__ void store(float x, __nv_bfloat16* p) {
  *p = __float2bfloat16(x);
}

// One 16-byte load, widened to f32.
__device__ __forceinline__ void load16(const float* src, float* dst) {
  const float4 x = *reinterpret_cast<const float4*>(src);
  dst[0] = x.x; dst[1] = x.y; dst[2] = x.z; dst[3] = x.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* src, float* dst) {
  const uint4 x = *reinterpret_cast<const uint4*>(src);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&x);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    dst[2 * i] = f.x;
    dst[2 * i + 1] = f.y;
  }
}

template <int DH>
struct RowState {
  static constexpr int D = DH / kLanes;     // head dims owned by one lane
  float q[D];                               // pre-scaled query
  float acc[D];
  float m;
  float l;
};

template <int DH, typename T>
__device__ __forceinline__ void init_row(RowState<DH>& st, const T* qrow,
                                         float scale, int lane) {
#pragma unroll
  for (int i = 0; i < RowState<DH>::D; ++i) {
    st.q[i] = to_float(qrow[i * kLanes + lane]) * scale;
    st.acc[i] = 0.f;
  }
  st.m = kNegInf;
  st.l = 0.f;
}

// Stage key rows [j0, j0 + kTile) of K and V into shared memory as f32.
// ``row_off(j)`` is the element offset of key j's head vector; rows at or
// past ``jend`` are zero-filled (and masked by attend_tile).
template <int DH, typename T, typename RowOff>
__device__ __forceinline__ void stage_tile(const T* k, const T* v,
                                           RowOff row_off, int j0, int jend,
                                           float* ks, float* vs) {
  constexpr int V = 16 / sizeof(T);         // elements per 16-byte load
  constexpr int kChunks = kTile * DH / V;
  for (int c = threadIdx.x; c < kChunks; c += kThreads) {
    const int j = c / (DH / V);
    const int col = (c % (DH / V)) * V;
    float* kd = ks + j * DH + col;
    float* vd = vs + j * DH + col;
    if (j0 + j < jend) {
      const int64_t off = row_off(j0 + j) + col;
      load16(k + off, kd);
      load16(v + off, vd);
    } else {
#pragma unroll
      for (int i = 0; i < V; ++i) { kd[i] = 0.f; vd[i] = 0.f; }
    }
  }
}

// Fold one staged tile into a row's online softmax.  Key kv is visible to
// the row at ``q_pos`` iff kv <= q_pos, kv < length, q_pos - kv < window
// and kv < jend (the end of what the block walks).
template <int DH>
__device__ __forceinline__ void attend_tile(RowState<DH>& st,
                                            const float* ks, const float* vs,
                                            int j0, int jend, int q_pos,
                                            int length, int window,
                                            int lane) {
  constexpr int D = RowState<DH>::D;
  float s[kTile];
  float tile_max = kNegInf;
#pragma unroll
  for (int j = 0; j < kTile; ++j) {
    float part = 0.f;
#pragma unroll
    for (int i = 0; i < D; ++i)
      part = fmaf(st.q[i], ks[j * DH + i * kLanes + lane], part);
    part += __shfl_xor_sync(0xffffffffu, part, 4);
    part += __shfl_xor_sync(0xffffffffu, part, 2);
    part += __shfl_xor_sync(0xffffffffu, part, 1);
    const int kv = j0 + j;
    const bool ok = kv < jend && kv <= q_pos && kv < length &&
                    q_pos - kv < window;
    s[j] = ok ? part : kNegInf;
    tile_max = fmaxf(tile_max, s[j]);
  }
  const float m_new = fmaxf(st.m, tile_max);
  const float corr = expf(st.m - m_new);
  float psum = 0.f;
#pragma unroll
  for (int j = 0; j < kTile; ++j) {
    s[j] = expf(s[j] - m_new);
    psum += s[j];
  }
  st.l = st.l * corr + psum;
#pragma unroll
  for (int i = 0; i < D; ++i) st.acc[i] *= corr;
#pragma unroll
  for (int j = 0; j < kTile; ++j) {
#pragma unroll
    for (int i = 0; i < D; ++i)
      st.acc[i] = fmaf(s[j], vs[j * DH + i * kLanes + lane], st.acc[i]);
  }
  st.m = m_new;
}

template <int DH, typename T>
__device__ __forceinline__ void write_row(const RowState<DH>& st, T* orow,
                                          int lane) {
  const float l = fmaxf(st.l, 1e-20f);
#pragma unroll
  for (int i = 0; i < RowState<DH>::D; ++i)
    store(st.acc[i] / l, orow + i * kLanes + lane);
}

}  // namespace repro_attn
