// Causal GQA flash attention, backward (FlashAttention-2), for Hopper:
// dq, dk and dv from (q, k, v, out, lse, dout), f32 FMAs, in three
// launches.
//
// Replaces: src/repro/models/flash.py, _flash_bwd, the block-recomputing
// custom VJP the JAX package trains through.  That is plain JAX, not a
// Pallas kernel: the JAX package never trains through Pallas.  Same
// function, step by step: delta = rowsum(dO * O); P = exp(S - lse) with S
// the scaled scores under the -1e30 sentinel; dV = P^T dO with P rounded to
// dO's dtype; dP = dO V^T; dS = P * (dP - delta), rounded to q's dtype;
// dQ = dS K * scale; dK = dS^T (q * scale), q * scale rounded to q's dtype.
// Masks: kv <= q, kv < lengths[b], q - kv < window.  A masked (q, kv) pair
// contributes exactly 0, as exp(-1e30 - lse) does for any row that sees a
// key; a row that sees none (only rows past a length, with a window) has
// dout 0 wherever it matters.  lse is (B, H, S) f32 in natural-log units
// (head h = kv-head * G + g: the JAX package's (B, KV, G, S)).
//
// What bounds it on an H100: 2.5x the forward's operations (S and dP
// recomputed, dV, dK and dQ accumulated; S and dP twice, once in each of
// the two main launches), ~14 * pairs * dh FLOPs against a few MB of
// traffic, so operations; on FMAs, not tensor cores, the f32 rate (67
// TFLOP/s) and shared-memory bandwidth bound it, far from the bf16
// tensor-core bound the kernel line states.  Tensor cores, TMA and fusing
// (b) into (c) are later work.
//
// The design, three launches, none with atomics, so every launch is
// bitwise repeatable:
//  (a) flash_bwd_delta_kernel: delta = rowsum(dO * O) in f32, one warp a
//      row, into a (B, H, S) f32 scratch;
//  (b) flash_bwd_dkdv_kernel: one block per (32 keys, kv-head, sequence).
//      K and V of the tile sit in shared memory (rows padded by four
//      words); the block walks the query rows that can see the tile (from
//      the tile's diagonal to the window's end, stopping at S) in steps of
//      16 rows, for each of the G query heads of the group: stage q * scale
//      and dO, recompute S and dP for the 16 x 32 pairs (4 a thread), form
//      P and dS, then accumulate dV and dK for the 32 keys in registers (4
//      threads a key, dh / 4 columns each);
//  (c) flash_bwd_dq_kernel: one block per (16 query rows, head, sequence),
//      the forward's key-loop bounds (window edge to the diagonal and the
//      length): stage K and V tiles of 32 keys, recompute S, dP, dS, and
//      accumulate dQ in registers (8 threads a row, dh / 8 columns each).
//  Shared memory is the limit of this FMA design (a scalar read fed about
//  one FMA): the dot products and the accumulations read four floats at a
//  time (float4), the rows that a whole warp shares as broadcasts; the
//  sums still run in the same order.
//  Two passes rather than atomicAdd on dQ: float atomics land in no fixed
//  order, and the kernel must give the same bits at every launch.
#include "attention_tile.cuh"
#include "hopper.cuh"

namespace repro_attn {

constexpr int kBwdThreads = 128;
constexpr int kBwdKeys = 32;        // keys per tile
constexpr int kBwdRows = 16;        // query rows per step
constexpr int kPairLd = kBwdKeys + 1;

template <typename T>
__device__ __forceinline__ float round_to(float x) { return x; }
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// Stage rows [pos0, pos0 + nrows) of head ``hh`` of a (B, S, heads, DH)
// tensor into dst (row stride ld floats), times ``mul``, rounded to T
// when ``kRound``; rows at or past S are zero.
template <int DH, typename T, bool kRound>
__device__ __forceinline__ void stage_rows(const T* src, int b, int S,
                                           int heads, int hh, int pos0,
                                           int nrows, float* dst, int ld,
                                           float mul) {
  constexpr int V = 16 / sizeof(T);
  const int chunks = nrows * (DH / V);
  for (int c = threadIdx.x; c < chunks; c += kBwdThreads) {
    const int r = c / (DH / V), col = (c % (DH / V)) * V;
    const int pos = pos0 + r;
    float tmp[V];
    if (pos < S) {
      load16(src + ((int64_t(b) * S + pos) * heads + hh) * DH + col, tmp);
    } else {
#pragma unroll
      for (int i = 0; i < V; ++i) tmp[i] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < V; ++i)
      dst[r * ld + col + i] = kRound ? round_to<T>(tmp[i] * mul) : tmp[i];
  }
}

__device__ __forceinline__ bool visible(int q_pos, int kv, int S, int length,
                                        int window) {
  return q_pos < S && kv < S && kv <= q_pos && kv < length &&
         q_pos - kv < window;
}

// ------------------------------------------------------------ (a) delta

template <int DH, typename T>
__global__ void __launch_bounds__(256)
flash_bwd_delta_kernel(const T* __restrict__ out, const T* __restrict__ dout,
                       float* __restrict__ delta, int64_t n_rows, int S,
                       int H) {
  const int64_t row = int64_t(blockIdx.x) * 8 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= n_rows) return;
  float acc = 0.f;
  for (int d = lane; d < DH; d += 32)
    acc = fmaf(to_float(dout[row * DH + d]), to_float(out[row * DH + d]),
               acc);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, o);
  if (lane == 0) {
    // row = (b * S + s) * H + h  ->  delta[(b * H + h) * S + s]
    const int h = int(row % H);
    const int64_t bs = row / H;
    const int s = int(bs % S);
    const int64_t b = bs / S;
    delta[(b * H + h) * S + s] = acc;
  }
}

// The shared-memory layout of (b) and (c), in floats.
template <int DH>
struct BwdSmem {
  // K/V rows padded by 4 words: rows stay 16-byte aligned for float4
  // reads, and 8 consecutive rows start on 8 different 4-bank groups
  static constexpr int KV_LD = DH + 4;
  static constexpr int K = 0;
  static constexpr int V = K + kBwdKeys * KV_LD;
  static constexpr int Q = V + kBwdKeys * KV_LD;
  static constexpr int DO = Q + kBwdRows * DH;
  static constexpr int P = DO + kBwdRows * DH;
  static constexpr int DS = P + kBwdRows * kPairLd;
  static constexpr int LSE = DS + kBwdRows * kPairLd;
  static constexpr int DELTA = LSE + kBwdRows;
  static constexpr int BYTES = (DELTA + kBwdRows) * 4;
};

// S and dP of the 4 (row, key) pairs of this thread: key t % 32, rows
// t / 32 + 4r.  Then P (into ps, rounded to T, when ps is not null) and dS
// (into dss, rounded to T) for each, zero where the pair is masked.
template <int DH, typename T>
__device__ __forceinline__ void pair_step(const float* sm, float* ps,
                                          float* dss, int q_lo, int j0,
                                          int S, int length, int window) {
  using L = BwdSmem<DH>;
  const int j = threadIdx.x % kBwdKeys, i0 = threadIdx.x / kBwdKeys;
  float s[4] = {0.f, 0.f, 0.f, 0.f}, dp[4] = {0.f, 0.f, 0.f, 0.f};
  const float4* kr =
      reinterpret_cast<const float4*>(sm + L::K + j * L::KV_LD);
  const float4* vr =
      reinterpret_cast<const float4*>(sm + L::V + j * L::KV_LD);
#pragma unroll 4
  for (int d4 = 0; d4 < DH / 4; ++d4) {
    const float4 kd = kr[d4], vd = vr[d4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = i0 + 4 * r;
      const float4 qd =
          reinterpret_cast<const float4*>(sm + L::Q + i * DH)[d4];
      const float4 od =
          reinterpret_cast<const float4*>(sm + L::DO + i * DH)[d4];
      s[r] = fmaf(qd.w, kd.w,
                  fmaf(qd.z, kd.z, fmaf(qd.y, kd.y, fmaf(qd.x, kd.x, s[r]))));
      dp[r] = fmaf(od.w, vd.w,
                   fmaf(od.z, vd.z, fmaf(od.y, vd.y, fmaf(od.x, vd.x,
                                                          dp[r]))));
    }
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = i0 + 4 * r;
    const bool ok = visible(q_lo + i, j0 + j, S, length, window);
    const float p = ok ? expf(s[r] - sm[L::LSE + i]) : 0.f;
    if (ps) ps[i * kPairLd + j] = round_to<T>(p);
    dss[i * kPairLd + j] = round_to<T>(p * (dp[r] - sm[L::DELTA + i]));
  }
}

// ------------------------------------------------------------ (b) dK, dV

template <int DH, typename T>
__global__ void __launch_bounds__(kBwdThreads)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta,
                      const int* __restrict__ lengths, T* __restrict__ dk,
                      T* __restrict__ dv, int S, int H, int KV, int window,
                      float scale) {
  using L = BwdSmem<DH>;
  extern __shared__ float sm[];
  const int j0 = blockIdx.x * kBwdKeys, kvh = blockIdx.y, b = blockIdx.z;
  const int G = H / KV;
  const int length = lengths[b];
  // a thread accumulates key jj's columns 4 (c0 + 4m) + e, read as float4
  constexpr int C = DH / 4;
  const int jj = threadIdx.x / 4, c0 = threadIdx.x % 4;
  float dk_acc[C], dv_acc[C];
#pragma unroll
  for (int m = 0; m < C; ++m) { dk_acc[m] = 0.f; dv_acc[m] = 0.f; }

  // the last key of the tile any row can see, and the rows that see it
  const int kv_last = min(j0 + kBwdKeys, min(S, length)) - 1;
  if (kv_last >= j0) {
    stage_rows<DH, T, false>(k, b, S, KV, kvh, j0, kBwdKeys, sm + L::K,
                             L::KV_LD, 1.f);
    stage_rows<DH, T, false>(v, b, S, KV, kvh, j0, kBwdKeys, sm + L::V,
                             L::KV_LD, 1.f);
    const int q_begin = (j0 / kBwdRows) * kBwdRows;
    const int q_end = int(min(int64_t(S), int64_t(kv_last) + window));
    for (int g = 0; g < G; ++g) {
      const int h = kvh * G + g;
      for (int q_lo = q_begin; q_lo < q_end; q_lo += kBwdRows) {
        __syncthreads();                    // the last step's reads are done
        stage_rows<DH, T, true>(q, b, S, H, h, q_lo, kBwdRows, sm + L::Q, DH,
                                scale);
        stage_rows<DH, T, false>(dout, b, S, H, h, q_lo, kBwdRows,
                                 sm + L::DO, DH, 1.f);
        if (threadIdx.x < kBwdRows) {
          const int qp = q_lo + threadIdx.x;
          const int64_t at = (int64_t(b) * H + h) * S + min(qp, S - 1);
          sm[L::LSE + threadIdx.x] = lse[at];
          sm[L::DELTA + threadIdx.x] = delta[at];
        }
        __syncthreads();
        pair_step<DH, T>(sm, sm + L::P, sm + L::DS, q_lo, j0, S, length,
                         window);
        __syncthreads();
#pragma unroll 4
        for (int i = 0; i < kBwdRows; ++i) {
          const float p = sm[L::P + i * kPairLd + jj];
          const float ds = sm[L::DS + i * kPairLd + jj];
          const float4* qr =
              reinterpret_cast<const float4*>(sm + L::Q + i * DH);
          const float4* dor =
              reinterpret_cast<const float4*>(sm + L::DO + i * DH);
#pragma unroll
          for (int m = 0; m < C / 4; ++m) {
            const float4 o = dor[c0 + 4 * m], q4 = qr[c0 + 4 * m];
            float* dva = dv_acc + 4 * m;
            float* dka = dk_acc + 4 * m;
            dva[0] = fmaf(p, o.x, dva[0]);
            dva[1] = fmaf(p, o.y, dva[1]);
            dva[2] = fmaf(p, o.z, dva[2]);
            dva[3] = fmaf(p, o.w, dva[3]);
            dka[0] = fmaf(ds, q4.x, dka[0]);
            dka[1] = fmaf(ds, q4.y, dka[1]);
            dka[2] = fmaf(ds, q4.z, dka[2]);
            dka[3] = fmaf(ds, q4.w, dka[3]);
          }
        }
      }
    }
  }
  const int kv = j0 + jj;
  if (kv < S) {
    const int64_t at = ((int64_t(b) * S + kv) * KV + kvh) * DH;
#pragma unroll
    for (int m = 0; m < C; ++m) {
      const int col = 4 * (c0 + 4 * (m / 4)) + m % 4;
      store(dk_acc[m], dk + at + col);
      store(dv_acc[m], dv + at + col);
    }
  }
}

// ------------------------------------------------------------ (c) dQ

template <int DH, typename T>
__global__ void __launch_bounds__(kBwdThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    const int* __restrict__ lengths, T* __restrict__ dq,
                    int S, int H, int KV, int window, float scale) {
  using L = BwdSmem<DH>;
  extern __shared__ float sm[];
  const int q_lo = blockIdx.x * kBwdRows, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int length = lengths[b];
  // a thread accumulates row ii's columns 4 (c0 + 8m) + e, read as float4
  // (at DH 16: columns c0 + 8m, one float a read)
  constexpr int C = DH / 8;
  constexpr bool kVec = DH >= 32;
  const int ii = threadIdx.x / 8, c0 = threadIdx.x % 8;
  float dq_acc[C];
#pragma unroll
  for (int m = 0; m < C; ++m) dq_acc[m] = 0.f;

  stage_rows<DH, T, true>(q, b, S, H, h, q_lo, kBwdRows, sm + L::Q, DH,
                          scale);
  stage_rows<DH, T, false>(dout, b, S, H, h, q_lo, kBwdRows, sm + L::DO, DH,
                           1.f);
  if (threadIdx.x < kBwdRows) {
    const int qp = q_lo + threadIdx.x;
    const int64_t at = (int64_t(b) * H + h) * S + min(qp, S - 1);
    sm[L::LSE + threadIdx.x] = lse[at];
    sm[L::DELTA + threadIdx.x] = delta[at];
  }
  const int q_hi = min(q_lo + kBwdRows, S) - 1;
  const int kv_end = max(min(q_hi + 1, length), 0);
  const int kv_begin = (max(0, q_lo - window + 1) / kBwdKeys) * kBwdKeys;
  for (int j0 = kv_begin; j0 < kv_end; j0 += kBwdKeys) {
    __syncthreads();                        // the last tile's reads are done
    stage_rows<DH, T, false>(k, b, S, KV, kvh, j0, kBwdKeys, sm + L::K,
                             L::KV_LD, 1.f);
    stage_rows<DH, T, false>(v, b, S, KV, kvh, j0, kBwdKeys, sm + L::V,
                             L::KV_LD, 1.f);
    __syncthreads();
    pair_step<DH, T>(sm, nullptr, sm + L::DS, q_lo, j0, S, length, window);
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < kBwdKeys; ++j) {
      const float ds = sm[L::DS + ii * kPairLd + j];
      const float* kr = sm + L::K + j * L::KV_LD;
      if constexpr (kVec) {
#pragma unroll
        for (int m = 0; m < C / 4; ++m) {
          const float4 k4 = reinterpret_cast<const float4*>(kr)[c0 + 8 * m];
          float* dqa = dq_acc + 4 * m;
          dqa[0] = fmaf(ds, k4.x, dqa[0]);
          dqa[1] = fmaf(ds, k4.y, dqa[1]);
          dqa[2] = fmaf(ds, k4.z, dqa[2]);
          dqa[3] = fmaf(ds, k4.w, dqa[3]);
        }
      } else {
#pragma unroll
        for (int m = 0; m < C; ++m)
          dq_acc[m] = fmaf(ds, kr[c0 + 8 * m], dq_acc[m]);
      }
    }
  }
  const int qp = q_lo + ii;
  if (qp < S) {
    T* row = dq + ((int64_t(b) * S + qp) * H + h) * DH;
#pragma unroll
    for (int m = 0; m < C; ++m) {
      const int col = kVec ? 4 * (c0 + 8 * (m / 4)) + m % 4 : c0 + 8 * m;
      store(dq_acc[m] * scale, row + col);
    }
  }
}

template <int DH, typename T>
static int launch_bwd(const void* q, const void* k, const void* v,
                      const void* out, const float* lse, const void* dout,
                      const int* lengths, void* dq, void* dk, void* dv,
                      float* delta, int B, int S, int H, int KV, int window,
                      float scale, cudaStream_t st) {
  using L = BwdSmem<DH>;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dout);
  const int64_t rows = int64_t(B) * S * H;
  flash_bwd_delta_kernel<DH, T><<<unsigned((rows + 7) / 8), 256, 0, st>>>(
      static_cast<const T*>(out), dot, delta, rows, S, H);
  int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  err = repro_hopper::allow_smem<flash_bwd_dkdv_kernel<DH, T>>(L::BYTES);
  if (err) return err;
  err = repro_hopper::allow_smem<flash_bwd_dq_kernel<DH, T>>(L::BYTES);
  if (err) return err;
  dim3 gk((S + kBwdKeys - 1) / kBwdKeys, KV, B);
  flash_bwd_dkdv_kernel<DH, T><<<gk, kBwdThreads, L::BYTES, st>>>(
      qt, kt, vt, dot, lse, delta, lengths, static_cast<T*>(dk),
      static_cast<T*>(dv), S, H, KV, window, scale);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  dim3 gq((S + kBwdRows - 1) / kBwdRows, H, B);
  flash_bwd_dq_kernel<DH, T><<<gq, kBwdThreads, L::BYTES, st>>>(
      qt, kt, vt, dot, lse, delta, lengths, static_cast<T*>(dq), S, H, KV,
      window, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace repro_attn

// dtype: 0 = float32, 1 = bfloat16.  ``delta`` is a (B, H, S) f32 scratch
// the caller allocates.  Returns a cudaError_t: the first launch's error,
// or cudaErrorInvalidValue for a head dim, dtype or shape it lacks.
extern "C" int flash_attention_bwd(const void* q, const void* k,
                                   const void* v, const void* out,
                                   const float* lse, const void* dout,
                                   const int* lengths, void* dq, void* dk,
                                   void* dv, float* delta, int B, int S,
                                   int H, int KV, int dh, int window,
                                   float scale, int dtype, void* stream) {
  using namespace repro_attn;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (H > 65535 || B > 65535 || KV < 1 || H % KV)
    return static_cast<int>(cudaErrorInvalidValue);
#define REPRO_FLASH_BWD(D, T)                                               \
  case D:                                                                   \
    return launch_bwd<D, T>(q, k, v, out, lse, dout, lengths, dq, dk, dv,   \
                            delta, B, S, H, KV, window, scale, st);
  if (dtype == 0) {
    switch (dh) {
      REPRO_FLASH_BWD(16, float) REPRO_FLASH_BWD(32, float)
      REPRO_FLASH_BWD(64, float) REPRO_FLASH_BWD(128, float)
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  if (dtype == 1) {
    switch (dh) {
      REPRO_FLASH_BWD(16, __nv_bfloat16) REPRO_FLASH_BWD(32, __nv_bfloat16)
      REPRO_FLASH_BWD(64, __nv_bfloat16) REPRO_FLASH_BWD(128, __nv_bfloat16)
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
#undef REPRO_FLASH_BWD
  return static_cast<int>(cudaErrorInvalidValue);
}
