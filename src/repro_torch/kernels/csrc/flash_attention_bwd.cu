// Causal GQA flash attention, backward (FlashAttention-2), for Hopper:
// dq, dk and dv from (q, k, v, out, lse, dout).  Two designs, chosen by
// dtype alone, neither a fallback for the other:
//   bf16: two passes on wgmma fed by TMA (flash_bwd_dkdv_wgmma_kernel,
//         flash_bwd_dq_wgmma_kernel);
//   f32:  two passes on f32 FMAs (flash_bwd_dkdv_kernel,
//         flash_bwd_dq_kernel).  Hopper's tensor cores have no full-f32
//         product, and TF32 would break the f32 path's 1e-4 agreement with
//         its plain version and the f32 card-vs-CPU training check.
// Both start with flash_bwd_delta_kernel.
//
// Replaces: src/repro/models/flash.py, _flash_bwd, the block-recomputing
// custom VJP the JAX package trains through.  That is plain JAX, not a
// Pallas kernel: the JAX package never trains through Pallas.  Same
// function, step by step: delta = rowsum(dO * O); P = exp(S - lse) with S
// the scaled scores under the -1e30 sentinel; dV = P^T dO with P rounded to
// dO's dtype; dP = dO V^T; dS = P * (dP - delta), rounded to q's dtype;
// dQ = dS K * scale; dK = dS^T (q * scale), q * scale rounded to q's dtype.
// At dh 16 and 64 (scale a power of two, q * scale exact) the bf16 kernels
// scale S in f32 and multiply dK by ``scale`` once at the store; at dh 32
// and 128 they round q * scale to bf16 in shared memory first, as the
// plain version does (scaling in f32 there moves a P near 1 by an ulp of
// bf16, and a small dV entry by more than 2e-2).
// Masks: kv <= q, kv < lengths[b], q - kv < window.  A masked (q, kv) pair
// contributes exactly 0, as exp(-1e30 - lse) does for any row that sees a
// key; a row that sees none (only rows past a length, with a window) has
// dout 0 wherever it matters.  lse is (B, H, S) f32 in natural-log units
// (head h = kv-head * G + g: the JAX package's (B, KV, G, S)).
//
// What bounds it on an H100: ~10 * dh FLOPs a visible (query, key) pair
// (S = QK^T, dP = dO V^T, dV += P^T dO, dK += dS^T Q, dQ += dS K) against a
// few MB of traffic, so the bf16 tensor-core rate; the two passes do 14 *
// dh (S and dP in both), so their floor is 1.4x that bound.  Between the
// products each tile needs exp2, the masks, dS and the bf16 packing on the
// CUDA cores, which one consumer warpgroup serialises with its own wgmma
// waits; few warpgroups share an SM, as the dK/dV kernel keeps dK and dV
// (64 x dh f32 each) in registers (at dh 128 one block an SM), and its
// heaviest block walks G * S / 64 query tiles in turn.
//
// The bf16 design, per pass one block of 160 threads in the shape of the
// forward (flash_attention.cu): warp 4 loads by TMA (attention_wgmma.cuh's
// 64-row tiles, swizzled) into a 2-stage mbarrier ring, warpgroup 0 runs
// wgmma on what has arrived.
//  dK/dV: one block per (64 keys, kv-head, sequence), key tile 0 (the
//    most query tiles) launched first.  K_j and V_j are loaded once; Q_i,
//    dO_i and the rows' lse (times log2 e) and delta stream in for each
//    query head g of the group and each 64-row query tile that can see the
//    key tile (from its diagonal to the window's end, stopping at S).  Per
//    tile (Q_i scaled in place first at dh 32 and 128): S^T = K_j Q_i^T
//    and dP^T = V_j dO_i^T in one wgmma group (all K-major);
//    P^T = exp2(S^T * scale * log2 e - lse * log2 e), lse along
//    the accumulator's columns, read from shared memory; dS^T = P^T *
//    (dP^T - delta); then dV += P^T dO_i and dK += dS^T Q_i with P^T and
//    dS^T packed to bf16 in registers as the A operand and dO_i, Q_i read
//    MN-major.  dK and dV (64 x dh f32 each) stay in registers.
//  dQ: one block per (64 query rows, head, sequence), the last query tile
//    (the most key tiles) launched first.  Q_i and dO_i are loaded once
//    and K_j, V_j stream over the forward's key-loop bounds: S = Q_i K_j^T
//    and dP = dO_i V_j^T, P and dS as above, dQ += dS K_j with K_j read
//    MN-major.
//  Masks are applied only on tiles that cross the diagonal, the window's
//  edge, S or lengths[b].
// No atomics in either design: each output element is summed by one block
// in a fixed order, so every launch gives the same bits.  Fusing the two
// passes would need a dQ workspace per key tile (a 64 x 64 f32 partial per
// visible tile pair, ~214 MB written and read at demo-110m's shape) to
// save 4 * dh FLOPs a pair: it loses on this card.
//
// The f32 design, three launches:
//  (a) flash_bwd_delta_kernel: delta = rowsum(dO * O) in f32, one warp a
//      row, into a (B, H, S) f32 scratch (both dtypes);
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
//  The dot products and the accumulations read shared memory four floats
//  at a time (float4), the rows that a whole warp shares as broadcasts.
#include "attention_tile.cuh"
#include "attention_wgmma.cuh"
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

// ------------------------------------------------ bf16: tensor cores, TMA

constexpr float kLog2e = 1.4426950408889634f;

// Whether the kernels round q * scale to bf16 before the products: where
// scale = dh^-1/2 is not a power of two.
template <int DH>
constexpr bool kScaleQ = DH == 32 || DH == 128;

// tile *= mul, rounded to bf16, for a 64-row tile of dh in shared memory,
// by the 128 consumer threads (elementwise, so the swizzle does not
// matter); then the tile is made visible to wgmma and the threads meet at
// named barrier 1.
template <int DH>
__device__ __forceinline__ void scale_tile(uint8_t* tile, float mul,
                                           int tid) {
  uint4* t = reinterpret_cast<uint4*>(tile);
#pragma unroll 4
  for (int i = tid; i < kTcRows * DH / 8; i += 128) {
    uint4 x = t[i];
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&x);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(h[j]);
      h[j] = __floats2bfloat162_rn(f.x * mul, f.y * mul);
    }
    t[i] = x;
  }
  repro_hopper::fence_proxy_async();
  asm volatile("bar.sync 1, 128;\n" ::: "memory");
}

// Shared memory of both bf16 passes: two 64-row tiles loaded once (dK/dV:
// K, V; dQ: Q, dO), kTcStages stages of two streamed tiles (dK/dV: Q, dO;
// dQ: K, V), per stage the streamed rows' lse (times log2 e) and delta
// (dK/dV only), then the barriers.
template <int DH>
struct BwdTcLayout {
  static constexpr int TILE = TcLayout<DH>::KV_BYTES;
  static constexpr int STREAM = 2 * TILE;
  static constexpr int ROWS = STREAM + kTcStages * 2 * TILE;
  static constexpr int BARS = ROWS + kTcStages * 2 * kTcRows * 4;
  static constexpr int SMEM = BARS + 64 + 1024;
};

template <int DH>
__global__ void __launch_bounds__(kTcThreads)
flash_bwd_dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                            const __grid_constant__ CUtensorMap kmap,
                            const __grid_constant__ CUtensorMap vmap,
                            const __grid_constant__ CUtensorMap domap,
                            const float* __restrict__ lse,
                            const float* __restrict__ delta,
                            const int* __restrict__ lengths,
                            __nv_bfloat16* __restrict__ dk,
                            __nv_bfloat16* __restrict__ dv, int B, int S,
                            int H, int KV, int window, float scale) {
  using namespace repro_hopper;
  using L = BwdTcLayout<DH>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  float* rows = reinterpret_cast<float*>(smem + L::ROWS);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::BARS);
  uint64_t* kvbar = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = full + kTcStages;

  const int kt = blockIdx.x / (KV * B);
  const int kvh = blockIdx.x % KV, b = (blockIdx.x / KV) % B;
  const int G = H / KV;
  const int j0 = kt * kTcKeys;
  const int length = lengths[b];
  // the last key of the tile any row can see, and the query tiles (from
  // the diagonal's) whose rows can see it
  const int kv_last = min(j0 + kTcKeys, min(S, length)) - 1;
  const int q_end = kv_last < j0
                        ? j0
                        : int(min(int64_t(S), int64_t(kv_last) + window));
  const int nq = (q_end - j0 + kTcRows - 1) / kTcRows;
  const int n_tiles = G * nq;
  const int tid = threadIdx.x;

  if (tid == 0) {
    mbar_init(kvbar, 1);
    for (int s = 0; s < kTcStages; ++s) {
      mbar_init(&full[s], 32);                    // the producer warp
      mbar_init(&empty[s], 128);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (tid >= 128) {                               // ---- producer warp
    const int lane = tid - 128;
    if (n_tiles == 0) return;
    if (lane == 0) {
      mbar_expect_tx(kvbar, 2 * L::TILE);
      tc_load_tile<DH>(smem, &kmap, kvbar, kvh, j0, b);
      tc_load_tile<DH>(smem + L::TILE, &vmap, kvbar, kvh, j0, b);
    }
    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % kTcStages;
      const int h = kvh * G + t / nq, q_lo = j0 + (t % nq) * kTcRows;
      if (t >= kTcStages) mbar_wait(&empty[s], ((t / kTcStages) + 1) & 1);
      float* r = rows + s * 2 * kTcRows;
      for (int i = lane; i < kTcRows; i += 32) {
        const int qp = q_lo + i;
        const int64_t at = (int64_t(b) * H + h) * S + qp;
        r[i] = qp < S ? lse[at] * kLog2e : 0.f;
        r[kTcRows + i] = qp < S ? delta[at] : 0.f;
      }
      if (lane == 0) {
        uint8_t* st = smem + L::STREAM + s * 2 * L::TILE;
        mbar_expect_tx(&full[s], 2 * L::TILE);
        tc_load_tile<DH>(st, &qmap, &full[s], h, q_lo, b);
        tc_load_tile<DH>(st + L::TILE, &domap, &full[s], h, q_lo, b);
      } else {
        mbar_arrive(&full[s]);
      }
    }
    return;
  }

  // ---- consumer: warpgroup 0; a thread's accumulator rows are keys kv0
  // and kv1, its columns query rows (attention_wgmma.cuh's fragment map)
  const int wq = tid / 32, l = tid % 32;
  const int kv0 = j0 + wq * 16 + (l >> 2), kv1 = kv0 + 8;
  const float s_mul = kScaleQ<DH> ? 1.f : scale;  // what S and dK still need
  const float s_log2 = s_mul * kLog2e;
  float dk_acc[DH / 2], dv_acc[DH / 2];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) { dk_acc[i] = 0.f; dv_acc[i] = 0.f; }
  if (n_tiles > 0) mbar_wait(kvbar, 0);
  const uint8_t* ks = smem;
  const uint8_t* vs = smem + L::TILE;

  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % kTcStages;
    const int q_lo = j0 + (t % nq) * kTcRows;
    mbar_wait(&full[s], (t / kTcStages) & 1);
    uint8_t* qs = smem + L::STREAM + s * 2 * L::TILE;
    const uint8_t* dos = qs + L::TILE;
    const float* r = rows + s * 2 * kTcRows;
    if constexpr (kScaleQ<DH>) scale_tile<DH>(qs, scale, tid);
    float st[32], dpt[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) { st[i] = 0.f; dpt[i] = 0.f; }
    fence_regs(st);
    fence_regs(dpt);
    wgmma_fence();
    tc_abt<DH>(st, ks, qs);                       // S^T = K Q^T
    tc_abt<DH>(dpt, vs, dos);                     // dP^T = V dO^T
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(st);
    fence_regs(dpt);

    // every pair visible: the tile lies below the diagonal, inside S, the
    // length and the window
    const bool interior = q_lo >= j0 + kTcKeys && q_lo + kTcRows <= S &&
                          j0 + kTcKeys <= length &&
                          q_lo + kTcRows - 1 - j0 < window;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int c = (i >> 2) * 8 + (l & 3) * 2 + (i & 1);
      const int kv = (i & 2) ? kv1 : kv0, qp = q_lo + c;
      const bool keep = interior || (qp < S && kv <= qp && kv < length &&
                                     qp - kv < window);
      const float p = keep ? exp2f(st[i] * s_log2 - r[c]) : 0.f;
      st[i] = p;
      dpt[i] = p * (dpt[i] - r[kTcRows + c]);
    }
    uint32_t pa[4][4], dsa[4][4];
    tc_pack(st, pa);
    tc_pack(dpt, dsa);
    fence_regs(dv_acc);
    fence_regs(dk_acc);
    wgmma_fence();
    tc_ab<DH>(dv_acc, pa, dos);                   // dV += P^T dO
    tc_ab<DH>(dk_acc, dsa, qs);                   // dK += dS^T Q
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dv_acc);
    fence_regs(dk_acc);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      fence_regs(pa[kk]);
      fence_regs(dsa[kk]);
    }
    mbar_arrive(&empty[s]);
  }

#pragma unroll
  for (int i = 0; i < DH / 2; i += 2) {
    const int kv = (i & 2) ? kv1 : kv0;
    if (kv >= S) continue;
    const int64_t at = ((int64_t(b) * S + kv) * KV + kvh) * DH +
                       (i >> 2) * 8 + (l & 3) * 2;
    *reinterpret_cast<__nv_bfloat162*>(dk + at) =
        __floats2bfloat162_rn(dk_acc[i] * s_mul, dk_acc[i + 1] * s_mul);
    *reinterpret_cast<__nv_bfloat162*>(dv + at) =
        __floats2bfloat162_rn(dv_acc[i], dv_acc[i + 1]);
  }
}

template <int DH>
__global__ void __launch_bounds__(kTcThreads)
flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                          const __grid_constant__ CUtensorMap kmap,
                          const __grid_constant__ CUtensorMap vmap,
                          const __grid_constant__ CUtensorMap domap,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          const int* __restrict__ lengths,
                          __nv_bfloat16* __restrict__ dq, int B, int S,
                          int H, int KV, int window, float scale) {
  using namespace repro_hopper;
  using L = BwdTcLayout<DH>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::BARS);
  uint64_t* qbar = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = full + kTcStages;

  const int n_qt = (S + kTcRows - 1) / kTcRows;
  const int qt = n_qt - 1 - int(blockIdx.x / (H * B));
  const int h = blockIdx.x % H, b = (blockIdx.x / H) % B;
  const int kvh = h / (H / KV);
  const int q_lo = qt * kTcRows;
  const int q_hi = min(q_lo + kTcRows, S) - 1;
  const int length = lengths[b];
  const int kv_end = max(min(q_hi + 1, length), 0);
  const int kv_begin = (max(0, q_lo - window + 1) / kTcKeys) * kTcKeys;
  const int n_tiles =
      kv_end > kv_begin ? (kv_end - kv_begin + kTcKeys - 1) / kTcKeys : 0;
  const int tid = threadIdx.x;

  if (tid == 0) {
    mbar_init(qbar, 1);
    for (int s = 0; s < kTcStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 128);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (tid >= 128) {                               // ---- producer
    if (tid != 128 || n_tiles == 0) return;
    mbar_expect_tx(qbar, 2 * L::TILE);
    tc_load_tile<DH>(smem, &qmap, qbar, h, q_lo, b);
    tc_load_tile<DH>(smem + L::TILE, &domap, qbar, h, q_lo, b);
    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % kTcStages;
      if (t >= kTcStages) mbar_wait(&empty[s], ((t / kTcStages) + 1) & 1);
      uint8_t* st = smem + L::STREAM + s * 2 * L::TILE;
      const int j0 = kv_begin + t * kTcKeys;
      mbar_expect_tx(&full[s], 2 * L::TILE);
      tc_load_tile<DH>(st, &kmap, &full[s], kvh, j0, b);
      tc_load_tile<DH>(st + L::TILE, &vmap, &full[s], kvh, j0, b);
    }
    return;
  }

  // ---- consumer: warpgroup 0, query rows qp0 and qp1 a thread
  const int wq = tid / 32, l = tid % 32;
  const int qp0 = q_lo + wq * 16 + (l >> 2), qp1 = qp0 + 8;
  const int64_t row = (int64_t(b) * H + h) * S;
  const float lse0 = lse[row + min(qp0, S - 1)] * kLog2e;
  const float lse1 = lse[row + min(qp1, S - 1)] * kLog2e;
  const float d0 = delta[row + min(qp0, S - 1)];
  const float d1 = delta[row + min(qp1, S - 1)];
  const float s_log2 = (kScaleQ<DH> ? 1.f : scale) * kLog2e;
  float dq_acc[DH / 2];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) dq_acc[i] = 0.f;
  if (n_tiles > 0) {
    mbar_wait(qbar, 0);
    if constexpr (kScaleQ<DH>) scale_tile<DH>(smem, scale, tid);
  }
  const uint8_t* qs = smem;
  const uint8_t* dos = smem + L::TILE;

  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % kTcStages;
    const int j0 = kv_begin + t * kTcKeys;
    mbar_wait(&full[s], (t / kTcStages) & 1);
    const uint8_t* ks = smem + L::STREAM + s * 2 * L::TILE;
    const uint8_t* vs = ks + L::TILE;
    float sc[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) { sc[i] = 0.f; dp[i] = 0.f; }
    fence_regs(sc);
    fence_regs(dp);
    wgmma_fence();
    tc_abt<DH>(sc, qs, ks);                       // S = Q K^T
    tc_abt<DH>(dp, dos, vs);                      // dP = dO V^T
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);
    fence_regs(dp);

    const bool interior = j0 + kTcKeys - 1 <= q_lo &&
                          j0 + kTcKeys <= length && q_hi - j0 < window;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int kv = j0 + (i >> 2) * 8 + (l & 3) * 2 + (i & 1);
      const bool second = (i & 2) != 0;
      const int qp = second ? qp1 : qp0;
      const bool keep =
          interior || (kv <= qp && kv < length && qp - kv < window);
      const float p =
          keep ? exp2f(sc[i] * s_log2 - (second ? lse1 : lse0)) : 0.f;
      dp[i] = p * (dp[i] - (second ? d1 : d0));
    }
    uint32_t dsa[4][4];
    tc_pack(dp, dsa);
    fence_regs(dq_acc);
    wgmma_fence();
    tc_ab<DH>(dq_acc, dsa, ks);                   // dQ += dS K
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dq_acc);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) fence_regs(dsa[kk]);
    mbar_arrive(&empty[s]);
  }

#pragma unroll
  for (int i = 0; i < DH / 2; i += 2) {
    const int qp = (i & 2) ? qp1 : qp0;
    if (qp >= S) continue;
    *reinterpret_cast<__nv_bfloat162*>(
        dq + ((int64_t(b) * S + qp) * H + h) * DH + (i >> 2) * 8 +
        (l & 3) * 2) =
        __floats2bfloat162_rn(dq_acc[i] * scale, dq_acc[i + 1] * scale);
  }
}

// ------------------------------------------------------------ launches

template <int DH, typename T>
static int launch_delta(const void* out, const void* dout, float* delta,
                        int B, int S, int H, cudaStream_t st) {
  const int64_t rows = int64_t(B) * S * H;
  flash_bwd_delta_kernel<DH, T><<<unsigned((rows + 7) / 8), 256, 0, st>>>(
      static_cast<const T*>(out), static_cast<const T*>(dout), delta, rows,
      S, H);
  return static_cast<int>(cudaGetLastError());
}

template <int DH>
static int launch_bwd(const void* q, const void* k, const void* v,
                      const float* lse, const void* dout,
                      const int* lengths, void* dq, void* dk, void* dv,
                      const float* delta, int B, int S, int H, int KV,
                      int window, float scale, cudaStream_t st) {
  using T = float;
  using L = BwdSmem<DH>;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dout);
  int err = repro_hopper::allow_smem<flash_bwd_dkdv_kernel<DH, T>>(L::BYTES);
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

template <int DH>
static int launch_bwd_tc(const void* q, const void* k, const void* v,
                         const float* lse, const void* dout,
                         const int* lengths, void* dq, void* dk, void* dv,
                         const float* delta, int B, int S, int H, int KV,
                         int window, float scale, cudaStream_t st) {
  using L = BwdTcLayout<DH>;
  CUtensorMap qm, km, vm, dom;
  int err = tc_head_map<DH>(&qm, q, B, S, H);
  if (!err) err = tc_head_map<DH>(&km, k, B, S, KV);
  if (!err) err = tc_head_map<DH>(&vm, v, B, S, KV);
  if (!err) err = tc_head_map<DH>(&dom, dout, B, S, H);
  if (!err)
    err = repro_hopper::allow_smem<flash_bwd_dkdv_wgmma_kernel<DH>>(L::SMEM);
  if (!err)
    err = repro_hopper::allow_smem<flash_bwd_dq_wgmma_kernel<DH>>(L::SMEM);
  if (err) return err;
  const int64_t tiles = (S + kTcRows - 1) / kTcRows;
  if (tiles * H * B > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  flash_bwd_dkdv_wgmma_kernel<DH>
      <<<unsigned(tiles * KV * B), kTcThreads, L::SMEM, st>>>(
          qm, km, vm, dom, lse, delta, lengths,
          static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv),
          B, S, H, KV, window, scale);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  flash_bwd_dq_wgmma_kernel<DH>
      <<<unsigned(tiles * H * B), kTcThreads, L::SMEM, st>>>(
          qm, km, vm, dom, lse, delta, lengths,
          static_cast<__nv_bfloat16*>(dq), B, S, H, KV, window, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace repro_attn

// dtype: 0 = float32 (FMA kernels), 1 = bfloat16 (tensor-core kernels).
// ``delta`` is a (B, H, S) f32 scratch the caller allocates.  Returns a
// cudaError_t: the first launch's error, or cudaErrorInvalidValue for a
// head dim, dtype or shape it lacks.
extern "C" int flash_attention_bwd(const void* q, const void* k,
                                   const void* v, const void* out,
                                   const float* lse, const void* dout,
                                   const int* lengths, void* dq, void* dk,
                                   void* dv, float* delta, int B, int S,
                                   int H, int KV, int dh, int window,
                                   float scale, int dtype, void* stream) {
  using namespace repro_attn;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (H > 65535 || B > 65535 || KV < 1 || H % KV || dtype < 0 || dtype > 1)
    return static_cast<int>(cudaErrorInvalidValue);
#define REPRO_FLASH_BWD(D)                                                  \
  case D: {                                                                 \
    const int err = dtype == 0                                              \
        ? launch_delta<D, float>(out, dout, delta, B, S, H, st)             \
        : launch_delta<D, __nv_bfloat16>(out, dout, delta, B, S, H, st);    \
    if (err) return err;                                                    \
    return dtype == 0                                                       \
        ? launch_bwd<D>(q, k, v, lse, dout, lengths, dq, dk, dv, delta, B,  \
                        S, H, KV, window, scale, st)                        \
        : launch_bwd_tc<D>(q, k, v, lse, dout, lengths, dq, dk, dv, delta,  \
                           B, S, H, KV, window, scale, st);                 \
  }
  switch (dh) {
    REPRO_FLASH_BWD(16) REPRO_FLASH_BWD(32) REPRO_FLASH_BWD(64)
    REPRO_FLASH_BWD(128)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef REPRO_FLASH_BWD
}
