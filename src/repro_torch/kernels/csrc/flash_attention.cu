// Causal GQA prefill attention (flash) for Hopper, f32 online softmax.
// Two hand-written kernels, chosen by dtype:
//   bf16: flash_fwd_wgmma_kernel, tensor cores fed by a TMA ring (below);
//   f32:  flash_fwd_kernel, f32 FMAs (attention_tile.cuh).  Hopper's tensor
//         cores have no full-f32 product and TF32 keeps only 10 mantissa
//         bits, which would break the f32 path's 1e-4 agreement with its
//         plain version and the token-exact f32 card-vs-CPU serve.
// Neither is a fallback for the other: a dtype reaches one kernel only.
//
// Replaces: src/repro/kernels/flash_attention.py, flash_attention_pallas /
// _flash_kernel (the Pallas TPU kernel).  Same function: q (B,S,H,dh)
// against k/v (B,S,KV,dh) of kv-head h // G, masks kv < lengths[b],
// kv <= q and q - kv < window, a -1e30 sentinel for masked scores and a
// division by max(l, 1e-20); rows past a length are unspecified but finite.
// With a non-null ``lse`` each kernel also writes the row's log-sum-exp,
// (B, H, S) f32 in natural-log units of the scaled scores, m + log(max(l,
// 1e-20)) as src/repro/models/flash.py's _fwd_scan gives it: what the
// backward (flash_attention_bwd.cu) recomputes P from.  The serve passes
// null and its launches do exactly what they did before.
//
// What bounds it on an H100: at serving prefill lengths the work is
// 4 * S^2 / 2 * H * dh FLOPs against (2*S*H + 2*S*KV) * dh elements of
// traffic, above the card's ~295 FLOP/byte ridge at long S; at the serve's
// S <= 256 both bounds are a few microseconds, and what a kernel loses is
// latency: the serial chain of load, QK^T, softmax and PV per key tile.
//
// The bf16 design (flash_fwd_wgmma_kernel), in the FlashAttention-3 shape:
// one block per (64 query rows, head, sequence).  Warp 4 is the producer:
// one thread loads the Q tile once and then K and V tiles of 64 keys by TMA
// into a ring of 2 stages (swizzle = the bytes of min(dh, 64) elements),
// each stage with a full and an empty mbarrier, so the next tile is in
// flight while the current one is used.  Warpgroup 0 computes
// S = Q K^T with wgmma from shared memory (both K-major), runs the online
// softmax on the accumulator fragments in registers (exp2 with the scale
// folded in; row max and sum across the four lanes of a row by shuffles),
// converts P to bf16 in registers as the A operand of O += P V, with V
// read MN-major through the transpose bit (that step is shared with the
// paged extend kernel: attention_wgmma.cuh).  The key loop starts at the
// window's edge and stops at the diagonal and at lengths[b]; masks are
// applied only on tiles that cross one of these edges.
//
// The f32 design (flash_fwd_kernel): one block per (16 query rows, head,
// sequence), 8 lanes per row, K/V tiles of 32 keys widened to f32 in shared
// memory, scores and the PV sum as f32 FMAs, the same key-loop bounds.
#include "attention_tile.cuh"
#include "attention_wgmma.cuh"
#include "hopper.cuh"

namespace repro_attn {

template <int DH, typename T>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const int* __restrict__ lengths,
                 T* __restrict__ out, float* __restrict__ lse, int S, int H,
                 int KV, int window, float scale) {
  __shared__ float ks[kTile * DH];
  __shared__ float vs[kTile * DH];
  const int qb = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int row = threadIdx.x / kLanes, lane = threadIdx.x % kLanes;
  const int q_lo = qb * kRows;
  const int q_hi = min(q_lo + kRows, S) - 1;
  const int q_pos = q_lo + row;
  const int qr = min(q_pos, S - 1);   // idle rows compute on a valid row
  const int length = lengths[b];

  RowState<DH> st;
  init_row<DH, T>(st, q + ((int64_t(b) * S + qr) * H + h) * DH, scale, lane);

  const int kv_end = max(min(q_hi + 1, length), 0);
  const int kv_begin = (max(0, q_lo - window + 1) / kTile) * kTile;
  auto row_off = [&](int j) -> int64_t {
    return ((int64_t(b) * S + j) * KV + kvh) * DH;
  };
  for (int j0 = kv_begin; j0 < kv_end; j0 += kTile) {
    stage_tile<DH, T>(k, v, row_off, j0, kv_end, ks, vs);
    __syncthreads();
    attend_tile<DH>(st, ks, vs, j0, kv_end, q_pos, length, window, lane);
    __syncthreads();
  }
  if (q_pos < S) {
    write_row<DH, T>(st, out + ((int64_t(b) * S + q_pos) * H + h) * DH, lane);
    if (lse && lane == 0)
      lse[(int64_t(b) * H + h) * S + q_pos] =
          st.m + logf(fmaxf(st.l, 1e-20f));
  }
}

template <int DH, typename T>
static void launch(const void* q, const void* k, const void* v,
                   const int* lengths, void* out, float* lse, int B, int S,
                   int H, int KV, int window, float scale,
                   cudaStream_t stream) {
  dim3 grid((S + kRows - 1) / kRows, H, B);
  flash_fwd_kernel<DH, T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), lengths, static_cast<T*>(out), lse, S, H,
      KV, window, scale);
}


// ---------------------------------------------- bf16: tensor cores, TMA

template <int DH>
__global__ void __launch_bounds__(kTcThreads)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                       const __grid_constant__ CUtensorMap kmap,
                       const __grid_constant__ CUtensorMap vmap,
                       const int* __restrict__ lengths,
                       __nv_bfloat16* __restrict__ out,
                       float* __restrict__ lse, int S, int H, int KV,
                       int window, float scale_log2) {
  using namespace repro_hopper;
  using L = TcLayout<DH>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint8_t* qs = smem;
  uint64_t* bars = reinterpret_cast<uint64_t*>(
      smem + L::Q_BYTES + kTcStages * L::STAGE);
  uint64_t* qbar = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = full + kTcStages;

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
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
    if (tid != 128) return;
    mbar_expect_tx(qbar, L::Q_BYTES);
    tc_load_tile<DH>(qs, &qmap, qbar, h, q_lo, b);
    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % kTcStages;
      if (t >= kTcStages) mbar_wait(&empty[s], ((t / kTcStages) + 1) & 1);
      uint8_t* ks = smem + L::Q_BYTES + s * L::STAGE;
      const int j0 = kv_begin + t * kTcKeys;
      mbar_expect_tx(&full[s], L::STAGE);
      tc_load_tile<DH>(ks, &kmap, &full[s], kvh, j0, b);
      tc_load_tile<DH>(ks + L::KV_BYTES, &vmap, &full[s], kvh, j0, b);
    }
    return;
  }

  // ---- consumer: warpgroup 0, two rows a thread (attention_wgmma.cuh)
  const int wq = tid / 32, l = tid % 32;
  const int qp0 = q_lo + wq * 16 + (l >> 2), qp1 = qp0 + 8;
  TcRows<DH> rows;
  mbar_wait(qbar, 0);

  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % kTcStages;
    mbar_wait(&full[s], (t / kTcStages) & 1);
    const uint8_t* ks = smem + L::Q_BYTES + s * L::STAGE;
    const int j0 = kv_begin + t * kTcKeys;
    // masks only where the tile crosses the diagonal, the length or the
    // window's edge
    const bool interior = j0 + kTcKeys - 1 <= q_lo &&
                          j0 + kTcKeys <= length && q_hi - j0 < window;
    tc_attend_tile<DH>(rows, qs, ks, ks + L::KV_BYTES, j0, interior,
                       scale_log2, l, [&](int kv, bool second) {
                         const int qp = second ? qp1 : qp0;
                         return kv <= qp && kv < length && qp - kv < window;
                       });
    mbar_arrive(&empty[s]);
  }

  float inv0, inv1;
  tc_row_scales(rows, inv0, inv1);
  if (lse && (l & 3) == 0) {
    // m and l are in log2 units (the scale folded into log2(e)): the
    // natural-log lse is (m2 + log2(max(l, 1e-20))) * ln 2
    const float ln2 = 0.6931471805599453f;
    if (qp0 < S)
      lse[(int64_t(b) * H + h) * S + qp0] =
          (rows.m0 + log2f(fmaxf(rows.l0, 1e-20f))) * ln2;
    if (qp1 < S)
      lse[(int64_t(b) * H + h) * S + qp1] =
          (rows.m1 + log2f(fmaxf(rows.l1, 1e-20f))) * ln2;
  }
#pragma unroll
  for (int i = 0; i < DH / 2; i += 2) {
    const int qp = (i & 2) ? qp1 : qp0;
    if (qp >= S) continue;
    const float inv = (i & 2) ? inv1 : inv0;
    const int col = (i >> 2) * 8 + (l & 3) * 2;
    *reinterpret_cast<__nv_bfloat162*>(
        out + ((int64_t(b) * S + qp) * H + h) * DH + col) =
        __floats2bfloat162_rn(rows.o[i] * inv, rows.o[i + 1] * inv);
  }
}

template <int DH>
static int launch_tc(const void* q, const void* k, const void* v,
                     const int* lengths, void* out, float* lse, int B, int S,
                     int H, int KV, int window, float scale,
                     cudaStream_t stream) {
  using L = TcLayout<DH>;
  CUtensorMap maps[3];
  const void* bases[3] = {q, k, v};
  const int heads[3] = {H, KV, KV};
  for (int m = 0; m < 3; ++m) {
    const int err = tc_head_map<DH>(&maps[m], bases[m], B, S, heads[m]);
    if (err) return err;
  }
  int err = repro_hopper::allow_smem<flash_fwd_wgmma_kernel<DH>>(L::SMEM);
  if (err) return err;
  dim3 grid((S + kTcRows - 1) / kTcRows, H, B);
  flash_fwd_wgmma_kernel<DH><<<grid, kTcThreads, L::SMEM, stream>>>(
      maps[0], maps[1], maps[2], lengths,
      static_cast<__nv_bfloat16*>(out), lse, S, H, KV, window,
      scale * 1.4426950408889634f);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace repro_attn

// dtype: 0 = float32 (FMA kernel), 1 = bfloat16 (tensor-core kernel).
// ``lse``: null, or a (B, H, S) f32 output for the rows' log-sum-exp.
// Returns a cudaError_t: the launch's own, or cudaErrorInvalidValue for a
// head dim, dtype or shape it lacks.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, const int* lengths,
                                   void* out, float* lse, int B, int S,
                                   int H, int KV, int dh, int window,
                                   float scale, int dtype, void* stream) {
  using namespace repro_attn;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
#define REPRO_FLASH_F32(D)                                                  \
  case D:                                                                   \
    launch<D, float>(q, k, v, lengths, out, lse, B, S, H, KV, window,       \
                     scale, st);                                            \
    break;
    switch (dh) {
      REPRO_FLASH_F32(16) REPRO_FLASH_F32(32) REPRO_FLASH_F32(64)
      REPRO_FLASH_F32(128)
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
#undef REPRO_FLASH_F32
    return static_cast<int>(cudaGetLastError());
  }
  if (dtype != 1 || H > 65535 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
#define REPRO_FLASH_TC(D)                                                   \
  case D:                                                                   \
    return launch_tc<D>(q, k, v, lengths, out, lse, B, S, H, KV, window,  \
                        scale, st);
  switch (dh) {
    REPRO_FLASH_TC(16) REPRO_FLASH_TC(32) REPRO_FLASH_TC(64)
    REPRO_FLASH_TC(128)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef REPRO_FLASH_TC
}
