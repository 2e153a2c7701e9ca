// Causal GQA prefill attention (flash) for Hopper, f32 or bf16 in, f32
// online softmax.
//
// Replaces: src/repro/kernels/flash_attention.py, flash_attention_pallas /
// _flash_kernel (the Pallas TPU kernel).  Same function: q (B,S,H,dh)
// against k/v (B,S,KV,dh) of kv-head h // G, masks kv < lengths[b],
// kv <= q and q - kv < window; rows past a length are unspecified but
// finite.
//
// What bounds it on an H100: at serving prefill lengths the work is
// 4 * S^2 / 2 * H * dh FLOPs against (2*S*H + 2*S*KV) * dh elements of
// traffic, far above the card's ~295 FLOP/byte ridge, so it is bound by
// operations.  This first version does them with plain f32 FMAs (about
// 67 TFLOP/s at most, a fifteenth of the bf16 tensor-core rate) and feeds
// each FMA from shared memory, which caps it lower still.
//
// What the design does about it: one block per (query block of 16 rows,
// head, sequence), so a prefill launches S/16 * H blocks and fills the 132
// SMs; the KV loop stops at the diagonal and at the sequence length and
// starts at the window's edge, so masked tiles cost nothing; K/V tiles are
// read with 16-byte loads and widened to f32 once in shared memory.
// Tensor cores (wgmma with TMA-fed tiles) are the next step.
#include "attention_tile.cuh"

namespace repro_attn {

template <int DH, typename T>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const int* __restrict__ lengths,
                 T* __restrict__ out, int S, int H, int KV, int window,
                 float scale) {
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
  if (q_pos < S)
    write_row<DH, T>(st, out + ((int64_t(b) * S + q_pos) * H + h) * DH, lane);
}

template <int DH, typename T>
static void launch(const void* q, const void* k, const void* v,
                   const int* lengths, void* out, int B, int S, int H, int KV,
                   int window, float scale, cudaStream_t stream) {
  dim3 grid((S + kRows - 1) / kRows, H, B);
  flash_fwd_kernel<DH, T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), lengths, static_cast<T*>(out), S, H, KV,
      window, scale);
}

}  // namespace repro_attn

// dtype: 0 = float32, 1 = bfloat16.  Returns a cudaError_t: the launch's
// own error, or cudaErrorInvalidValue for a head dim or dtype it lacks.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, const int* lengths,
                                   void* out, int B, int S, int H, int KV,
                                   int dh, int window, float scale,
                                   int dtype, void* stream) {
  using namespace repro_attn;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define REPRO_FLASH(D, T)                                                   \
  launch<D, T>(q, k, v, lengths, out, B, S, H, KV, window, scale, st)
#define REPRO_FLASH_DH(T)                                                   \
  switch (dh) {                                                             \
    case 16: REPRO_FLASH(16, T); break;                                     \
    case 32: REPRO_FLASH(32, T); break;                                     \
    case 64: REPRO_FLASH(64, T); break;                                     \
    case 128: REPRO_FLASH(128, T); break;                                   \
    default: return static_cast<int>(cudaErrorInvalidValue);               \
  }
  if (dtype == 0) {
    REPRO_FLASH_DH(float)
  } else if (dtype == 1) {
    REPRO_FLASH_DH(__nv_bfloat16)
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
#undef REPRO_FLASH_DH
#undef REPRO_FLASH
  return static_cast<int>(cudaGetLastError());
}
