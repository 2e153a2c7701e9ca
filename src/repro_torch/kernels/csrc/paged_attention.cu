// Paged attention for Hopper (decode and chunked-prefill extend), f32 or
// bf16 in, f32 online softmax.
//
// Replaces: src/repro/kernels/paged_attention.py, paged_attention_pallas /
// _paged_kernel (the Pallas TPU kernel).  Same function: S*G query rows
// per (sequence, kv-head), row r at position start[b] + r / G, attending
// through block_table[b] over shared page pools (P,ps,KV,dh); pages walked
// = min(ceil(length / ps), maxp) (an unscheduled full slot arrives with
// length == capacity + 1 and must not walk past the table); mask
// kv <= q & kv < length & q - kv < window.
//
// What bounds it on an H100: decode reads every cached K/V byte once for
// G query rows, about 2 FLOPs per byte in bf16, so it is bound by bytes
// (3.35 TB/s).  An extend chunk of S=256 rows reuses each byte 4*S times
// and is bound by operations, done here with plain f32 FMAs.
//
// What the design does about it: one block per (block of 16 query rows,
// kv-head, sequence) rather than the TPU's (B, KV) grid alone, so an extend
// chunk of 256 tokens with G=4 spreads its 1024 rows over 64 blocks per
// kv-head.  Each block walks the block table itself (no gather copy),
// stages 32 key rows at a time in shared memory with 16-byte loads, and
// starts at the window's edge and stops at the causal and length limits.
// At decode batch 8 with 8 kv-heads this is only 64 blocks with 4 live rows
// each, which leaves most SMs idle; the fix is a split-KV pass (several
// blocks per sequence, each over a range of pages, and a second pass that
// merges their (m, l, acc)), planned for a later PR.
#include "attention_tile.cuh"

namespace repro_attn {

template <int DH, typename T>
__global__ void __launch_bounds__(kThreads)
paged_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                 const T* __restrict__ v_pages,
                 const int* __restrict__ block_table,
                 const int* __restrict__ start, const int* __restrict__ lengths,
                 T* __restrict__ out, int S, int H, int KV, int ps, int maxp,
                 int window, float scale) {
  __shared__ float ks[kTile * DH];
  __shared__ float vs[kTile * DH];
  const int rb = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int G = H / KV;
  const int R = S * G;
  const int row = threadIdx.x / kLanes, lane = threadIdx.x % kLanes;
  const int r_lo = rb * kRows;
  const int r_hi = min(r_lo + kRows, R) - 1;
  const int r = r_lo + row;
  const int rr = min(r, R - 1);       // idle rows compute on a valid row
  const int s_idx = rr / G;
  const int h = kvh * G + rr % G;
  const int st0 = start[b];
  const int length = lengths[b];
  const int q_pos = st0 + s_idx;
  const int* table = block_table + int64_t(b) * maxp;

  RowState<DH> st;
  init_row<DH, T>(st, q + ((int64_t(b) * S + s_idx) * H + h) * DH, scale,
                  lane);

  const int n_used = min((length + ps - 1) / ps, maxp);
  const int q_lo = st0 + r_lo / G;
  const int q_hi = st0 + r_hi / G;
  const int kv_end = max(min(min(n_used * ps, length), q_hi + 1), 0);
  const int kv_begin = (max(0, q_lo - window + 1) / kTile) * kTile;
  auto row_off = [&](int j) -> int64_t {
    return ((int64_t(table[j / ps]) * ps + j % ps) * KV + kvh) * DH;
  };
  for (int j0 = kv_begin; j0 < kv_end; j0 += kTile) {
    stage_tile<DH, T>(k_pages, v_pages, row_off, j0, kv_end, ks, vs);
    __syncthreads();
    attend_tile<DH>(st, ks, vs, j0, kv_end, q_pos, length, window, lane);
    __syncthreads();
  }
  if (r < R)
    write_row<DH, T>(st, out + ((int64_t(b) * S + s_idx) * H + h) * DH,
                     lane);
}

template <int DH, typename T>
static void launch(const void* q, const void* kp, const void* vp,
                   const int* table, const int* start, const int* lengths,
                   void* out, int B, int S, int H, int KV, int ps, int maxp,
                   int window, float scale, cudaStream_t stream) {
  const int R = S * (H / KV);
  dim3 grid((R + kRows - 1) / kRows, KV, B);
  paged_fwd_kernel<DH, T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), table, start, lengths,
      static_cast<T*>(out), S, H, KV, ps, maxp, window, scale);
}

}  // namespace repro_attn

// dtype: 0 = float32, 1 = bfloat16.  Returns a cudaError_t: the launch's
// own error, or cudaErrorInvalidValue for a head dim or dtype it lacks.
extern "C" int paged_attention_fwd(const void* q, const void* k_pages,
                                   const void* v_pages,
                                   const int* block_table, const int* start,
                                   const int* lengths, void* out, int B,
                                   int S, int H, int KV, int dh, int ps,
                                   int maxp, int window, float scale,
                                   int dtype, void* stream) {
  using namespace repro_attn;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define REPRO_PAGED(D, T)                                                   \
  launch<D, T>(q, k_pages, v_pages, block_table, start, lengths, out, B, S, \
               H, KV, ps, maxp, window, scale, st)
#define REPRO_PAGED_DH(T)                                                   \
  switch (dh) {                                                             \
    case 16: REPRO_PAGED(16, T); break;                                     \
    case 32: REPRO_PAGED(32, T); break;                                     \
    case 64: REPRO_PAGED(64, T); break;                                     \
    case 128: REPRO_PAGED(128, T); break;                                   \
    default: return static_cast<int>(cudaErrorInvalidValue);               \
  }
  if (dtype == 0) {
    REPRO_PAGED_DH(float)
  } else if (dtype == 1) {
    REPRO_PAGED_DH(__nv_bfloat16)
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
#undef REPRO_PAGED_DH
#undef REPRO_PAGED
  return static_cast<int>(cudaGetLastError());
}
