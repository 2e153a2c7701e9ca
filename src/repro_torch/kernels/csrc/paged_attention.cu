// Paged attention for Hopper (decode and chunked-prefill extend), f32 or
// bf16 in, f32 online softmax.  Three hand-written kernels, chosen by mode
// and dtype only; none is a fallback for another, and a call the chosen
// kernel cannot take returns an error:
//   decode, f32 and bf16: paged_decode_split_kernel (split-KV, below);
//   extend, bf16:         paged_extend_wgmma_kernel (tensor cores, TMA);
//   extend, f32:          paged_fwd_kernel (f32 FMAs, attention_tile.cuh).
//
// Replaces: src/repro/kernels/paged_attention.py, paged_attention_pallas /
// _paged_kernel (the Pallas TPU kernel).  Same function: S*G query rows
// per (sequence, kv-head), row r at position start[b] + r / G, attending
// through block_table[b] over shared page pools (P,ps,KV,dh); pages walked
// = min(ceil(length / ps), maxp) (an unscheduled full slot arrives with
// length == capacity + 1 and must not walk past the table); mask
// kv <= q & kv < length & q - kv < window; a masked score is the -1e30
// sentinel, the output divides by max(l, 1e-20), and a row with nothing to
// attend to comes out as 0.  Every sum runs in a fixed order (no atomics in
// any sum), so a second launch gives the same bits.
//
// Decode (paged_decode_split_kernel).  What bounds it: every cached K/V
// byte is read once for G query rows, about 2 FLOPs per byte, so bytes
// (3.35 TB/s).  At batch 8 with 8 kv-heads a block per (sequence, kv-head)
// is 64 blocks on 132 SMs, each walking up to 17 pages one after another.
// The design: grid (n_split, KV, B); split s takes the fixed page range
// [s * kPagesPerSplit, (s + 1) * kPagesPerSplit), planned on the host from
// maxp alone (the host never reads lengths), and a block whose range lies
// past the pages used or wholly before the window's edge exits at once.  A
// block serves all G query rows of its kv-head, so each K/V byte leaves
// HBM once.  It streams its range in tiles of 64 keys through a 2-stage
// cp.async ring (16-byte copies gathered row by row through the block
// table, XOR-swizzled 16-byte chunks so that neither the per-key nor the
// per-dim reads conflict), so the next tile's loads are in flight while
// the current one is scored.  Warps 0/2 take the tile's first 32 keys,
// warps 1/3 the last 32, and warps 0/1 the even query rows, 2/3 the odd:
// for scores a lane owns one key and reads the (pre-scaled, f32) query
// rows by broadcast; for P V a lane owns dh/32 output dims.  Each warp keeps
// f32 (m, l, acc) per row; the two key halves merge in shared memory.  A
// sequence whose keys fit in one split writes its output directly.
// Otherwise each split writes (m, l, acc) in f32 to a workspace, and the
// last block to finish for a (sequence, kv-head) merges all splits in
// split order in the same launch: it knows it is last from a ticket
// counter (a __threadfence before the ticket; the target is the number of
// splits that hold keys, computed on the device), and resets the counter
// to 0.  Blocks that exit at once take no ticket.  On request the block
// that writes a row's output also writes its log-sum-exp, (m + log2 l) ·
// ln 2 (m runs in scale · log2 e units), and -inf for a row with nothing
// to attend to: a sequence-sharded cache combines the ranks' partial
// outputs by it.
//
// Extend, bf16 (paged_extend_wgmma_kernel).  What bounds it: a 256-token
// chunk reuses each K/V byte 4*S times, so operations; it needs the tensor
// cores.  The design is the FlashAttention-3 shape of flash_fwd_wgmma_kernel
// with the GQA group packed: one block per (64 query rows, kv-head,
// sequence), the rows being floor(64/G) consecutive tokens times their G
// heads (rows past floor(64/G)*G are masked), so every K/V tile serves 64
// rows.  The producer warp loads Q once with one 4-D TMA box over q viewed
// as (B*S, KV, G, dh), then K and V tiles of 64 keys by 4-D TMA boxes over
// the pools viewed as (P, ps, KV, dh), following block_table[b, j]: one box
// of gcd(ps, 64) rows per page piece (64/ps per stage for ps <= 64, a
// 64-row slice of a page above), into a 2-stage full/empty mbarrier ring;
// no gathered copy of the pages is ever made.  Warpgroup 0 computes
// S = Q K^T with wgmma, the online softmax in registers (exp2, scale
// folded), and O += P V with P as the register A operand, in the step it
// shares with flash (attention_wgmma.cuh).  The key loop
// starts at the window's edge and stops at min(length, last row's q + 1);
// masks only on tiles that cross an edge.  It takes ps a multiple of 8 (a
// box then starts on a swizzle-atom row) and dh 16..128.
//
// Extend, f32 (paged_fwd_kernel): one block per (16 query rows, kv-head,
// sequence), 32-key tiles widened to f32 in shared memory, f32 FMAs.  The
// tensor cores have no full-f32 product and TF32 would break the f32
// path's 1e-4 agreement and the token-exact f32 card-vs-CPU serve.
#include <numeric>

#include "attention_tile.cuh"
#include "attention_wgmma.cuh"
#include "hopper.cuh"

// Pages per decode split: the fastest of 1, 2 and 4 at the llama3.1-8b
// serve's decode shape on an H100 (tools/paged_split_sweep.py builds the
// library with each value to measure them; nothing else sets it).
#ifndef REPRO_PAGED_PAGES_PER_SPLIT
#define REPRO_PAGED_PAGES_PER_SPLIT 2
#endif

namespace repro_attn {

// ------------------------------------------------------ f32 extend: FMAs

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
static int launch_fma(const void* q, const void* kp, const void* vp,
                      const int* table, const int* start, const int* lengths,
                      void* out, int B, int S, int H, int KV, int ps,
                      int maxp, int window, float scale,
                      cudaStream_t stream) {
  const int R = S * (H / KV);
  dim3 grid((R + kRows - 1) / kRows, KV, B);
  paged_fwd_kernel<DH, T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), table, start, lengths,
      static_cast<T*>(out), S, H, KV, ps, maxp, window, scale);
  return static_cast<int>(cudaGetLastError());
}

// --------------------------------------------------- decode: split-KV

constexpr int kPagesPerSplit = REPRO_PAGED_PAGES_PER_SPLIT;
constexpr int kDecWarps = 4;
constexpr int kDecThreads = 32 * kDecWarps;
constexpr int kDecKeys = 64;          // keys per ring stage, 32 per half
constexpr int kDecStages = 2;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__host__ __device__ constexpr int decode_splits(int maxp) {
  return (maxp + kPagesPerSplit - 1) / kPagesPerSplit;
}

template <int DH, typename T>
struct Dec {
  static constexpr int ROW = DH * int(sizeof(T));   // bytes of a key row
  static constexpr int NCH = ROW / 16;              // 16-byte chunks a row
  static constexpr int SWZ = (NCH < 8 ? NCH : 8) - 1;
  static constexpr int CE = 16 / int(sizeof(T));    // elements a chunk
  static constexpr int TILE = kDecKeys * ROW;       // a K or a V tile
  static constexpr int STAGE = 2 * TILE;
  static constexpr int DPL = DH >= 32 ? DH / 32 : 1;  // P V dims a lane
  static constexpr int DLANES = DH / DPL;           // lanes over the dims
  static constexpr int KP = 32 / DLANES;            // key phases (dh 16: 2)
};

// Byte offset of 16-byte chunk c of key row j in a K or V tile: the chunk
// index is XORed with the row's low bits, so 8 lanes reading one chunk of
// 8 rows, or 8 chunks of one row, hit 8 different bank groups.
template <int DH, typename T>
__device__ __forceinline__ int dec_chunk(int j, int c) {
  using L = Dec<DH, T>;
  return j * L::ROW + ((c ^ (j & L::SWZ)) << 4);
}

// N consecutive elements (at most 16 bytes, aligned) widened to f32.
template <int N>
__device__ __forceinline__ void load_n(const float* p, float* d) {
  if constexpr (N == 4) {
    load16(p, d);
  } else if constexpr (N == 2) {
    const float2 x = *reinterpret_cast<const float2*>(p);
    d[0] = x.x;
    d[1] = x.y;
  } else {
    static_assert(N == 1, "load_n");
    d[0] = *p;
  }
}
template <int N>
__device__ __forceinline__ void load_n(const __nv_bfloat16* p, float* d) {
  if constexpr (N == 8) {
    load16(p, d);
  } else if constexpr (N == 4) {
    const uint2 x = *reinterpret_cast<const uint2*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&x);
    const float2 a = __bfloat1622float2(h[0]), b = __bfloat1622float2(h[1]);
    d[0] = a.x; d[1] = a.y; d[2] = b.x; d[3] = b.y;
  } else if constexpr (N == 2) {
    const float2 a =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
    d[0] = a.x;
    d[1] = a.y;
  } else {
    static_assert(N == 1, "load_n");
    d[0] = __bfloat162float(*p);
  }
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// RW: query rows a warp carries (rows rs, rs + 2, ... of the G), 2 for
// G <= 4 and 8 for G <= 16.  Shared memory: the ring, the query rows in
// f32 (G x DH, pre-scaled by scale * log2 e), each warp's P (RW x 32) and a
// flag.  ws: B*KV*n_split*G*DH accumulators, then (m, l) pairs.
template <int DH, typename T, int RW>
__global__ void __launch_bounds__(kDecThreads)
paged_decode_split_kernel(const T* __restrict__ q,
                          const T* __restrict__ k_pages,
                          const T* __restrict__ v_pages,
                          const int* __restrict__ block_table,
                          const int* __restrict__ start,
                          const int* __restrict__ lengths,
                          T* __restrict__ out, float* __restrict__ ws,
                          int* __restrict__ tickets,
                          float* __restrict__ lse, int H, int KV, int ps,
                          int maxp, int window, float scale_log2) {
  using namespace repro_hopper;
  using L = Dec<DH, T>;
  extern __shared__ __align__(16) uint8_t smem[];
  const int G = H / KV;
  float* qs = reinterpret_cast<float*>(smem + kDecStages * L::STAGE);
  float* pbuf = qs + G * DH;
  int* flag = reinterpret_cast<int*>(pbuf + kDecWarps * RW * 32);

  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int n_split = gridDim.x;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int length = lengths[b];
  const int q_pos = start[b];
  const int n_used = min((length + ps - 1) / ps, maxp);
  const int kv_end = max(min(min(n_used * ps, length), q_pos + 1), 0);
  const int kv_w = max(0, q_pos - window + 1);      // the window's edge
  const int span = kPagesPerSplit * ps;
  const int s_first = kv_w / span;
  const int n_active = kv_end > kv_w ? (kv_end - 1) / span - s_first + 1 : 0;
  const int64_t bk = int64_t(b) * KV + kvh;
  T* orow = out + (int64_t(b) * H + kvh * G) * DH;
  float* lrow = lse == nullptr ? nullptr : lse + int64_t(b) * H + kvh * G;
  if (n_active == 0) {                // nothing to attend to: zeros, -inf
    if (split == 0) {
      for (int i = tid; i < G * DH; i += kDecThreads) store(0.f, orow + i);
      if (lrow != nullptr)
        for (int g = tid; g < G; g += kDecThreads) lrow[g] = -INFINITY;
    }
    return;
  }
  if (split < s_first || split >= s_first + n_active) return;
  const int base = split * span;
  const int lo = max(base, kv_w), hi = min(base + span, kv_end);
  const int t0 = base + ((lo - base) / kDecKeys) * kDecKeys;
  const int n_tiles = (hi - t0 + kDecKeys - 1) / kDecKeys;
  const int* table = block_table + int64_t(b) * maxp;

  // keys [t0 + 64t, +64) of K and V into ring slot t % stages; rows at or
  // past hi are zero-filled (their P is 0, so they add exactly nothing)
  auto issue = [&](int t) {
    uint8_t* ks = smem + (t % kDecStages) * L::STAGE;
    uint8_t* vs = ks + L::TILE;
    const int j0 = t0 + t * kDecKeys;
    for (int ci = tid; ci < kDecKeys * L::NCH; ci += kDecThreads) {
      const int j = ci / L::NCH, c = ci % L::NCH;
      const int kv = j0 + j;
      const bool in = kv < hi;
      int64_t off = 0;
      if (in)
        off = ((int64_t(table[kv / ps]) * ps + kv % ps) * KV + kvh) * L::ROW +
              c * 16;
      const int d = dec_chunk<DH, T>(j, c);
      cp_async16(ks + d, reinterpret_cast<const uint8_t*>(k_pages) + off,
                 in ? 16 : 0);
      cp_async16(vs + d, reinterpret_cast<const uint8_t*>(v_pages) + off,
                 in ? 16 : 0);
    }
  };
#pragma unroll
  for (int t = 0; t < kDecStages - 1; ++t) {
    if (t < n_tiles) issue(t);
    cp_async_commit();
  }
  const T* qg = q + (int64_t(b) * H + kvh * G) * DH;
  for (int i = tid; i < G * DH; i += kDecThreads)
    qs[i] = to_float(qg[i]) * scale_log2;

  const int kh = warp & 1, rs = warp >> 1;          // key half, row set
  const int dl = lane % L::DLANES, kp = lane / L::DLANES;
  const int d0 = dl * L::DPL;                       // this lane's P V dims
  const int vc = d0 * int(sizeof(T)) / 16, vo = d0 * int(sizeof(T)) % 16;
  float* pw = pbuf + warp * RW * 32;
  float m[RW], l[RW], acc[RW][L::DPL];
#pragma unroll
  for (int i = 0; i < RW; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < L::DPL; ++e) acc[i][e] = 0.f;
  }

  for (int t = 0; t < n_tiles; ++t) {
    if (t + kDecStages - 1 < n_tiles) issue(t + kDecStages - 1);
    cp_async_commit();
    cp_async_wait<kDecStages - 1>();
    __syncthreads();
    const uint8_t* ks = smem + (t % kDecStages) * L::STAGE;
    const uint8_t* vs = ks + L::TILE;
    const int j = kh * 32 + lane;                   // this lane's key
    const int kv = t0 + t * kDecKeys + j;
    float s[RW];
#pragma unroll
    for (int i = 0; i < RW; ++i) s[i] = 0.f;
#pragma unroll
    for (int c = 0; c < L::NCH; ++c) {
      float kf[L::CE];
      load16(reinterpret_cast<const T*>(ks + dec_chunk<DH, T>(j, c)), kf);
#pragma unroll
      for (int i = 0; i < RW; ++i) {
        if (rs + 2 * i < G) {
          const float* qc = qs + (rs + 2 * i) * DH + c * L::CE;
#pragma unroll
          for (int e = 0; e < L::CE; ++e) s[i] = fmaf(qc[e], kf[e], s[i]);
        }
      }
    }
    const bool ok = kv >= lo && kv < hi;
#pragma unroll
    for (int i = 0; i < RW; ++i) {
      if (rs + 2 * i >= G) continue;
      const float sc = ok ? s[i] : kNegInf;
      const float mn = fmaxf(m[i], warp_max(sc));
      const float corr = exp2f(m[i] - mn);
      const float p = ok ? exp2f(sc - mn) : 0.f;
      l[i] = l[i] * corr + p;                       // per-lane partial
#pragma unroll
      for (int e = 0; e < L::DPL; ++e) acc[i][e] *= corr;
      m[i] = mn;
      pw[i * 32 + lane] = p;
    }
    __syncwarp();
#pragma unroll 8
    for (int jj = kp; jj < 32; jj += L::KP) {
      float vf[L::DPL];
      load_n<L::DPL>(reinterpret_cast<const T*>(
                         vs + dec_chunk<DH, T>(kh * 32 + jj, vc) + vo),
                     vf);
#pragma unroll
      for (int i = 0; i < RW; ++i) {
        if (rs + 2 * i < G) {
          const float p = pw[i * 32 + jj];
#pragma unroll
          for (int e = 0; e < L::DPL; ++e) acc[i][e] = fmaf(p, vf[e], acc[i][e]);
        }
      }
    }
    __syncthreads();              // the slot and P are rewritten next
  }

  // the warp's rows: l over its 32 keys, acc over the key phases (dh 16)
#pragma unroll
  for (int i = 0; i < RW; ++i) {
    if (rs + 2 * i >= G) continue;
    l[i] = warp_sum(l[i]);
    if constexpr (L::KP == 2) {
#pragma unroll
      for (int e = 0; e < L::DPL; ++e)
        acc[i][e] += __shfl_xor_sync(0xffffffffu, acc[i][e], 16);
    }
  }
  // the two key halves of a row meet in shared memory (the ring is free)
  float* xbuf = reinterpret_cast<float*>(smem);     // [rs][RW][2 + DH]
  if (kh == 1) {
#pragma unroll
    for (int i = 0; i < RW; ++i) {
      if (rs + 2 * i >= G) continue;
      float* x = xbuf + (rs * RW + i) * (2 + DH);
      if (kp == 0)
#pragma unroll
        for (int e = 0; e < L::DPL; ++e) x[2 + d0 + e] = acc[i][e];
      if (lane == 0) {
        x[0] = m[i];
        x[1] = l[i];
      }
    }
  }
  __syncthreads();
  if (kh == 0) {
#pragma unroll
    for (int i = 0; i < RW; ++i) {
      if (rs + 2 * i >= G) continue;
      const float* x = xbuf + (rs * RW + i) * (2 + DH);
      const float mn = fmaxf(m[i], x[0]);
      const float c0 = exp2f(m[i] - mn), c1 = exp2f(x[0] - mn);
      l[i] = l[i] * c0 + x[1] * c1;
#pragma unroll
      for (int e = 0; e < L::DPL; ++e)
        acc[i][e] = acc[i][e] * c0 + x[2 + d0 + e] * c1;
      m[i] = mn;
    }
  }

  if (n_active == 1) {                // one split holds every key
    if (kh == 0 && kp == 0) {
#pragma unroll
      for (int i = 0; i < RW; ++i) {
        if (rs + 2 * i >= G) continue;
        const float li = fmaxf(l[i], 1e-20f);
#pragma unroll
        for (int e = 0; e < L::DPL; ++e)
          store(acc[i][e] / li, orow + (rs + 2 * i) * DH + d0 + e);
        if (lrow != nullptr && lane == 0)
          lrow[rs + 2 * i] = (m[i] + log2f(li)) * kLn2;
      }
    }
    return;
  }

  // this split's (m, l, acc) to the workspace, then the ticket
  float* ws_acc = ws;
  float* ws_ml = ws + int64_t(gridDim.z) * KV * n_split * G * DH;
  const int64_t part = (bk * n_split + split) * G;
  if (kh == 0) {
#pragma unroll
    for (int i = 0; i < RW; ++i) {
      const int g = rs + 2 * i;
      if (g >= G) continue;
      if (kp == 0)
#pragma unroll
        for (int e = 0; e < L::DPL; ++e)
          ws_acc[(part + g) * DH + d0 + e] = acc[i][e];
      if (lane == 0) {
        ws_ml[(part + g) * 2] = m[i];
        ws_ml[(part + g) * 2 + 1] = l[i];
      }
    }
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) *flag = atomicAdd(&tickets[bk], 1) == n_active - 1;
  __syncthreads();
  if (!*flag) return;
  __threadfence();

  // the last block merges every split of (b, kv-head) in split order
  float* mrow = qs;                   // [G][2]: max, then max(sum, 1e-20)
  const int64_t first = bk * n_split + s_first;
  for (int g = tid; g < G; g += kDecThreads) {
    float mx = kNegInf;
    for (int s = 0; s < n_active; ++s)
      mx = fmaxf(mx, __ldcg(ws_ml + ((first + s) * G + g) * 2));
    float sum = 0.f;
    for (int s = 0; s < n_active; ++s) {
      const float* ml = ws_ml + ((first + s) * G + g) * 2;
      sum += __ldcg(ml + 1) * exp2f(__ldcg(ml) - mx);
    }
    mrow[2 * g] = mx;
    mrow[2 * g + 1] = fmaxf(sum, 1e-20f);
    if (lrow != nullptr) lrow[g] = (mx + log2f(mrow[2 * g + 1])) * kLn2;
  }
  __syncthreads();
  for (int i = tid; i < G * DH; i += kDecThreads) {
    const int g = i / DH, d = i % DH;
    const float mx = mrow[2 * g];
    float a = 0.f;
    for (int s = 0; s < n_active; ++s) {
      const int64_t r = (first + s) * G + g;
      a += __ldcg(ws_acc + r * DH + d) * exp2f(__ldcg(ws_ml + r * 2) - mx);
    }
    store(a / mrow[2 * g + 1], orow + i);
  }
  if (tid == 0) tickets[bk] = 0;      // every ticket of this launch is taken
}

template <int DH, typename T, int RW>
static int launch_decode(const void* q, const void* kp, const void* vp,
                         const int* table, const int* start,
                         const int* lengths, void* out, float* ws,
                         int* tickets, float* lse, int B, int H, int KV,
                         int ps, int maxp, int window, float scale,
                         cudaStream_t stream) {
  using L = Dec<DH, T>;
  const int G = H / KV;
  const int smem =
      kDecStages * L::STAGE + (G * DH + kDecWarps * RW * 32 + 4) * 4;
  const int err =
      repro_hopper::allow_smem<paged_decode_split_kernel<DH, T, RW>>(smem);
  if (err) return err;
  dim3 grid(decode_splits(maxp), KV, B);
  paged_decode_split_kernel<DH, T, RW><<<grid, kDecThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), table, start, lengths,
      static_cast<T*>(out), ws, tickets, lse, H, KV, ps, maxp, window,
      scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------- bf16 extend: tensor cores, TMA

// qmap: q (B,S,H,dh) as dims {dh, G, KV, B*S}, box {CHUNK, G, 1, tpb};
// kmap/vmap: pools (P,ps,KV,dh) as dims {dh, KV, ps, P}, box {CHUNK, 1,
// box_rows, 1}, box_rows = gcd(ps, 64).  Row r of the block is token
// qt * tpb + r / G, head kvh * G + r % G.
template <int DH>
__global__ void __launch_bounds__(kTcThreads)
paged_extend_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                          const __grid_constant__ CUtensorMap kmap,
                          const __grid_constant__ CUtensorMap vmap,
                          const int* __restrict__ block_table,
                          const int* __restrict__ start,
                          const int* __restrict__ lengths,
                          __nv_bfloat16* __restrict__ out, int S, int H,
                          int KV, int ps, int maxp, int window,
                          float scale_log2, int box_rows) {
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

  const int qt = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int G = H / KV, tpb = kTcRows / G;
  const int st0 = start[b], length = lengths[b];
  const int n_used = min((length + ps - 1) / ps, maxp);
  const int kv_lim = min(n_used * ps, length);
  const int t_lo = qt * tpb, t_hi = min(t_lo + tpb, S) - 1;
  const int q_lo = st0 + t_lo, q_hi = st0 + t_hi;
  const int kv_end = max(min(kv_lim, q_hi + 1), 0);
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
    mbar_expect_tx(qbar, tpb * G * DH * 2);
#pragma unroll
    for (int c = 0; c < L::NC; ++c)
      tma_load_4d(qs + c * kTcRows * L::SW, &qmap, qbar, c * L::CHUNK, 0,
                  kvh, b * S + t_lo);
    const int* table = block_table + int64_t(b) * maxp;
    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % kTcStages;
      if (t >= kTcStages) mbar_wait(&empty[s], ((t / kTcStages) + 1) & 1);
      uint8_t* ks = smem + L::Q_BYTES + s * L::STAGE;
      uint8_t* vs = ks + L::KV_BYTES;
      const int j0 = kv_begin + t * kTcKeys;
      mbar_expect_tx(&full[s], L::STAGE);
      for (int jb = j0; jb < j0 + kTcKeys; jb += box_rows) {
        // a piece past the pages in use loads the last used page instead:
        // finite data under a mask, never a table entry past n_used
        int pg = jb / ps, row = jb % ps;
        if (pg >= n_used) {
          pg = n_used - 1;
          row = 0;
        }
        const int page = table[pg];
        const int dst = (jb - j0) * L::SW;
#pragma unroll
        for (int c = 0; c < L::NC; ++c) {
          tma_load_4d(ks + c * kTcKeys * L::SW + dst, &kmap, &full[s],
                      c * L::CHUNK, kvh, row, page);
          tma_load_4d(vs + c * kTcKeys * L::SW + dst, &vmap, &full[s],
                      c * L::CHUNK, kvh, row, page);
        }
      }
    }
    return;
  }

  // ---- consumer: warpgroup 0, two rows a thread (attention_wgmma.cuh)
  const int wq = tid / 32, l = tid % 32;
  const int r0 = wq * 16 + (l >> 2), r1 = r0 + 8;
  const int qp0 = q_lo + r0 / G, qp1 = q_lo + r1 / G;
  TcRows<DH> rows;
  mbar_wait(qbar, 0);

  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % kTcStages;
    mbar_wait(&full[s], (t / kTcStages) & 1);
    const uint8_t* ks = smem + L::Q_BYTES + s * L::STAGE;
    const int j0 = kv_begin + t * kTcKeys;
    // masks only where the tile crosses the causal edge, the length or
    // the window's edge
    const bool interior = j0 + kTcKeys - 1 <= q_lo &&
                          j0 + kTcKeys <= kv_lim && q_hi - j0 < window;
    tc_attend_tile<DH>(rows, qs, ks, ks + L::KV_BYTES, j0, interior,
                       scale_log2, l, [&](int kv, bool second) {
                         const int qp = second ? qp1 : qp0;
                         return kv <= qp && kv < kv_lim && qp - kv < window;
                       });
    mbar_arrive(&empty[s]);
  }

  float inv0, inv1;
  tc_row_scales(rows, inv0, inv1);
  const int n_rows = tpb * G;
#pragma unroll
  for (int i = 0; i < DH / 2; i += 2) {
    const int r = (i & 2) ? r1 : r0;
    const int tok = t_lo + r / G;
    if (r >= n_rows || tok >= S) continue;
    const float inv = (i & 2) ? inv1 : inv0;
    const int col = (i >> 2) * 8 + (l & 3) * 2;
    *reinterpret_cast<__nv_bfloat162*>(
        out + ((int64_t(b) * S + tok) * H + kvh * G + r % G) * DH + col) =
        __floats2bfloat162_rn(rows.o[i] * inv, rows.o[i + 1] * inv);
  }
}

template <int DH>
static int launch_extend(const void* q, const void* kp, const void* vp,
                         const int* table, const int* start,
                         const int* lengths, void* out, int B, int S, int H,
                         int KV, int ps, int P, int maxp, int window,
                         float scale, cudaStream_t stream) {
  using L = TcLayout<DH>;
  const int G = H / KV, tpb = kTcRows / G;
  const int box_rows = std::gcd(ps, kTcKeys);
  CUtensorMap maps[3];
  {
    const uint64_t dims[4] = {uint64_t(DH), uint64_t(G), uint64_t(KV),
                              uint64_t(B) * S};
    const uint64_t strides[3] = {uint64_t(DH) * 2, uint64_t(G) * DH * 2,
                                 uint64_t(H) * DH * 2};
    const uint32_t box[4] = {uint32_t(L::CHUNK), uint32_t(G), 1,
                             uint32_t(tpb)};
    const int err = repro_hopper::make_tensor_map(&maps[0], q, 4, dims,
                                                  strides, box, L::SW);
    if (err) return err;
  }
  const void* pools[2] = {kp, vp};
  for (int m = 0; m < 2; ++m) {
    const uint64_t dims[4] = {uint64_t(DH), uint64_t(KV), uint64_t(ps),
                              uint64_t(P)};
    const uint64_t strides[3] = {uint64_t(DH) * 2, uint64_t(KV) * DH * 2,
                                 uint64_t(ps) * KV * DH * 2};
    const uint32_t box[4] = {uint32_t(L::CHUNK), 1, uint32_t(box_rows), 1};
    const int err = repro_hopper::make_tensor_map(&maps[1 + m], pools[m], 4,
                                                  dims, strides, box, L::SW);
    if (err) return err;
  }
  const int err =
      repro_hopper::allow_smem<paged_extend_wgmma_kernel<DH>>(L::SMEM);
  if (err) return err;
  dim3 grid((S + tpb - 1) / tpb, KV, B);
  paged_extend_wgmma_kernel<DH><<<grid, kTcThreads, L::SMEM, stream>>>(
      maps[0], maps[1], maps[2], table, start, lengths,
      static_cast<__nv_bfloat16*>(out), S, H, KV, ps, maxp, window,
      scale * kLog2e, box_rows);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace repro_attn

// Splits of the decode grid for a block table of maxp pages (the size of
// its workspace: B * KV * splits * G * (dh + 2) floats), and the pages
// each split takes.
extern "C" int paged_decode_splits(int maxp) {
  return repro_attn::decode_splits(maxp);
}
extern "C" int paged_decode_pages_per_split() {
  return repro_attn::kPagesPerSplit;
}

// mode: 0 = decode (S == 1; split-KV kernel, needs ``ws`` and ``tickets``:
// B * KV int32 counters that are 0 before and after every launch; ``lse``,
// when not null, takes each (sequence, head)'s log-sum-exp of its scaled
// scores, (B, H) f32 in natural log, -inf where nothing is visible), 1 =
// extend (``lse`` must be null).  dtype: 0 = float32, 1 = bfloat16.  Returns a cudaError_t: the
// launch's own error, or cudaErrorInvalidValue for a shape, head dim, dtype
// or mode the chosen kernel does not take.
extern "C" int paged_attention_fwd(const void* q, const void* k_pages,
                                   const void* v_pages,
                                   const int* block_table, const int* start,
                                   const int* lengths, void* out, float* ws,
                                   int* tickets, float* lse, int B, int S,
                                   int H, int KV,
                                   int dh, int ps, int P, int maxp,
                                   int window, float scale, int dtype,
                                   int mode, void* stream) {
  using namespace repro_attn;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  if ((dtype != 0 && dtype != 1) || KV <= 0 || H % KV || B > 65535 ||
      KV > 65535)
    return bad;
  const int G = H / KV;
  if (mode == 0) {
    if (S != 1 || G > 16) return bad;
#define REPRO_DEC(D, T, RW)                                                 \
  return launch_decode<D, T, RW>(q, k_pages, v_pages, block_table, start,   \
                                 lengths, out, ws, tickets, lse, B, H, KV,  \
                                 ps, maxp, window, scale, st)
#define REPRO_DEC_RW(D, T)                                                  \
  case D:                                                                   \
    if (G <= 4) REPRO_DEC(D, T, 2);                                         \
    REPRO_DEC(D, T, 8);
#define REPRO_DEC_DH(T)                                                     \
  switch (dh) {                                                             \
    REPRO_DEC_RW(16, T) REPRO_DEC_RW(32, T) REPRO_DEC_RW(64, T)             \
    REPRO_DEC_RW(128, T)                                                    \
    default: return bad;                                                    \
  }
    if (dtype == 0) REPRO_DEC_DH(float)
    REPRO_DEC_DH(__nv_bfloat16)
#undef REPRO_DEC_DH
#undef REPRO_DEC_RW
#undef REPRO_DEC
  }
  if (mode != 1 || lse != nullptr) return bad;
  if (dtype == 0) {
#define REPRO_FMA(D)                                                        \
  case D:                                                                   \
    return launch_fma<D, float>(q, k_pages, v_pages, block_table, start,    \
                                lengths, out, B, S, H, KV, ps, maxp,        \
                                window, scale, st);
    switch (dh) {
      REPRO_FMA(16) REPRO_FMA(32) REPRO_FMA(64) REPRO_FMA(128)
      default: return bad;
    }
#undef REPRO_FMA
  }
  if (ps % 8 || G > kTcRows) return bad;
#define REPRO_EXT(D)                                                        \
  case D:                                                                   \
    return launch_extend<D>(q, k_pages, v_pages, block_table, start,        \
                            lengths, out, B, S, H, KV, ps, P, maxp, window, \
                            scale, st);
  switch (dh) {
    REPRO_EXT(16) REPRO_EXT(32) REPRO_EXT(64) REPRO_EXT(128)
    default: return bad;
  }
#undef REPRO_EXT
}
