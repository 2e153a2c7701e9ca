// Shared device code of the tensor-core attention kernels (bf16 flash
// prefill, its backward and bf16 paged extend): the block's tile sizes and
// shared-memory layout, TMA loads of 64-row tiles, the two products they
// are built from, and warpgroup 0's forward step over one K/V tile.
//
// A block computes 64 query rows (wgmma's M) against K/V tiles of 64 keys
// that a producer warp loads by TMA into a 2-stage ring.  Shared-memory
// tiles follow hopper.cuh's rules: swizzle = the bytes of min(dh, 64)
// elements, dh split in chunks of that many elements, each chunk of a tile
// 64 rows of SW bytes, tiles on 1024-byte boundaries.
//
// Thread (warp wq, lane l) of warpgroup 0 holds two query rows, wq*16 + l/4
// and that + 8; its accumulator i is the second row iff i & 2, column
// (i/4)*8 + (l%4)*2 + (i&1).  The four lanes of a row meet by shuffles.
#pragma once

#include "attention_tile.cuh"
#include "hopper.cuh"

namespace repro_attn {

constexpr int kTcRows = 64;       // query rows per block (wgmma's M)
constexpr int kTcKeys = 64;       // keys per K/V tile
constexpr int kTcStages = 2;
constexpr int kTcThreads = 160;   // warpgroup 0 computes, warp 4 loads

template <int DH>
struct TcLayout {
  static constexpr int SW = DH * 2 < 128 ? DH * 2 : 128;  // bytes a box row
  static constexpr int CHUNK = SW / 2;                    // elements a row
  static constexpr int NC = DH / CHUNK;                   // chunks of dh
  static constexpr int LAYOUT = repro_hopper::swizzle_layout(SW);
  static constexpr int Q_BYTES = kTcRows * DH * 2;
  static constexpr int KV_BYTES = kTcKeys * DH * 2;       // K or V tile
  static constexpr int STAGE = 2 * KV_BYTES;
  static constexpr int SMEM = Q_BYTES + kTcStages * STAGE + 64 + 1024;
};

static_assert(kTcRows == kTcKeys, "every tile below has 64 rows");

// The TMA descriptor of a (B, S, heads, DH) bf16 tensor read in tiles of
// 64 rows of one head: dims {dh, heads, S, B}, box CHUNK x 1 x 64 x 1.
// Returns a cudaError_t.
template <int DH>
inline int tc_head_map(CUtensorMap* map, const void* base, int B, int S,
                       int heads) {
  using L = TcLayout<DH>;
  const uint64_t dims[4] = {uint64_t(DH), uint64_t(heads), uint64_t(S),
                            uint64_t(B)};
  const uint64_t strides[3] = {uint64_t(DH) * 2, uint64_t(heads) * DH * 2,
                               uint64_t(S) * heads * DH * 2};
  const uint32_t box[4] = {uint32_t(L::CHUNK), 1, uint32_t(kTcRows), 1};
  return repro_hopper::make_tensor_map(map, base, 4, dims, strides, box,
                                       L::SW);
}

// Load rows row0 .. row0 + 63 of ``head`` of sequence b (a tc_head_map
// tensor; rows past S load as zero) into the tile at dst, completing on
// ``bar``: NC chunks, each 64 rows of SW bytes.
template <int DH>
__device__ __forceinline__ void tc_load_tile(uint8_t* dst,
                                             const CUtensorMap* map,
                                             uint64_t* bar, int head,
                                             int row0, int b) {
  using L = TcLayout<DH>;
#pragma unroll
  for (int c = 0; c < L::NC; ++c)
    repro_hopper::tma_load_4d(dst + c * kTcRows * L::SW, map, bar,
                              c * L::CHUNK, head, row0, b);
}

// wgmma descriptors of k16 step kk of a 64-row tile of dh: read K-major
// (the step is 16 columns of dh: 32 bytes into a chunk's rows) or
// MN-major (the step is 16 rows; LBO = one chunk of dh, 64 rows away).
template <int DH>
__device__ __forceinline__ uint64_t tc_kmajor(const uint8_t* tile, int kk) {
  using L = TcLayout<DH>;
  const int off = (kk * 16 / L::CHUNK) * kTcRows * L::SW +
                  (kk * 16 % L::CHUNK) * 2;
  return repro_hopper::smem_desc(tile + off, 16, 8 * L::SW, L::LAYOUT);
}
template <int DH>
__device__ __forceinline__ uint64_t tc_mnmajor(const uint8_t* tile,
                                               int kk) {
  using L = TcLayout<DH>;
  return repro_hopper::smem_desc(tile + kk * 16 * L::SW, kTcRows * L::SW,
                                 8 * L::SW, L::LAYOUT);
}

// Issue acc (64 x 64) += A B^T for two 64-row tiles of dh (both K-major).
template <int DH>
__device__ __forceinline__ void tc_abt(float (&acc)[32], const uint8_t* a,
                                       const uint8_t* b) {
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk)
    repro_hopper::wgmma_ss<64, 0, 0>(acc, tc_kmajor<DH>(a, kk),
                                     tc_kmajor<DH>(b, kk));
}

// Issue acc (64 x dh) += A B for A (64 x 64) in registers, four k16 steps
// of bf16 pairs (pack_bf16 of a 64 x 64 accumulator), and B a 64-row tile
// of dh read MN-major.
template <int DH>
__device__ __forceinline__ void tc_ab(float (&acc)[DH / 2],
                                      const uint32_t (&a)[4][4],
                                      const uint8_t* b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    repro_hopper::wgmma_rs<DH, 1>(acc, a[kk], tc_mnmajor<DH>(b, kk));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// A 64 x 64 accumulator as the register A operand of tc_ab: k16 step kk
// takes columns 16kk..16kk+15, i.e. accumulators 8kk..8kk+7, in pairs,
// rounded to bf16.
__device__ __forceinline__ void tc_pack(const float (&acc)[32],
                                        uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      a[kk][j] = pack_bf16(acc[8 * kk + 2 * j], acc[8 * kk + 2 * j + 1]);
}

// The online-softmax state of a thread's two rows (scores in log2 units).
template <int DH>
struct TcRows {
  float o[DH / 2];
  float m0, m1, l0, l1;            // l: this lane's part of the row sum

  __device__ __forceinline__ TcRows() : m0(kNegInf), m1(kNegInf), l0(0.f),
                                        l1(0.f) {
#pragma unroll
    for (int i = 0; i < DH / 2; ++i) o[i] = 0.f;
  }
};

// Fold the K/V tile at ks / vs (keys j0 .. j0 + 63) into the rows:
// S = Q K^T on wgmma from shared memory (both K-major), scaled to log2
// units; unless the tile is ``interior``, a score whose key fails
// ``keep(kv, second_row)`` becomes the -1e30 sentinel; online softmax on
// the fragments with exp2; then O += P V with P converted to bf16 in
// registers as the A operand and V read MN-major.
template <int DH, typename Keep>
__device__ __forceinline__ void tc_attend_tile(TcRows<DH>& r,
                                               const uint8_t* qs,
                                               const uint8_t* ks,
                                               const uint8_t* vs, int j0,
                                               bool interior,
                                               float scale_log2, int l,
                                               Keep keep) {
  using namespace repro_hopper;
  float sc[kTcKeys / 2];
#pragma unroll
  for (int i = 0; i < kTcKeys / 2; ++i) sc[i] = 0.f;
  fence_regs(sc);
  wgmma_fence();
  tc_abt<DH>(sc, qs, ks);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(sc);

  float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
  for (int i = 0; i < kTcKeys / 2; ++i) {
    float v = sc[i] * scale_log2;
    if (!interior && !keep(j0 + (i >> 2) * 8 + (l & 3) * 2 + (i & 1),
                           (i & 2) != 0))
      v = kNegInf;
    sc[i] = v;
    if (i & 2) mx1 = fmaxf(mx1, v); else mx0 = fmaxf(mx0, v);
  }
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
  const float mn0 = fmaxf(r.m0, mx0), mn1 = fmaxf(r.m1, mx1);
  const float c0 = exp2f(r.m0 - mn0), c1 = exp2f(r.m1 - mn1);
  float s0 = 0.f, s1 = 0.f;
#pragma unroll
  for (int i = 0; i < kTcKeys / 2; ++i) {
    const float p = exp2f(sc[i] - ((i & 2) ? mn1 : mn0));
    sc[i] = p;
    if (i & 2) s1 += p; else s0 += p;
  }
  r.l0 = r.l0 * c0 + s0;
  r.l1 = r.l1 * c1 + s1;
  r.m0 = mn0;
  r.m1 = mn1;
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) r.o[i] *= (i & 2) ? c1 : c0;

  // P as the register A operand, V read MN-major
  uint32_t pa[4][4];
  tc_pack(sc, pa);
  fence_regs(r.o);
  wgmma_fence();
  tc_ab<DH>(r.o, pa, vs);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(r.o);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) fence_regs(pa[kk]);
}

// 1 / max(l, 1e-20) of the two rows, once their four lanes' sums are added.
template <int DH>
__device__ __forceinline__ void tc_row_scales(TcRows<DH>& r, float& inv0,
                                              float& inv1) {
  r.l0 += __shfl_xor_sync(0xffffffffu, r.l0, 1);
  r.l0 += __shfl_xor_sync(0xffffffffu, r.l0, 2);
  r.l1 += __shfl_xor_sync(0xffffffffu, r.l1, 1);
  r.l1 += __shfl_xor_sync(0xffffffffu, r.l1, 2);
  inv0 = 1.f / fmaxf(r.l0, 1e-20f);
  inv1 = 1.f / fmaxf(r.l1, 1e-20f);
}

}  // namespace repro_attn
