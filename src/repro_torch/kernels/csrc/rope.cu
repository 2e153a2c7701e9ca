// Rotary embedding (RoPE, the half-split rotation with one theta) of one
// attention layer's q and k in one launch, f32 or bf16 in and out.
//
// Replaces no TPU kernel: the JAX package rotates in plain JAX
// (src/repro/models/layers.py:63, rope), which XLA fuses.  Eager PyTorch
// issued that function as some 16 small ops for q and again for k
// (rebuilding the frequency table each time); this kernel issues it as one
// launch.  Same function as repro_torch/models/layers.py's rope: for each
// (token, head) and i < half = dh / 2, with angle = pos * inv_freq[i],
//   out[i]        = x[i] * cos(angle) - x[i + half] * sin(angle)
//   out[i + half] = x[i + half] * cos(angle) + x[i] * sin(angle)
// computed in f32 and rounded once to the output dtype.  Bitwise the eager
// ops' result on the card: the wrapper hands the inverse frequencies that
// layers.rope_inv_freq computed on the device, the angle is one rounded f32
// product of the position (int32 or int64, converted round-to-nearest) and
// the frequency, cosf / sinf are the precise library functions (no
// fast-math flag in the build, no __sinf / __cosf), each product, the
// difference and the sum are rounded on their own (__fmul_rn, __fsub_rn,
// __fadd_rn: no FMA contraction, as separate eager ops), and the bf16 store
// rounds to nearest even.
//
// What bounds it: every q and k element is read once and written once, 6
// FLOPs a pair, so bytes (3.35 TB/s): at a 2,048-token chunk of 36 query
// and 4 KV heads of 128, 42 MB.  The design: one block a token.  Its
// threads compute the token's half angles' cosines and sines once into
// shared memory, then walk every (head, i) pair of the q heads and then of
// the k heads, so consecutive threads read consecutive elements of a head.
// q, k and the positions are read through their strides (q and k are views
// of the fused QKV projection's output; prefill's positions an expanded
// arange), and the outputs are written contiguous, (B, S, H, dh) and
// (B, S, KV, dh).  Each element is written by one thread: a second launch
// gives the same bits.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace repro_rope {

constexpr int kThreads = 128;
constexpr int kMaxHalf = 128;   // dh <= 256

struct Strides {
  long long b, s, h, d;
};

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename T, typename P>
__global__ void __launch_bounds__(kThreads)
rope_qk_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const P* __restrict__ pos, const float* __restrict__ inv_freq,
               T* __restrict__ q_out, T* __restrict__ k_out, int S, int H,
               int KV, int half, Strides qs, Strides ks, long long pos_sb,
               long long pos_ss) {
  __shared__ float cos_s[kMaxHalf];
  __shared__ float sin_s[kMaxHalf];
  const long long t = blockIdx.x;            // token: b * S + s
  const long long b = t / S, s = t - b * S;
  const float p = static_cast<float>(pos[b * pos_sb + s * pos_ss]);
  for (int i = threadIdx.x; i < half; i += kThreads) {
    const float a = __fmul_rn(p, inv_freq[i]);
    cos_s[i] = cosf(a);
    sin_s[i] = sinf(a);
  }
  __syncthreads();
  const int dh = 2 * half;
  const int pairs = (H + KV) * half;
  for (int j = threadIdx.x; j < pairs; j += kThreads) {
    const int h = j / half, i = j - h * half;
    const T* src;
    T* dst;
    long long sd;
    if (h < H) {
      src = q + b * qs.b + s * qs.s + h * qs.h;
      dst = q_out + (t * H + h) * dh;
      sd = qs.d;
    } else {
      src = k + b * ks.b + s * ks.s + (h - H) * ks.h;
      dst = k_out + (t * KV + (h - H)) * dh;
      sd = ks.d;
    }
    const float x1 = load_f32(src + i * sd);
    const float x2 = load_f32(src + (i + half) * sd);
    const float c = cos_s[i], sn = sin_s[i];
    store(dst + i, __fsub_rn(__fmul_rn(x1, c), __fmul_rn(x2, sn)));
    store(dst + i + half, __fadd_rn(__fmul_rn(x2, c), __fmul_rn(x1, sn)));
  }
}

template <typename T, typename P>
int launch(const void* q, const void* k, const void* pos,
           const float* inv_freq, void* q_out, void* k_out, int B, int S,
           int H, int KV, int half, Strides qs, Strides ks, long long pos_sb,
           long long pos_ss, cudaStream_t st) {
  rope_qk_kernel<T, P><<<static_cast<unsigned>(B) * S, kThreads, 0, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const P*>(pos), inv_freq, static_cast<T*>(q_out),
      static_cast<T*>(k_out), S, H, KV, half, qs, ks, pos_sb, pos_ss);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace repro_rope

// q (B, S, H, dh) and k (B, S, KV, dh) through their strides (in
// elements), positions (B, S) through theirs; q_out and k_out contiguous.
// dtype: 0 = float32, 1 = bfloat16; pos64: 0 = int32, 1 = int64.  Returns a
// cudaError_t: the launch's own error, or cudaErrorInvalidValue for a
// shape, head dim or dtype the kernel does not take.  Nothing to rotate
// (no token, or no head at all) launches nothing and returns 0.
extern "C" int rope_qk(const void* q, const void* k, const void* pos,
                       const float* inv_freq, void* q_out, void* k_out, int B,
                       int S, int H, int KV, int dh, long long q_sb,
                       long long q_ss, long long q_sh, long long q_sd,
                       long long k_sb, long long k_ss, long long k_sh,
                       long long k_sd, long long pos_sb, long long pos_ss,
                       int dtype, int pos64, void* stream) {
  using namespace repro_rope;
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  if (B < 0 || S < 0 || H < 0 || KV < 0 || dh <= 0 || dh % 2 ||
      dh / 2 > kMaxHalf || (dtype != 0 && dtype != 1) ||
      (pos64 != 0 && pos64 != 1) ||
      static_cast<long long>(B) * S > 0x7fffffffLL)
    return bad;
  if (static_cast<long long>(B) * S == 0 || H + KV == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Strides qs{q_sb, q_ss, q_sh, q_sd}, ks{k_sb, k_ss, k_sh, k_sd};
  const int half = dh / 2;
#define REPRO_ROPE(T, P)                                                    \
  return launch<T, P>(q, k, pos, inv_freq, q_out, k_out, B, S, H, KV, half, \
                      qs, ks, pos_sb, pos_ss, st)
  if (dtype == 0) {
    if (pos64) REPRO_ROPE(float, int64_t);
    REPRO_ROPE(float, int32_t);
  }
  if (pos64) REPRO_ROPE(__nv_bfloat16, int64_t);
  REPRO_ROPE(__nv_bfloat16, int32_t);
#undef REPRO_ROPE
}
