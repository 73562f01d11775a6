// K6 — fused rotary position embedding on the packed projection layout,
// for Hopper (sm_90a).
//
// Replaces the TPU kernel _rope_pallas (paddle_tpu/ops/fused_rope.py:73,
// pallas_call :84, kernel _rope_kernel :43): one pass rotates q
// [B, L, nh*D] and k [B, L, nkv*D] straight off the projections with the
// half-split (llama/HF) convention
//     out = x * cos + swap(x) * signed_sin,
//     swap(x) = concat(x[D/2:], x[:D/2]),
//     signed_sin = concat(-sin[:D/2], sin[D/2:]),
// and the backward is the same pass with sin negated (`neg`), the
// inverse rotation.  One thread owns the pair (i, i + D/2) of one head
// row: it reads both, writes both.  Arithmetic in f32 with one rounding
// to the input dtype at the store; the products and the sum are
// separately rounded (no FMA contraction), so the kernel is bitwise equal
// to its plain PyTorch version (x.float() * cos + swap(x).float() * sin,
// cast back).  The reference rounds after each bf16 operation, so bf16
// results may differ from it by one unit in the last place.
//
// What bounds it on the card: bytes — q and k read and written once, the
// [L, D] tables (small, cache-resident).  The design reads each element
// once and writes it once; neighbouring threads touch neighbouring
// elements.  Vector (16-byte) loads are later work.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}
__device__ __forceinline__ void store(__half* p, float x) {
  *p = __float2half(x);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    rope_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ cos_t, const T* __restrict__ sin_t,
                T* __restrict__ oq, T* __restrict__ ok, long long n_pos, int L,
                int nh, int nkv, int D, int neg) {
  const int half = D / 2;
  const long long per_pos = static_cast<long long>(nh + nkv) * half;
  const long long total = n_pos * per_pos;
  for (long long e = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       e < total; e += static_cast<long long>(gridDim.x) * kThreads) {
    const long long p = e / per_pos;                 // (batch, position)
    const int rem = static_cast<int>(e - p * per_pos);
    const int head = rem / half, i = rem - head * half;
    const T* x;
    T* o;
    long long base;
    if (head < nh) {
      base = (p * nh + head) * D;
      x = q;
      o = oq;
    } else {
      base = (p * nkv + head - nh) * D;
      x = k;
      o = ok;
    }
    const long long t = static_cast<long long>(p % L) * D;
    const float x1 = to_f32(x[base + i]), x2 = to_f32(x[base + i + half]);
    const float c1 = to_f32(cos_t[t + i]), c2 = to_f32(cos_t[t + i + half]);
    float s1 = -to_f32(sin_t[t + i]), s2 = to_f32(sin_t[t + i + half]);
    if (neg) {
      s1 = -s1;
      s2 = -s2;
    }
    store(o + base + i, __fadd_rn(__fmul_rn(x1, c1), __fmul_rn(x2, s1)));
    store(o + base + i + half,
          __fadd_rn(__fmul_rn(x2, c2), __fmul_rn(x1, s2)));
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* cos_t, const void* sin_t,
           void* oq, void* ok, long long n_pos, int L, int nh, int nkv, int D,
           int neg, cudaStream_t s) {
  const long long total = n_pos * (nh + nkv) * (D / 2);
  long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > (1LL << 20)) blocks = 1LL << 20;      // grid-stride beyond
  if (blocks < 1) blocks = 1;
  rope_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(cos_t), static_cast<const T*>(sin_t),
      static_cast<T*>(oq), static_cast<T*>(ok), n_pos, L, nh, nkv, D, neg);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 float32, 1 bfloat16, 2 float16 (q, k, the tables and the
// outputs).  q/oq [B, L, nh*D], k/ok [B, L, nkv*D], cos/sin [L, D] (the
// standard unsigned, half-duplicated tables); neg != 0 applies the inverse
// rotation.  D must be even.  Returns the launch's cudaError_t (0 = ok).
extern "C" int fused_rope(int dtype, const void* q, const void* k,
                          const void* cos_t, const void* sin_t, void* oq,
                          void* ok, int B, int L, int nh, int nkv, int D,
                          int neg, void* stream) {
  if (D % 2 != 0 || L <= 0) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long n_pos = static_cast<long long>(B) * L;
  switch (dtype) {
    case 0:
      return launch<float>(q, k, cos_t, sin_t, oq, ok, n_pos, L, nh, nkv, D,
                           neg, s);
    case 1:
      return launch<__nv_bfloat16>(q, k, cos_t, sin_t, oq, ok, n_pos, L, nh,
                                   nkv, D, neg, s);
    case 2:
      return launch<__half>(q, k, cos_t, sin_t, oq, ok, n_pos, L, nh, nkv, D,
                            neg, s);
    default:
      return -1;
  }
}
