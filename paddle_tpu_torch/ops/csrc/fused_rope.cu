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
// inverse rotation.  Arithmetic in f32 with one rounding to the input
// dtype at the store; the products and the sum are separately rounded (no
// FMA contraction), so the kernel is bitwise equal to its plain PyTorch
// version (x.float() * cos + swap(x).float() * sin, cast back).  The
// reference rounds after each bf16 operation, so bf16 results may differ
// from it by one unit in the last place.
//
// What bounds it on the card: bytes — q and k read and written once, the
// [L, D] tables (small, cache-resident).  A thread owns V pairs of one
// position — columns i..i+V-1 and the matching ones of the second half —
// in every head: it reads the position's table chunks once, then moves
// each head's two chunks with one load and one store apiece.  The vector
// instance takes 16 bytes a chunk (V = 8 bf16/f16 elements, 4 f32); where
// D/2 is not a multiple of that or a pointer is not 16-byte aligned, the
// caller picks the scalar instance (V = 1) of the same kernel up front.
// The grid gives the batch (y) and the (position, chunk) pairs of a row
// (x): no 64-bit division.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <>
__device__ __forceinline__ __half from_f32<__half>(float x) {
  return __float2half(x);
}

// V elements moved as one access (16 bytes in the vector instance)
template <typename T, int V>
struct alignas(sizeof(T) * V) Chunk {
  T v[V];
};

template <typename T, int V>
__device__ __forceinline__ Chunk<T, V> ld(const T* p) {
  return *reinterpret_cast<const Chunk<T, V>*>(p);
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    rope_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ cos_t, const T* __restrict__ sin_t,
                T* __restrict__ oq, T* __restrict__ ok, int L, int nh,
                int nkv, int D, int neg) {
  const int half = D / 2, chunks = half / V;
  const int e = blockIdx.x * kThreads + threadIdx.x;
  if (e >= L * chunks) return;
  const int l = e / chunks, i = (e - l * chunks) * V;
  const long long pos = static_cast<long long>(blockIdx.y) * L + l;
  // the position's table chunks, once for every head
  const Chunk<T, V> c1 = ld<T, V>(cos_t + l * D + i);
  const Chunk<T, V> c2 = ld<T, V>(cos_t + l * D + i + half);
  const Chunk<T, V> s1 = ld<T, V>(sin_t + l * D + i);
  const Chunk<T, V> s2 = ld<T, V>(sin_t + l * D + i + half);
  float fc1[V], fc2[V], fs1[V], fs2[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    fc1[j] = to_f32(c1.v[j]);
    fc2[j] = to_f32(c2.v[j]);
    fs1[j] = neg ? to_f32(s1.v[j]) : -to_f32(s1.v[j]);
    fs2[j] = neg ? -to_f32(s2.v[j]) : to_f32(s2.v[j]);
  }
#pragma unroll 4
  for (int head = 0; head < nh + nkv; ++head) {
    const bool is_q = head < nh;
    const long long base =
        is_q ? (pos * nh + head) * D + i : (pos * nkv + head - nh) * D + i;
    const T* x = (is_q ? q : k) + base;
    T* o = (is_q ? oq : ok) + base;
    const Chunk<T, V> x1 = ld<T, V>(x), x2 = ld<T, V>(x + half);
    Chunk<T, V> o1, o2;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float a = to_f32(x1.v[j]), b = to_f32(x2.v[j]);
      o1.v[j] = from_f32<T>(__fadd_rn(__fmul_rn(a, fc1[j]),
                                      __fmul_rn(b, fs1[j])));
      o2.v[j] = from_f32<T>(__fadd_rn(__fmul_rn(b, fc2[j]),
                                      __fmul_rn(a, fs2[j])));
    }
    *reinterpret_cast<Chunk<T, V>*>(o) = o1;
    *reinterpret_cast<Chunk<T, V>*>(o + half) = o2;
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <typename T>
int launch(const void* q, const void* k, const void* cos_t, const void* sin_t,
           void* oq, void* ok, int B, int L, int nh, int nkv, int D, int neg,
           int vec, cudaStream_t s) {
  constexpr int V = 16 / sizeof(T);
  if (vec && ((D / 2) % V != 0 || !aligned16(q) || !aligned16(k) ||
              !aligned16(cos_t) || !aligned16(sin_t) || !aligned16(oq) ||
              !aligned16(ok)))
    return -1;
  const long long threads =
      static_cast<long long>(L) * (D / 2 / (vec ? V : 1));
  const long long blocks = (threads + kThreads - 1) / kThreads;
  if (B > 65535 || blocks > 0x7fffffffLL) return -1;
  const dim3 grid(static_cast<unsigned>(blocks), B);
  const T* tq = static_cast<const T*>(q);
  const T* tk = static_cast<const T*>(k);
  const T* tc = static_cast<const T*>(cos_t);
  const T* ts = static_cast<const T*>(sin_t);
  if (vec)
    rope_kernel<T, V><<<grid, kThreads, 0, s>>>(
        tq, tk, tc, ts, static_cast<T*>(oq), static_cast<T*>(ok), L, nh, nkv,
        D, neg);
  else
    rope_kernel<T, 1><<<grid, kThreads, 0, s>>>(
        tq, tk, tc, ts, static_cast<T*>(oq), static_cast<T*>(ok), L, nh, nkv,
        D, neg);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 float32, 1 bfloat16, 2 float16 (q, k, the tables and the
// outputs).  q/oq [B, L, nh*D], k/ok [B, L, nkv*D], cos/sin [L, D] (the
// standard unsigned, half-duplicated tables); neg != 0 applies the inverse
// rotation.  D must be even.  vec != 0 takes the vector instance (D/2 a
// multiple of 16 bytes' worth of elements, every pointer 16-byte aligned),
// else the scalar one.  Returns the launch's cudaError_t (0 = ok, -1 = a
// shape or alignment the instance does not take).
extern "C" int fused_rope(int dtype, const void* q, const void* k,
                          const void* cos_t, const void* sin_t, void* oq,
                          void* ok, int B, int L, int nh, int nkv, int D,
                          int neg, int vec, void* stream) {
  if (D % 2 != 0 || L <= 0 || B <= 0) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch<float>(q, k, cos_t, sin_t, oq, ok, B, L, nh, nkv, D, neg,
                           vec, s);
    case 1:
      return launch<__nv_bfloat16>(q, k, cos_t, sin_t, oq, ok, B, L, nh, nkv,
                                   D, neg, vec, s);
    case 2:
      return launch<__half>(q, k, cos_t, sin_t, oq, ok, B, L, nh, nkv, D, neg,
                            vec, s);
    default:
      return -1;
  }
}
