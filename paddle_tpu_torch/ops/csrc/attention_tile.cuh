// Shared pieces of the port's two serving attention kernels (K8 paged
// decode, K9 fused chunked prefill).
//
// The CUDA-core tile of K9's float instances: a block of 256 threads
// holds up to 16 query rows of one kv head in shared memory and folds the
// keys into an f32 online softmax, 32 keys at a time — one warp lane per
// key for the scores and the row max/sum, one thread per (row, dim) pair
// of the accumulator, which lives in registers.  Keys and values arrive
// in shared memory as f32 whatever the cache stores: float caches widen,
// int8 caches dequantize (code * f16 scale, exact in f32).
//
// The recurrence is the reference's (paddle_tpu/ops/decode_attention.py
// _attend_chunked): scores s = q.k * scale, masked lanes held at -1e30
// and given probability EXACTLY 0 after the exp (the fully-masked-row
// pollution guard), running max m, denominator l and accumulator
// rescaled by exp(m_old - m_new), final division by max(l, 1e-30).  Only
// the summation order differs (32-key sub-tiles instead of whole
// chunks), which moves results by float reassociation only.
//
// Beside it: the int8 row quantizer both kernels share (q8_row) and the
// cp.async helpers of their shared-memory rings.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace ptt {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kKeys = 32;                          // keys per sub-tile
constexpr int kRows = 16;                          // query rows per block
constexpr int kMaxD = 256;                         // largest head_dim
constexpr int kAcc = kRows * kMaxD / kThreads;     // accumulators a thread
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

// 16 bytes from device memory into shared memory without a register
// round trip (both addresses 16-byte aligned); the copies a thread issued
// are grouped by cp_async_commit and waited for by cp_async_wait<N>,
// which returns once at most N of the thread's groups are in flight
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Shared-memory carve-up of one block, all f32:
//   q    [kRows][D]      the block's query rows
//   k    [kKeys][D + 1]  key sub-tile (row padded by one: the score loop
//                        reads one key row per lane, bank-conflict free)
//   v    [kKeys][D]      value sub-tile
//   p    [kRows][kKeys]  the sub-tile's probabilities
//   m, l, corr [kRows]   running max, denominator, the sub-tile's rescale
struct Smem {
  float *q, *k, *v, *p, *m, *l, *corr;
  __device__ Smem(float* base, int D) {
    q = base;
    k = q + kRows * D;
    v = k + kKeys * (D + 1);
    p = v + kKeys * D;
    m = p + kRows * kKeys;
    l = m + kRows;
    corr = l + kRows;
  }
};

inline size_t smem_bytes(int D) {
  return sizeof(float) * static_cast<size_t>(
      kRows * D + kKeys * (D + 1) + kKeys * D + kRows * kKeys + 3 * kRows);
}

// Load `n` rows of `D` elements into a shared tile with row stride `ld`,
// converting to f32; row s starts at element `base + s * stride` of src.
template <typename T>
__device__ __forceinline__ void load_rows(float* dst, int ld, const T* src,
                                          long long base, long long stride,
                                          int n, int D) {
  for (int e = threadIdx.x; e < n * D; e += kThreads) {
    const int s = e / D, d = e - s * D;
    dst[s * ld + d] = to_f32(src[base + s * stride + d]);
  }
}

// The int8 counterpart of load_rows: n rows of D codes, each with one f16
// scale, dequantized into the shared tile as f32(code) * f32(scale) — the
// reference's _q8_dequant, one exact product per element.  The codes of
// row s start at element base + s * stride of src (a multiple of D), its
// scale at element (base + s * stride) / D of scl.  With D a multiple of
// 16 each thread moves 16 codes per 16-byte load (the caller guarantees
// 16-byte alignment of src then).
__device__ __forceinline__ void load_rows_q8(float* dst, int ld,
                                             const int8_t* src,
                                             const __half* scl,
                                             long long base, long long stride,
                                             int n, int D) {
  if ((D & 15) == 0) {
    const int per = D >> 4;
    for (int e = threadIdx.x; e < n * per; e += kThreads) {
      const int s = e / per, c = e - s * per;
      const long long row = base + s * stride;
      const uint4 w = *reinterpret_cast<const uint4*>(src + row + c * 16);
      const float sc = __half2float(scl[row / D]);
      const int8_t* b = reinterpret_cast<const int8_t*>(&w);
      float* o = dst + s * ld + c * 16;
#pragma unroll
      for (int j = 0; j < 16; ++j)
        o[j] = __fmul_rn(static_cast<float>(b[j]), sc);
    }
    return;
  }
  for (int e = threadIdx.x; e < n * D; e += kThreads) {
    const int s = e / D, d = e - s * D;
    const long long row = base + s * stride;
    dst[s * ld + d] = __fmul_rn(static_cast<float>(src[row + d]),
                                __half2float(scl[row / D]));
  }
}

// The reference's _q8_quantize of one row of D <= kMaxD values (f32, or
// bf16 widened exactly), by one warp (lane holds d = lane + 32 j):
// scale = f16(amax * f32(1/127)) —
// what XLA compiles the reference's amax / 127 into — and the codes
// clip(rint(x * (1 / max(f32(scale), 1e-8))), +-127), each operation
// rounded once, to nearest even.  Returns the scale; q[j] holds the code
// of d = lane + 32 j as a float (0 past D).
template <typename X>
__device__ __forceinline__ __half q8_row(const X* x, int D, int lane,
                                         float (&q)[kMaxD / 32]) {
  float amax = 0.f;
#pragma unroll
  for (int j = 0; j < kMaxD / 32; ++j) {
    const int d = lane + 32 * j;
    q[j] = d < D ? to_f32(x[d]) : 0.f;
    amax = fmaxf(amax, fabsf(q[j]));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  const __half sc = __float2half_rn(__fmul_rn(amax, 1.f / 127.f));
  const float inv = __fdiv_rn(1.f, fmaxf(__half2float(sc), 1e-8f));
#pragma unroll
  for (int j = 0; j < kMaxD / 32; ++j)
    q[j] = fminf(fmaxf(rintf(__fmul_rn(q[j], inv)), -127.f), 127.f);
  return sc;
}

// Copy R query rows (contiguous, f32) into shared memory and reset the
// running state.
__device__ __forceinline__ void init_rows(Smem& sm, const float* q, int R,
                                          int D, float (&acc)[kAcc]) {
  for (int e = threadIdx.x; e < R * D; e += kThreads) sm.q[e] = q[e];
  for (int r = threadIdx.x; r < kRows; r += kThreads) {
    sm.m[r] = kNegInf;
    sm.l[r] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;
  __syncthreads();
}

// Fold one sub-tile of `nk` keys (already in sm.k / sm.v) into the
// running softmax of the block's R rows.  live(r, s) says whether key s
// is visible to row r.  Ends with a barrier, so the caller may overwrite
// the sub-tile right after.
template <typename Live>
__device__ __forceinline__ void fold(Smem& sm, int R, int D, int nk,
                                     float scale, Live live,
                                     float (&acc)[kAcc]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int r = warp; r < R; r += kWarps) {
    const bool ok = lane < nk && live(r, lane);
    float s = kNegInf;
    if (ok) {
      const float* qr = sm.q + r * D;
      const float* kr = sm.k + lane * (D + 1);
      float dot = 0.f;
      for (int d = 0; d < D; ++d) dot = fmaf(qr[d], kr[d], dot);
      s = dot * scale;
    }
    float mx = s;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    const float m_old = sm.m[r];
    const float m_new = fmaxf(m_old, mx);
    const float pr = ok ? expf(s - m_new) : 0.f;
    float sum = pr;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, o);
    sm.p[r * kKeys + lane] = pr;
    if (lane == 0) {
      const float c = expf(m_old - m_new);
      sm.corr[r] = c;
      sm.l[r] = sm.l[r] * c + sum;
      sm.m[r] = m_new;
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kAcc; ++i) {
    const int e = threadIdx.x + i * kThreads;
    if (e < R * D) {
      const int r = e / D, d = e - r * D;
      const float* pr = sm.p + r * kKeys;
      float a = acc[i] * sm.corr[r];
      for (int s = 0; s < nk; ++s) a = fmaf(pr[s], sm.v[s * D + d], a);
      acc[i] = a;
    }
  }
  __syncthreads();
}

// out[r * D + d] = acc / max(l, 1e-30) for the block's R rows.
__device__ __forceinline__ void finish(const Smem& sm, int R, int D,
                                       const float (&acc)[kAcc], float* out) {
#pragma unroll
  for (int i = 0; i < kAcc; ++i) {
    const int e = threadIdx.x + i * kThreads;
    if (e < R * D) out[e] = acc[i] / fmaxf(sm.l[e / D], 1e-30f);
  }
}

// The largest chunk-relative token index among the block's rows: rows
// are laid out g * T + t, so a block of R rows starting at row0 covers
// t = (row0 + r) % T.
__device__ __forceinline__ int last_token(int row0, int R, int T) {
  const int t0 = row0 % T;
  return (R >= T || t0 + R - 1 >= T) ? T - 1 : t0 + R - 1;
}

template <typename Kernel>
inline cudaError_t set_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace ptt
