// K7 — fused int8-moment AdamW for Hopper (sm_90a).
//
// Replaces the TPU kernel _fused_adamw_q8 (paddle_tpu/ops/fused_adamw.py,
// pallas_call :169 for native 2-D tiles and :211 for the flat [nb, 256]
// view, body _kernel :30).  One AdamW step over a parameter of n values:
// the first moment is int8 codes with one f32 absmax scale per 256 values
// of the flat parameter (the last block may be short: its missing values
// count as zeros, as the reference's zero-padded encode has them), the
// second moment is bf16, and an f32 master weight is optional.  Each warp
// owns one 256-value block, 8 values a lane, and in one pass:
//   1. reads p (the f32 master, or the parameter widened in registers),
//      g (f32/bf16, widened in registers: exact), the codes, the
//      block's scale and v;
//   2. computes m = code * s, m' = b1 m + (1-b1) g, v' = b2 v + ((1-b2)
//      g) g, upd = lr (m'/c1) / (sqrt(v'/c2) + eps), p' = p wd - upd;
//   3. writes p' (and the f32 master), s' = max|m'| / 127 (a warp max:
//      exact in any order; the division taken as a multiply by f32(1/127),
//      which is what XLA compiles the reference's division by the
//      constant into), the codes rint(m' / max(s', 1e-30)) and v' rounded
//      to bf16.
// The TPU needed two tilings (native 2-D tiles, the flat view) for its
// layouts; here one flat kernel serves every shape and the ragged block.
//
// Exactness: every operation is written with the _rn intrinsics in the
// reference's order, so nvcc cannot contract a multiply and an add into
// one FMA (the reference rounds twice); rounding is to nearest even
// (rintf, __float2bfloat16_rn).  The plain version
// (ops/fused_adamw.py) gives the same bits.  The 9 scalars arrive by
// value, computed once on the host, (1-b1) and (1-b2) included.
//
// In place: the training step owns the parameter, the master, the codes,
// the scales and v (the JAX package donated them), so the kernel
// overwrites them: the master is read and written by the same lane, and a
// parameter without a master is read before it is written.
//
// What bounds it on the card: bytes.  With a bf16 parameter, no master
// and a bf16 gradient an element moves 2 + 2 + 1 + 2 bytes in and 2 + 1
// + 2 out, plus 8 bytes of scale per 256: 12.03 bytes, against ~20 flops
// — far below the ~295 flops a byte at which the card turns compute-
// bound.  The design reads and writes every operand once, with 16-byte
// loads and stores where a block is whole and the operands are aligned.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace ptt {

constexpr int kBlock = 256;         // values per quantization block
constexpr int kPer = 8;             // values per lane
constexpr int kWarpsPerCta = 8;

struct Scalars {
  float b1, b2, eps, lr, c1, c2, wd, omb1, omb2;
};

__device__ __forceinline__ float f32(float x) { return x; }
__device__ __forceinline__ float f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float f32(int8_t x) {
  return static_cast<float>(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// 8 consecutive values of T at src + i0 into f32 registers: one or two
// 16-byte loads when `vec`, else element by element up to `n`.
template <typename T>
__device__ __forceinline__ void load8(const T* src, long long i0,
                                      long long n, bool vec,
                                      float (&out)[kPer]) {
  if (vec) {
    alignas(16) T buf[kPer];
    if constexpr (sizeof(T) * kPer >= 16) {
      const uint4* s = reinterpret_cast<const uint4*>(src + i0);
#pragma unroll
      for (int w = 0; w < static_cast<int>(sizeof(T) * kPer / 16); ++w)
        reinterpret_cast<uint4*>(buf)[w] = s[w];
    } else {
      *reinterpret_cast<uint2*>(buf) =
          *reinterpret_cast<const uint2*>(src + i0);
    }
#pragma unroll
    for (int j = 0; j < kPer; ++j) out[j] = f32(buf[j]);
    return;
  }
#pragma unroll
  for (int j = 0; j < kPer; ++j)
    out[j] = i0 + j < n ? f32(src[i0 + j]) : 0.f;
}

template <typename T>
__device__ __forceinline__ void store8(T* dst, long long i0, long long n,
                                       bool vec, const T (&val)[kPer]) {
  if (vec) {
    if constexpr (sizeof(T) * kPer >= 16) {
      uint4* d = reinterpret_cast<uint4*>(dst + i0);
#pragma unroll
      for (int w = 0; w < static_cast<int>(sizeof(T) * kPer / 16); ++w)
        d[w] = reinterpret_cast<const uint4*>(val)[w];
    } else {
      *reinterpret_cast<uint2*>(dst + i0) =
          *reinterpret_cast<const uint2*>(val);
    }
    return;
  }
#pragma unroll
  for (int j = 0; j < kPer; ++j)
    if (i0 + j < n) dst[i0 + j] = val[j];
}

// TP: the type of the value the update reads (the f32 master, or the
// parameter); TG: the gradient's; TO: the parameter's (written).
template <typename TP, typename TG, typename TO>
__global__ void __launch_bounds__(kWarpsPerCta * 32) fused_adamw_kernel(
    const TP* p_in, const TG* __restrict__ g, int8_t* codes,
    float* scales, __nv_bfloat16* v, float* master_out, TO* p_out,
    long long n, long long nb, bool aligned, Scalars sc) {
  const int lane = threadIdx.x & 31;
  const long long blk =
      static_cast<long long>(blockIdx.x) * kWarpsPerCta + (threadIdx.x >> 5);
  if (blk >= nb) return;
  const long long i0 = blk * kBlock + lane * kPer;
  const bool vec = aligned && blk * kBlock + kBlock <= n;

  float p[kPer], gr[kPer], c[kPer], vv[kPer];
  load8(p_in, i0, n, vec, p);
  load8(g, i0, n, vec, gr);
  load8(codes, i0, n, vec, c);
  load8(v, i0, n, vec, vv);
  const float s = scales[blk];

  float m_new[kPer], p_new[kPer];
  float amax = 0.f;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const float m = __fmul_rn(c[j], s);
    const float gj = gr[j];
    const float mn = __fadd_rn(__fmul_rn(sc.b1, m), __fmul_rn(sc.omb1, gj));
    const float vn = __fadd_rn(__fmul_rn(sc.b2, vv[j]),
                               __fmul_rn(__fmul_rn(sc.omb2, gj), gj));
    const float upd =
        __fdiv_rn(__fmul_rn(sc.lr, __fdiv_rn(mn, sc.c1)),
                  __fadd_rn(__fsqrt_rn(__fdiv_rn(vn, sc.c2)), sc.eps));
    p_new[j] = __fsub_rn(__fmul_rn(p[j], sc.wd), upd);
    m_new[j] = mn;
    vv[j] = vn;
    // values past n (the ragged block) stay out of the max, as the
    // reference's zero padding does
    if (vec || i0 + j < n) amax = fmaxf(amax, fabsf(mn));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  const float s_new = __fmul_rn(amax, 1.f / 127.f);
  const float div = fmaxf(s_new, 1e-30f);

  alignas(16) int8_t q[kPer];
  alignas(16) __nv_bfloat16 vb[kPer];
  alignas(16) TO po[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    q[j] = static_cast<int8_t>(rintf(__fdiv_rn(m_new[j], div)));
    vb[j] = __float2bfloat16_rn(vv[j]);
    po[j] = from_f32<TO>(p_new[j]);
  }
  if (master_out != nullptr) {
    alignas(16) float pm[kPer];
#pragma unroll
    for (int j = 0; j < kPer; ++j) pm[j] = p_new[j];
    store8(master_out, i0, n, vec, pm);
  }
  store8(p_out, i0, n, vec, po);
  store8(codes, i0, n, vec, q);
  store8(v, i0, n, vec, vb);
  if (lane == 0) scales[blk] = s_new;
}

template <typename TP, typename TG, typename TO>
int launch(const void* p_in, const void* g, void* codes, void* scales,
           void* v, void* master_out, void* p_out, long long n,
           const Scalars& sc, cudaStream_t stream) {
  const long long nb = (n + kBlock - 1) / kBlock;
  if (nb == 0) return 0;
  const uintptr_t any = reinterpret_cast<uintptr_t>(p_in) |
                        reinterpret_cast<uintptr_t>(g) |
                        reinterpret_cast<uintptr_t>(codes) |
                        reinterpret_cast<uintptr_t>(v) |
                        reinterpret_cast<uintptr_t>(master_out) |
                        reinterpret_cast<uintptr_t>(p_out);
  const bool aligned = (any & 15u) == 0;
  const long long grid = (nb + kWarpsPerCta - 1) / kWarpsPerCta;
  if (grid > 0x7fffffffLL) return -1;
  fused_adamw_kernel<TP, TG, TO>
      <<<static_cast<unsigned>(grid), kWarpsPerCta * 32, 0, stream>>>(
          static_cast<const TP*>(p_in), static_cast<const TG*>(g),
          static_cast<int8_t*>(codes), static_cast<float*>(scales),
          static_cast<__nv_bfloat16*>(v), static_cast<float*>(master_out),
          static_cast<TO*>(p_out), n, nb, aligned, sc);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace ptt

// Dtype codes: 0 float32, 1 bfloat16.  p_in (p_dtype) is the f32 master
// when master_out is not null (then master_out == p_in and the parameter
// p_out is bf16), else the parameter itself (p_out == p_in).  g (g_dtype)
// is the parameter's dtype, or f32 where the optimizer widened it to add
// an L2 term.  codes int8 [n]; scales f32 [ceil(n/256)]; v bf16 [n];
// p_out (out_dtype) [n].  All updated in place.  Built for what the
// optimizer passes and nothing else: a bf16 parameter (bf16 or f32
// gradient), an f32 master of a bf16 parameter (bf16 or f32 gradient),
// an f32 parameter (f32 gradient).  Returns the launch's cudaError_t (0
// = launched), -1 for arguments it does not take.
extern "C" int fused_adamw_q8(int p_dtype, int g_dtype, int out_dtype,
                              const void* p_in, const void* g, void* codes,
                              void* scales, void* v, void* master_out,
                              void* p_out, long long n, float b1, float b2,
                              float eps, float lr, float c1, float c2,
                              float wd, float omb1, float omb2,
                              void* stream) {
  using bf16 = __nv_bfloat16;
  if ((master_out != nullptr) != (p_dtype == 0 && out_dtype == 1))
    return -1;
  const ptt::Scalars sc{b1, b2, eps, lr, c1, c2, wd, omb1, omb2};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (p_dtype * 100 + g_dtype * 10 + out_dtype) {
    case 111:  // bf16 parameter, bf16 gradient
      return ptt::launch<bf16, bf16, bf16>(p_in, g, codes, scales, v,
                                           master_out, p_out, n, sc, s);
    case 101:  // bf16 parameter, f32 gradient
      return ptt::launch<bf16, float, bf16>(p_in, g, codes, scales, v,
                                            master_out, p_out, n, sc, s);
    case 11:  // f32 master, bf16 gradient
      return ptt::launch<float, bf16, bf16>(p_in, g, codes, scales, v,
                                            master_out, p_out, n, sc, s);
    case 1:  // f32 master, f32 gradient
      return ptt::launch<float, float, bf16>(p_in, g, codes, scales, v,
                                             master_out, p_out, n, sc, s);
    case 0:  // f32 parameter, f32 gradient
      return ptt::launch<float, float, float>(p_in, g, codes, scales, v,
                                              master_out, p_out, n, sc, s);
    default:
      return -1;
  }
}
