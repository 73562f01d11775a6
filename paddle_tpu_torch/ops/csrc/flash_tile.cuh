// Shared pieces of the port's flash-attention kernels (K1/K2 forward,
// K3 delta, K4 dK/dV, K5 dQ, and their ROPE instances, K10): the
// packed-layout geometry, f32 tiles in shared memory with a
// register-tiled product on the CUDA cores, the mma.sync fragments (K9's
// tensor-core path; the wgmma kernels reuse their fragment conversion),
// the in-tile rotation (also on the wgmma kernels' swizzled tiles) and the
// wgmma kernels' exponential.
//
// Layout (the JAX package's projection layout, consumed without a
// transpose): q/out/dq [B, Lq, H*D], k/v/dk/dv [B, Lk, Hkv*D], row
// statistics (lse, delta) f32 [B, H, Lq].  Query head h = kvh*G + g reads
// kv head kvh.  A kernel block owns one kv head and walks the FLATTENED
// row space of its G query heads: row r = pos*G + g (position-major,
// group-head-minor, the reference's row order), 64 rows per tile, so one
// K/V tile loaded into shared memory serves all G heads.
//
// Thread tiling (256 threads, tx = tid % 16, ty = tid / 16): a 64 x N
// product tile gives thread (ty, tx) rows 4ty..4ty+3 and columns
// tx + 16j.  The 16 threads of a row group are one half-warp, so row
// reductions are 16-lane butterflies; a butterfly leaves the identical
// value in every lane, and no kernel uses atomics, so every result is
// bitwise reproducible run to run.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace ptf {

constexpr int kThreads = 256;
constexpr int kRows = 64;            // flattened query rows per tile
constexpr float kNegInf = -1e30f;    // running-max init (the reference's)

// -inf: the score of a causally masked key, whose exp is exactly 0
__device__ __forceinline__ float neg_inf() {
  return __uint_as_float(0xff800000u);
}

// Segment masks (the SEG instances of every flash kernel): int32 ids
// qseg [B, Lq] and kseg [B, Lk]; a (query, key) pair attends only within
// one segment.  A cross-segment score is the reference's FINITE sentinel
// kNegInf, not -inf: the running max starts there, so a row whose leading
// key tiles are all out of segment sums p = 1 over them until its first
// same-segment key arrives and exp(kNegInf - m) = 0 wipes that sum, and a
// dead row (no same-segment key at all) ends with the mean of V over the
// keys it sees.  Its lse, m + log(l), rounds to kNegInf in f32, so the
// backward recognises it (lse <= kDeadLse) and gives each of its n keys
// p = 1/n and no ds — the gradient of that mean.  Rows with a negative q
// segment write a zero output; their dout is zeroed by the caller.
constexpr float kDeadLse = 0.5f * kNegInf;

// the forward's score of one pair: -inf past the causal limit, kNegInf
// across segments, else the scaled product
__device__ __forceinline__ float seg_score(float s, bool visible,
                                           bool same) {
  return !visible ? neg_inf() : (same ? s : kNegInf);
}

// the backward's p and ds of one causally visible pair of a row with
// statistics (lse, delta), dp = do . v: across segments p is 1/n on a dead
// row and 0 on a live one, with no ds
__device__ __forceinline__ void seg_p_ds(float s_scaled, float dp, float lse,
                                         float delta, float scale, bool same,
                                         float inv_n, float& p, float& ds) {
  if (same) {
    p = expf(s_scaled - lse);
    ds = p * (dp - delta) * scale;
  } else {
    p = lse <= kDeadLse ? inv_n : 0.f;
    ds = 0.f;
  }
}

// e^x as the wgmma kernels take it: one ex2 of x·log2(e) (exp2f: the
// hardware's exponential, within 2 ulps in f32 as expf is) in place of
// expf's range reduction — their softmax is bound by these instructions
__device__ __forceinline__ float exp_ex2(float x) {
  return exp2f(x * 1.4426950408889634f);
}

// the number of keys flattened row r sees (1/n is a dead row's p)
__device__ __forceinline__ float inv_keys(int vis) {
  return 1.f / static_cast<float>(vis + 1);
}

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

struct Geom {
  int B, H, Hkv, G, Lq, Lk;
  int q_offset;    // Lk - Lq: bottom-right alignment of the causal mask
  int causal;
  float scale;
};

// element offset of flattened row r of kv head kvh, batch b, in a packed
// [B, Lq, H*D] tensor
template <int D>
__device__ __forceinline__ long long row_off(const Geom& g, int b, int kvh,
                                             int r) {
  const int pos = r / g.G, gi = r - pos * g.G;
  return ((static_cast<long long>(b) * g.Lq + pos) * g.H + kvh * g.G + gi) *
         D;
}

// the segment id of flattened row r (position r / G) in qseg [B, Lq]
__device__ __forceinline__ int row_seg(const int* qseg, const Geom& g, int b,
                                       int r) {
  return qseg[static_cast<long long>(b) * g.Lq + r / g.G];
}

// offset of the same row in a [B, H, Lq] statistics tensor
__device__ __forceinline__ long long stat_off(const Geom& g, int b, int kvh,
                                              int r) {
  const int pos = r / g.G, gi = r - pos * g.G;
  return (static_cast<long long>(b) * g.H + kvh * g.G + gi) * g.Lq + pos;
}

// the 64 query rows [r0, r0 + 64) -> f32 shared tile [64][ld]
template <typename T, int D>
__device__ __forceinline__ void load_rows(float* dst, int ld, const T* src,
                                          const Geom& g, int b, int kvh,
                                          int r0) {
  for (int e = threadIdx.x; e < kRows * D; e += kThreads) {
    const int rr = e / D, d = e - rr * D;
    dst[rr * ld + d] = to_f32(src[row_off<D>(g, b, kvh, r0 + rr) + d]);
  }
}

// BK key rows (row s at src[base + s * stride]) -> f32 shared tile,
// TRANSPOSED: dst[d * (BK + 1) + s].  The +1 pad makes both the
// transposing store and the column reads of the products conflict-free.
template <typename T, int D, int BK>
__device__ __forceinline__ void load_keys_t(float* dst, const T* src,
                                            long long base, long long stride) {
  for (int e = threadIdx.x; e < BK * D; e += kThreads) {
    const int s = e / D, d = e - s * D;
    dst[d * (BK + 1) + s] = to_f32(src[base + s * stride + d]);
  }
}

// BK key rows -> f32 shared tile [BK][D], row-major
template <typename T, int D, int BK>
__device__ __forceinline__ void load_keys(float* dst, const T* src,
                                          long long base, long long stride) {
  for (int e = threadIdx.x; e < BK * D; e += kThreads) {
    const int s = e / D, d = e - s * D;
    dst[s * D + d] = to_f32(src[base + s * stride + d]);
  }
}

// out[i][j] = sum_d A[4ty + i][d] * Bt[d][tx + 16j] — a 64 x (16*CJ) tile
// of A·B^T with A [64][lda] and B^T [D][ldb] in shared memory, f32 FMAs
// in ascending d.
template <int D, int CJ>
__device__ __forceinline__ void tile_dot(float (&out)[4][CJ], const float* A,
                                         int lda, const float* Bt, int ldb,
                                         int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < CJ; ++j) out[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float a[4], b[CJ];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = A[(4 * ty + i) * lda + d];
#pragma unroll
    for (int j = 0; j < CJ; ++j) b[j] = Bt[d * ldb + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j) out[i][j] = fmaf(a[i], b[j], out[i][j]);
  }
}

// butterflies over the 16 lanes of a half-warp (one row group)
__device__ __forceinline__ float max16(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float sum16(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// RoPE inside the flash kernels (the ROPE instances, K10: the reference's
// rope=True branches).  q and k arrive raw in the projection layout with
// four tables in the input dtype, sin pre-signed (concat(-sin_lo, sin_hi),
// the reference's signed_sin): qcos/qsin [Lq, D] for the query positions
// (the last Lq of the Lk positions: bottom-right, as the causal mask) and
// kcos/ksin [Lk, D].  A q or K tile is rotated in shared memory after it
// lands and before any product or fragment load reads it,
// x*c + swap(x)*s with swap(x) = concat(x[D/2:], x[:D/2]).  The column
// pair (i, i + D/2) of a row belongs to one thread, which reads both and
// writes both, so the rotation needs no barrier of its own beyond the two
// around it.  The reference rotates in the input dtype (_rot_tile on bf16
// tiles): each product and the sum is rounded to it — three roundings,
// which its jitted and eager runs both show; one rounding (K6's) differs
// from it in a third of the elements at bf16.  So each product and the
// sum is formed in f32 (exact for two bf16 or f16 factors) and rounded to
// the input dtype, no FMA contraction, as the plain version does
// (rope_tile); the tensor-core tiles use bf16x2 instructions with the
// same roundings, 16 bytes a thread (rope_sw128).  dq and dk accumulate
// in rotated space and are rotated back with -sin on the f32 accumulator
// (f32 arithmetic, the tables widened) before their one cast.  Both
// accumulator layouts keep columns d and d + D/2 of a row in the same
// thread (CUDA cores: c and c + CD/2; mma C
// fragments: n and n + ND/2), so that rotation runs in registers.
template <typename T>
struct Rope {
  const T* qcos;
  const T* qsin;
  const T* kcos;
  const T* ksin;
};

// the tables as the C interface passes them (all null: no rotation)
struct RopePtrs {
  const void* qcos;
  const void* qsin;
  const void* kcos;
  const void* ksin;
  bool on() const { return qcos != nullptr; }
  bool complete() const {
    return qcos != nullptr && qsin != nullptr && kcos != nullptr &&
           ksin != nullptr;
  }
  template <typename T>
  Rope<T> as() const {
    return Rope<T>{static_cast<const T*>(qcos), static_cast<const T*>(qsin),
                   static_cast<const T*>(kcos), static_cast<const T*>(ksin)};
  }
};

// x rounded to T, as f32
template <typename T>
__device__ __forceinline__ float round_as(float x) {
  return to_f32(from_f32<T>(x));
}

// one rotated pair in the arithmetic of dtype T:
// (x1, x2) = (x1 c1 + x2 s1, x2 c2 + x1 s2), each product and each sum
// rounded to T (T = float: plain f32 operations)
template <typename T>
__device__ __forceinline__ void rope_pair(float& x1, float& x2, float c1,
                                          float s1, float c2, float s2) {
  const float a = round_as<T>(__fadd_rn(round_as<T>(__fmul_rn(x1, c1)),
                                        round_as<T>(__fmul_rn(x2, s1))));
  const float b = round_as<T>(__fadd_rn(round_as<T>(__fmul_rn(x2, c2)),
                                        round_as<T>(__fmul_rn(x1, s2))));
  x1 = a;
  x2 = b;
}

// a rotated value (already a value of the input dtype) into an f32 tile
// (the CUDA-core kernels) or a bf16 one (the tensor-core kernels)
__device__ __forceinline__ void store_tile(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_tile(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// Rotate `rows` rows of a shared tile in place: element (r, d) at
// tile[r * rs + d * cs] (row-major: rs = ld, cs = 1; transposed: rs = 1,
// cs = ld, an odd ld in f32 keeps it conflict-free); row r takes table
// row (first + r) / div — a key tile's keys (div 1) or a q tile's
// flattened rows, position-major (div G: each row its position's table
// row, the reference's _rope_q_tile).  Neighbouring threads take
// neighbouring columns: the table reads coalesce.
template <typename T, int D, int NT, typename S>
__device__ __forceinline__ void rope_tile(S* tile, int rs, int cs, int rows,
                                          const T* cos_t, const T* sin_t,
                                          int first, int div) {
  constexpr int H2 = D / 2;
  for (int e = threadIdx.x; e < rows * H2; e += NT) {
    const int r = e / H2, i = e - r * H2;
    const long long t = static_cast<long long>((first + r) / div) * D + i;
    S* p1 = tile + r * rs + i * cs;
    S* p2 = p1 + H2 * cs;
    float x1 = to_f32(*p1), x2 = to_f32(*p2);
    rope_pair<T>(x1, x2, to_f32(cos_t[t]), to_f32(sin_t[t]),
                 to_f32(cos_t[t + H2]), to_f32(sin_t[t + H2]));
    store_tile(p1, x1);
    store_tile(p2, x2);
  }
}

// the inverse rotation (sin negated) of an f32 accumulator pair, columns
// d and d + D/2 of table row t / D (t = row * D + d), the tables widened
// from the input dtype to f32 — the reference's rotate-back of dq and dk
template <typename T>
__device__ __forceinline__ void unrope_pair(float& x1, float& x2,
                                            const T* cos_t, const T* sin_t,
                                            long long t, int half) {
  rope_pair<float>(x1, x2, to_f32(cos_t[t]), -to_f32(sin_t[t]),
                   to_f32(cos_t[t + half]), -to_f32(sin_t[t + half]));
}

template <typename Kernel>
inline cudaError_t set_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// key-tile width: 64 keys, 32 at head_dim 256 (shared memory)
template <int D>
struct KeyTile {
  static constexpr int value = D >= 256 ? 32 : 64;
};

// Tensor-core pieces (bf16): mma.sync m16n8k16 fragments (lane = 4*gq +
// tq: A rows gq and gq+8, cols 2tq.. and 2tq+8..; B col gq, rows 2tq..; C
// rows gq/gq+8, cols 2tq, 2tq+1), which the wgmma accumulators share per
// 16 rows of a warp.  Two adjacent 16x8 C fragments are exactly the A
// fragment of the next product, so probabilities never leave registers.
namespace mma {

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// c += a (16x16, row) · b (16x8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// bf16x2 multiply and add, each rounded to nearest even: the explicit
// .rn keeps the code generator from contracting them into an FMA (which
// would round the product only once with the sum)
__device__ __forceinline__ uint32_t mul_bf16x2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("mul.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
__device__ __forceinline__ uint32_t add_bf16x2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("add.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

// x c + y s on two bf16 lanes, each product and the sum rounded
__device__ __forceinline__ uint32_t rot_bf16x2(uint32_t x, uint32_t y,
                                               uint32_t c, uint32_t s) {
  return add_bf16x2(mul_bf16x2(x, c), mul_bf16x2(y, s));
}

// Rotate a head_dim-128 tile of R rows held as two 128-byte-swizzled
// boxes [R][64] (hopper.cuh; the wgmma kernels' tiles, written by TMA) in
// place, 16 bytes at a time: the pair (d, d + 64) sits at one offset in
// the two boxes, so a thread takes chunk c of row r in both, and the
// tables' same columns.  bf16x2 arithmetic rounds each product and the
// sum to bf16 — exactly the reference's three roundings (the product of
// two bf16 values is exact in f32, so rope_pair<__nv_bfloat16> gives the
// same bits) — at three instructions per two outputs.  Rows [r0, r1) are
// rotated, row r by table row first + r; threads t, t + nt, ... share
// the work.
__device__ __forceinline__ void rope_sw128(unsigned char* tile, int R, int r0,
                                           int r1,
                                           const __nv_bfloat16* cos_t,
                                           const __nv_bfloat16* sin_t,
                                           int first, int t, int nt) {
  for (int e = 8 * r0 + t; e < 8 * r1; e += nt) {
    const int r = e >> 3, c = e & 7;
    const int off = r * 128 + ((c ^ (r & 7)) << 4);
    uint4* p1 = reinterpret_cast<uint4*>(tile + off);
    uint4* p2 = reinterpret_cast<uint4*>(tile + R * 128 + off);
    const long long tt = static_cast<long long>(first + r) * 128 + 8 * c;
    const uint4 x1 = *p1, x2 = *p2;
    const uint4 c1 = *reinterpret_cast<const uint4*>(cos_t + tt);
    const uint4 c2 = *reinterpret_cast<const uint4*>(cos_t + tt + 64);
    const uint4 s1 = *reinterpret_cast<const uint4*>(sin_t + tt);
    const uint4 s2 = *reinterpret_cast<const uint4*>(sin_t + tt + 64);
    *p1 = make_uint4(rot_bf16x2(x1.x, x2.x, c1.x, s1.x),
                     rot_bf16x2(x1.y, x2.y, c1.y, s1.y),
                     rot_bf16x2(x1.z, x2.z, c1.z, s1.z),
                     rot_bf16x2(x1.w, x2.w, c1.w, s1.w));
    *p2 = make_uint4(rot_bf16x2(x2.x, x1.x, c2.x, s2.x),
                     rot_bf16x2(x2.y, x1.y, c2.y, s2.y),
                     rot_bf16x2(x2.z, x1.z, c2.z, s2.z),
                     rot_bf16x2(x2.w, x1.w, c2.w, s2.w));
  }
}

// the A fragment of a 16 x 16 product operand from two adjacent 16x8 f32
// C fragments (cols 0-7 in c0, 8-15 in c1), rounded to bf16
__device__ __forceinline__ void a_frag(const float (&c0)[4],
                                       const float (&c1)[4],
                                       uint32_t (&a)[4]) {
  a[0] = pack(c0[0], c0[1]);
  a[1] = pack(c0[2], c0[3]);
  a[2] = pack(c1[0], c1[1]);
  a[3] = pack(c1[2], c1[3]);
}

}  // namespace mma

}  // namespace ptf
