// Shared pieces of the port's flash-attention kernels (K1/K2 forward,
// K3 delta, K4 dK/dV, K5 dQ): the packed-layout geometry, f32 tiles in
// shared memory with a register-tiled product on the CUDA cores, and the
// bf16 tiles and mma.sync fragments of the tensor-core paths.
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

// -inf: the score of a masked key, whose exp is exactly 0
__device__ __forceinline__ float neg_inf() {
  return __uint_as_float(0xff800000u);
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

// Tensor-core pieces (bf16, head_dim 64/128): 4 warps over the 64 rows of
// a tile, warp w owning rows 16w..16w+15; mma.sync m16n8k16 fragments
// (lane = 4*gq + tq: A rows gq and gq+8, cols 2tq.. and 2tq+8..; B col
// gq, rows 2tq..; C rows gq/gq+8, cols 2tq, 2tq+1).  A row-major shared
// tile padded by 8 elements keeps every 32-bit fragment load
// conflict-free.  Two adjacent 16x8 C fragments are exactly the A
// fragment of the next product, so probabilities never leave registers.
namespace mma {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kKeys = 64;

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

// The tile loads move 16 bytes a thread and have a constant trip count,
// so the compiler starts all of a thread's loads before its stores: the
// blocks are few per SM and would otherwise wait on each load in turn.

// the 64 query rows [r0, r0 + 64) of a packed tensor -> shared [64][D + 8]
template <int D>
__device__ __forceinline__ void load_rows(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src,
                                          const Geom& g, int b, int kvh,
                                          int r0) {
  constexpr int V8 = D / 8;                         // 16-byte vectors a row
#pragma unroll
  for (int it = 0; it < kRows * V8 / kThreads; ++it) {
    const int e = threadIdx.x + it * kThreads;
    const int rr = e / V8, c = e - rr * V8;         // a row's vectors adjacent
    *reinterpret_cast<uint4*>(dst + rr * (D + 8) + 8 * c) =
        *reinterpret_cast<const uint4*>(
            src + row_off<D>(g, b, kvh, r0 + rr) + 8 * c);
  }
}

// one 16-byte vector (8 elements of row sk of a 64-row tile, from column
// 8c) into a row-major [64][D + 8] and/or a transposed [D][64 + 8] tile
static_assert(kKeys == kRows, "key and query tiles share one shape");
template <int D>
__device__ __forceinline__ void put_row(__nv_bfloat16* rows,
                                        __nv_bfloat16* cols, const uint4& x,
                                        int sk, int c) {
  if (rows != nullptr)
    *reinterpret_cast<uint4*>(rows + sk * (D + 8) + 8 * c) = x;
  if (cols != nullptr) {
    const uint32_t w[4] = {x.x, x.y, x.z, x.w};   // element 2i in the low half
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const uint32_t bits = (w[i / 2] >> (16 * (i % 2))) & 0xffffu;
      cols[(8 * c + i) * (kKeys + 8) + sk] =
          __ushort_as_bfloat16(static_cast<unsigned short>(bits));
    }
  }
}

// kKeys rows of K and of V (row s at base + s * stride) into shared
// tiles; a null destination is skipped.  Neighbouring threads take
// neighbouring keys, so the transposed stores are conflict-free.
template <int D>
__device__ __forceinline__ void load_kv(__nv_bfloat16* k_rows,
                                        __nv_bfloat16* k_cols,
                                        __nv_bfloat16* v_rows,
                                        __nv_bfloat16* v_cols,
                                        const __nv_bfloat16* k,
                                        const __nv_bfloat16* v,
                                        long long base, long long stride) {
#pragma unroll
  for (int it = 0; it < kKeys * (D / 8) / kThreads; ++it) {
    const int e = threadIdx.x + it * kThreads;
    const int sk = e % kKeys, c = e / kKeys;
    const long long src = base + sk * stride + 8 * c;
    const uint4 kx = *reinterpret_cast<const uint4*>(k + src);
    const uint4 vx = *reinterpret_cast<const uint4*>(v + src);
    put_row<D>(k_rows, k_cols, kx, sk, c);
    put_row<D>(v_rows, v_cols, vx, sk, c);
  }
}

// the 64 query rows [r0, r0 + 64) into a row-major and a transposed tile
template <int D>
__device__ __forceinline__ void load_rows_t(__nv_bfloat16* rows,
                                            __nv_bfloat16* cols,
                                            const __nv_bfloat16* src,
                                            const Geom& g, int b, int kvh,
                                            int r0) {
#pragma unroll
  for (int it = 0; it < kRows * (D / 8) / kThreads; ++it) {
    const int e = threadIdx.x + it * kThreads;
    const int rr = e % kRows, c = e / kRows;
    const uint4 x = *reinterpret_cast<const uint4*>(
        src + row_off<D>(g, b, kvh, r0 + rr) + 8 * c);
    put_row<D>(rows, cols, x, rr, c);
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
