// K9 — fused chunked-prefill attention + KV append for Hopper (sm_90a).
//
// Replaces the TPU kernel fused_prefill_attention
// (paddle_tpu/ops/prefill_attention_pallas.py:328, body _prefill_kernel
// :102) for float and int8 caches.  One admission chunk of T prompt tokens: every
// query sees the slot's written prefix (positions < offset) plus the
// chunk's own causal triangle, and the chunk's K/V rows are appended to
// the cache in place — into the paged pool through the slot's table row,
// or into the slot's dense row.  On the TPU the grid (Hkv, n_chunks)
// swept the prefix with double-buffered DMAs per kv head; here block
// (z, h) holds query rows [16 z, 16 z + 16) of kv head h (rows g*T + t),
// so G*T/16 * Hkv blocks share the work instead of Hkv.
//
// What bounds it on the card: for a long prefix, the bytes of the prefix
// KV (offset rows of K and V per kv head); for a short one, the
// operations of the T x (offset + T) score and value products (4 flops
// per query row, key and dim, in f32 — the kernel runs on the CUDA cores,
// not the tensor cores).  What the design does about it: every block
// reads the prefix once, in 32-key sub-tiles converted to f32 in shared
// memory, and reads the chunk's own rows from the k_new/v_new inputs
// instead of from the cache, so the append and the attention never
// depend on each other inside the launch.  Each block re-reads the
// prefix for its 16 rows; sharing it between blocks (clusters / larger
// tiles), tensor-core products and TMA are later work.
//
// Exactness contract with the reference:
//   * the new rows attend through their values ROUNDED TO THE CACHE
//     DTYPE (the caller passes k_new/v_new already in that dtype — the
//     reference reads them back from the cache after its scatter);
//   * only prefix rows BELOW offset are loaded: when C > T the block
//     being appended to is also a prefix block, and its rows >= offset
//     may be in flight from another block's append;
//   * the append drops a row whose destination is past the table's span
//     or maps to a sentinel entry (< 0 or >= n_blocks), like the
//     reference's mode="drop" scatter; dense appends are bounded by lmax.
//
// int8 caches (quant=True in the reference, :217-234, :265-267,
// :296-300): the caller passes k_new/v_new in f32, and the append
// quantizes each (token, kv head) row with _q8_quantize's recipe, one
// warp a row (q8_row: absmax over D, the scale rounded to f16, the codes
// through the reciprocal of the f16 scale, rint, clip +-127), writing the
// codes and the f16 scale under the same drop rules.  The chunk's own
// rows fold from their quantized-then-dequantized values, as the
// reference reads them back; every block that folds them quantizes them
// itself from k_new/v_new — deterministic, so bitwise the codes that were
// written — and never reads them from the pool.  Prefix rows dequantize
// as in K8 (load_rows_q8).
#include <type_traits>

#include "attention_tile.cuh"

namespace ptt {

// Quantize n rows of the new chunk (token key0 + r, head h; rows of x at
// element (key0 + r) * stride + h * D) and put their dequantized values
// in a shared tile of row stride ld: one warp a row.
__device__ __forceinline__ void q8_rows_to_tile(float* dst, int ld,
                                                const float* x, int key0,
                                                int n, long long stride,
                                                int h, int D) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int r = warp; r < n; r += kWarps) {
    float q[kMaxD / 32];
    const float sc = __half2float(q8_row(
        x + (key0 + r) * stride + static_cast<long long>(h) * D, D, lane,
        q));
#pragma unroll
    for (int j = 0; j < kMaxD / 32; ++j) {
      const int d = lane + 32 * j;
      if (d < D) dst[r * ld + d] = __fmul_rn(q[j], sc);
    }
  }
}

// T: the cache's element type; TN: k_new/v_new's (T for float caches,
// float for int8_t caches, whose f16 scales are ks/vs — null otherwise).
template <typename T, typename TN>
__global__ void __launch_bounds__(kThreads) prefill_kernel(
    const float* __restrict__ q, const TN* __restrict__ kn,
    const TN* __restrict__ vn, T* __restrict__ kc, T* __restrict__ vc,
    __half* __restrict__ ks, __half* __restrict__ vs,
    const int* __restrict__ table, float* __restrict__ out, int Hkv, int G,
    int Tn, int D, int C, int W, int n_blocks, int lmax, int slot,
    int offset, float scale) {
  extern __shared__ float smem_raw[];
  Smem sm(smem_raw, D);
  const int h = blockIdx.y, row0 = blockIdx.x * kRows;
  const int rows_all = G * Tn;
  const int R = min(kRows, rows_all - row0);
  const long long qoff =
      (static_cast<long long>(h) * rows_all + row0) * D;
  const long long stride = static_cast<long long>(Hkv) * D;

  // the destination of chunk token t's row of head h (element offset of
  // its first value), or -1 where the append drops it
  auto dest = [&](int t) -> long long {
    const long long pos = static_cast<long long>(offset) + t;
    if (table != nullptr) {
      const long long wb = pos / C;
      if (wb < W) {
        const int blk = table[wb];
        if (blk >= 0 && blk < n_blocks)
          return (static_cast<long long>(blk) * C + pos % C) * stride +
                 static_cast<long long>(h) * D;
      }
      return -1;
    }
    return pos < lmax ? (static_cast<long long>(slot) * lmax + pos) * stride +
                            static_cast<long long>(h) * D
                      : -1;
  };

  // 1. append: this block writes the chunk tokens t in [row0, row0 + R)
  //    that are < Tn (the g == 0 rows it holds), so every token of every
  //    head is written by exactly one block
  const int n_app = max(0, min(row0 + R, Tn) - row0);
  if constexpr (std::is_same_v<T, int8_t>) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    for (int r = warp; r < 2 * n_app; r += kWarps) {
      const int t = row0 + (r >> 1);
      const bool is_v = r & 1;
      float qv[kMaxD / 32];
      const __half sc = q8_row(
          (is_v ? vn : kn) + t * stride + static_cast<long long>(h) * D, D,
          lane, qv);
      const long long dst = dest(t);
      if (dst >= 0) {
        int8_t* data = is_v ? vc : kc;
#pragma unroll
        for (int j = 0; j < kMaxD / 32; ++j) {
          const int d = lane + 32 * j;
          if (d < D) data[dst + d] = static_cast<int8_t>(qv[j]);
        }
        if (lane == 0) (is_v ? vs : ks)[dst / D] = sc;
      }
    }
  } else {
    for (int e = threadIdx.x; e < n_app * D; e += kThreads) {
      const int t = row0 + e / D, d = e % D;
      const long long dst = dest(t);
      if (dst >= 0) {
        const long long src = static_cast<long long>(t) * stride +
                              static_cast<long long>(h) * D + d;
        kc[dst + d] = kn[src];
        vc[dst + d] = vn[src];
      }
    }
  }

  float acc[kAcc];
  init_rows(sm, q + qoff, R, D, acc);

  // 2. the written prefix: every row < offset is visible to every query
  for (int key0 = 0; key0 < offset; key0 += kKeys) {
    const int nk = min(kKeys, offset - key0);
    long long base;
    if (table != nullptr) {
      const int j = min(key0 / C, W - 1);
      const int blk = min(max(table[j], 0), n_blocks - 1);
      base = (static_cast<long long>(blk) * C + key0 % C) * stride +
             static_cast<long long>(h) * D;
    } else {
      base = (static_cast<long long>(slot) * lmax + key0) * stride +
             static_cast<long long>(h) * D;
    }
    if constexpr (std::is_same_v<T, int8_t>) {
      load_rows_q8(sm.k, D + 1, kc, ks, base, stride, nk, D);
      load_rows_q8(sm.v, D, vc, vs, base, stride, nk, D);
    } else {
      load_rows(sm.k, D + 1, kc, base, stride, nk, D);
      load_rows(sm.v, D, vc, base, stride, nk, D);
    }
    __syncthreads();
    fold(sm, R, D, nk, scale, [](int, int) { return true; }, acc);
  }

  // 3. the chunk's own rows under the intra-chunk causal mask
  const int t_hi = last_token(row0, R, Tn);
  for (int key0 = 0; key0 <= t_hi; key0 += kKeys) {
    const int nk = min(kKeys, Tn - key0);
    if constexpr (std::is_same_v<T, int8_t>) {
      q8_rows_to_tile(sm.k, D + 1, kn, key0, nk, stride, h, D);
      q8_rows_to_tile(sm.v, D, vn, key0, nk, stride, h, D);
    } else {
      const long long base = static_cast<long long>(key0) * stride +
                             static_cast<long long>(h) * D;
      load_rows(sm.k, D + 1, kn, base, stride, nk, D);
      load_rows(sm.v, D, vn, base, stride, nk, D);
    }
    __syncthreads();
    fold(sm, R, D, nk, scale,
         [&](int r, int s) { return key0 + s <= (row0 + r) % Tn; }, acc);
  }
  finish(sm, R, D, acc, out + qoff);
}

template <typename T, typename TN>
int launch(const void* q, const void* kn, const void* vn, void* kc, void* vc,
           void* ks, void* vs, const void* table, void* out, int Hkv, int G,
           int Tn, int D, int C, int W, int n_blocks, int lmax, int slot,
           int offset, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes(D);
  cudaError_t err = set_smem(prefill_kernel<T, TN>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((G * Tn + kRows - 1) / kRows, Hkv);
  prefill_kernel<T, TN><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const TN*>(kn),
      static_cast<const TN*>(vn), static_cast<T*>(kc), static_cast<T*>(vc),
      static_cast<__half*>(ks), static_cast<__half*>(vs),
      static_cast<const int*>(table), static_cast<float*>(out), Hkv, G, Tn,
      D, C, W, n_blocks, lmax, slot, offset, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace ptt

// dtype: 0 float32, 1 bfloat16, 2 float16 (the cache's; k_new/v_new are
// in it too), 3 int8 (k_new/v_new in float32; the caches' f16 scales
// [.., Hkv] in ks/vs, null for float caches).  q and out are f32
// [Hkv, G*T, D]; k_new/v_new [T, Hkv, D]; the cache is dense
// [B, lmax, Hkv, D] (table null, rows of `slot`) or a pool
// [n_blocks, C, Hkv, D] through the slot's table row [W].  offset must be
// a multiple of T.  Returns the launch's cudaError_t (0 = ok).
extern "C" int prefill_attention(int dtype, const void* q, const void* kn,
                                 const void* vn, void* kc, void* vc,
                                 void* ks, void* vs, const void* table,
                                 void* out, int Hkv, int G, int Tn, int D,
                                 int C, int W, int n_blocks, int lmax,
                                 int slot, int offset, float scale,
                                 void* stream) {
  if (D > ptt::kMaxD || C % ptt::kKeys != 0) return -1;
  if ((dtype == 3) != (ks != nullptr && vs != nullptr)) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return ptt::launch<float, float>(q, kn, vn, kc, vc, ks, vs, table, out,
                                       Hkv, G, Tn, D, C, W, n_blocks, lmax,
                                       slot, offset, scale, s);
    case 1:
      return ptt::launch<__nv_bfloat16, __nv_bfloat16>(
          q, kn, vn, kc, vc, ks, vs, table, out, Hkv, G, Tn, D, C, W,
          n_blocks, lmax, slot, offset, scale, s);
    case 2:
      return ptt::launch<__half, __half>(q, kn, vn, kc, vc, ks, vs, table,
                                         out, Hkv, G, Tn, D, C, W, n_blocks,
                                         lmax, slot, offset, scale, s);
    case 3:
      return ptt::launch<int8_t, float>(q, kn, vn, kc, vc, ks, vs, table,
                                        out, Hkv, G, Tn, D, C, W, n_blocks,
                                        lmax, slot, offset, scale, s);
    default:
      return -1;
  }
}
