// K8 — paged decode attention for Hopper (sm_90a).
//
// Replaces the TPU kernel fused_decode_attention
// (paddle_tpu/ops/paged_attention_pallas.py:195, body _fused_kernel :118)
// for float and int8 caches.  On the TPU the grid (B, Hkv, n_chunks) ran
// in order and carried the online-softmax state across chunks in VMEM
// scratch; here blocks run in parallel and in no order, so the chunk
// sweep is a loop inside one block: block (h, b, z) holds query rows
// [16 z, 16 z + 16) of the G*T rows of batch row b and kv head h, and
// walks that row's cache.
//
// What bounds it on the card: the bytes of LIVE KV.  Per step a decode
// row must read (length + T) rows of K and V for each kv head — at the
// serving shapes (bf16, Hkv 4, D 128) 2 KiB per token per layer — and
// does 4 flops per query row per key element, far below the card's
// ~295 flops-per-byte balance point, so the least time is live KV bytes
// over 3.35 TB/s; an int8 cache halves it: Hkv * (D + 2) * 2 bytes per
// token per layer (codes plus one f16 scale per (position, head) row),
// 1040 B at the serving shapes.  What the design does about it:
//   * per-row adaptive reads: a row reads only chunks i < ceil((eff+T)/C)
//     (eff = 0 for a slot parked at >= lmax, which reads chunk 0 only and
//     returns finite garbage — the reference's trip-count exclusion), and
//     inside them only the 32-key sub-tiles that hold a position some
//     query of the block can see;
//   * each K/V element is read from device memory once per block and
//     converted to f32 in shared memory — an int8 row as 16 codes per
//     16-byte load, times its f16 scale (the reference's dequant,
//     quant=True at :160-163, one exact product); the paged block table
//     and the scales go through the same indices; the table is read in
//     the kernel (physical block clamp(table[b, i], 0, N-1), the
//     reference's mode="clip" gather: a sentinel reads a real block whose
//     rows the mask discards).
// This first version is latency-bound, not bandwidth-bound: only
// B * Hkv blocks run at serving shapes (32 on 132 SMs), each walking its
// row's keys in sequence.  Splitting the key range across blocks (split-K
// with a combine pass), wgmma and TMA are later work.
#include <type_traits>

#include "attention_tile.cuh"

namespace ptt {

// T: the cache's element type (float, bf16, f16, or int8_t with the f16
// scales ks/vs; null for float caches).
template <typename T>
__global__ void __launch_bounds__(kThreads) paged_decode_kernel(
    const float* __restrict__ q, const T* __restrict__ kc,
    const T* __restrict__ vc, const __half* __restrict__ ks,
    const __half* __restrict__ vs, const int* __restrict__ table,
    const int* __restrict__ lengths, float* __restrict__ out, int Hkv, int G,
    int Tq, int D, int C, int n_chunks, int lmax, int n_blocks, float scale) {
  extern __shared__ float smem_raw[];
  Smem sm(smem_raw, D);
  const int h = blockIdx.x, b = blockIdx.y, row0 = blockIdx.z * kRows;
  const int rows_all = G * Tq;
  const int R = min(kRows, rows_all - row0);
  const long long qoff =
      (static_cast<long long>(b) * Hkv + h) * rows_all * D +
      static_cast<long long>(row0) * D;
  float acc[kAcc];
  init_rows(sm, q + qoff, R, D, acc);

  const int length = lengths[b];
  const int eff = length < lmax ? length : 0;
  const int n_iter = min((eff + Tq + C - 1) / C, n_chunks);
  // keys past the block's last query position are masked for every row:
  // skipping them leaves the running state bit-identical
  const long long qpos_hi =
      static_cast<long long>(length) + last_token(row0, R, Tq);
  const long long kv_end =
      min(static_cast<long long>(n_iter) * C, qpos_hi + 1);
  const long long stride = static_cast<long long>(Hkv) * D;

  for (int key0 = 0; key0 < kv_end; key0 += kKeys) {
    const int i = key0 / C;
    long long base;
    if (table != nullptr) {
      int blk = table[static_cast<long long>(b) * n_chunks + i];
      blk = min(max(blk, 0), n_blocks - 1);
      base = (static_cast<long long>(blk) * C + (key0 - i * C)) * stride +
             static_cast<long long>(h) * D;
    } else {
      base = (static_cast<long long>(b) * lmax + key0) * stride +
             static_cast<long long>(h) * D;
    }
    if constexpr (std::is_same_v<T, int8_t>) {
      load_rows_q8(sm.k, D + 1, kc, ks, base, stride, kKeys, D);
      load_rows_q8(sm.v, D, vc, vs, base, stride, kKeys, D);
    } else {
      load_rows(sm.k, D + 1, kc, base, stride, kKeys, D);
      load_rows(sm.v, D, vc, base, stride, kKeys, D);
    }
    __syncthreads();
    fold(sm, R, D, kKeys, scale,
         [&](int r, int s) {
           return static_cast<long long>(key0 + s) <=
                  static_cast<long long>(length) + (row0 + r) % Tq;
         },
         acc);
  }
  finish(sm, R, D, acc, out + qoff);
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* ks,
           const void* vs, const void* table, const void* lengths, void* out,
           int B, int Hkv, int G, int Tq, int D, int C, int n_chunks,
           int lmax, int n_blocks, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes(D);
  cudaError_t err = set_smem(paged_decode_kernel<T>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(Hkv, B, (G * Tq + kRows - 1) / kRows);
  paged_decode_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const __half*>(ks),
      static_cast<const __half*>(vs), static_cast<const int*>(table),
      static_cast<const int*>(lengths), static_cast<float*>(out), Hkv, G, Tq,
      D, C, n_chunks, lmax, n_blocks, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace ptt

// dtype: 0 float32, 1 bfloat16, 2 float16, 3 int8 (the cache's; int8
// caches pass their f16 scales [.., Hkv] in ks/vs, float caches null).
// q and out are f32 [B, Hkv, G*T, D]; the cache is dense [B, lmax, Hkv, D]
// (table null) or a pool [n_blocks, C, Hkv, D] read through table
// [B, n_chunks].  Returns the launch's cudaError_t (0 = launched).
extern "C" int paged_decode_attention(int dtype, const void* q, const void* k,
                                      const void* v, const void* ks,
                                      const void* vs, const void* table,
                                      const void* lengths, void* out, int B,
                                      int Hkv, int G, int Tq, int D, int C,
                                      int n_chunks, int lmax, int n_blocks,
                                      float scale, void* stream) {
  if (D > ptt::kMaxD || C % ptt::kKeys != 0) return -1;
  if ((dtype == 3) != (ks != nullptr && vs != nullptr)) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return ptt::launch<float>(q, k, v, ks, vs, table, lengths, out, B, Hkv,
                                G, Tq, D, C, n_chunks, lmax, n_blocks, scale,
                                s);
    case 1:
      return ptt::launch<__nv_bfloat16>(q, k, v, ks, vs, table, lengths, out,
                                        B, Hkv, G, Tq, D, C, n_chunks, lmax,
                                        n_blocks, scale, s);
    case 2:
      return ptt::launch<__half>(q, k, v, ks, vs, table, lengths, out, B, Hkv,
                                 G, Tq, D, C, n_chunks, lmax, n_blocks, scale,
                                 s);
    case 3:
      return ptt::launch<int8_t>(q, k, v, ks, vs, table, lengths, out, B, Hkv,
                                 G, Tq, D, C, n_chunks, lmax, n_blocks, scale,
                                 s);
    default:
      return -1;
  }
}
