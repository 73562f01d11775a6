// K9 — fused chunked-prefill attention + KV append for Hopper (sm_90a).
//
// Replaces the TPU kernel fused_prefill_attention
// (paddle_tpu/ops/prefill_attention_pallas.py:328, body _prefill_kernel
// :102) for float and int8 caches.  One admission chunk of T prompt tokens: every
// query sees the slot's written prefix (positions < offset) plus the
// chunk's own causal triangle, and the chunk's K/V rows are appended to
// the cache in place — into the paged pool through the slot's table row,
// or into the slot's dense row.  On the TPU the grid (Hkv, n_chunks)
// swept the prefix with double-buffered DMAs per kv head; here blocks
// hold row tiles of kv head h's query rows g*T + t (16 in the CUDA-core
// template, 64 in the tensor-core one), so many blocks share the work
// instead of Hkv.
//
// What bounds it on the card: for a long prefix, the bytes of the prefix
// KV (offset rows of K and V per kv head); for a short one, the
// operations of the T x (offset + T) score and value products (4 flops
// per query row, key and dim: 1.88 GFLOP at T 256, offset 768, 16 heads,
// D 128 — 1.9 us on the tensor cores).  Two instances: bf16 queries over
// a bf16 or int8 cache at head_dim 64/128 (the serving path) run both
// products on the tensor cores (the `tc` instance below, with its own
// note); every other dtype and head_dim runs this CUDA-core template, in
// which every block reads the prefix in 32-key sub-tiles converted to
// f32 in shared memory, once per 16 query rows.  Both read the chunk's
// own rows from the k_new/v_new inputs instead of from the cache, so the
// append and the attention never depend on each other inside the launch.
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
#include "flash_tile.cuh"

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

// ------------------------------------------ tensor-core instance (bf16 q)
// The same function for bf16 queries over a bf16 or int8 cache at
// head_dim 64/128 (the serving width), with both products on the tensor
// cores: mma.sync m16n8k16, bf16 in, f32 accumulate (flash_tile.cuh's
// ptf::mma fragments, as K1).  The key sweep is one sequence of 64-key
// tiles: the written prefix (rows < offset, from the cache) then the
// chunk's own rows (from k_new/v_new, key <= t), arriving by 16-byte
// cp.async in their own dtype, two tiles at a time into a ring of two
// such pairs.  CTA (z, h, sp) holds 64 query rows of kv head h's G*T row
// space (rows g*T + t) and folds the pairs sp, sp + 2, ... of the sweep;
// within it, warp w holds rows 16 (w % 4) .. + 16 (their q fragments in
// registers for the whole sweep) and folds the pair's first tile (w < 4)
// or its second (w >= 4) into its own online softmax.  The two warp
// groups' states merge through shared memory, the two CTAs' through an
// f32 workspace: the last to finish (an atomic ticket after a
// __threadfence) merges them in split order and resets the ticket, so
// the output is bitwise the same run to run.  At T 256 that is 128 CTAs
// of 8 warps; one CTA of 4 warps per 64-row tile left half the SMs idle,
// and 32-row tiles (more CTAs) paid a whole tile's loads for half the
// rows — both measured slower on the card.  q is read in its [T, H, D]
// layout and the output written there in bf16, rounded once to nearest
// from the f32 result — what the CUDA-core path's permute, widen and
// cast passes in the wrapper did.
//
// Exactness against the reference, which forms q.k and p.v in f32:
//   * q.k: bf16 q times bf16 K is an exact product, summed in f32 by the
//     tensor core.  An int8 cache puts the codes in the bf16 operand
//     (exact for |code| <= 127) and multiplies each score column by its
//     key's f32 scale after the product: only the rounding order moves.
//   * p.v: p is f32 in the reference, so p = hi + mid + lo, three bf16
//     values that hold all of its 24 bits (each remainder is exact in
//     f32), three products.  Rounding p to bf16 once would put outputs
//     where values cancel past 2 bf16 ulps; hi + lo alone (16 bits) still
//     left some beyond 1e-6 on the card.  An int8 cache folds each value
//     row's scale into p in f32 first, then splits.
//   * the tensor core aligns the addends of one mma to the largest (the
//     accumulator, when it carries a running sum) and drops the bits
//     below it: so no mma chain carries a running sum — a score's 32-dim
//     partials and a tile's 64-key P·V start from zero and are added in
//     f32, rounded to nearest.
//   * l sums the unrounded p, masked keys get p = 0 exactly (score
//     -inf), out = acc / max(l, 1e-30).
// The chunk's rows of an int8 cache are quantized from the staged bf16
// rows, 8 lanes a row (q8_row8: bitwise _q8_quantize), and attend
// through their codes and scales; the CTA that owns tokens
// [row0, row0 + 64) writes them to the cache from the same registers
// (codes and f16 scale, or the bf16 rows straight from the stage), under
// the same drop rules as the CUDA-core path.  The CTA that stages a
// chunk tile appends it (one split of the row tile holding the tokens).
namespace tc {

using bf16 = __nv_bfloat16;
using ptf::mma::ld32;
using ptf::mma::mma16816;
using ptf::mma::pack;

constexpr int kKeys = 64;                 // keys a tile
constexpr int kRows = 64;                 // query rows a CTA
constexpr int kGroupWarps = kRows / 16;   // warps of a key group
constexpr int kWarps = 2 * kGroupWarps;   // two key groups: even, odd tiles
constexpr int kThreads = 32 * kWarps;
constexpr int kSplits = 2;                // CTAs sharing a row tile's keys
static_assert(kThreads >= 2 * kKeys, "a thread stages a key's scales");

// every shared tile row: D bf16 plus 16 bytes (conflict-free fragment
// loads and ldmatrix rows)
template <int D>
constexpr int kRowBytes = 2 * D + 16;

// Shared memory (bytes): the ring [4 stages][K, V][kKeys][row] of raw rows
// (the cache dtype for prefix tiles, bf16 for the chunk's), a pair of
// tiles in stages 2p, 2p+1; for int8 the bf16 operand tiles
// [2][K, V][kKeys][row] of the pair being folded, the staged scales f32
// [2 pairs][2 tiles][K, V][kKeys] and the folded pair's f32
// [2 tiles][K, V][kKeys]; the slot's pool blocks int [W].  The q tile is
// read through stage 2 before the ring starts, and the two key groups'
// states meet in stage 0 after it ends.
template <bool Q8, int D>
struct Layout {
  size_t ops, staged, cur, tab, bytes;
  __host__ __device__ explicit Layout(int W) {
    constexpr size_t tile = size_t{kKeys} * kRowBytes<D>;
    ops = 8 * tile;
    staged = ops + (Q8 ? 4 * tile : 0);
    cur = staged + sizeof(float) * 8 * kKeys;
    tab = cur + sizeof(float) * 4 * kKeys;
    bytes = tab + sizeof(int) * static_cast<size_t>(W);
  }
};

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<const uint32_t*>(&v);
}

// p = hi + mid + lo for two f32 values: the bf16 pairs (a, b) of each
// part; a - hi and its remainder after mid are exact in f32
__device__ __forceinline__ void split3(float a, float b, uint32_t& hi,
                                       uint32_t& mid, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  const float ra = a - hf.x, rb = b - hf.y;
  const __nv_bfloat162 m = __floats2bfloat162_rn(ra, rb);
  const float2 mf = __bfloat1622float2(m);
  hi = bits(h);
  mid = bits(m);
  lo = pack(ra - mf.x, rb - mf.y);
}

// four int8 codes (one word, code i in byte i) -> their bf16 values, two
// pairs: the f32 2^23 + 128 + c, its low byte c + 128 put in by a byte
// permutation, minus 2^23 + 128, is c exactly; a small integer's f32 has
// a zero low half, so its high half is the bf16
__device__ __forceinline__ void codes_bf16(uint32_t w, uint32_t& lo,
                                           uint32_t& hi) {
  const uint32_t x = w ^ 0x80808080u;   // bytes c + 128
  uint32_t f[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    f[i] = __float_as_uint(
        __uint_as_float(__byte_perm(x, 0x4B000000u, 0x7440 | i)) -
        8388736.f);
  lo = __byte_perm(f[0], f[1], 0x7632);
  hi = __byte_perm(f[2], f[3], 0x7632);
}

// The reference's _q8_quantize of one row of D bf16 values by 8 lanes:
// lane8 = lane & 7 holds d = lane8 * D/8 + i (a 16-byte aligned run).
// The same operations as q8_row (amax, f16(amax * f32(1/127)), codes
// through the reciprocal of the f16 scale, rint, clip), so the same bits.
// Returns the scale; q[i] the codes.
template <int D>
__device__ __forceinline__ __half q8_row8(const bf16* x, int lane8,
                                          float (&q)[D / 8]) {
  constexpr int N = D / 8;
  float amax = 0.f;
#pragma unroll
  for (int v = 0; v < N / 8; ++v) {
    const uint4 w = reinterpret_cast<const uint4*>(x + lane8 * N)[v];
    const uint32_t u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&u[i]));
      q[8 * v + 2 * i] = f.x;
      q[8 * v + 2 * i + 1] = f.y;
    }
  }
#pragma unroll
  for (int i = 0; i < N; ++i) amax = fmaxf(amax, fabsf(q[i]));
#pragma unroll
  for (int o = 4; o > 0; o >>= 1)   // within the aligned group of 8 lanes
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  const __half sc = __float2half_rn(__fmul_rn(amax, 1.f / 127.f));
  const float inv = __fdiv_rn(1.f, fmaxf(__half2float(sc), 1e-8f));
#pragma unroll
  for (int i = 0; i < N; ++i)
    q[i] = fminf(fmaxf(rintf(__fmul_rn(q[i], inv)), -127.f), 127.f);
  return sc;
}

// T: the cache's element type, bf16 or int8_t (f16 scales ks/vs).
// k_new/v_new are bf16 [Tn, Hkv, D]; q and out bf16 [Tn, H, D].
template <typename T, int D>
__global__ void __launch_bounds__(kThreads) prefill_mma_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ kn,
    const bf16* __restrict__ vn, T* __restrict__ kc, T* __restrict__ vc,
    __half* __restrict__ ks, __half* __restrict__ vs,
    const int* __restrict__ table, bf16* __restrict__ out,
    float* __restrict__ ws_o, float* __restrict__ ws_ml,
    int* __restrict__ tickets, int Hkv, int G, int Tn, int C, int W,
    int n_blocks, int lmax, int slot, int offset, float scale) {
  constexpr bool kQ8 = std::is_same_v<T, int8_t>;
  constexpr int RB = kRowBytes<D>, LE = RB / 2;   // row: bytes, bf16s
  constexpr int KD = D / 16, ND = D / 8, NT = kKeys / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout<kQ8, D> lay(W);
  // stage st's K (kv 0) or V (kv 1) rows
  auto stage = [&](int st, int kv) {
    return smem + static_cast<size_t>(2 * st + kv) * kKeys * RB;
  };
  // the int8 instance's bf16 operand tile of pair slot i, K or V
  auto ops = [&](int i, int kv) {
    return reinterpret_cast<bf16*>(smem + lay.ops) + (2 * i + kv) * kKeys * LE;
  };
  float* staged = reinterpret_cast<float*>(smem + lay.staged);
  float* cur = reinterpret_cast<float*>(smem + lay.cur);
  int* tab = reinterpret_cast<int*>(smem + lay.tab);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const int grp = warp / kGroupWarps;   // key group: even or odd tiles
  const int h = blockIdx.y, row0 = blockIdx.x * kRows, sp = blockIdx.z;
  const int rows_all = G * Tn, H = Hkv * G;
  const int R = min(kRows, rows_all - row0);
  const long long stride = static_cast<long long>(Hkv) * D;

  // the destination of chunk token t's row of head h, or -1 (dropped)
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
  // the CTA that stages a chunk tile appends its tokens among its rows
  // (the g = 0 rows)
  auto owns = [&](int t) { return t >= row0 && t < row0 + kRows && t < Tn; };
  // element offset of prefix key pos's row of head h
  auto prow = [&](int pos) -> long long {
    if (table != nullptr) {
      const int pg = pos / C;
      return (static_cast<long long>(tab[pg]) * C + (pos - pg * C)) * stride +
             static_cast<long long>(h) * D;
    }
    return (static_cast<long long>(slot) * lmax + pos) * stride +
           static_cast<long long>(h) * D;
  };

  const int n_pre = (offset + kKeys - 1) / kKeys;
  const int n_tiles = n_pre + last_token(row0, R, Tn) / kKeys + 1;
  // this CTA's pairs of tiles: sp, sp + kSplits, ... of n_pairs
  const int n_pairs = (n_tiles + 1) / 2;
  const int n_split = min(kSplits, n_pairs);
  if (sp >= n_split) return;
  const int n_local = (n_pairs - sp + kSplits - 1) / kSplits;
  // tile it: prefix or chunk, its first key and how many keys it holds
  auto tile_keys = [&](int it, int& key0) {
    const bool pre = it < n_pre;
    key0 = (pre ? it : it - n_pre) * kKeys;
    return min(kKeys, pre ? offset - key0 : Tn - key0);
  };

  // the q tile (zero past the last row) and the slot's pool blocks
  bf16* qs = reinterpret_cast<bf16*>(stage(2, 0));
  for (int e = tid; e < kRows * (D / 8); e += kThreads) {
    const int rr = e / (D / 8), c = e - rr * (D / 8), row = row0 + rr;
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (row < rows_all) {
      const int g = row / Tn, t = row - g * Tn;
      x = *reinterpret_cast<const uint4*>(
          q + (static_cast<long long>(t) * H + h * G + g) * D + 8 * c);
    }
    *reinterpret_cast<uint4*>(qs + rr * LE + 8 * c) = x;
  }
  if (table != nullptr)
    for (int i = tid; i < min(W, (offset + C - 1) / C); i += kThreads)
      tab[i] = min(max(table[i], 0), n_blocks - 1);
  __syncthreads();
  const int lo = 16 * (warp % kGroupWarps) + gq, hi = lo + 8;   // its rows
  uint32_t qa[KD][4];
#pragma unroll
  for (int kk = 0; kk < KD; ++kk) {
    qa[kk][0] = ld32(qs + lo * LE + 16 * kk + 2 * tq);
    qa[kk][1] = ld32(qs + hi * LE + 16 * kk + 2 * tq);
    qa[kk][2] = ld32(qs + lo * LE + 16 * kk + 8 + 2 * tq);
    qa[kk][3] = ld32(qs + hi * LE + 16 * kk + 8 + 2 * tq);
  }
  const int t_lo = (row0 + lo) % Tn, t_hi = (row0 + hi) % Tn;
  __syncthreads();   // stage 2 is the ring's from here

  // stage the tiles of pair p (cp.async of their rows, zero past each
  // tile's keys); for an int8 prefix tile returns this thread's scale —
  // thread i < 2 kKeys stages tile 2p + i / kKeys, key i % kKeys, K and V
  auto issue = [&](int p) -> float2 {
    float2 sc = make_float2(0.f, 0.f);
    for (int i = 0; i < 2; ++i) {
      const int it = 2 * (sp + kSplits * p) + i;
      if (it >= n_tiles) break;
      unsigned char* kd = stage(2 * (p & 1) + i, 0);
      unsigned char* vd = stage(2 * (p & 1) + i, 1);
      const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
      int key0;
      const int nk = tile_keys(it, key0);
      if (it < n_pre) {
        constexpr int EPV = 16 / sizeof(T), NV = D / EPV;
        for (int e = tid; e < kKeys * NV; e += kThreads) {
          const int s = e / NV, c = e - s * NV;
          if (s < nk) {
            const long long src = prow(key0 + s) + c * EPV;
            cp_async16(kd + s * RB + 16 * c, kc + src);
            cp_async16(vd + s * RB + 16 * c, vc + src);
          } else {
            *reinterpret_cast<uint4*>(kd + s * RB + 16 * c) = zero;
            *reinterpret_cast<uint4*>(vd + s * RB + 16 * c) = zero;
          }
        }
        if constexpr (kQ8) {
          const int s = tid - i * kKeys;
          if (s >= 0 && s < nk) {
            const long long r = prow(key0 + s) / D;
            sc = make_float2(__half2float(ks[r]), __half2float(vs[r]));
          }
        }
      } else {
        for (int e = tid; e < kKeys * (D / 8); e += kThreads) {
          const int s = e / (D / 8), c = e - s * (D / 8);
          if (s < nk) {
            const long long src =
                (static_cast<long long>(key0 + s) * Hkv + h) * D + 8 * c;
            cp_async16(kd + s * RB + 16 * c, kn + src);
            cp_async16(vd + s * RB + 16 * c, vn + src);
          } else {
            *reinterpret_cast<uint4*>(kd + s * RB + 16 * c) = zero;
            *reinterpret_cast<uint4*>(vd + s * RB + 16 * c) = zero;
          }
        }
      }
    }
    cp_async_commit();
    return sc;
  };
  // staged[pair slot][tile i][K, V][key]
  auto put_scales = [&](int ps, float2 sc) {
    if (kQ8 && tid < 2 * kKeys) {
      float* st = staged + ps * 4 * kKeys + (tid / kKeys) * 2 * kKeys;
      st[tid % kKeys] = sc.x;
      st[kKeys + tid % kKeys] = sc.y;
    }
  };

  float m_lo = kNegInf, m_hi = kNegInf, l_lo = 0.f, l_hi = 0.f;
  float o[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;

  put_scales(0, issue(0));
  for (int p = 0; p < n_local; ++p) {
    const float2 sc_next = issue(p + 1);
    cp_async_wait<1>();
    __syncthreads();
    // int8: the pair's codes -> bf16 operand tiles, the chunk's rows
    // quantized (the owned ones appended); bf16: the chunk's owned rows
    // appended straight from the stage
    for (int i = 0; i < 2; ++i) {
      const int it = 2 * (sp + kSplits * p) + i;
      if (it >= n_tiles) break;
      int key0;
      const int nk = tile_keys(it, key0);
      const unsigned char* kr = stage(2 * (p & 1) + i, 0);
      const unsigned char* vr = stage(2 * (p & 1) + i, 1);
      if constexpr (kQ8) {
        float* ci = cur + i * 2 * kKeys;
        if (it < n_pre) {
          for (int e = tid; e < 2 * kKeys * (D / 16); e += kThreads) {
            const int kv = e / (kKeys * (D / 16)), r = e % (kKeys * (D / 16));
            const int s = r / (D / 16), c = r - s * (D / 16);
            const uint4 x = *reinterpret_cast<const uint4*>(
                (kv ? vr : kr) + s * RB + 16 * c);
            uint4 y0, y1;
            codes_bf16(x.x, y0.x, y0.y);
            codes_bf16(x.y, y0.z, y0.w);
            codes_bf16(x.z, y1.x, y1.y);
            codes_bf16(x.w, y1.z, y1.w);
            uint4* dst =
                reinterpret_cast<uint4*>(ops(i, kv) + s * LE + 16 * c);
            dst[0] = y0;
            dst[1] = y1;
          }
          for (int j = tid; j < 2 * kKeys; j += kThreads)
            ci[j] = staged[(p & 1) * 4 * kKeys + i * 2 * kKeys + j];
        } else {   // 8 lanes a row, 4 rows a warp at once
          constexpr int N = D / 8;
          const int lane8 = lane & 7;
          for (int rr = 4 * warp + (lane >> 3); rr < 2 * kKeys;
               rr += 4 * kWarps) {
            const int kv = rr & 1, s = rr >> 1, t = key0 + s;
            float qv[N];
            const __half sc = q8_row8<D>(
                reinterpret_cast<const bf16*>((kv ? vr : kr) + s * RB), lane8,
                qv);
            uint32_t w[N / 2];
#pragma unroll
            for (int j = 0; j < N / 2; ++j)
              w[j] = pack(qv[2 * j], qv[2 * j + 1]);
            uint4* dst =
                reinterpret_cast<uint4*>(ops(i, kv) + s * LE + lane8 * N);
#pragma unroll
            for (int v = 0; v < N / 8; ++v)
              dst[v] = make_uint4(w[4 * v], w[4 * v + 1], w[4 * v + 2],
                                  w[4 * v + 3]);
            if (lane8 == 0) ci[kv * kKeys + s] = __half2float(sc);
            const long long dg = s < nk && owns(t) ? dest(t) : -1;
            if (dg >= 0) {
              int8_t* data = reinterpret_cast<int8_t*>(kv ? vc : kc) + dg +
                             lane8 * N;
#pragma unroll
              for (int j = 0; j < N; ++j)
                data[j] = static_cast<int8_t>(qv[j]);
              if (lane8 == 0) (kv ? vs : ks)[dg / D] = sc;
            }
          }
        }
      } else if (it >= n_pre) {
        for (int e = tid; e < nk * (D / 8); e += kThreads) {
          const int s = e / (D / 8), c = e - s * (D / 8), t = key0 + s;
          const long long dg = owns(t) ? dest(t) : -1;
          if (dg >= 0) {
            *reinterpret_cast<uint4*>(kc + dg + 8 * c) =
                *reinterpret_cast<const uint4*>(kr + s * RB + 16 * c);
            *reinterpret_cast<uint4*>(vc + dg + 8 * c) =
                *reinterpret_cast<const uint4*>(vr + s * RB + 16 * c);
          }
        }
      }
    }
    if constexpr (kQ8) __syncthreads();

    // this warp group's tile of the pair
    const int it = 2 * (sp + kSplits * p) + grp;
    if (it < n_tiles) {
      int key0;
      const int nk = tile_keys(it, key0);
      const bool pre = it < n_pre;
      const float* ci = cur + grp * 2 * kKeys;
      const bf16* kt = kQ8 ? ops(grp, 0)
                           : reinterpret_cast<const bf16*>(
                                 stage(2 * (p & 1) + grp, 0));
      const bf16* vt = kQ8 ? ops(grp, 1)
                           : reinterpret_cast<const bf16*>(
                                 stage(2 * (p & 1) + grp, 1));

      // S = q.K^T, 32 dims an mma chain from zero, summed in f32
      float s[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
        const bf16* krow = kt + (8 * j + gq) * LE + 2 * tq;
#pragma unroll
        for (int kk = 0; kk < KD; kk += 2) {
          float d4[4] = {0.f, 0.f, 0.f, 0.f};
          mma16816(d4, qa[kk], ld32(krow + 16 * kk),
                   ld32(krow + 16 * kk + 8));
          mma16816(d4, qa[kk + 1], ld32(krow + 16 * kk + 16),
                   ld32(krow + 16 * kk + 24));
#pragma unroll
          for (int e = 0; e < 4; ++e) s[j][e] += d4[e];
        }
      }
      // scales, masks, the online softmax (a row's 4 lanes: shuffles)
      float mx_lo = ptf::neg_inf(), mx_hi = ptf::neg_inf();
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = 8 * j + 2 * tq + (e & 1);
          float v = s[j][e];
          if constexpr (kQ8) v *= ci[col];
          const bool vis =
              pre ? col < nk : key0 + col <= (e < 2 ? t_lo : t_hi);
          s[j][e] = vis ? v * scale : ptf::neg_inf();
        }
        mx_lo = fmaxf(mx_lo, fmaxf(s[j][0], s[j][1]));
        mx_hi = fmaxf(mx_hi, fmaxf(s[j][2], s[j][3]));
      }
#pragma unroll
      for (int x = 1; x <= 2; x <<= 1) {
        mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, x));
        mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, x));
      }
      const float mn_lo = fmaxf(m_lo, mx_lo), mn_hi = fmaxf(m_hi, mx_hi);
      float sum_lo = 0.f, sum_hi = 0.f;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        s[j][0] = expf(s[j][0] - mn_lo);
        s[j][1] = expf(s[j][1] - mn_lo);
        s[j][2] = expf(s[j][2] - mn_hi);
        s[j][3] = expf(s[j][3] - mn_hi);
        sum_lo += s[j][0] + s[j][1];
        sum_hi += s[j][2] + s[j][3];
      }
#pragma unroll
      for (int x = 1; x <= 2; x <<= 1) {
        sum_lo += __shfl_xor_sync(0xffffffffu, sum_lo, x);
        sum_hi += __shfl_xor_sync(0xffffffffu, sum_hi, x);
      }
      const float c_lo = expf(m_lo - mn_lo), c_hi = expf(m_hi - mn_hi);
      l_lo = l_lo * c_lo + sum_lo;
      l_hi = l_hi * c_hi + sum_hi;
      m_lo = mn_lo;
      m_hi = mn_hi;
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        o[n][0] *= c_lo;
        o[n][1] *= c_lo;
        o[n][2] *= c_hi;
        o[n][3] *= c_hi;
      }
      // O += P·V with p = hi + mid + lo (an int8 row's scale folded in
      // first): the tile's 64 keys an mma chain from zero, added to O in
      // f32; V's B fragments by ldmatrix.trans from its row-major tile
      uint32_t a3[kKeys / 16][3][4];
#pragma unroll
      for (int kk = 0; kk < kKeys / 16; ++kk) {
        float pp[2][4];
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            pp[hf][e] = s[2 * kk + hf][e];
            if constexpr (kQ8)
              pp[hf][e] *= ci[kKeys + 16 * kk + 8 * hf + 2 * tq + (e & 1)];
          }
        }
        split3(pp[0][0], pp[0][1], a3[kk][0][0], a3[kk][1][0], a3[kk][2][0]);
        split3(pp[0][2], pp[0][3], a3[kk][0][1], a3[kk][1][1], a3[kk][2][1]);
        split3(pp[1][0], pp[1][1], a3[kk][0][2], a3[kk][1][2], a3[kk][2][2]);
        split3(pp[1][2], pp[1][3], a3[kk][0][3], a3[kk][1][3], a3[kk][2][3]);
      }
      const bf16* vrow = vt + ((lane & 7) + 8 * ((lane >> 3) & 1)) * LE +
                         8 * (lane >> 4);
#pragma unroll
      for (int n = 0; n < ND; n += 2) {
        float t0[4] = {0.f, 0.f, 0.f, 0.f}, t1[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int kk = 0; kk < kKeys / 16; ++kk) {
          uint32_t bv[4];
          ldsm_x4_trans(bv, vrow + 16 * kk * LE + 8 * n);
#pragma unroll
          for (int part = 0; part < 3; ++part) {
            mma16816(t0, a3[kk][part], bv[0], bv[1]);
            mma16816(t1, a3[kk][part], bv[2], bv[3]);
          }
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          o[n][e] += t0[e];
          o[n + 1][e] += t1[e];
        }
      }
    }
    put_scales((p + 1) & 1, sc_next);
    __syncthreads();   // the pair's stages (and operand tiles) refill next
  }

  // the odd-tile group hands its state to the even one through stage 0
  float* xs = reinterpret_cast<float*>(stage(0, 0)) +
              (tid % (32 * kGroupWarps)) * (4 * ND + 4);
  if (grp == 1) {
#pragma unroll
    for (int n = 0; n < ND; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) xs[4 * n + e] = o[n][e];
    xs[4 * ND] = m_lo;
    xs[4 * ND + 1] = m_hi;
    xs[4 * ND + 2] = l_lo;
    xs[4 * ND + 3] = l_hi;
  }
  __syncthreads();
  if (grp == 0) {   // (m, l, o) of the CTA's keys, o unnormalised
    const float om_lo = xs[4 * ND], om_hi = xs[4 * ND + 1];
    const float mm_lo = fmaxf(m_lo, om_lo), mm_hi = fmaxf(m_hi, om_hi);
    // a group that saw no key of a row (m = -1e30, l = 0) weighs exactly 0
    const float w_lo = m_lo == kNegInf ? 0.f : expf(m_lo - mm_lo);
    const float w_hi = m_hi == kNegInf ? 0.f : expf(m_hi - mm_hi);
    const float x_lo = om_lo == kNegInf ? 0.f : expf(om_lo - mm_lo);
    const float x_hi = om_hi == kNegInf ? 0.f : expf(om_hi - mm_hi);
    l_lo = l_lo * w_lo + xs[4 * ND + 2] * x_lo;
    l_hi = l_hi * w_hi + xs[4 * ND + 3] * x_hi;
    m_lo = mm_lo;
    m_hi = mm_hi;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      o[n][0] = o[n][0] * w_lo + xs[4 * n] * x_lo;
      o[n][1] = o[n][1] * w_lo + xs[4 * n + 1] * x_lo;
      o[n][2] = o[n][2] * w_hi + xs[4 * n + 2] * x_hi;
      o[n][3] = o[n][3] * w_hi + xs[4 * n + 3] * x_hi;
    }
  }

  // more than one CTA on these rows: each writes its partial, the last
  // (an atomic ticket after a __threadfence) merges them in split order
  // and resets the ticket
  const long long zh = static_cast<long long>(h) * gridDim.x + blockIdx.x;
  if (n_split > 1) {
    if (grp == 0) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const long long u = (zh * kSplits + sp) * kRows + (half ? hi : lo);
#pragma unroll
        for (int n = 0; n < ND; ++n)
          *reinterpret_cast<float2*>(ws_o + u * D + 8 * n + 2 * tq) =
              make_float2(o[n][2 * half], o[n][2 * half + 1]);
        if (tq == 0)
          *reinterpret_cast<float2*>(ws_ml + 2 * u) =
              make_float2(half ? m_hi : m_lo, half ? l_hi : l_lo);
      }
    }
    __shared__ int last;
    __threadfence();
    __syncthreads();
    if (tid == 0) last = atomicAdd(&tickets[zh], 1) == n_split - 1;
    __syncthreads();
    if (!last) return;
    __threadfence();
    if (grp == 0) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const long long u0 = zh * kSplits * kRows + (half ? hi : lo);
        float mx = kNegInf;
        for (int j = 0; j < n_split; ++j)
          mx = fmaxf(mx, __ldcg(ws_ml + 2 * (u0 + j * kRows)));
        float lsum = 0.f;
#pragma unroll
        for (int n = 0; n < ND; ++n) o[n][2 * half] = o[n][2 * half + 1] = 0.f;
        for (int j = 0; j < n_split; ++j) {
          const long long u = u0 + j * kRows;
          const float mj = __ldcg(ws_ml + 2 * u);
          const float w = mj == kNegInf ? 0.f : expf(mj - mx);
          lsum += w * __ldcg(ws_ml + 2 * u + 1);
#pragma unroll
          for (int n = 0; n < ND; ++n) {
            const float2 v =
                __ldcg(reinterpret_cast<const float2*>(ws_o + u * D + 8 * n +
                                                       2 * tq));
            o[n][2 * half] += w * v.x;
            o[n][2 * half + 1] += w * v.y;
          }
        }
        (half ? l_hi : l_lo) = lsum;
      }
    }
    if (tid == 0) tickets[zh] = 0;
  }

  if (grp == 0) {
    const float d_lo = fmaxf(l_lo, 1e-30f), d_hi = fmaxf(l_hi, 1e-30f);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = row0 + (half ? hi : lo);
      if (row >= rows_all) continue;
      const int g = row / Tn, t = row - g * Tn;
      bf16* dst = out + (static_cast<long long>(t) * H + h * G + g) * D;
      const float den = half ? d_hi : d_lo;
#pragma unroll
      for (int n = 0; n < ND; ++n)
        *reinterpret_cast<uint32_t*>(dst + 8 * n + 2 * tq) =
            pack(o[n][2 * half] / den, o[n][2 * half + 1] / den);
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* kn, const void* vn, void* kc, void* vc,
           void* ks, void* vs, const void* table, void* out, void* ws_o,
           void* ws_ml, void* tickets, int Hkv, int G, int Tn, int C, int W,
           int n_blocks, int lmax, int slot, int offset, float scale,
           cudaStream_t stream) {
  const size_t smem =
      Layout<std::is_same_v<T, int8_t>, D>(table != nullptr ? W : 0).bytes;
  cudaError_t err = set_smem(prefill_mma_kernel<T, D>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((G * Tn + kRows - 1) / kRows, Hkv, kSplits);
  prefill_mma_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(kn),
      static_cast<const bf16*>(vn), static_cast<T*>(kc), static_cast<T*>(vc),
      static_cast<__half*>(ks), static_cast<__half*>(vs),
      static_cast<const int*>(table), static_cast<bf16*>(out),
      static_cast<float*>(ws_o), static_cast<float*>(ws_ml),
      static_cast<int*>(tickets), Hkv, G, Tn, C, W, n_blocks, lmax, slot,
      offset, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

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

// The tensor-core instance: dtype 1 bfloat16 or 3 int8 (the cache's), q
// and out bf16 [T, H, D] (H = Hkv * G, query head h * G + g), k_new and
// v_new bf16 [T, Hkv, D], head_dim 64 or 128, every pointer 16-byte
// aligned; ws_o f32 [Hkv, ceil(G*T/64), 2, 64, D] and ws_ml f32 [.., 64, 2]
// hold the two key splits' partials, tickets int32 [Hkv, ceil(G*T/64)]
// (zero, and left zero); the rest as prefill_attention.  Returns the launch's
// cudaError_t (0 = ok).
extern "C" int prefill_attention_mma(int dtype, const void* q,
                                     const void* kn, const void* vn,
                                     void* kc, void* vc, void* ks, void* vs,
                                     const void* table, void* out,
                                     void* ws_o, void* ws_ml, void* tickets,
                                     int Hkv, int G, int Tn, int D, int C,
                                     int W, int n_blocks, int lmax, int slot,
                                     int offset, float scale, void* stream) {
  if (C % ptt::kKeys != 0) return -1;
  if ((dtype == 3) != (ks != nullptr && vs != nullptr)) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PTT_K9_MMA(T, DD)                                                 \
  ptt::tc::launch<T, DD>(q, kn, vn, kc, vc, ks, vs, table, out, ws_o,     \
                         ws_ml, tickets, Hkv, G, Tn, C, W, n_blocks, lmax, \
                         slot, offset, scale, s)
  if (dtype == 1 && D == 64) return PTT_K9_MMA(__nv_bfloat16, 64);
  if (dtype == 1 && D == 128) return PTT_K9_MMA(__nv_bfloat16, 128);
  if (dtype == 3 && D == 64) return PTT_K9_MMA(int8_t, 64);
  if (dtype == 3 && D == 128) return PTT_K9_MMA(int8_t, 128);
#undef PTT_K9_MMA
  return -1;
}
