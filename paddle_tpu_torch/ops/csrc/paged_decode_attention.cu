// K8 — paged decode attention for Hopper (sm_90a): split-K over the keys.
//
// Replaces the TPU kernel fused_decode_attention
// (paddle_tpu/ops/paged_attention_pallas.py:195, pallas_call :259, body
// _fused_kernel :118) for float and int8 caches.  On the TPU the grid
// (B, Hkv, n_chunks) ran in order and carried the online-softmax state
// across chunks in VMEM scratch.  Here the key range of every row is
// split into spans of `split` keys (the wrapper passes 64); CTA
// (j, h, b*Z + z) folds the keys of span j for query rows [16 z, 16 z +
// 16) of the G*T rows of batch row b and kv head h, so
// B * Hkv * ceil(lmax / split) CTAs share the read instead of B * Hkv.
// At the serving shapes (B 8, Hkv 4, lengths up to 2040) spans of 64
// keys measured fastest on an H100 (`serving_probe.py spans`): 24.8 us a
// launch against 33.1 at 128 and 54.7 at one 256-key pool block a CTA
// (too few CTAs in flight), 31.6 at 32 (the merge outweighs the loads).
//
// What bounds it on the card: the bytes of LIVE KV.  A decode row reads
// (length + T) rows of K and V per kv head — at the serving shapes (bf16,
// Hkv 4, D 128) 2 KiB per token per layer — and does 4 flops per query
// row per key element, under 10 flops a byte at G*T <= 16 rows: far
// below the card's ~295 flops-per-byte balance point, so the least time
// is live KV bytes over 3.35 TB/s (an int8 cache: Hkv * (D + 2) * 2 bytes
// per token per layer, codes plus one f16 scale per row).  What the
// design does about it:
//   * enough CTAs to keep every SM's loads in flight: a CTA whose span
//     starts at or past the row's end (kv_end below) exits at once; the
//     split plan comes from `lengths` on the device, never from the host;
//   * a 3-stage ring of 32-key K/V tiles filled by 16-byte cp.async, in
//     the cache dtype (bf16 and f16 rows of 256 bytes at D 128, int8 rows
//     of 128); values are widened to f32 in registers, an int8 code
//     times its f16 scale (the reference's dequant, quant=True at
//     :160-163: one exact product per element); a tile costs two
//     barriers;
//   * scores and P·V on the CUDA cores in f32: a warp owns query rows
//     warp + 4i, a lane one key of the tile for the scores (its row's
//     max and sum are warp shuffles) and D/32 adjacent dims of the
//     accumulator for P·V (p broadcast by shuffle);
//   * the merge: a CTA writes its partial (m, l, acc) to an f32
//     workspace; the last CTA of each (b, h, z) — an atomic ticket after
//     a __threadfence — merges spans 0..n_split-1 in index order and
//     resets the ticket, so the result is bitwise the same run to run
//     and one launch does everything.  A span whose keys are all masked
//     for a row (m = -1e30, l = 0) gets weight exactly 0.  A row group
//     with one span writes its output directly (the same bits).
// Top-2 tree verification hides keys per query row: with `hidden` (int32
// [B, T, 2], half-open [lo, hi) per batch row and query token) a key in
// its row's range gets no weight, exactly as a key past the causal limit
// (the reference added a bias of -1e30 over those keys to the scores).  A
// span wholly hidden for a row leaves (m = -1e30, l = 0) like an empty
// one and merges with weight 0.  The range is a template flag, so the
// instances without it are the kernels they were.
// The page table is read in the kernel (physical block
// clamp(table[b, i], 0, N-1), the reference's mode="clip" gather: a
// sentinel reads a real block whose rows the mask discards); a row reads
// only chunks i < ceil((eff+T)/C) (eff = 0 for a slot parked at >= lmax,
// which reads chunk 0 only and returns finite garbage — the reference's
// trip-count exclusion) and within them only keys some query of the CTA
// can see.  The workspace and the tickets are the caller's (cached per
// device and geometry); the tickets start at 0 and are left at 0.
#include <type_traits>

#include "attention_tile.cuh"

namespace ptt {
namespace splitk {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kKeys = 32;              // keys a tile: one per lane
constexpr int kRows = 16;              // query rows a CTA
constexpr int kRowsW = kRows / kWarps; // rows a warp: warp + kWarps * i
constexpr int kStages = 3;             // cp.async ring depth
constexpr int kMaxSplit = 256;         // keys a span, at most
constexpr int kMaxPages = kMaxSplit / 32 + 1;  // pool blocks a span spans

// Shared-memory carve-up (bytes): q f32 [kRows][D]; the ring, kStages x
// (K, V) tiles of the cache dtype [kKeys][ld] with ld = D + 16 bytes (the
// 32 lanes reading one column of 32 rows hit distinct banks); the int8
// spans' scales f32 [2][kMaxSplit]; the span's pool blocks int [kMaxPages].
template <typename T>
struct Layout {
  int ld;
  size_t tiles, scales, pages, bytes;
  __host__ __device__ explicit Layout(int D) {
    ld = D + 16 / static_cast<int>(sizeof(T));
    tiles = (sizeof(float) * kRows * D + 15) & ~size_t{15};
    scales = tiles + sizeof(T) * kStages * 2 * kKeys * ld;
    scales = (scales + 15) & ~size_t{15};
    pages = scales + sizeof(float) * 2 * kMaxSplit;
    bytes = pages + sizeof(int) * kMaxPages;
  }
};

// One element as f32: int8 codes times their scale (one exact product),
// float types widened.
template <typename T>
__device__ __forceinline__ float deq(T x, float sc) {
  if constexpr (std::is_same_v<T, int8_t>)
    return __fmul_rn(static_cast<float>(x), sc);
  else
    return to_f32(x);
}

// N adjacent elements at p (aligned to their size, or to 16 bytes) as f32
template <typename T, int N>
__device__ __forceinline__ void widen(const T* p, float sc, float (&out)[N]) {
  constexpr int kBytes = N * static_cast<int>(sizeof(T));
  alignas(16) T raw[N];
  if constexpr (kBytes % 16 == 0) {
#pragma unroll
    for (int k = 0; k < kBytes / 16; ++k)
      reinterpret_cast<uint4*>(raw)[k] = reinterpret_cast<const uint4*>(p)[k];
  } else if constexpr (kBytes == 8) {
    *reinterpret_cast<uint2*>(raw) = *reinterpret_cast<const uint2*>(p);
  } else if constexpr (kBytes == 4) {
    *reinterpret_cast<uint32_t*>(raw) = *reinterpret_cast<const uint32_t*>(p);
  } else {
    static_assert(kBytes == 2, "1, 2, 4, 8 or 16k bytes");
    *reinterpret_cast<uint16_t*>(raw) = *reinterpret_cast<const uint16_t*>(p);
  }
#pragma unroll
  for (int k = 0; k < N; ++k) out[k] = deq(raw[k], sc);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// T: the cache's element type (float, bf16, f16, or int8_t with the f16
// scales ks/vs; null for float caches).  DV: the head_dim of a vector
// instance (16-byte loads into the ring, D/32 adjacent dims a lane), or 0
// for any head_dim (element-wise loads, dims lane + 32 j).  HIDE: the
// launch carries hidden key ranges.
template <typename T, int DV, bool HIDE>
__global__ void __launch_bounds__(kThreads) paged_decode_kernel(
    const float* __restrict__ q, const T* __restrict__ kc,
    const T* __restrict__ vc, const __half* __restrict__ ks,
    const __half* __restrict__ vs, const int* __restrict__ table,
    const int* __restrict__ lengths, const int* __restrict__ hidden,
    float* __restrict__ out,
    float* __restrict__ ws_acc, float* __restrict__ ws_ml,
    int* __restrict__ tickets, int Hkv, int G, int Tq, int Drt, int C,
    int n_chunks, int lmax, int n_blocks, int split, float scale) {
  constexpr bool kQ8 = std::is_same_v<T, int8_t>;
  constexpr int NJ = DV > 0 ? DV / 32 : kMaxD / 32;  // dims a lane
  const int D = DV > 0 ? DV : Drt;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int last;
  const Layout<T> lay(D);
  float* qs = reinterpret_cast<float*>(smem);
  T* ring = reinterpret_cast<T*>(smem + lay.tiles);
  float* ksc = reinterpret_cast<float*>(smem + lay.scales);
  float* vsc = ksc + kMaxSplit;
  int* pages = reinterpret_cast<int*>(smem + lay.pages);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rows_all = G * Tq, nz = (rows_all + kRows - 1) / kRows;
  const int j = blockIdx.x, h = blockIdx.y;
  const int b = blockIdx.z / nz, z = blockIdx.z - b * nz;
  const int row0 = z * kRows, R = min(kRows, rows_all - row0);

  const int length = lengths[b];
  const int eff = length < lmax ? length : 0;
  const int n_iter = min((eff + Tq + C - 1) / C, n_chunks);
  // keys past the CTA's last query position are masked for every row:
  // no span holds only such keys
  const long long qpos_hi =
      static_cast<long long>(length) + last_token(row0, R, Tq);
  const int kv_end = static_cast<int>(
      min(static_cast<long long>(n_iter) * C, qpos_hi + 1));
  const int n_split = (kv_end + split - 1) / split;
  if (j >= n_split) return;
  const int key_lo = j * split, key_hi = min(key_lo + split, kv_end);
  const long long stride = static_cast<long long>(Hkv) * D;
  const int pg0 = key_lo / C;

  if (table != nullptr && tid < kMaxPages) {
    const int pg = pg0 + tid;
    if (pg < n_chunks && static_cast<long long>(pg) * C < key_hi)
      pages[tid] = min(
          max(table[static_cast<long long>(b) * n_chunks + pg], 0),
          n_blocks - 1);
  }
  const long long qoff =
      (static_cast<long long>(b) * Hkv + h) * rows_all * D +
      static_cast<long long>(row0) * D;
  for (int e = tid; e < R * D; e += kThreads) qs[e] = q[qoff + e];
  __syncthreads();

  // element offset of key `pos`'s row of head h
  auto row_of = [&](int pos) -> long long {
    if (table != nullptr) {
      const int pg = pos / C;
      return (static_cast<long long>(pages[pg - pg0]) * C + (pos - pg * C)) *
                 stride + static_cast<long long>(h) * D;
    }
    return (static_cast<long long>(b) * lmax + pos) * stride +
           static_cast<long long>(h) * D;
  };
  const int n_tiles = (key_hi - key_lo + kKeys - 1) / kKeys;
  auto issue = [&](int it) {
    if (it < n_tiles) {
      const int key0 = key_lo + it * kKeys, nk = min(kKeys, key_hi - key0);
      T* kt = ring + static_cast<size_t>(it % kStages) * 2 * kKeys * lay.ld;
      T* vt = kt + kKeys * lay.ld;
      if constexpr (DV > 0) {
        constexpr int EPV = 16 / sizeof(T), NV = DV / EPV;
        for (int e = tid; e < nk * NV; e += kThreads) {
          const int s = e / NV, c = e - s * NV;
          const long long src = row_of(key0 + s) + c * EPV;
          cp_async16(kt + s * lay.ld + c * EPV, kc + src);
          cp_async16(vt + s * lay.ld + c * EPV, vc + src);
        }
      } else {
        for (int e = tid; e < nk * D; e += kThreads) {
          const int s = e / D, d = e - s * D;
          const long long src = row_of(key0 + s) + d;
          kt[s * lay.ld + d] = kc[src];
          vt[s * lay.ld + d] = vc[src];
        }
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int p = 0; p < kStages - 1; ++p) issue(p);
  if constexpr (kQ8) {   // the span's scales, while the first tiles fly
    for (int s = tid; s < key_hi - key_lo; s += kThreads) {
      const long long r = row_of(key_lo + s) / D;
      ksc[s] = __half2float(ks[r]);
      vsc[s] = __half2float(vs[r]);
    }
  }

  float m[kRowsW], l[kRowsW], pr[kRowsW], acc[kRowsW][NJ];
  int hlo[kRowsW], hhi[kRowsW];   // each row's hidden keys [lo, hi)
#pragma unroll
  for (int i = 0; i < kRowsW; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) acc[i][jj] = 0.f;
    hlo[i] = hhi[i] = 0;
    if constexpr (HIDE) {
      const int r = warp + kWarps * i;
      if (r < R) {
        const long long hr =
            (static_cast<long long>(b) * Tq + (row0 + r) % Tq) * 2;
        hlo[i] = hidden[hr];
        hhi[i] = hidden[hr + 1];
      }
    }
  }
  auto dim = [&](int jj) { return DV > 0 ? lane * NJ + jj : lane + 32 * jj; };

  for (int it = 0; it < n_tiles; ++it) {
    issue(it + kStages - 1);
    cp_async_wait<kStages - 1>();
    __syncthreads();
    const int key0 = key_lo + it * kKeys, nk = min(kKeys, key_hi - key0);
    const T* kt =
        ring + static_cast<size_t>(it % kStages) * 2 * kKeys * lay.ld;
    const T* vt = kt + kKeys * lay.ld;

    // scores: lane = key, the warp's rows warp + kWarps * i
    float dot[kRowsW];
#pragma unroll
    for (int i = 0; i < kRowsW; ++i) dot[i] = 0.f;
    if (lane < nk) {
      const T* kr = kt + lane * lay.ld;
      const float sc = kQ8 ? ksc[key0 - key_lo + lane] : 1.f;
      if constexpr (DV > 0) {
        constexpr int EPV = 16 / sizeof(T);
#pragma unroll 4
        for (int c = 0; c < DV / EPV; ++c) {
          float kf[EPV];
          widen<T, EPV>(kr + c * EPV, sc, kf);
#pragma unroll
          for (int i = 0; i < kRowsW; ++i) {
            const int r = warp + kWarps * i;
            if (r < R) {
              const float4* q4 =
                  reinterpret_cast<const float4*>(qs + r * DV + c * EPV);
#pragma unroll
              for (int e = 0; e < EPV / 4; ++e) {
                const float4 qv = q4[e];
                dot[i] = fmaf(qv.x, kf[4 * e], dot[i]);
                dot[i] = fmaf(qv.y, kf[4 * e + 1], dot[i]);
                dot[i] = fmaf(qv.z, kf[4 * e + 2], dot[i]);
                dot[i] = fmaf(qv.w, kf[4 * e + 3], dot[i]);
              }
            }
          }
        }
      } else {
        for (int d = 0; d < D; ++d) {
          const float kf = deq(kr[d], sc);
#pragma unroll
          for (int i = 0; i < kRowsW; ++i) {
            const int r = warp + kWarps * i;
            if (r < R) dot[i] = fmaf(qs[r * D + d], kf, dot[i]);
          }
        }
      }
    }
    // the online softmax of each of the warp's rows
#pragma unroll
    for (int i = 0; i < kRowsW; ++i) {
      const int r = warp + kWarps * i;
      pr[i] = 0.f;
      if (r < R) {
        const int key = key0 + lane;
        bool ok = lane < nk && static_cast<long long>(key) <=
                                   static_cast<long long>(length) +
                                       (row0 + r) % Tq;
        if constexpr (HIDE) ok = ok && (key < hlo[i] || key >= hhi[i]);
        const float s = ok ? dot[i] * scale : kNegInf;
        const float m_new = fmaxf(m[i], warp_max(s));
        pr[i] = ok ? expf(s - m_new) : 0.f;
        const float corr = expf(m[i] - m_new);
        l[i] = l[i] * corr + warp_sum(pr[i]);
        m[i] = m_new;
#pragma unroll
        for (int jj = 0; jj < NJ; ++jj) acc[i][jj] *= corr;
      }
    }
    // P·V: key s's probability broadcast from lane s
    for (int s = 0; s < nk; ++s) {
      const T* vr = vt + s * lay.ld;
      const float sc = kQ8 ? vsc[key0 - key_lo + s] : 1.f;
      float vf[NJ];
      if constexpr (DV > 0) {
        widen<T, NJ>(vr + lane * NJ, sc, vf);
      } else {
#pragma unroll
        for (int jj = 0; jj < NJ; ++jj) {
          const int d = dim(jj);
          vf[jj] = d < D ? deq(vr[d], sc) : 0.f;
        }
      }
#pragma unroll
      for (int i = 0; i < kRowsW; ++i) {
        if (warp + kWarps * i < R) {
          const float p = __shfl_sync(0xffffffffu, pr[i], s);
#pragma unroll
          for (int jj = 0; jj < NJ; ++jj)
            acc[i][jj] = fmaf(p, vf[jj], acc[i][jj]);
        }
      }
    }
    __syncthreads();   // the stage is refilled by the next issue
  }

  if (n_split == 1) {
#pragma unroll
    for (int i = 0; i < kRowsW; ++i) {
      const int r = warp + kWarps * i;
      if (r >= R) continue;
      const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) {
        const int d = dim(jj);
        if (d < D) out[qoff + r * D + d] = acc[i][jj] / den;
      }
    }
    return;
  }

  // the partial of span j, then the ticket
  const int ns = (lmax + split - 1) / split;
  const long long u0 = (static_cast<long long>(b) * Hkv + h) * ns;
  const long long tix = (static_cast<long long>(b) * Hkv + h) * nz + z;
#pragma unroll
  for (int i = 0; i < kRowsW; ++i) {
    const int r = warp + kWarps * i;
    if (r >= R) continue;
    const long long u = (u0 + j) * rows_all + row0 + r;
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) {
      const int d = dim(jj);
      if (d < D) ws_acc[u * D + d] = acc[i][jj];
    }
    if (lane == 0) {
      ws_ml[2 * u] = m[i];
      ws_ml[2 * u + 1] = l[i];
    }
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(&tickets[tix], 1) == n_split - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();

  // the last CTA: merge spans 0..n_split-1 in index order
#pragma unroll
  for (int i = 0; i < kRowsW; ++i) {
    const int r = warp + kWarps * i;
    if (r >= R) continue;
    float mx = kNegInf;
#pragma unroll 4
    for (int sp = 0; sp < n_split; ++sp)
      mx = fmaxf(mx, __ldcg(ws_ml + 2 * ((u0 + sp) * rows_all + row0 + r)));
    float lsum = 0.f, a[NJ];
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) a[jj] = 0.f;
#pragma unroll 4
    for (int sp = 0; sp < n_split; ++sp) {
      const long long u = (u0 + sp) * rows_all + row0 + r;
      const float ms = __ldcg(ws_ml + 2 * u);
      const float w = ms == kNegInf ? 0.f : expf(ms - mx);
      lsum += w * __ldcg(ws_ml + 2 * u + 1);
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) {
        const int d = dim(jj);
        if (d < D) a[jj] += w * __ldcg(ws_acc + u * D + d);
      }
    }
    const float den = fmaxf(lsum, 1e-30f);
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) {
      const int d = dim(jj);
      if (d < D) out[qoff + r * D + d] = a[jj] / den;
    }
  }
  if (tid == 0) tickets[tix] = 0;
}

template <typename T, int DV, bool HIDE>
int launch_d(const void* q, const void* k, const void* v, const void* ks,
             const void* vs, const void* table, const void* lengths,
             const void* hidden, void* out, void* ws_acc, void* ws_ml,
             void* tickets, int B, int Hkv, int G, int Tq, int D, int C,
             int n_chunks, int lmax, int n_blocks, int split, float scale,
             cudaStream_t stream) {
  const size_t smem = Layout<T>(D).bytes;
  cudaError_t err = set_smem(paged_decode_kernel<T, DV, HIDE>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nz = (G * Tq + kRows - 1) / kRows;
  const dim3 grid((lmax + split - 1) / split, Hkv, B * nz);
  paged_decode_kernel<T, DV, HIDE><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const __half*>(ks),
      static_cast<const __half*>(vs), static_cast<const int*>(table),
      static_cast<const int*>(lengths), static_cast<const int*>(hidden),
      static_cast<float*>(out),
      static_cast<float*>(ws_acc), static_cast<float*>(ws_ml),
      static_cast<int*>(tickets), Hkv, G, Tq, D, C, n_chunks, lmax,
      n_blocks, split, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool HIDE>
int launch_h(int vec, const void* q, const void* k, const void* v,
             const void* ks, const void* vs, const void* table,
             const void* lengths, const void* hidden, void* out,
             void* ws_acc, void* ws_ml, void* tickets, int B, int Hkv, int G,
             int Tq, int D, int C, int n_chunks, int lmax, int n_blocks,
             int split, float scale, cudaStream_t s) {
#define PTT_K8_ARGS                                                       \
  q, k, v, ks, vs, table, lengths, hidden, out, ws_acc, ws_ml, tickets, B, \
      Hkv, G, Tq, D, C, n_chunks, lmax, n_blocks, split, scale, s
  if (vec && D == 64) return launch_d<T, 64, HIDE>(PTT_K8_ARGS);
  if (vec && D == 128) return launch_d<T, 128, HIDE>(PTT_K8_ARGS);
  if (vec && D == 256) return launch_d<T, 256, HIDE>(PTT_K8_ARGS);
  return launch_d<T, 0, HIDE>(PTT_K8_ARGS);
#undef PTT_K8_ARGS
}

template <typename T>
int launch(int vec, const void* q, const void* k, const void* v,
           const void* ks, const void* vs, const void* table,
           const void* lengths, const void* hidden, void* out, void* ws_acc,
           void* ws_ml, void* tickets, int B, int Hkv, int G, int Tq, int D,
           int C, int n_chunks, int lmax, int n_blocks, int split,
           float scale, cudaStream_t s) {
  if (hidden != nullptr)
    return launch_h<T, true>(vec, q, k, v, ks, vs, table, lengths, hidden,
                             out, ws_acc, ws_ml, tickets, B, Hkv, G, Tq, D,
                             C, n_chunks, lmax, n_blocks, split, scale, s);
  return launch_h<T, false>(vec, q, k, v, ks, vs, table, lengths, hidden,
                            out, ws_acc, ws_ml, tickets, B, Hkv, G, Tq, D, C,
                            n_chunks, lmax, n_blocks, split, scale, s);
}

}  // namespace splitk
}  // namespace ptt

// dtype: 0 float32, 1 bfloat16, 2 float16, 3 int8 (the cache's; int8
// caches pass their f16 scales [.., Hkv] in ks/vs, float caches null).
// q and out are f32 [B, Hkv, G*T, D]; the cache is dense [B, lmax, Hkv, D]
// (table null) or a pool [n_blocks, C, Hkv, D] read through table
// [B, n_chunks].  hidden: null, or int32 [B, T, 2], each query token's
// hidden keys [lo, hi).  ws_acc f32 [B, Hkv, ceil(lmax/split), G*T, D] and
// ws_ml f32 [.., G*T, 2] hold the spans' partials, tickets int32
// [B, Hkv, ceil(G*T/16)] (zero, and left zero).  split: keys a span, a
// multiple of 32 up to 256.  vec: every pointer is 16-byte aligned (the
// 16-byte loads of the head_dim 64/128/256 instances).  Returns the
// launch's cudaError_t (0 = launched).
extern "C" int paged_decode_attention(
    int dtype, const void* q, const void* k, const void* v, const void* ks,
    const void* vs, const void* table, const void* lengths,
    const void* hidden, void* out, void* ws_acc, void* ws_ml, void* tickets,
    int B, int Hkv, int G, int Tq, int D, int C, int n_chunks, int lmax,
    int n_blocks, int split, int vec, float scale, void* stream) {
  using namespace ptt::splitk;
  if (D > ptt::kMaxD || C % kKeys != 0 || split % kKeys != 0 ||
      split < kKeys || split > kMaxSplit)
    return -1;
  if ((dtype == 3) != (ks != nullptr && vs != nullptr)) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PTT_K8_CALL(T)                                                      \
  launch<T>(vec, q, k, v, ks, vs, table, lengths, hidden, out, ws_acc,      \
            ws_ml, tickets, B, Hkv, G, Tq, D, C, n_chunks, lmax, n_blocks, \
            split, scale, s)
  switch (dtype) {
    case 0:
      return PTT_K8_CALL(float);
    case 1:
      return PTT_K8_CALL(__nv_bfloat16);
    case 2:
      return PTT_K8_CALL(__half);
    case 3:
      return PTT_K8_CALL(int8_t);
    default:
      return -1;
  }
#undef PTT_K8_CALL
}
