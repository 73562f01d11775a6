// K3, K4, K5 — flash-attention backward for Hopper (sm_90a).
//
// Replaces the TPU kernels of _flash_bwd_pallas
// (paddle_tpu/ops/flash_attention.py): K3 _delta_pallas (:714, kernel
// _delta_kernel :695), K4 the dK/dV pass (pallas_call :1131, kernel
// _bwd_dkv_kernel :729) and K5 the dQ pass (pallas_call :1242 resident,
// :1175 streamed; kernels _bwd_dq_kernel :864, _bwd_dq_kernel_streamed
// :335).  The reference's two-pass structure is kept: with the forward's
// lse the softmax is rebuilt per tile as p = exp(s - lse), then
//   dv = p^T·do,  dp = do·v^T,  ds = p ∘ (dp - delta) · scale,
//   dk = ds^T·q,  dq = ds·k,    delta = rowsum(do ∘ o),
// accumulated in f32, with no [Lq, Lk] tensor in device memory.
//
//  * delta (K3): one warp per (batch, position, head) row, a 32-lane
//    butterfly — bound by the bytes of do and o.
//  * dK/dV (K4): block (key tile, kv head, batch) keeps its K and V tiles
//    in shared memory and dK/dV in registers, and sweeps the query rows of
//    all G heads: the G heads' sum happens in-block, with no atomics.
//    Causal blocks start at the first row tile that sees their keys.
//  * dQ (K5): block (row tile, kv head, batch) keeps q, do and dQ and
//    sweeps the key tiles (causal: up to the tile's last visible key).
//    K/V stream through shared memory, so it has no residency limit and
//    is also the streamed variant.
//
// What bounds K4 and K5 on the card: operations (the two passes together
// do 2.5x the forward's, 10·D per visible (query head, key) pair, counting
// the score recomputed in both passes once).  For bf16 at head_dim 64/128
// (the training path) K4 and K5 run as the `wg` instances below — wgmma
// fed by a TMA ring (K4: of q/dO tiles, one consumer warpgroup per
// gradient; K5: of K/V tiles, two consumer warpgroups of 64 positions);
// f32, f16 and head_dim 256 run in f32 on the CUDA cores with register
// micro-tiles.  As in the reference, p and ds are computed in f32 and
// rounded to the input dtype where they enter a product (dV = p^T·do,
// dK = ds^T·q, dQ = ds·k); ds is built from the unrounded p.  Every sum
// runs in a fixed order: results are bitwise reproducible.
//
// Segment masks (the reference's segmented=True branches of
// _bwd_dkv_kernel :754-812, _bwd_dq_kernel :879-927 and
// _bwd_dq_kernel_streamed :372-376) are the compile-time switch SEG of
// K4's and K5's templates: the same int32 ids as the forward, a block's
// key segments in shared memory or registers, its query rows' beside
// their lse.  p = exp(s - lse) is rebuilt only for same-segment pairs;
// across segments p is 0 on a live row and 1/n on a dead one (its lse is
// the -1e30 sentinel), with no ds (flash_tile.cuh).  Padding rows arrive
// with dout zeroed, so K3 needs no switch.
//
// In-kernel RoPE (K10: the rope=True branches of _bwd_dkv_kernel :751-753,
// :796-801, :853-862 and _bwd_dq_kernel :876-878, :901-903, :916-919,
// :965-971, reached through flash_attention_packed_rope :1370) is the
// compile-time switch ROPE of K4's and K5's templates, without segments,
// at head_dim 128 (bf16 on the tensor cores) and 256.  q and k arrive raw
// and are re-rotated in shared memory from the residuals: K4 rotates its
// K tile once and each q tile of its sweep, K5 its q tile once and each K
// tile of its sweep (flash_tile.cuh; the wgmma instances on their
// swizzled tiles, which they also read transposed).  dK and dQ accumulate
// in rotated space in f32 and are rotated back with -sin on the
// accumulator (the tables widened to f32) before their one cast; dV is
// not rotated.  K3 needs no switch (out and dout
// are not rotated).
#include "flash_tile.cuh"
#include "hopper.cuh"

#include <climits>

namespace ptf {

// The operands of one backward launch, shared by K4 and K5.
struct BwdArgs {
  const void *q, *k, *v, *dout, *lse, *delta;
  const int *qseg, *kseg;
  RopePtrs rope;
  void *dk, *dv, *dq;
};

// ------------------------------------------------------------------- K3
template <typename T>
__global__ void __launch_bounds__(kThreads)
    delta_kernel(const T* __restrict__ dout, const T* __restrict__ out,
                 float* __restrict__ delta, int B, int L, int H, int D) {
  const long long row = static_cast<long long>(blockIdx.x) * (kThreads / 32) +
                        (threadIdx.x >> 5);    // (b, pos, h), memory order
  if (row >= static_cast<long long>(B) * L * H) return;
  const int lane = threadIdx.x & 31;
  const long long base = row * D;
  float s = 0.f;
  for (int d = lane; d < D; d += 32)
    s = fmaf(to_f32(dout[base + d]), to_f32(out[base + d]), s);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  if (lane == 0) {
    const int h = static_cast<int>(row % H);
    const long long bp = row / H;
    const int pos = static_cast<int>(bp % L);
    const long long b = bp / L;
    delta[(b * H + h) * L + pos] = s;
  }
}

// ------------------------------------------------------------------- K4
template <typename T, int D, int BK, bool SEG, bool ROPE>
__global__ void __launch_bounds__(kThreads)
    dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const T* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ delta,
               const int* __restrict__ qseg, const int* __restrict__ kseg,
               Rope<T> rp, T* __restrict__ dk, T* __restrict__ dv, Geom g) {
  constexpr int QS = D + 4, KS = BK + 1, PS = BK + 4;
  constexpr int CJ = BK / 16, CD = D / 16, KI = BK / 16;
  extern __shared__ float smem[];
  float* Kt = smem;               // [D][KS]
  float* Vt = Kt + D * KS;        // [D][KS]
  float* Qs = Vt + D * KS;        // [64][QS]
  float* dOs = Qs + kRows * QS;   // [64][QS]
  float* Ps = dOs + kRows * QS;   // [64][PS]
  float* dSs = Ps + kRows * PS;   // [64][PS]
  float* lse_s = dSs + kRows * PS;
  float* dl_s = lse_s + kRows;
  __shared__ int kseg_s[SEG ? BK : 1], qseg_s[SEG ? kRows : 1];

  const int key0 = blockIdx.x * BK, kvh = blockIdx.y, b = blockIdx.z;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const long long stride = static_cast<long long>(g.Hkv) * D;
  const long long kv0 = (static_cast<long long>(b) * g.Lk + key0) * stride +
                        static_cast<long long>(kvh) * D;
  load_keys_t<T, D, BK>(Kt, k, kv0, stride);
  load_keys_t<T, D, BK>(Vt, v, kv0, stride);
  if (SEG && threadIdx.x < BK)
    kseg_s[threadIdx.x] =
        kseg[static_cast<long long>(b) * g.Lk + key0 + threadIdx.x];
  if constexpr (ROPE) {   // this block's K^T tile, rotated once
    __syncthreads();
    rope_tile<T, D, kThreads>(Kt, 1, KS, BK, rp.kcos, rp.ksin, key0, 1);
  }

  float dk_acc[KI][CD], dv_acc[KI][CD];
#pragma unroll
  for (int i = 0; i < KI; ++i)
#pragma unroll
    for (int c = 0; c < CD; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;

  const int n_rows = g.Lq * g.G;
  int r_start = 0;
  if (g.causal) {
    const int pos0 = max(0, key0 - g.q_offset);   // first row seeing key0
    r_start = min(n_rows, pos0 * g.G) / kRows * kRows;
  }
  for (int r0 = r_start; r0 < n_rows; r0 += kRows) {
    __syncthreads();   // the previous tile's reads are done
    load_rows<T, D>(Qs, QS, q, g, b, kvh, r0);
    load_rows<T, D>(dOs, QS, dout, g, b, kvh, r0);
    if (threadIdx.x < kRows) {
      const long long so = stat_off(g, b, kvh, r0 + threadIdx.x);
      lse_s[threadIdx.x] = lse[so];
      dl_s[threadIdx.x] = delta[so];
      if (SEG) qseg_s[threadIdx.x] = row_seg(qseg, g, b, r0 + threadIdx.x);
    }
    __syncthreads();
    if constexpr (ROPE) {   // each q tile of the sweep
      rope_tile<T, D, kThreads>(Qs, QS, 1, kRows, rp.qcos, rp.qsin, r0, g.G);
      __syncthreads();
    }
    float s[4][CJ], dp[4][CJ];
    tile_dot<D, CJ>(s, Qs, QS, Kt, KS, ty, tx);
    tile_dot<D, CJ>(dp, dOs, QS, Vt, KS, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int rr = 4 * ty + i;
      const int vis =
          g.causal ? (r0 + rr) / g.G + g.q_offset : g.Lk - 1;
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const int col = tx + 16 * j;
        float p, ds;
        if constexpr (SEG) {
          p = ds = 0.f;
          if (key0 + col <= vis)
            seg_p_ds(s[i][j] * g.scale, dp[i][j], lse_s[rr], dl_s[rr],
                     g.scale, qseg_s[rr] == kseg_s[col], inv_keys(vis), p,
                     ds);
        } else {
          p = key0 + col <= vis ? expf(s[i][j] * g.scale - lse_s[rr]) : 0.f;
          ds = p * (dp[i][j] - dl_s[rr]) * g.scale;
        }
        Ps[rr * PS + col] = to_f32(from_f32<T>(p));
        dSs[rr * PS + col] = to_f32(from_f32<T>(ds));
      }
    }
    __syncthreads();
#pragma unroll 2
    for (int r = 0; r < kRows; ++r) {
      float p[KI], ds[KI], o[CD], qq[CD];
#pragma unroll
      for (int i = 0; i < KI; ++i) {
        p[i] = Ps[r * PS + ty * KI + i];
        ds[i] = dSs[r * PS + ty * KI + i];
      }
#pragma unroll
      for (int c = 0; c < CD; ++c) {
        o[c] = dOs[r * QS + tx + 16 * c];
        qq[c] = Qs[r * QS + tx + 16 * c];
      }
#pragma unroll
      for (int i = 0; i < KI; ++i)
#pragma unroll
        for (int c = 0; c < CD; ++c) {
          dv_acc[i][c] = fmaf(p[i], o[c], dv_acc[i][c]);
          dk_acc[i][c] = fmaf(ds[i], qq[c], dk_acc[i][c]);
        }
    }
  }
  if constexpr (ROPE) {   // dK back from rotated space: columns c, c + CD/2
#pragma unroll
    for (int i = 0; i < KI; ++i) {
      const long long t = static_cast<long long>(key0 + ty * KI + i) * D + tx;
#pragma unroll
      for (int c = 0; c < CD / 2; ++c)
        unrope_pair(dk_acc[i][c], dk_acc[i][c + CD / 2], rp.kcos, rp.ksin,
                    t + 16 * c, D / 2);
    }
  }
#pragma unroll
  for (int i = 0; i < KI; ++i) {
    const long long o = kv0 + (ty * KI + i) * stride;
#pragma unroll
    for (int c = 0; c < CD; ++c) {
      dk[o + tx + 16 * c] = from_f32<T>(dk_acc[i][c]);
      dv[o + tx + 16 * c] = from_f32<T>(dv_acc[i][c]);
    }
  }
}

// ------------------------------------------------------------------- K5
template <typename T, int D, int BK, bool SEG, bool ROPE>
__global__ void __launch_bounds__(kThreads)
    dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const T* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              const int* __restrict__ qseg, const int* __restrict__ kseg,
              Rope<T> rp, T* __restrict__ dq, Geom g) {
  constexpr int QS = D + 4, KS = BK + 1, PS = BK + 4;
  constexpr int CJ = BK / 16, CD = D / 16;
  extern __shared__ float smem[];
  float* Qs = smem;               // [64][QS]
  float* dOs = Qs + kRows * QS;   // [64][QS]
  float* KV = dOs + kRows * QS;   // V^T, then K^T [D][KS]
  float* dSs = KV + D * KS;       // [64][PS]
  float* lse_s = dSs + kRows * PS;
  float* dl_s = lse_s + kRows;
  __shared__ int kseg_s[SEG ? BK : 1];

  const int n_tiles = g.Lq * g.G / kRows;
  const int tile = g.causal ? n_tiles - 1 - blockIdx.x : blockIdx.x;
  const int r0 = tile * kRows, kvh = blockIdx.y, b = blockIdx.z;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;

  load_rows<T, D>(Qs, QS, q, g, b, kvh, r0);
  load_rows<T, D>(dOs, QS, dout, g, b, kvh, r0);
  if (threadIdx.x < kRows) {
    const long long so = stat_off(g, b, kvh, r0 + threadIdx.x);
    lse_s[threadIdx.x] = lse[so];
    dl_s[threadIdx.x] = delta[so];
  }
  if constexpr (ROPE) {   // the q tile, rotated once
    __syncthreads();
    rope_tile<T, D, kThreads>(Qs, QS, 1, kRows, rp.qcos, rp.qsin, r0, g.G);
  }
  int vis[4], qs[4];
  float acc[4][CD];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    vis[i] = g.causal ? (r0 + 4 * ty + i) / g.G + g.q_offset : g.Lk - 1;
    qs[i] = SEG ? row_seg(qseg, g, b, r0 + 4 * ty + i) : 0;
#pragma unroll
    for (int c = 0; c < CD; ++c) acc[i][c] = 0.f;
  }
  const int key_end =
      g.causal ? min(g.Lk, (r0 + kRows - 1) / g.G + g.q_offset + 1) : g.Lk;
  const long long stride = static_cast<long long>(g.Hkv) * D;
  const long long kv0 = static_cast<long long>(b) * g.Lk * stride +
                        static_cast<long long>(kvh) * D;

  for (int key0 = 0; key0 < key_end; key0 += BK) {
    __syncthreads();   // the previous tile's K^T and dS reads are done
    load_keys_t<T, D, BK>(KV, v, kv0 + key0 * stride, stride);
    if (SEG && threadIdx.x < BK)
      kseg_s[threadIdx.x] = kseg[static_cast<long long>(b) * g.Lk + key0 +
                                 threadIdx.x];
    __syncthreads();
    float dp[4][CJ], s[4][CJ];
    tile_dot<D, CJ>(dp, dOs, QS, KV, KS, ty, tx);
    __syncthreads();
    load_keys_t<T, D, BK>(KV, k, kv0 + key0 * stride, stride);
    __syncthreads();
    if constexpr (ROPE) {   // each K^T tile of the sweep
      rope_tile<T, D, kThreads>(KV, 1, KS, BK, rp.kcos, rp.ksin, key0, 1);
      __syncthreads();
    }
    tile_dot<D, CJ>(s, Qs, QS, KV, KS, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int rr = 4 * ty + i;
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const int col = tx + 16 * j;
        float ds;
        if constexpr (SEG) {
          float p;
          ds = 0.f;
          if (key0 + col <= vis[i])
            seg_p_ds(s[i][j] * g.scale, dp[i][j], lse_s[rr], dl_s[rr],
                     g.scale, qs[i] == kseg_s[col], inv_keys(vis[i]), p, ds);
        } else {
          const float p = key0 + col <= vis[i]
                              ? expf(s[i][j] * g.scale - lse_s[rr])
                              : 0.f;
          ds = p * (dp[i][j] - dl_s[rr]) * g.scale;
        }
        dSs[rr * PS + col] = to_f32(from_f32<T>(ds));
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int sk = 0; sk < BK; ++sk) {
      float ds[4], kk[CD];
#pragma unroll
      for (int i = 0; i < 4; ++i) ds[i] = dSs[(4 * ty + i) * PS + sk];
#pragma unroll
      for (int c = 0; c < CD; ++c) kk[c] = KV[(tx + 16 * c) * KS + sk];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < CD; ++c) acc[i][c] = fmaf(ds[i], kk[c], acc[i][c]);
    }
  }
  if constexpr (ROPE) {   // dQ back from rotated space: columns c, c + CD/2
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const long long t =
          static_cast<long long>((r0 + 4 * ty + i) / g.G) * D + tx;
#pragma unroll
      for (int c = 0; c < CD / 2; ++c)
        unrope_pair(acc[i][c], acc[i][c + CD / 2], rp.qcos, rp.qsin,
                    t + 16 * c, D / 2);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long o = row_off<D>(g, b, kvh, r0 + 4 * ty + i);
#pragma unroll
    for (int c = 0; c < CD; ++c) dq[o + tx + 16 * c] = from_f32<T>(acc[i][c]);
  }
}

// ------------------------------------- K4 on the tensor cores (bf16, wgmma)
// dK/dV for bf16 at head_dim 64/128 on Hopper's asynchronous tensor-core
// path (hopper.cuh).  Block (kv head, batch, key block) owns kDkvKeys = 64
// keys; K and V arrive once by TMA and stay in shared memory.  A producer
// warp streams the row tiles — 64 positions of ONE query head (a TMA
// box of q and of dO, rows past Lq zero-filled), with the rows'
// lse, delta (and segment ids) beside them — through a ring of
// kDkvStages stages, over the G query heads of the kv head in turn and,
// causal, from the first position tile that sees the block's keys.  The
// two consumer warpgroups split the work by side, so that each holds one
// gradient:
//  * the p side takes s^T = K·q^T (wgmma, both operands K-major in shared
//    memory), rebuilds p = exp(s·scale - lse) in f32 on the accumulator
//    fragments, leaves p in the stage's f32 tile (an mbarrier tells the
//    other side), rounds it to bf16 into the register A operand and adds
//    dV += p^T·dO, dO read MN-major through the transpose bit;
//  * the ds side takes dp^T = V·dO^T, waits for p, forms
//    ds = p (dp - delta) scale from the unrounded p and adds
//    dK += ds^T·q, q read MN-major.
// Each side issues the next tile's score product before this tile's
// gradient product, so that its elementwise work overlaps the product.
// One gradient (64 accumulator registers a thread at D 128) plus one
// score tile keeps each side inside the ~168 registers ptxas gives wgmma
// accumulators whatever setmaxnreg grants (one warpgroup holding both
// gradients spilled them around every score product and ran 1.5x
// slower).  No transposed copies.  The sum over the G heads and the
// position tiles runs in that fixed order in every block: bitwise
// reproducible.  ROPE: the p side rotates the K tile once, both rotate
// each q tile as it lands (fence.proxy.async and a named barrier before
// wgmma reads it), and dK goes back from rotated space with -sin on the
// f32 accumulators.  The stage count is flash_probe.py sweep's.
namespace wg {

#ifndef PTF_DKV_STAGES
#define PTF_DKV_STAGES 3
#endif
constexpr int kDkvKeys = 64;                     // keys a block
constexpr int kDkvStages = PTF_DKV_STAGES;

template <int D>
struct DkvSmem {
  static constexpr int kRows = 64;               // positions a row tile
  static constexpr int kKV = kDkvKeys * D * 2;   // bytes of K or V
  static constexpr int kRow = kRows * D * 2;     // of a q or dO tile
  static constexpr int kStat = kRows * 4;        // of lse, delta or qseg
  static constexpr int kP = kDkvKeys * kRows * 4;      // f32 p
  static constexpr int kStage =                  // 1024-byte aligned
      (2 * kRow + kP + 3 * kStat + 1023) / 1024 * 1024;
  static constexpr size_t kBytes = 1024 + 2 * kKV + kDkvStages * kStage;
};

template <int D, bool SEG, bool ROPE>
__global__ void __launch_bounds__(kThreads, 1)
    dkv_kernel(const __grid_constant__ CUtensorMap tq,
               const __grid_constant__ CUtensorMap tdo,
               const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tv,
               const float* __restrict__ lse, const float* __restrict__ delta,
               const int* __restrict__ qseg, const int* __restrict__ kseg,
               Rope<__nv_bfloat16> rp, __nv_bfloat16* __restrict__ dk,
               __nv_bfloat16* __restrict__ dv, Geom g) {
  using Sm = DkvSmem<D>;
  constexpr int S = kDkvStages, NB = D / 64, ND = D / 8, BR = Sm::kRows;
  constexpr int NR = BR / 8;                    // 8-column blocks of a tile
  extern __shared__ unsigned char smem_raw[];
  unsigned char* Ks = align1024(smem_raw);      // [NB][kDkvKeys][64]
  unsigned char* Vs = Ks + Sm::kKV;
  unsigned char* stages = Vs + Sm::kKV;         // q, dO, p, lse, delta, qseg
  __shared__ __align__(8) uint64_t full[S], empty[S], pready[S], kvbar;

  const int kvh = blockIdx.x, b = blockIdx.y;
  const int key0 = blockIdx.z * kDkvKeys;
  const int n_pt = (g.Lq + BR - 1) / BR;
  // causal: the first position tile with a row that sees key0
  const int pt0 = g.causal ? max(0, key0 - g.q_offset) / BR : 0;
  const int per_head = n_pt - pt0;
  const int n_t = g.G * per_head;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      hop::mbar_init(&full[s], 32);
      hop::mbar_init(&empty[s], 128 * kConsumers);
      hop::mbar_init(&pready[s], 128);
    }
    hop::mbar_init(&kvbar, 1);
    hop::mbar_fence_init();
  }
  __syncthreads();

  if (hop::warpgroup() == 0) {
    // ---- producer warpgroup: one warp issues the loads
    hop::regs_dec<kProducerRegs>();
    const int lane = threadIdx.x & 31;
    if (hop::warp_in_warpgroup() == 0) {
      if (lane == 0) {
        hop::mbar_arrive_tx(&kvbar, 2 * Sm::kKV);
        for (int c = 0; c < NB; ++c) {
          hop::tma_load_3d(Ks + c * kDkvKeys * 128, &tk, &kvbar,
                           kvh * D + 64 * c, key0, b);
          hop::tma_load_3d(Vs + c * kDkvKeys * 128, &tv, &kvbar,
                           kvh * D + 64 * c, key0, b);
        }
      }
      for (int t = 0; t < n_t; ++t) {
        const int s = t % S;
        const int h = kvh * g.G + t / per_head;
        const int p0 = (pt0 + t % per_head) * BR;
        unsigned char* st = stages + s * Sm::kStage;
        float* stat = reinterpret_cast<float*>(st + 2 * Sm::kRow + Sm::kP);
        hop::mbar_wait(&empty[s], ((t / S) & 1) ^ 1);
        if (lane == 0) {   // the tiles first: they land while the lanes load
          hop::mbar_expect_tx(&full[s], 2 * Sm::kRow);
          for (int c = 0; c < NB; ++c) {
            hop::tma_load_3d(st + c * BR * 128, &tq, &full[s],
                             h * D + 64 * c, p0, b);
            hop::tma_load_3d(st + Sm::kRow + c * BR * 128, &tdo, &full[s],
                             h * D + 64 * c, p0, b);
          }
        }
        const long long so = (static_cast<long long>(b) * g.H + h) * g.Lq;
        for (int i = lane; i < BR; i += 32) {
          const int pos = p0 + i;
          const bool in = pos < g.Lq;
          stat[i] = in ? lse[so + pos] : 0.f;
          stat[BR + i] = in ? delta[so + pos] : 0.f;
          if constexpr (SEG)
            reinterpret_cast<int*>(stat)[2 * BR + i] =
                in ? qseg[static_cast<long long>(b) * g.Lq + pos] : -1;
        }
        hop::mbar_arrive(&full[s]);
      }
    }
  } else {
    // ---- consumer warpgroups: 1 the p side (dV), 2 the ds side (dK)
    hop::regs_inc<kConsumerRegs>();
    const bool pside = hop::warpgroup() == 1;
    const int ct = threadIdx.x - 128;            // 0 .. 255
    const int wt = threadIdx.x & 127;
    const int warp = wt >> 5, lane = wt & 31, gq = lane >> 2, tq = lane & 3;
    const int k_lo = key0 + 16 * warp + gq, k_hi = k_lo + 8;
    int ks_lo = 0, ks_hi = 0;
    if constexpr (SEG) {
      const long long kb = static_cast<long long>(b) * g.Lk;
      ks_lo = k_lo < g.Lk ? kseg[kb + k_lo] : INT_MIN;
      ks_hi = k_hi < g.Lk ? kseg[kb + k_hi] : INT_MIN;
    }
    // the score product's operands (K·q^T or V·dO^T, K-major) and the
    // gradient product's B (dO for dV, q for dK, MN-major), stage 0
    const uint64_t da0 = hop::desc_sw128(pside ? Ks : Vs, 0);
    const uint64_t db0 = hop::desc_sw128(stages + (pside ? 0 : Sm::kRow), 0);
    const uint64_t dt0 =
        hop::desc_sw128(stages + (pside ? Sm::kRow : 0), BR * 128);

    hop::mbar_wait(&kvbar, 0);
    if (ROPE && pside) {   // the K tile, rotated once
      mma::rope_sw128(Ks, kDkvKeys, 0, min(kDkvKeys, g.Lk - key0), rp.kcos,
                      rp.ksin, key0, wt, 128);
      hop::fence_proxy_async();
      hop::bar_sync(2, 128);
    }
    float acc[ND][4];                            // dV (p side), dK (ds side)
#pragma unroll
    for (int n = 0; n < ND; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[n][c] = 0.f;

    // Tile t's score product (s^T on the p side, dp^T on the ds side),
    // issued once its stage has landed (and its q tile is rotated)
    auto score = [&](int t, float (&x)[NR][4]) {
      const int s = t % S;
      hop::mbar_wait(&full[s], (t / S) & 1);
      if constexpr (ROPE) {   // each q tile, rotated by both sides
        const int p0 = (pt0 + t % per_head) * BR;
        mma::rope_sw128(stages + s * Sm::kStage, BR, 0, min(BR, g.Lq - p0),
                        rp.qcos, rp.qsin, p0, ct, 128 * kConsumers);
        hop::fence_proxy_async();
        hop::bar_sync(1, 128 * kConsumers);
      }
      const uint64_t da = hop::opaque(da0);
      const uint64_t db = hop::opaque(hop::desc_at(db0, s * Sm::kStage));
      hop::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        hop::ss<BR>(x, hop::desc_at(da, (kk >> 2) * kDkvKeys * 128 +
                                            (kk & 3) * 32),
                    hop::desc_at(db, (kk >> 2) * BR * 128 + (kk & 3) * 32),
                    kk > 0);
      hop::wgmma_commit();
    };
    // tile t's p (p side: also left for the ds side) or ds in place of its
    // finished score tile; column = position p0 + rr, row = key
    auto side = [&](int t, float (&x)[NR][4]) {
      const int s = t % S;
      const int p0 = (pt0 + t % per_head) * BR;
      float* pb = reinterpret_cast<float*>(stages + s * Sm::kStage +
                                           2 * Sm::kRow);
      const float* stat = pb + BR * kDkvKeys;
      const int* sseg = reinterpret_cast<const int*>(stat) + 2 * BR;
      hop::fence_regs(x);
      if (pside) {
        const bool whole =
            !SEG && p0 + BR <= g.Lq &&
            (!g.causal || key0 + kDkvKeys - 1 <= p0 + g.q_offset);
        // p in place of the scores; the unrounded p the ds side takes (0
        // where ds is 0) to the stage's p tile
#pragma unroll
        for (int j = 0; j < NR; ++j) {
          float pd[4];
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int rr = 8 * j + 2 * tq + (c & 1);
            const float l_r = stat[rr];
            float p = 0.f;
            if (whole) {
              p = exp_ex2(x[j][c] * g.scale - l_r);
            } else {
              const int pos = p0 + rr, key = c >= 2 ? k_hi : k_lo;
              const int vis = g.causal ? pos + g.q_offset : g.Lk - 1;
              const bool ok = pos < g.Lq && key <= vis;
              if constexpr (SEG) {
                float ds;
                const bool same = sseg[rr] == (c >= 2 ? ks_hi : ks_lo);
                if (ok)
                  seg_p_ds(x[j][c] * g.scale, 0.f, l_r, 0.f, g.scale, same,
                           inv_keys(vis), p, ds);
                pd[c] = same ? p : 0.f;   // a dead row's 1/n takes no ds
              } else {
                p = ok ? exp_ex2(x[j][c] * g.scale - l_r) : 0.f;
              }
            }
            x[j][c] = p;
            if constexpr (!SEG) pd[c] = p;
          }
          reinterpret_cast<float4*>(pb)[j * 128 + wt] =
              make_float4(pd[0], pd[1], pd[2], pd[3]);
        }
        hop::mbar_arrive(&pready[s]);
      } else {
        hop::mbar_wait(&pready[s], (t / S) & 1);
#pragma unroll
        for (int j = 0; j < NR; ++j) {
          const float4 p4 = reinterpret_cast<const float4*>(pb)[j * 128 + wt];
          const float p[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int rr = 8 * j + 2 * tq + (c & 1);
            x[j][c] = p[c] * (x[j][c] - stat[BR + rr]) * g.scale;
          }
        }
      }
    };

    // Software-pipelined: tile t+1's score product is issued before tile
    // t's gradient product and its p or ds are formed while that runs, so
    // the tensor cores always hold queued work.  Groups complete in order
    // (wait_group 1: t+1's scores, 0: t's gradient).  ptxas keeps the
    // products asynchronous only if every group inside the loop is issued
    // unconditionally (the last tile's gradient product is peeled) and no
    // register of an operand in flight is written: p or ds goes to bf16
    // into the A operand (the reference's rounding points) once the
    // previous gradient product is done.
    float x[NR][4];
    uint32_t af[NR / 2][4];
    auto to_a = [&]() {
#pragma unroll
      for (int kk = 0; kk < NR / 2; ++kk)
        mma::a_frag(x[2 * kk], x[2 * kk + 1], af[kk]);
    };
    auto gradient = [&](int t) {   // acc += p^T·dO or ds^T·q of tile t
      const uint64_t dt =
          hop::opaque(hop::desc_at(dt0, (t % S) * Sm::kStage));
      hop::fence_regs(acc);
      hop::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < NR / 2; ++kk)
        hop::rs<D>(acc, af[kk], hop::desc_at(dt, kk * 2048), 1);
      hop::wgmma_commit();
    };
    score(0, x);
    hop::wgmma_wait<0>();
    side(0, x);
    to_a();
    for (int t = 0; t + 1 < n_t; ++t) {
      score(t + 1, x);
      gradient(t);
      hop::wgmma_wait<1>();
      side(t + 1, x);
      hop::wgmma_wait<0>();
      hop::fence_regs(acc);
      hop::mbar_arrive(&empty[t % S]);
      to_a();
    }
    gradient(n_t - 1);
    hop::wgmma_wait<0>();
    hop::fence_regs(acc);
    hop::mbar_arrive(&empty[(n_t - 1) % S]);

    if (ROPE && !pside) {   // dK back from rotated space: n and n + ND/2
      const long long t_lo = static_cast<long long>(min(k_lo, g.Lk - 1)) * D;
      const long long t_hi = static_cast<long long>(min(k_hi, g.Lk - 1)) * D;
#pragma unroll
      for (int n = 0; n < ND / 2; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          unrope_pair(acc[n][c], acc[n + ND / 2][c], rp.kcos, rp.ksin,
                      (c >= 2 ? t_hi : t_lo) + 8 * n + 2 * tq + (c & 1),
                      D / 2);
    }
    __nv_bfloat16* grad = pside ? dv : dk;
    const long long stride = static_cast<long long>(g.Hkv) * D;
    const long long kv0 = static_cast<long long>(b) * g.Lk * stride +
                          static_cast<long long>(kvh) * D;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int key = half ? k_hi : k_lo;
      if (key >= g.Lk) continue;
      const long long o = kv0 + key * stride;
#pragma unroll
      for (int n = 0; n < ND; ++n)
        *reinterpret_cast<uint32_t*>(grad + o + 8 * n + 2 * tq) =
            mma::pack(acc[n][2 * half], acc[n][2 * half + 1]);
    }
  }
}

template <int D, bool SEG, bool ROPE = false>
int launch_dkv(const BwdArgs& a, const Geom& g, cudaStream_t stream) {
  CUtensorMap tq, tdo, tk, tv;
  const uint64_t qw = static_cast<uint64_t>(g.H) * D;
  const uint64_t kw = static_cast<uint64_t>(g.Hkv) * D;
  if (hop::bf16_map(&tq, a.q, qw, g.Lq, g.B, DkvSmem<D>::kRows) ||
      hop::bf16_map(&tdo, a.dout, qw, g.Lq, g.B, DkvSmem<D>::kRows) ||
      hop::bf16_map(&tk, a.k, kw, g.Lk, g.B, kDkvKeys) ||
      hop::bf16_map(&tv, a.v, kw, g.Lk, g.B, kDkvKeys))
    return -2;
  const size_t smem = DkvSmem<D>::kBytes;
  cudaError_t err = set_smem(dkv_kernel<D, SEG, ROPE>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  static const bool regs = regs_ok(dkv_kernel<D, SEG, ROPE>);
  if (!regs) return -3;
  const dim3 grid(g.Hkv, g.B, (g.Lk + kDkvKeys - 1) / kDkvKeys);
  dkv_kernel<D, SEG, ROPE><<<grid, kThreads, smem, stream>>>(
      tq, tdo, tk, tv, static_cast<const float*>(a.lse),
      static_cast<const float*>(a.delta), a.qseg, a.kseg,
      a.rope.as<__nv_bfloat16>(), static_cast<__nv_bfloat16*>(a.dk),
      static_cast<__nv_bfloat16*>(a.dv), g);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------- K5 on the tensor cores (bf16, wgmma)
// dQ for bf16 at head_dim 64/128 on the same building blocks.  Block (head
// h, batch b, position tile) owns kDqRows = 128 positions of ONE query
// head, the forward's layout: q and dO arrive once by TMA (rows past Lq
// zero-filled), each consumer thread reads its two rows' lse and delta
// (and segment ids) into registers.  A producer warp streams the kv
// head's 64-key K and V tiles, with their key segment ids (SEG), through a
// ring of kDqStages stages; causal blocks stop at their last visible key
// and run longest first.  Each of the two consumer warpgroups owns 64
// positions and, per key tile, takes s = q·K^T and dp = dO·V^T (wgmma,
// both operands K-major in shared memory), rebuilds p = 2^(s·scale·log2 e
// - lse·log2 e) on the accumulator fragments (the scale and log2 e folded
// into one multiply-add, one ex2), forms ds = p (dp - delta) scale,
// rounds it to bf16 (the reference's rounding point) into the
// warpgroup's own 128-byte-swizzled [64][64] dS tile in shared memory once
// every product of the warpgroup is done, and adds dq += ds·K (wgmma, both
// operands in shared memory) with K read MN-major through the transpose
// bit from the same swizzled stage tile — no transposed copy.  dS goes
// through shared memory, not the register A operand: s (32 registers a
// thread), dp (32), dQ (64 at head_dim 128) and 16 registers of A
// fragments were more than ptxas keeps for a pipelined wgmma loop, and it
// serialised every product (C7512).  Only key tiles that cross a row's
// causal limit (or the end of K) test the mask per element; SEG tests
// each pair's segments too: only same-segment pairs take p and ds
// (seg_p_ds's 1/n on a dead row's cross-segment keys feeds dV, never ds),
// and a warp none of whose pairs in the tile does skips the exponentials.
// The two warpgroups take the tensor cores in turns through named
// barriers (ping-pong), each issuing its dq, s and dp products in one
// turn and rebuilding p and ds while the other's run: 6% less time at the
// Llama and BERT shapes than issuing the next tile's s before this tile's
// dq product (PERF.md, the sweep that chose it).  flash_probe.py sweep
// chose 3 stages (4 within 2%, 2 stages 25% slower).  dQ sums the key tiles
// in one fixed order: bitwise reproducible.  ROPE: each consumer rotates
// its q rows once after they land; the producer warpgroup's three idle
// warps rotate each K tile as it lands (fence.proxy.async, then an
// mbarrier the consumers wait on), so the consumers never stop for it; dq
// goes back from rotated space with -sin on the f32 accumulators before
// its one cast.  K/V stream, so the long (streamed) shape is the same
// kernel.

#ifndef PTF_DQ_STAGES
#define PTF_DQ_STAGES 3
#endif
constexpr int kDqRows = 64 * kConsumers;         // positions a block
constexpr int kDqKeys = 64;                      // keys a ring stage
constexpr int kDqStages = PTF_DQ_STAGES;

template <int D>
struct DqSmem {
  static constexpr int kQ = kDqRows * D * 2;     // bytes of the q or dO tile
  static constexpr int kDS = 64 * kDqKeys * 2;   // of a warpgroup's dS tile
  static constexpr int kKV = kDqKeys * D * 2;    // of one K or V tile
  static constexpr size_t kBytes = 1024 + 2 * kQ + kConsumers * kDS +
                                   2 * kDqStages * kKV +
                                   kDqStages * kDqKeys * 4;
};

// The register split: the ROPE instance's producer warpgroup rotates K
// tiles, which needs more than the 24 registers of a load-issuing warp
template <bool ROPE>
struct DqRegs {
  static constexpr int kProducer = ROPE ? 56 : kProducerRegs;
  static constexpr int kConsumer = ROPE ? 224 : kConsumerRegs;
};

template <int D, bool SEG, bool ROPE>
__global__ void __launch_bounds__(kThreads, 1)
    dq_kernel(const __grid_constant__ CUtensorMap tq,
              const __grid_constant__ CUtensorMap tdo,
              const __grid_constant__ CUtensorMap tk,
              const __grid_constant__ CUtensorMap tv,
              const float* __restrict__ lse, const float* __restrict__ delta,
              const int* __restrict__ qseg, const int* __restrict__ kseg,
              Rope<__nv_bfloat16> rp, __nv_bfloat16* __restrict__ dq,
              Geom g) {
  using Sm = DqSmem<D>;
  using Rg = DqRegs<ROPE>;
  constexpr int S = kDqStages, BK = kDqKeys, BM = kDqRows, NB = D / 64;
  constexpr int NT = BK / 8, ND = D / 8;
  constexpr int kRotators = 96;                  // the producer's warps 1-3
  extern __shared__ unsigned char smem_raw[];
  unsigned char* Qs = align1024(smem_raw);       // [NB][BM][64]
  unsigned char* dOs = Qs + Sm::kQ;              // [NB][BM][64]
  unsigned char* dSs = dOs + Sm::kQ;             // [kConsumers][64][BK]
  unsigned char* KVs = dSs + kConsumers * Sm::kDS;   // stage s: K, then V
  int* kseg_s = reinterpret_cast<int*>(KVs + 2 * S * Sm::kKV);   // [S][BK]
  __shared__ __align__(8) uint64_t full[S], empty[S], kready[S], qbar;

  const int n_pt = (g.Lq + BM - 1) / BM;
  const int pt = g.causal ? n_pt - 1 - static_cast<int>(blockIdx.z)
                          : static_cast<int>(blockIdx.z);
  const int h = blockIdx.x, b = blockIdx.y, kvh = h / g.G;
  const int p0 = pt * BM;
  const int key_end =
      g.causal ? min(g.Lk, min(p0 + BM, g.Lq) - 1 + g.q_offset + 1) : g.Lk;
  const int n_kt = (key_end + BK - 1) / BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      hop::mbar_init(&full[s], 32);
      hop::mbar_init(&empty[s], 128 * kConsumers);
      hop::mbar_init(&kready[s], kRotators);
    }
    hop::mbar_init(&qbar, 1);
    hop::mbar_fence_init();
  }
  __syncthreads();

  if (hop::warpgroup() == 0) {
    // ---- producer warpgroup: warp 0 issues the loads, ROPE: 1-3 rotate
    hop::regs_dec<Rg::kProducer>();
    const int lane = threadIdx.x & 31;
    if (hop::warp_in_warpgroup() == 0) {
      if (lane == 0) {
        hop::mbar_arrive_tx(&qbar, 2 * Sm::kQ);
        for (int c = 0; c < NB; ++c) {
          hop::tma_load_3d(Qs + c * BM * 128, &tq, &qbar, h * D + 64 * c, p0,
                           b);
          hop::tma_load_3d(dOs + c * BM * 128, &tdo, &qbar, h * D + 64 * c,
                           p0, b);
        }
      }
      for (int t = 0; t < n_kt; ++t) {
        const int s = t % S, key0 = t * BK;
        hop::mbar_wait(&empty[s], ((t / S) & 1) ^ 1);
        if (lane == 0) {   // the tiles first: they land while the lanes load
          unsigned char* ks = KVs + 2 * s * Sm::kKV;
          hop::mbar_expect_tx(&full[s], 2 * Sm::kKV);
          for (int c = 0; c < NB; ++c) {
            hop::tma_load_3d(ks + c * BK * 128, &tk, &full[s],
                             kvh * D + 64 * c, key0, b);
            hop::tma_load_3d(ks + Sm::kKV + c * BK * 128, &tv, &full[s],
                             kvh * D + 64 * c, key0, b);
          }
        }
        if constexpr (SEG) {
          for (int i = lane; i < BK; i += 32) {
            const int key = key0 + i;
            kseg_s[s * BK + i] =
                key < g.Lk ? kseg[static_cast<long long>(b) * g.Lk + key]
                           : INT_MIN;
          }
        }
        hop::mbar_arrive(&full[s]);
      }
    } else if constexpr (ROPE) {
      // each K tile rotated where it landed, then handed to the consumers
      const int rt = threadIdx.x - 32;
      for (int t = 0; t < n_kt; ++t) {
        const int s = t % S;
        hop::mbar_wait(&full[s], (t / S) & 1);
        mma::rope_sw128(KVs + 2 * s * Sm::kKV, BK, 0, min(BK, g.Lk - t * BK),
                        rp.kcos, rp.ksin, t * BK, rt, kRotators);
        hop::fence_proxy_async();
        hop::mbar_arrive(&kready[s]);
      }
    }
  } else {
    // ---- consumer warpgroups: 64 query positions each
    hop::regs_inc<Rg::kConsumer>();
    const int wgi = hop::warpgroup() - 1;
    const int wt = threadIdx.x & 127;
    const int warp = wt >> 5, lane = wt & 31, gq = lane >> 2, tq = lane & 3;
    const int r_lo = p0 + 64 * wgi + 16 * warp + gq, r_hi = r_lo + 8;
    const int last = g.Lk - 1;
    const int vis_lo = g.causal ? min(r_lo + g.q_offset, last) : last;
    const int vis_hi = g.causal ? min(r_hi + g.q_offset, last) : last;
    // the warpgroup's smallest limit: key tiles below it need no mask
    const int vis_min =
        g.causal ? min(p0 + 64 * wgi + g.q_offset, last) : last;
    // the rows' statistics; a row past Lq gets lse = +inf, so p = 0
    const long long so = (static_cast<long long>(b) * g.H + h) * g.Lq;
    const bool in_lo = r_lo < g.Lq, in_hi = r_hi < g.Lq;
    const float inf = __uint_as_float(0x7f800000u);
    const float lse_lo = in_lo ? lse[so + r_lo] : inf;
    const float lse_hi = in_hi ? lse[so + r_hi] : inf;
    const float dl_lo = in_lo ? delta[so + r_lo] : 0.f;
    const float dl_hi = in_hi ? delta[so + r_hi] : 0.f;
    // p = 2^(s·sl2 - l2): the scale and log2 e in one multiply-add
    constexpr float kLog2e = 1.4426950408889634f;
    const float sl2 = g.scale * kLog2e;
    const float l2_lo = lse_lo * kLog2e, l2_hi = lse_hi * kLog2e;
    int qs_lo = 0, qs_hi = 0;
    if constexpr (SEG) {
      const long long qb = static_cast<long long>(b) * g.Lq;
      qs_lo = in_lo ? qseg[qb + r_lo] : -1;
      qs_hi = in_hi ? qseg[qb + r_hi] : -1;
    }
    // descriptors of this warpgroup's q and dO rows and dS tile, and of
    // stage 0's K (K-major for the scores, MN-major for dq) and V
    unsigned char* dS = dSs + wgi * Sm::kDS;
    const uint64_t dq0 = hop::desc_sw128(Qs + 64 * wgi * 128, 0);
    const uint64_t ddo0 = hop::desc_sw128(dOs + 64 * wgi * 128, 0);
    const uint64_t dds0 = hop::desc_sw128(dS, 0);
    const uint64_t dk0 = hop::desc_sw128(KVs, 0);
    const uint64_t dkt0 = hop::desc_sw128(KVs, BK * 128);
    const uint64_t dv0 = hop::desc_sw128(KVs + Sm::kKV, 0);

    hop::mbar_wait(&qbar, 0);
    if constexpr (ROPE) {   // q rotated once, each row by its position
      mma::rope_sw128(Qs, BM, 64 * wgi, max(0, min(64 * wgi + 64, g.Lq - p0)),
                      rp.qcos, rp.qsin, p0, wt, 128);
      hop::fence_proxy_async();
      hop::bar_sync(1 + wgi, 128);
    }
    float acc[ND][4];
#pragma unroll
    for (int n = 0; n < ND; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[n][c] = 0.f;

    // Key tile t's stage has landed (and its K tile is rotated)
    auto landed = [&](int t) {
      if constexpr (ROPE)
        hop::mbar_wait(&kready[t % S], (t / S) & 1);
      else
        hop::mbar_wait(&full[t % S], (t / S) & 1);
    };
    // x = A·B^T over head_dim: A this warpgroup's q or dO rows, B key tile
    // t's K or V (both K-major)
    auto scores = [&](float (&x)[NT][4], uint64_t da0, uint64_t db0,
                      int t) {
      const uint64_t da = hop::opaque(da0);
      const uint64_t db =
          hop::opaque(hop::desc_at(db0, 2 * (t % S) * Sm::kKV));
      hop::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        hop::ss<BK>(x, hop::desc_at(da, (kk >> 2) * BM * 128 + (kk & 3) * 32),
                    hop::desc_at(db, (kk >> 2) * BK * 128 + (kk & 3) * 32),
                    kk > 0);
      hop::wgmma_commit();
    };
    // p of tile t in place of its finished scores: 0 where masked and
    // (SEG) across segments, where ds is 0
    auto p_step = [&](int t, float (&x)[NT][4]) {
      const int s = t % S, key0 = t * BK;
      hop::fence_regs(x);
      if (!SEG && key0 + BK - 1 <= vis_min) {
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          x[j][0] = exp2f(fmaf(x[j][0], sl2, -l2_lo));
          x[j][1] = exp2f(fmaf(x[j][1], sl2, -l2_lo));
          x[j][2] = exp2f(fmaf(x[j][2], sl2, -l2_hi));
          x[j][3] = exp2f(fmaf(x[j][3], sl2, -l2_hi));
        }
        return;
      }
      // pair (j, c) visible (and, SEG, within one segment)
      auto takes = [&](int j, int c) {
        const int col = 8 * j + 2 * tq + (c & 1);
        const bool up = c >= 2;
        return key0 + col <= (up ? vis_hi : vis_lo) &&
               (!SEG || (up ? qs_hi : qs_lo) == kseg_s[s * BK + col]);
      };
      if constexpr (SEG) {   // no pair of the warp's rows takes p: skip
        bool any = false;
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int c = 0; c < 4; ++c) any = any || takes(j, c);
        if (!__any_sync(0xffffffffu, any)) {
#pragma unroll
          for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int c = 0; c < 4; ++c) x[j][c] = 0.f;
          return;
        }
      }
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          x[j][c] = takes(j, c) ? exp2f(fmaf(x[j][c], sl2,
                                             -(c >= 2 ? l2_hi : l2_lo)))
                                : 0.f;
    };
    // ds = p (dp - delta) scale in place of p
    auto ds_step = [&](float (&x)[NT][4], float (&dp)[NT][4]) {
      hop::fence_regs(dp);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        x[j][0] = x[j][0] * (dp[j][0] - dl_lo) * g.scale;
        x[j][1] = x[j][1] * (dp[j][1] - dl_lo) * g.scale;
        x[j][2] = x[j][2] * (dp[j][2] - dl_hi) * g.scale;
        x[j][3] = x[j][3] * (dp[j][3] - dl_hi) * g.scale;
      }
    };
    float x[NT][4], dp[NT][4];
    // ds to bf16 into the dS tile (row r's 16-byte chunk j at j ^ (r % 8),
    // as a TMA box is swizzled; conflict-free), once this warpgroup's dq
    // product that read the last one is done; then visible to wgmma
    const int row = 16 * warp + gq;
    auto to_smem = [&]() {
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        unsigned char* c = dS + row * 128 + ((j ^ (gq & 7)) << 4) + 4 * tq;
        *reinterpret_cast<uint32_t*>(c) = mma::pack(x[j][0], x[j][1]);
        *reinterpret_cast<uint32_t*>(c + 8 * 128) =
            mma::pack(x[j][2], x[j][3]);
      }
      hop::fence_proxy_async();
      hop::bar_sync(1 + wgi, 128);
    };
    auto dq_product = [&](int t) {   // acc += ds·K of tile t
      const uint64_t da = hop::opaque(dds0);
      const uint64_t dkt =
          hop::opaque(hop::desc_at(dkt0, 2 * (t % S) * Sm::kKV));
      hop::fence_regs(acc);
      hop::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        hop::ss<D, 1>(acc, hop::desc_at(da, kk * 32),
                      hop::desc_at(dkt, kk * 2048), 1);
      hop::wgmma_commit();
    };
    // Every group inside the loops is issued unconditionally (the last
    // tile's dq product is peeled); groups complete in order.
    const int mine = 3 + wgi, other = 4 - wgi;
    if (wgi == 1) hop::bar_arrive(3, 256);   // warpgroup 0 goes first
    landed(0);
    hop::bar_sync(mine, 256);
    scores(x, dq0, dk0, 0);
    scores(dp, ddo0, dv0, 0);
    hop::bar_arrive(other, 256);
    hop::wgmma_wait<0>();
    p_step(0, x);
    ds_step(x, dp);
    to_smem();
    for (int t = 0; t + 1 < n_kt; ++t) {
      landed(t + 1);
      hop::bar_sync(mine, 256);
      dq_product(t);
      scores(x, dq0, dk0, t + 1);
      scores(dp, ddo0, dv0, t + 1);
      hop::bar_arrive(other, 256);
      hop::wgmma_wait<0>();
      hop::fence_regs(acc);
      hop::mbar_arrive(&empty[t % S]);
      p_step(t + 1, x);
      ds_step(x, dp);
      to_smem();
    }
    hop::bar_sync(mine, 256);
    dq_product(n_kt - 1);
    // the turns balance: warpgroup 1's first arrival stands for its last
    if (wgi == 0) hop::bar_arrive(other, 256);
    hop::wgmma_wait<0>();
    hop::fence_regs(acc);
    hop::mbar_arrive(&empty[(n_kt - 1) % S]);

    if constexpr (ROPE) {   // dQ back from rotated space: n and n + ND/2
      const long long t_lo = static_cast<long long>(min(r_lo, g.Lq - 1)) * D;
      const long long t_hi = static_cast<long long>(min(r_hi, g.Lq - 1)) * D;
#pragma unroll
      for (int n = 0; n < ND / 2; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          unrope_pair(acc[n][c], acc[n + ND / 2][c], rp.qcos, rp.qsin,
                      (c >= 2 ? t_hi : t_lo) + 8 * n + 2 * tq + (c & 1),
                      D / 2);
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = half ? r_hi : r_lo;
      if (r >= g.Lq) continue;
      __nv_bfloat16* dst =
          dq + ((static_cast<long long>(b) * g.Lq + r) * g.H + h) * D;
#pragma unroll
      for (int n = 0; n < ND; ++n)
        *reinterpret_cast<uint32_t*>(dst + 8 * n + 2 * tq) =
            mma::pack(acc[n][2 * half], acc[n][2 * half + 1]);
    }
  }
}

template <int D, bool SEG, bool ROPE = false>
int launch_dq(const BwdArgs& a, const Geom& g, cudaStream_t stream) {
  CUtensorMap tq, tdo, tk, tv;
  const uint64_t qw = static_cast<uint64_t>(g.H) * D;
  const uint64_t kw = static_cast<uint64_t>(g.Hkv) * D;
  if (hop::bf16_map(&tq, a.q, qw, g.Lq, g.B, kDqRows) ||
      hop::bf16_map(&tdo, a.dout, qw, g.Lq, g.B, kDqRows) ||
      hop::bf16_map(&tk, a.k, kw, g.Lk, g.B, kDqKeys) ||
      hop::bf16_map(&tv, a.v, kw, g.Lk, g.B, kDqKeys))
    return -2;
  const size_t smem = DqSmem<D>::kBytes;
  cudaError_t err = set_smem(dq_kernel<D, SEG, ROPE>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  static const bool regs = regs_ok(dq_kernel<D, SEG, ROPE>,
                                   DqRegs<ROPE>::kProducer,
                                   DqRegs<ROPE>::kConsumer);
  if (!regs) return -3;
  const dim3 grid(g.H, g.B, (g.Lq + kDqRows - 1) / kDqRows);
  dq_kernel<D, SEG, ROPE><<<grid, kThreads, smem, stream>>>(
      tq, tdo, tk, tv, static_cast<const float*>(a.lse),
      static_cast<const float*>(a.delta), a.qseg, a.kseg,
      a.rope.as<__nv_bfloat16>(), static_cast<__nv_bfloat16*>(a.dq), g);
  return static_cast<int>(cudaGetLastError());
}


}  // namespace wg

// ------------------------------------------------------------- launches
// key tiles: dK/dV as the forward (64, 32 at D 256); dQ 32 keys at
// D >= 128, which keeps two blocks per SM at D 128
template <int D>
struct DqTile {
  static constexpr int value = D >= 128 ? 32 : 64;
};

template <typename T, int D, bool SEG, bool ROPE = false>
int launch_dkv(const BwdArgs& a, const Geom& g, cudaStream_t stream) {
  constexpr int BK = KeyTile<D>::value;
  const size_t smem = sizeof(float) * (2 * D * (BK + 1) + 2 * kRows * (D + 4) +
                                       2 * kRows * (BK + 4) + 2 * kRows);
  if (g.Lk % BK != 0) return -1;
  cudaError_t err = set_smem(dkv_kernel<T, D, BK, SEG, ROPE>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(g.Lk / BK, g.Hkv, g.B);
  dkv_kernel<T, D, BK, SEG, ROPE><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      a.qseg, a.kseg, a.rope.as<T>(), static_cast<T*>(a.dk),
      static_cast<T*>(a.dv), g);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D, bool SEG, bool ROPE = false>
int launch_dq(const BwdArgs& a, const Geom& g, cudaStream_t stream) {
  constexpr int BK = DqTile<D>::value;
  const size_t smem = sizeof(float) * (2 * kRows * (D + 4) + D * (BK + 1) +
                                       kRows * (BK + 4) + 2 * kRows);
  if (g.Lk % BK != 0) return -1;
  cudaError_t err = set_smem(dq_kernel<T, D, BK, SEG, ROPE>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(g.Lq * g.G / kRows, g.Hkv, g.B);
  dq_kernel<T, D, BK, SEG, ROPE><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      a.qseg, a.kseg, a.rope.as<T>(), static_cast<T*>(a.dq), g);
  return static_cast<int>(cudaGetLastError());
}

// K4 (dq == false) or K5 of one dtype and head_dim on the CUDA cores
template <typename T, int D, bool SEG, bool ROPE = false>
int run(bool dq, const BwdArgs& a, const Geom& g, cudaStream_t s) {
  return dq ? launch_dq<T, D, SEG, ROPE>(a, g, s)
            : launch_dkv<T, D, SEG, ROPE>(a, g, s);
}

// the same on the tensor cores (bf16, wgmma)
template <int D, bool SEG, bool ROPE = false>
int run_wg(bool dq, const BwdArgs& a, const Geom& g, cudaStream_t s) {
  return dq ? wg::launch_dq<D, SEG, ROPE>(a, g, s)
            : wg::launch_dkv<D, SEG, ROPE>(a, g, s);
}

// K4 or K5 by dtype and head_dim: bf16 at head_dim 64/128 on the tensor
// cores, everything else on the CUDA cores
template <bool SEG>
int dispatch_bwd(bool dq, int dtype, int D, const BwdArgs& a, const Geom& g,
                 cudaStream_t s) {
  switch (dtype * 1000 + D) {
    case 64: return run<float, 64, SEG>(dq, a, g, s);
    case 128: return run<float, 128, SEG>(dq, a, g, s);
    case 256: return run<float, 256, SEG>(dq, a, g, s);
    case 1064: return run_wg<64, SEG>(dq, a, g, s);
    case 1128: return run_wg<128, SEG>(dq, a, g, s);
    case 1256: return run<__nv_bfloat16, 256, SEG>(dq, a, g, s);
    case 2064: return run<__half, 64, SEG>(dq, a, g, s);
    case 2128: return run<__half, 128, SEG>(dq, a, g, s);
    case 2256: return run<__half, 256, SEG>(dq, a, g, s);
    default: return -1;
  }
}

// The ROPE instances (K10): no segments, head_dim 128 and 256 — the
// shapes the gate admits; bf16 at 128 on the tensor cores
int dispatch_bwd_rope(bool dq, int dtype, int D, const BwdArgs& a,
                      const Geom& g, cudaStream_t s) {
  switch (dtype * 1000 + D) {
    case 128: return run<float, 128, false, true>(dq, a, g, s);
    case 256: return run<float, 256, false, true>(dq, a, g, s);
    case 1128: return run_wg<128, false, true>(dq, a, g, s);
    case 1256: return run<__nv_bfloat16, 256, false, true>(dq, a, g, s);
    case 2128: return run<__half, 128, false, true>(dq, a, g, s);
    case 2256: return run<__half, 256, false, true>(dq, a, g, s);
    default: return -1;
  }
}

inline int run_bwd(bool dq, int dtype, int D, const BwdArgs& a, int B, int H,
                   int Hkv, int Lq, int Lk, int causal, float scale,
                   void* stream) {
  if (Hkv <= 0 || H % Hkv != 0) return -1;
  if ((a.qseg == nullptr) != (a.kseg == nullptr)) return -1;
  if (a.rope.on() && (!a.rope.complete() || a.qseg != nullptr)) return -1;
  const Geom g{B, H, Hkv, H / Hkv, Lq, Lk, Lk - Lq, causal, scale};
  if ((Lq * g.G) % kRows != 0 || (causal && Lq > Lk)) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a.rope.on()) return dispatch_bwd_rope(dq, dtype, D, a, g, s);
  if (a.qseg != nullptr) return dispatch_bwd<true>(dq, dtype, D, a, g, s);
  return dispatch_bwd<false>(dq, dtype, D, a, g, s);
}

}  // namespace ptf

// dtype: 0 float32, 1 bfloat16, 2 float16.  dout/out [B, L, H*D];
// delta f32 [B, H, L].
extern "C" int flash_attention_delta(int dtype, const void* dout,
                                     const void* out, void* delta, int B,
                                     int L, int H, int D, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long rows = static_cast<long long>(B) * L * H;
  const unsigned blocks =
      static_cast<unsigned>((rows + ptf::kThreads / 32 - 1) /
                            (ptf::kThreads / 32));
  switch (dtype) {
    case 0:
      ptf::delta_kernel<float><<<blocks, ptf::kThreads, 0, s>>>(
          static_cast<const float*>(dout), static_cast<const float*>(out),
          static_cast<float*>(delta), B, L, H, D);
      break;
    case 1:
      ptf::delta_kernel<__nv_bfloat16><<<blocks, ptf::kThreads, 0, s>>>(
          static_cast<const __nv_bfloat16*>(dout),
          static_cast<const __nv_bfloat16*>(out), static_cast<float*>(delta),
          B, L, H, D);
      break;
    case 2:
      ptf::delta_kernel<__half><<<blocks, ptf::kThreads, 0, s>>>(
          static_cast<const __half*>(dout), static_cast<const __half*>(out),
          static_cast<float*>(delta), B, L, H, D);
      break;
    default:
      return -1;
  }
  return static_cast<int>(cudaGetLastError());
}

// q/dout [B, Lq, H*D], k/v/dk/dv [B, Lk, Hkv*D] (all in `dtype`),
// lse/delta f32 [B, H, Lq], qseg/kseg int32 [B, Lq]/[B, Lk] or both null,
// the rope tables as flash_attention_fwd (q and k raw; dq and dk come out
// as raw-space gradients) or all four null; geometry as
// flash_attention_fwd.
extern "C" int flash_attention_bwd_dkv(
    int dtype, const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, const void* qseg, const void* kseg,
    const void* qcos, const void* qsin, const void* kcos, const void* ksin,
    void* dk, void* dv, int B, int H, int Hkv, int Lq, int Lk, int D,
    int causal, float scale, void* stream) {
  const ptf::BwdArgs a{q, k, v, dout, lse, delta,
                       static_cast<const int*>(qseg),
                       static_cast<const int*>(kseg),
                       {qcos, qsin, kcos, ksin}, dk, dv, nullptr};
  return ptf::run_bwd(false, dtype, D, a, B, H, Hkv, Lq, Lk, causal, scale,
                      stream);
}

// dq [B, Lq, H*D] in `dtype`; the other operands as flash_attention_bwd_dkv.
extern "C" int flash_attention_bwd_dq(
    int dtype, const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, const void* qseg, const void* kseg,
    const void* qcos, const void* qsin, const void* kcos, const void* ksin,
    void* dq, int B, int H, int Hkv, int Lq, int Lk, int D, int causal,
    float scale, void* stream) {
  const ptf::BwdArgs a{q, k, v, dout, lse, delta,
                       static_cast<const int*>(qseg),
                       static_cast<const int*>(kseg),
                       {qcos, qsin, kcos, ksin}, nullptr, nullptr, dq};
  return ptf::run_bwd(true, dtype, D, a, B, H, Hkv, Lq, Lk, causal, scale,
                      stream);
}
