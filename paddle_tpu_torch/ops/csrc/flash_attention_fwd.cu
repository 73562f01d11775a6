// K1/K2 — flash-attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernels of _flash_fwd_pallas
// (paddle_tpu/ops/flash_attention.py): the resident kernel K1 (_fwd_kernel
// :85, pallas_call :653), which holds a kv head's whole K/V in VMEM, and
// the streamed kernel K2 (_fwd_kernel_streamed :255, pallas_call :571),
// which the TPU needs once K/V outgrow VMEM (Lk > 12288 at D 128).  Here
// K/V tiles always stream through shared memory, so one kernel has no
// residency limit and covers both.
//
// Every instance sweeps the key tiles with an f32 online softmax: scores
// s = q.k * scale, running max m (init -1e30), denominator l and
// accumulator rescaled by exp(m_old - m_new), masked keys given
// probability exactly 0, out = acc / max(l, 1e-30) in the input dtype,
// lse = m + log(max(l, 1e-30)) in f32 [B, H, Lq].  The causal mask is
// bottom-right aligned (query position p sees keys <= p + Lk - Lq), key
// tiles past a row tile's last visible key are skipped, and causal row
// tiles run last-first so the longest blocks start first.  As in the
// reference, p is rounded to the input dtype before p·V while l sums it
// unrounded.
//
// What bounds it on the card: operations, 4·D per (query head, visible
// key) pair — far above the bytes of q, k, v and out at training shapes.
// For bf16 at head_dim 64/128 (the training path) the `wg` instance below
// runs both products as wgmma on Hopper's tensor cores, fed by a TMA ring
// of K/V tiles in shared memory that a producer warp keeps ahead of two
// consumer warpgroups, each of which overlaps one tile's softmax with the
// previous tile's P·V; what holds it back now is the softmax on the CUDA
// cores between the products and one block per SM (its note says more).
// f32, f16 and head_dim 256 take a CUDA-core path: block (row tile, kv
// head, batch) holds 64 flattened query rows of the kv head's G query
// heads (flash_tile.cuh), one K/V tile in shared memory feeds all G heads,
// and each thread computes a 4 x 4 score and a 4 x D/16 output micro-tile
// from registers.
//
// Segment masks (the reference's segmented=True branches, :122-134 and
// :170-173 of _fwd_kernel, :291-295 of _fwd_kernel_streamed; the
// padding/varlen masks of BERT and flash_attn_unpadded) are a
// compile-time switch SEG of every template: each key tile's int32
// segment ids are loaded into shared memory beside K/V, each thread keeps
// its rows' query ids in registers,
// and a cross-segment score takes the finite sentinel -1e30
// (flash_tile.cuh says why); rows with a negative query segment write
// zeros.  No key tile is skipped by segment: a dead row needs every key.
//
// In-kernel RoPE (K10: the rope=True branch of _fwd_kernel, :116-121,
// :147-149, :162-165, reached through flash_attention_packed_rope :1370)
// is the compile-time switch ROPE of the same templates, instantiated
// without segments at head_dim 128 (bf16: the wgmma instance) and 256:
// the q tile is rotated once in shared memory after it lands, each K tile
// as it lands, each row by its position's table row (flash_tile.cuh), so
// the products read the same rounded tiles as K6 followed by K1 would.
// The rotation costs 3 operations per element of q and of each K tile, on
// the CUDA cores: ~1% of the kernel's operations at the Llama shape.
#include "flash_tile.cuh"
#include "hopper.cuh"

#include <climits>

namespace ptf {

template <typename T, int D, int BK, bool SEG, bool ROPE>
__global__ void __launch_bounds__(kThreads)
    fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, T* __restrict__ out,
               float* __restrict__ lse, const int* __restrict__ qseg,
               const int* __restrict__ kseg, Rope<T> rp, Geom g) {
  constexpr int QS = D + 4, KS = BK + 1, PS = BK + 4;
  constexpr int CJ = BK / 16, CD = D / 16;
  constexpr int KVF = D * KS > BK * D ? D * KS : BK * D;
  extern __shared__ float smem[];
  float* Qs = smem;              // [64][QS]
  float* KV = Qs + kRows * QS;   // K^T [D][KS], then V [BK][D]
  float* Ps = KV + KVF;          // [64][PS]
  __shared__ int kseg_s[SEG ? BK : 1];

  const int n_tiles = g.Lq * g.G / kRows;
  const int tile = g.causal ? n_tiles - 1 - blockIdx.x : blockIdx.x;
  const int r0 = tile * kRows, kvh = blockIdx.y, b = blockIdx.z;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;

  load_rows<T, D>(Qs, QS, q, g, b, kvh, r0);
  if constexpr (ROPE) {
    __syncthreads();   // the q tile has landed; the sweep's barrier follows
    rope_tile<T, D, kThreads>(Qs, QS, 1, kRows, rp.qcos, rp.qsin, r0, g.G);
  }

  int vis[4];   // last key each of the thread's rows may see
  int qs[4];    // the rows' segments (SEG)
  float m[4], l[4], acc[4][CD];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    vis[i] = g.causal ? (r0 + 4 * ty + i) / g.G + g.q_offset : g.Lk - 1;
    qs[i] = SEG ? row_seg(qseg, g, b, r0 + 4 * ty + i) : 0;
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CD; ++c) acc[i][c] = 0.f;
  }
  const int key_end =
      g.causal ? min(g.Lk, (r0 + kRows - 1) / g.G + g.q_offset + 1) : g.Lk;
  const long long stride = static_cast<long long>(g.Hkv) * D;
  const long long kv0 = static_cast<long long>(b) * g.Lk * stride +
                        static_cast<long long>(kvh) * D;

  for (int key0 = 0; key0 < key_end; key0 += BK) {
    __syncthreads();   // the previous tile's V and P reads are done
    load_keys_t<T, D, BK>(KV, k, kv0 + key0 * stride, stride);
    if (SEG && threadIdx.x < BK)
      kseg_s[threadIdx.x] = kseg[static_cast<long long>(b) * g.Lk + key0 +
                                 threadIdx.x];
    __syncthreads();
    if constexpr (ROPE) {   // the K^T tile [D][KS], rotated where it landed
      rope_tile<T, D, kThreads>(KV, 1, KS, BK, rp.kcos, rp.ksin, key0, 1);
      __syncthreads();
    }
    float s[4][CJ];
    tile_dot<D, CJ>(s, Qs, QS, KV, KS, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = neg_inf();
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const int key = key0 + tx + 16 * j;
        if constexpr (SEG)
          s[i][j] = seg_score(s[i][j] * g.scale, key <= vis[i],
                              qs[i] == kseg_s[tx + 16 * j]);
        else
          s[i][j] = key <= vis[i] ? s[i][j] * g.scale : neg_inf();
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], max16(mx));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        s[i][j] = expf(s[i][j] - m_new);   // masked: exp(-inf) = 0
        sum += s[i][j];
      }
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + sum16(sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < CD; ++c) acc[i][c] *= corr;
      // p·V takes p rounded to the input dtype, as the reference does
#pragma unroll
      for (int j = 0; j < CJ; ++j)
        Ps[(4 * ty + i) * PS + tx + 16 * j] = to_f32(from_f32<T>(s[i][j]));
    }
    __syncthreads();   // K^T reads done, P written
    load_keys<T, D, BK>(KV, v, kv0 + key0 * stride, stride);
    __syncthreads();
#pragma unroll 4
    for (int sk = 0; sk < BK; ++sk) {
      float p[4], vv[CD];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = Ps[(4 * ty + i) * PS + sk];
#pragma unroll
      for (int c = 0; c < CD; ++c) vv[c] = KV[sk * D + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < CD; ++c) acc[i][c] = fmaf(p[i], vv[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + 4 * ty + i;
    const float ls = fmaxf(l[i], 1e-30f);
    const long long o = row_off<D>(g, b, kvh, r);
    const bool pad = SEG && qs[i] < 0;    // a padding row writes zeros
#pragma unroll
    for (int c = 0; c < CD; ++c)
      out[o + tx + 16 * c] = from_f32<T>(pad ? 0.f : acc[i][c] / ls);
    if (tx == 0) lse[stat_off(g, b, kvh, r)] = m[i] + logf(ls);
  }
}

template <typename T, int D, bool SEG, bool ROPE = false>
int launch(const void* q, const void* k, const void* v, void* out, void* lse,
           const int* qseg, const int* kseg, const RopePtrs& rp,
           const Geom& g, cudaStream_t stream) {
  constexpr int BK = KeyTile<D>::value;
  constexpr int KVF = D * (BK + 1) > BK * D ? D * (BK + 1) : BK * D;
  const size_t smem =
      sizeof(float) * (kRows * (D + 4) + KVF + kRows * (BK + 4));
  if (g.Lk % BK != 0) return -1;
  cudaError_t err = set_smem(fwd_kernel<T, D, BK, SEG, ROPE>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(g.Lq * g.G / kRows, g.Hkv, g.B);
  fwd_kernel<T, D, BK, SEG, ROPE><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out),
      static_cast<float*>(lse), qseg, kseg, rp.as<T>(), g);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------ tensor-core path (bf16, wgmma)
// The same function for bf16 inputs at head_dim 64/128 on Hopper's
// asynchronous tensor-core path (hopper.cuh).  Block (head h, batch b,
// position tile) owns kBM = 128 query positions of ONE query head — a
// rectangle of the packed [B, Lq, H*D] tensor, so q arrives by one TMA
// load (rows past Lq zero-filled) whatever G is; the G heads of a kv head
// read the same K/V tiles through L2.  Three warpgroups, one if/else over
// roles: a producer warp keeps a ring of kFwdStages stages of K and V
// tiles (FwdSmem::kKeys keys each, TMA, 128-byte swizzle) in flight, with
// the key tile's segment ids beside them (SEG), and two consumer
// warpgroups own 64 positions each.  Per key tile a consumer takes
// S = q·K^T (wgmma, both operands in shared memory, K-major), runs the
// online softmax on the accumulator fragments (a row's max and sum over
// its 4 lanes by shuffles), rounds p to bf16 straight into wgmma's
// register A operand (the C layout of one product is the A layout of the
// next) and adds P·V with V read MN-major through the instruction's
// transpose bit — no transposed copy of V — and the next tile's S is
// issued before this tile's P·V so that its softmax overlaps the product.
// setmaxnreg gives the consumers 240 registers and the producer 24;
// ptxas keeps wgmma accumulators within ~168 registers all the same, so
// a stage holds 64 keys (S, P and O: 128 registers at head_dim 128; 128
// keys at head_dim 64 spilled).  Key tiles past the block's last visible
// key are skipped and only those that cross a row's limit are masked;
// causal blocks start with the longest (blockIdx.z counts from the last
// position tile).  ROPE: each consumer warpgroup rotates its q rows once
// after they land, and the two rotate each K tile together in shared
// memory before the first product reads it (generic writes, then
// fence.proxy.async and a named barrier).  The tile sizes and stage
// counts are flash_probe.py sweep's.
namespace wg {

#ifndef PTF_FWD_KEYS
#define PTF_FWD_KEYS 64
#endif
#ifndef PTF_FWD_STAGES
#define PTF_FWD_STAGES 4
#endif
constexpr int kBM = 64 * kConsumers;             // query positions a block
constexpr int kFwdStages = PTF_FWD_STAGES;       // stages in the ring

template <int D>
struct FwdSmem {
  static constexpr int kKeys = PTF_FWD_KEYS;     // keys a ring stage
  static constexpr int kQ = kBM * D * 2;         // bytes of the q tile
  static constexpr int kKV = kKeys * D * 2;      // of one K or V tile
  static constexpr size_t kBytes =
      1024 + kQ + 2 * kFwdStages * kKV + kFwdStages * kKeys * 4;
};

template <int D, bool SEG, bool ROPE>
__global__ void __launch_bounds__(kThreads, 1)
    fwd_kernel(const __grid_constant__ CUtensorMap tq,
               const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tv,
               __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
               const int* __restrict__ qseg, const int* __restrict__ kseg,
               Rope<__nv_bfloat16> rp, Geom g) {
  using Sm = FwdSmem<D>;
  constexpr int BK = Sm::kKeys, S = kFwdStages, NB = D / 64, NT = BK / 8;
  constexpr int ND = D / 8;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* Qs = align1024(smem_raw);       // [NB][kBM][64]
  unsigned char* KVs = Qs + Sm::kQ;              // stage s: K, then V
  int* kseg_s = reinterpret_cast<int*>(KVs + 2 * S * Sm::kKV);   // [S][BK]
  __shared__ __align__(8) uint64_t full[S], empty[S], qbar;

  const int n_pt = (g.Lq + kBM - 1) / kBM;
  const int pt = g.causal ? n_pt - 1 - static_cast<int>(blockIdx.z)
                          : static_cast<int>(blockIdx.z);
  const int h = blockIdx.x, b = blockIdx.y, kvh = h / g.G;
  const int p0 = pt * kBM;
  const int key_end =
      g.causal ? min(g.Lk, min(p0 + kBM, g.Lq) - 1 + g.q_offset + 1) : g.Lk;
  const int n_kt = (key_end + BK - 1) / BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      hop::mbar_init(&full[s], 32);
      hop::mbar_init(&empty[s], 128 * kConsumers);
    }
    hop::mbar_init(&qbar, 1);
    hop::mbar_fence_init();
  }
  __syncthreads();

  if (hop::warpgroup() == 0) {
    // ---- producer warpgroup: one warp issues the loads
    hop::regs_dec<kProducerRegs>();
    const int lane = threadIdx.x & 31;
    if (hop::warp_in_warpgroup() == 0) {
      if (lane == 0) {
        hop::mbar_arrive_tx(&qbar, Sm::kQ);
        for (int c = 0; c < NB; ++c)
          hop::tma_load_3d(Qs + c * kBM * 128, &tq, &qbar, h * D + 64 * c,
                           p0, b);
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
    }
  } else {
    // ---- consumer warpgroups: 64 query positions each
    hop::regs_inc<kConsumerRegs>();
    const int wgi = hop::warpgroup() - 1;
    const int ct = threadIdx.x - 128;            // 0 .. 255
    const int wt = threadIdx.x & 127;
    const int warp = wt >> 5, lane = wt & 31, gq = lane >> 2, tq = lane & 3;
    const int r_lo = p0 + 64 * wgi + 16 * warp + gq, r_hi = r_lo + 8;
    const int last = g.Lk - 1;
    const int vis_lo = g.causal ? min(r_lo + g.q_offset, last) : last;
    const int vis_hi = g.causal ? min(r_hi + g.q_offset, last) : last;
    // the warpgroup's smallest limit: key tiles below it need no mask
    const int vis_min =
        g.causal ? min(p0 + 64 * wgi + g.q_offset, last) : last;
    int qs_lo = 0, qs_hi = 0;
    if constexpr (SEG) {
      const long long qb = static_cast<long long>(b) * g.Lq;
      qs_lo = r_lo < g.Lq ? qseg[qb + r_lo] : -1;
      qs_hi = r_hi < g.Lq ? qseg[qb + r_hi] : -1;
    }
    // descriptors of this warpgroup's q rows and of stage 0's K and V
    const uint64_t dq0 = hop::desc_sw128(Qs + 64 * wgi * 128, 0);
    const uint64_t dk0 = hop::desc_sw128(KVs, 0);
    const uint64_t dv0 = hop::desc_sw128(KVs + Sm::kKV, BK * 128);

    hop::mbar_wait(&qbar, 0);
    if constexpr (ROPE) {   // q rotated once, each row by its position
      mma::rope_sw128(Qs, kBM, 64 * wgi, min(64 * wgi + 64, g.Lq - p0),
                      rp.qcos, rp.qsin, p0, wt, 128);
      hop::fence_proxy_async();
      hop::bar_sync(2 + wgi, 128);
    }
    float m_lo = kNegInf, m_hi = kNegInf, l_lo = 0.f, l_hi = 0.f;
    float o[ND][4];
#pragma unroll
    for (int n = 0; n < ND; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;

    // Key tile t's scores S = q·K^T, issued once its stage has landed (and
    // its K tile is rotated)
    auto score = [&](int t, float (&sc)[NT][4]) {
      const int s = t % S;
      hop::mbar_wait(&full[s], (t / S) & 1);
      if constexpr (ROPE) {   // the K tile, rotated by both warpgroups
        mma::rope_sw128(KVs + 2 * s * Sm::kKV, BK, 0, min(BK, g.Lk - t * BK),
                        rp.kcos, rp.ksin, t * BK, ct, 128 * kConsumers);
        hop::fence_proxy_async();
        hop::bar_sync(1, 128 * kConsumers);
      }
      const uint64_t dq = hop::opaque(dq0);
      const uint64_t dk = hop::opaque(hop::desc_at(dk0, 2 * s * Sm::kKV));
      hop::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        hop::ss<BK>(sc, hop::desc_at(dq, (kk >> 2) * kBM * 128 + (kk & 3) * 32),
                    hop::desc_at(dk, (kk >> 2) * BK * 128 + (kk & 3) * 32),
                    kk > 0);
      hop::wgmma_commit();
    };
    // The online softmax of tile t's finished scores, p in their place:
    // the running max and sum move on, and (c_lo, c_hi) is what the output
    // must be scaled by before tile t's P·V (l sums the unrounded p)
    auto softmax = [&](int t, float (&sc)[NT][4], float& c_lo,
                       float& c_hi) {
      const int s = t % S, key0 = t * BK;
      hop::fence_regs(sc);
      if (SEG || key0 + BK - 1 > vis_min) {
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const int key = key0 + 8 * j + 2 * tq;
          if constexpr (SEG) {
            const int k0 = kseg_s[s * BK + 8 * j + 2 * tq];
            const int k1 = kseg_s[s * BK + 8 * j + 2 * tq + 1];
            sc[j][0] = seg_score(sc[j][0] * g.scale, key <= vis_lo,
                                 qs_lo == k0);
            sc[j][1] = seg_score(sc[j][1] * g.scale, key + 1 <= vis_lo,
                                 qs_lo == k1);
            sc[j][2] = seg_score(sc[j][2] * g.scale, key <= vis_hi,
                                 qs_hi == k0);
            sc[j][3] = seg_score(sc[j][3] * g.scale, key + 1 <= vis_hi,
                                 qs_hi == k1);
          } else {
            sc[j][0] = key <= vis_lo ? sc[j][0] * g.scale : neg_inf();
            sc[j][1] = key + 1 <= vis_lo ? sc[j][1] * g.scale : neg_inf();
            sc[j][2] = key <= vis_hi ? sc[j][2] * g.scale : neg_inf();
            sc[j][3] = key + 1 <= vis_hi ? sc[j][3] * g.scale : neg_inf();
          }
        }
      } else {
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int c = 0; c < 4; ++c) sc[j][c] *= g.scale;
      }
      float mx_lo = neg_inf(), mx_hi = neg_inf();
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        mx_lo = fmaxf(mx_lo, fmaxf(sc[j][0], sc[j][1]));
        mx_hi = fmaxf(mx_hi, fmaxf(sc[j][2], sc[j][3]));
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
        sc[j][0] = exp_ex2(sc[j][0] - mn_lo);   // masked: exp(-inf) = 0
        sc[j][1] = exp_ex2(sc[j][1] - mn_lo);
        sc[j][2] = exp_ex2(sc[j][2] - mn_hi);
        sc[j][3] = exp_ex2(sc[j][3] - mn_hi);
        sum_lo += sc[j][0] + sc[j][1];
        sum_hi += sc[j][2] + sc[j][3];
      }
#pragma unroll
      for (int x = 1; x <= 2; x <<= 1) {
        sum_lo += __shfl_xor_sync(0xffffffffu, sum_lo, x);
        sum_hi += __shfl_xor_sync(0xffffffffu, sum_hi, x);
      }
      c_lo = exp_ex2(m_lo - mn_lo);
      c_hi = exp_ex2(m_hi - mn_hi);
      l_lo = l_lo * c_lo + sum_lo;
      l_hi = l_hi * c_hi + sum_hi;
      m_lo = mn_lo;
      m_hi = mn_hi;
    };

    // Software-pipelined: tile t+1's scores are issued before tile t's
    // P·V and their softmax runs while that product does; groups complete
    // in order (wait_group 1: t+1's scores, 0: t's P·V).  ptxas keeps the
    // products asynchronous only if every group inside the loop is issued
    // unconditionally (the last tile's P·V is peeled) and no register of
    // an operand in flight is written: p goes to bf16 into the A operand
    // (the reference's rounding point) once the previous P·V is done.  The
    // output is scaled for tile t+1 then too, so it takes exactly the
    // unpipelined order of operations.
    float sc[NT][4], c_lo, c_hi;
    uint32_t pa[BK / 16][4];
    auto to_a = [&]() {
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        mma::a_frag(sc[2 * kk], sc[2 * kk + 1], pa[kk]);
    };
    auto pv = [&](int t) {   // o += P·V of tile t
      const uint64_t dv =
          hop::opaque(hop::desc_at(dv0, 2 * (t % S) * Sm::kKV));
      hop::fence_regs(o);
      hop::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        hop::rs<D>(o, pa[kk], hop::desc_at(dv, kk * 2048), 1);
      hop::wgmma_commit();
    };
    score(0, sc);
    hop::wgmma_wait<0>();
    softmax(0, sc, c_lo, c_hi);              // the output is still zero
    to_a();
    for (int t = 0; t + 1 < n_kt; ++t) {
      score(t + 1, sc);
      pv(t);
      hop::wgmma_wait<1>();
      softmax(t + 1, sc, c_lo, c_hi);
      hop::wgmma_wait<0>();
      hop::fence_regs(o);
      hop::mbar_arrive(&empty[t % S]);
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        o[n][0] *= c_lo;
        o[n][1] *= c_lo;
        o[n][2] *= c_hi;
        o[n][3] *= c_hi;
      }
      to_a();
    }
    pv(n_kt - 1);
    hop::wgmma_wait<0>();
    hop::fence_regs(o);
    hop::mbar_arrive(&empty[(n_kt - 1) % S]);

    const float ls_lo = fmaxf(l_lo, 1e-30f), ls_hi = fmaxf(l_hi, 1e-30f);
    // a padding row (negative segment) writes zeros
    const bool pad_lo = SEG && qs_lo < 0, pad_hi = SEG && qs_hi < 0;
    const long long bh = static_cast<long long>(b) * g.H + h;
    if (r_lo < g.Lq) {
      __nv_bfloat16* dst =
          out + ((static_cast<long long>(b) * g.Lq + r_lo) * g.H + h) * D;
#pragma unroll
      for (int n = 0; n < ND; ++n)
        *reinterpret_cast<uint32_t*>(dst + 8 * n + 2 * tq) =
            pad_lo ? 0u : mma::pack(o[n][0] / ls_lo, o[n][1] / ls_lo);
      if (tq == 0) lse[bh * g.Lq + r_lo] = m_lo + logf(ls_lo);
    }
    if (r_hi < g.Lq) {
      __nv_bfloat16* dst =
          out + ((static_cast<long long>(b) * g.Lq + r_hi) * g.H + h) * D;
#pragma unroll
      for (int n = 0; n < ND; ++n)
        *reinterpret_cast<uint32_t*>(dst + 8 * n + 2 * tq) =
            pad_hi ? 0u : mma::pack(o[n][2] / ls_hi, o[n][3] / ls_hi);
      if (tq == 0) lse[bh * g.Lq + r_hi] = m_hi + logf(ls_hi);
    }
  }
}

template <int D, bool SEG, bool ROPE = false>
int launch(const void* q, const void* k, const void* v, void* out, void* lse,
           const int* qseg, const int* kseg, const RopePtrs& rp,
           const Geom& g, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  if (hop::bf16_map(&tq, q, static_cast<uint64_t>(g.H) * D, g.Lq, g.B,
                    kBM) ||
      hop::bf16_map(&tk, k, static_cast<uint64_t>(g.Hkv) * D, g.Lk, g.B,
                    FwdSmem<D>::kKeys) ||
      hop::bf16_map(&tv, v, static_cast<uint64_t>(g.Hkv) * D, g.Lk, g.B,
                    FwdSmem<D>::kKeys))
    return -2;
  const size_t smem = FwdSmem<D>::kBytes;
  cudaError_t err = set_smem(fwd_kernel<D, SEG, ROPE>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  static const bool regs = regs_ok(fwd_kernel<D, SEG, ROPE>);
  if (!regs) return -3;
  const dim3 grid(g.H, g.B, (g.Lq + kBM - 1) / kBM);
  fwd_kernel<D, SEG, ROPE><<<grid, kThreads, smem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(out), static_cast<float*>(lse),
      qseg, kseg, rp.as<__nv_bfloat16>(), g);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace wg

template <typename T, bool SEG>
int dispatch_d(int D, const void* q, const void* k, const void* v, void* out,
               void* lse, const int* qs, const int* ks, const RopePtrs& rp,
               const Geom& g, cudaStream_t s) {
  switch (D) {
    case 64: return launch<T, 64, SEG>(q, k, v, out, lse, qs, ks, rp, g, s);
    case 128: return launch<T, 128, SEG>(q, k, v, out, lse, qs, ks, rp, g, s);
    case 256: return launch<T, 256, SEG>(q, k, v, out, lse, qs, ks, rp, g, s);
    default: return -1;
  }
}

template <bool SEG>
int dispatch(int dtype, int D, const void* q, const void* k, const void* v,
             void* out, void* lse, const int* qs, const int* ks,
             const RopePtrs& rp, const Geom& g, cudaStream_t s) {
  switch (dtype) {
    case 0:
      return dispatch_d<float, SEG>(D, q, k, v, out, lse, qs, ks, rp, g, s);
    case 1:   // bf16: the tensor cores where the fragments fit registers
      switch (D) {
        case 64:
          return wg::launch<64, SEG>(q, k, v, out, lse, qs, ks, rp, g, s);
        case 128:
          return wg::launch<128, SEG>(q, k, v, out, lse, qs, ks, rp, g, s);
        case 256:
          return launch<__nv_bfloat16, 256, SEG>(q, k, v, out, lse, qs, ks,
                                                 rp, g, s);
        default: return -1;
      }
    case 2:
      return dispatch_d<__half, SEG>(D, q, k, v, out, lse, qs, ks, rp, g, s);
    default: return -1;
  }
}

// The ROPE instances (K10): no segments, head_dim 128 and 256 — the
// shapes the gate admits; bf16 at 128 on the tensor cores
int dispatch_rope(int dtype, int D, const void* q, const void* k,
                  const void* v, void* out, void* lse, const RopePtrs& rp,
                  const Geom& g, cudaStream_t s) {
  switch (dtype * 1000 + D) {
    case 128:
      return launch<float, 128, false, true>(q, k, v, out, lse, nullptr,
                                             nullptr, rp, g, s);
    case 256:
      return launch<float, 256, false, true>(q, k, v, out, lse, nullptr,
                                             nullptr, rp, g, s);
    case 1128:
      return wg::launch<128, false, true>(q, k, v, out, lse, nullptr,
                                           nullptr, rp, g, s);
    case 1256:
      return launch<__nv_bfloat16, 256, false, true>(q, k, v, out, lse,
                                                     nullptr, nullptr, rp, g,
                                                     s);
    case 2128:
      return launch<__half, 128, false, true>(q, k, v, out, lse, nullptr,
                                              nullptr, rp, g, s);
    case 2256:
      return launch<__half, 256, false, true>(q, k, v, out, lse, nullptr,
                                              nullptr, rp, g, s);
    default: return -1;
  }
}

}  // namespace ptf

// dtype: 0 float32, 1 bfloat16, 2 float16 (q, k, v, out and the rope
// tables).  q/out [B, Lq, H*D], k/v [B, Lk, Hkv*D], lse f32 [B, H, Lq];
// H % Hkv == 0, D in {64, 128, 256}, Lq*G a multiple of 64, Lk a multiple
// of 64 (32 at D 256), causal requires Lq <= Lk.  qseg/kseg: int32 segment
// ids [B, Lq]/[B, Lk], both null for unsegmented attention.  qcos/qsin
// [Lq, D] and kcos/ksin [Lk, D] (sin pre-signed): rotate q and k in the
// kernel (RoPE, K10; D 128/256, no segments), all four null for none.
// Returns the launch's cudaError_t (0 = ok, -1 = a shape the kernel does
// not take).
extern "C" int flash_attention_fwd(int dtype, const void* q, const void* k,
                                   const void* v, void* out, void* lse,
                                   const void* qseg, const void* kseg,
                                   const void* qcos, const void* qsin,
                                   const void* kcos, const void* ksin, int B,
                                   int H, int Hkv, int Lq, int Lk, int D,
                                   int causal, float scale, void* stream) {
  if (Hkv <= 0 || H % Hkv != 0) return -1;
  if ((qseg == nullptr) != (kseg == nullptr)) return -1;
  const ptf::RopePtrs rp{qcos, qsin, kcos, ksin};
  if (rp.on() && (!rp.complete() || qseg != nullptr)) return -1;
  const ptf::Geom g{B, H, Hkv, H / Hkv, Lq, Lk, Lk - Lq, causal, scale};
  if ((Lq * g.G) % ptf::kRows != 0 || (causal && Lq > Lk)) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rp.on())
    return ptf::dispatch_rope(dtype, D, q, k, v, out, lse, rp, g, s);
  const int* qs = static_cast<const int*>(qseg);
  const int* ks = static_cast<const int*>(kseg);
  if (qs != nullptr)
    return ptf::dispatch<true>(dtype, D, q, k, v, out, lse, qs, ks, rp, g, s);
  return ptf::dispatch<false>(dtype, D, q, k, v, out, lse, qs, ks, rp, g, s);
}
