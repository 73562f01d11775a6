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
//    in shared memory and dK/dV in registers, and sweeps the flattened
//    query rows of all G heads (flash_tile.cuh): the G heads' sum happens
//    in-block, with no atomics.  Causal blocks start at the first row
//    tile that sees their keys.
//  * dQ (K5): block (row tile, kv head, batch) keeps q, do and dQ and
//    sweeps the key tiles (causal: up to the tile's last visible key).
//    K/V stream through shared memory, so it has no residency limit and
//    is also the streamed variant.
//
// What bounds K4 and K5 on the card: operations (the two passes together
// do 2.5x the forward's, 10·D per visible (query head, key) pair, counting
// the score recomputed in both passes once).  For bf16 at head_dim 64/128
// (the training path) both run their products on the tensor cores (the
// `mma` paths below); f32, f16 and head_dim 256 run in f32 on the CUDA
// cores with register micro-tiles.  wgmma, TMA, a pipelined tile ring and
// a single fused pass are later work.  As in the reference, p and ds are
// computed in f32 and rounded to the input dtype where they enter a
// product (dV = p^T·do, dK = ds^T·q, dQ = ds·k); ds is built from the
// unrounded p.  Every sum runs in a fixed order: results are bitwise
// reproducible.
#include "flash_tile.cuh"

namespace ptf {

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
template <typename T, int D, int BK>
__global__ void __launch_bounds__(kThreads)
    dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const T* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ delta,
               T* __restrict__ dk, T* __restrict__ dv, Geom g) {
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

  const int key0 = blockIdx.x * BK, kvh = blockIdx.y, b = blockIdx.z;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const long long stride = static_cast<long long>(g.Hkv) * D;
  const long long kv0 = (static_cast<long long>(b) * g.Lk + key0) * stride +
                        static_cast<long long>(kvh) * D;
  load_keys_t<T, D, BK>(Kt, k, kv0, stride);
  load_keys_t<T, D, BK>(Vt, v, kv0, stride);

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
    }
    __syncthreads();
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
        const float p =
            key0 + col <= vis ? expf(s[i][j] * g.scale - lse_s[rr]) : 0.f;
        Ps[rr * PS + col] = to_f32(from_f32<T>(p));
        dSs[rr * PS + col] =
            to_f32(from_f32<T>(p * (dp[i][j] - dl_s[rr]) * g.scale));
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
template <typename T, int D, int BK>
__global__ void __launch_bounds__(kThreads)
    dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const T* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              T* __restrict__ dq, Geom g) {
  constexpr int QS = D + 4, KS = BK + 1, PS = BK + 4;
  constexpr int CJ = BK / 16, CD = D / 16;
  extern __shared__ float smem[];
  float* Qs = smem;               // [64][QS]
  float* dOs = Qs + kRows * QS;   // [64][QS]
  float* KV = dOs + kRows * QS;   // V^T, then K^T [D][KS]
  float* dSs = KV + D * KS;       // [64][PS]
  float* lse_s = dSs + kRows * PS;
  float* dl_s = lse_s + kRows;

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
  int vis[4];
  float acc[4][CD];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    vis[i] = g.causal ? (r0 + 4 * ty + i) / g.G + g.q_offset : g.Lk - 1;
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
    __syncthreads();
    float dp[4][CJ], s[4][CJ];
    tile_dot<D, CJ>(dp, dOs, QS, KV, KS, ty, tx);
    __syncthreads();
    load_keys_t<T, D, BK>(KV, k, kv0 + key0 * stride, stride);
    __syncthreads();
    tile_dot<D, CJ>(s, Qs, QS, KV, KS, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int rr = 4 * ty + i;
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const int col = tx + 16 * j;
        const float p =
            key0 + col <= vis[i] ? expf(s[i][j] * g.scale - lse_s[rr]) : 0.f;
        dSs[rr * PS + col] =
            to_f32(from_f32<T>(p * (dp[i][j] - dl_s[rr]) * g.scale));
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
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long o = row_off<D>(g, b, kvh, r0 + 4 * ty + i);
#pragma unroll
    for (int c = 0; c < CD; ++c) dq[o + tx + 16 * c] = from_f32<T>(acc[i][c]);
  }
}

// ------------------------------------------- K5 on the tensor cores (bf16)
// dQ for bf16 at head_dim 64/128 with the three products on the tensor
// cores (mma.sync, flash_tile.cuh): block = 4 warps over 64 rows, q
// fragments in registers, per 64-key tile s = q·K^T and dp = do·V^T into
// f32 fragments, ds = p (dp - delta) scale in registers, dq += ds·K with
// ds rounded to bf16 straight into the A fragments (the reference's
// rounding point).
namespace mma {

template <int D>
__global__ void __launch_bounds__(kThreads)
    dq_kernel(const __nv_bfloat16* __restrict__ q,
              const __nv_bfloat16* __restrict__ k,
              const __nv_bfloat16* __restrict__ v,
              const __nv_bfloat16* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              __nv_bfloat16* __restrict__ dq, Geom g) {
  constexpr int QS = D + 8, VS = kKeys + 8;
  constexpr int KD = D / 16, NT = kKeys / 8, ND = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* dOs = Qs + kRows * QS;   // [64][QS]
  __nv_bfloat16* Ks = dOs + kRows * QS;   // [64 keys][QS]
  __nv_bfloat16* Vs = Ks + kKeys * QS;    // [64 keys][QS]
  __nv_bfloat16* Kt = Vs + kKeys * QS;    // [D][VS]

  const int n_tiles = g.Lq * g.G / kRows;
  const int tile = g.causal ? n_tiles - 1 - blockIdx.x : blockIdx.x;
  const int r0 = tile * kRows, kvh = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const int lo = 16 * warp + gq, hi = lo + 8;

  load_rows<D>(Qs, q, g, b, kvh, r0);
  load_rows<D>(dOs, dout, g, b, kvh, r0);
  __syncthreads();
  uint32_t qa[KD][4];
#pragma unroll
  for (int kk = 0; kk < KD; ++kk) {
    qa[kk][0] = ld32(Qs + lo * QS + 16 * kk + 2 * tq);
    qa[kk][1] = ld32(Qs + hi * QS + 16 * kk + 2 * tq);
    qa[kk][2] = ld32(Qs + lo * QS + 16 * kk + 8 + 2 * tq);
    qa[kk][3] = ld32(Qs + hi * QS + 16 * kk + 8 + 2 * tq);
  }
  const float lse_lo = lse[stat_off(g, b, kvh, r0 + lo)];
  const float lse_hi = lse[stat_off(g, b, kvh, r0 + hi)];
  const float dl_lo = delta[stat_off(g, b, kvh, r0 + lo)];
  const float dl_hi = delta[stat_off(g, b, kvh, r0 + hi)];
  const int vis_lo = g.causal ? (r0 + lo) / g.G + g.q_offset : g.Lk - 1;
  const int vis_hi = g.causal ? (r0 + hi) / g.G + g.q_offset : g.Lk - 1;
  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  const int key_end =
      g.causal ? min(g.Lk, (r0 + kRows - 1) / g.G + g.q_offset + 1) : g.Lk;
  const long long stride = static_cast<long long>(g.Hkv) * D;
  const long long kv0 = static_cast<long long>(b) * g.Lk * stride +
                        static_cast<long long>(kvh) * D;

  for (int key0 = 0; key0 < key_end; key0 += kKeys) {
    __syncthreads();   // the previous tile's K and V reads are done
    load_kv<D>(Ks, Kt, Vs, nullptr, k, v, kv0 + key0 * stride, stride);
    __syncthreads();
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[j][c] = dp[j][c] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      const uint32_t da[4] = {ld32(dOs + lo * QS + 16 * kk + 2 * tq),
                              ld32(dOs + hi * QS + 16 * kk + 2 * tq),
                              ld32(dOs + lo * QS + 16 * kk + 8 + 2 * tq),
                              ld32(dOs + hi * QS + 16 * kk + 8 + 2 * tq)};
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int o = (8 * j + gq) * QS + 16 * kk + 2 * tq;
        mma16816(s[j], qa[kk], ld32(Ks + o), ld32(Ks + o + 8));
        mma16816(dp[j], da, ld32(Vs + o), ld32(Vs + o + 8));
      }
    }
    // ds in place of s: p = exp(s * scale - lse), 0 where masked
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int key = key0 + 8 * j + 2 * tq + (c & 1);
        const bool up = c >= 2;
        const float p = key <= (up ? vis_hi : vis_lo)
                            ? expf(s[j][c] * g.scale - (up ? lse_hi : lse_lo))
                            : 0.f;
        s[j][c] = p * (dp[j][c] - (up ? dl_hi : dl_lo)) * g.scale;
      }
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk) {
      uint32_t a[4];
      a_frag(s[2 * kk], s[2 * kk + 1], a);
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        const __nv_bfloat16* kr = Kt + (8 * n + gq) * VS + 16 * kk + 2 * tq;
        mma16816(acc[n], a, ld32(kr), ld32(kr + 8));
      }
    }
  }
  const long long o_lo = row_off<D>(g, b, kvh, r0 + lo);
  const long long o_hi = row_off<D>(g, b, kvh, r0 + hi);
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    *reinterpret_cast<uint32_t*>(dq + o_lo + 8 * n + 2 * tq) =
        pack(acc[n][0], acc[n][1]);
    *reinterpret_cast<uint32_t*>(dq + o_hi + 8 * n + 2 * tq) =
        pack(acc[n][2], acc[n][3]);
  }
}

template <int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, void* dq, const Geom& g,
              cudaStream_t stream) {
  const size_t smem = sizeof(__nv_bfloat16) *
                      ((2 * kRows + 2 * kKeys) * (D + 8) + D * (kKeys + 8));
  if (g.Lk % kKeys != 0) return -1;
  cudaError_t err = set_smem(dq_kernel<D>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(g.Lq * g.G / kRows, g.Hkv, g.B);
  dq_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<const __nv_bfloat16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<__nv_bfloat16*>(dq), g);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------- K4 on the tensor cores (bf16)
// dK/dV for bf16 at head_dim 64/128: block (64-key tile, kv head, batch),
// 4 warps, warp w owning keys 16w..16w+15 and their dK/dV accumulators.
// Per 64-row tile of the flattened query rows (q and do row-major and
// transposed in shared memory), in two halves of 32 rows: s^T = K·q^T and
// dp^T = V·do^T into f32 fragments, p^T and ds^T in registers, then
// dV += p^T·do and dK += ds^T·q with p and ds rounded to bf16 into the A
// fragments (the reference's rounding points).  Causal blocks start at
// the first row tile that sees their keys.
template <int D>
__global__ void __launch_bounds__(kThreads)
    dkv_kernel(const __nv_bfloat16* __restrict__ q,
               const __nv_bfloat16* __restrict__ k,
               const __nv_bfloat16* __restrict__ v,
               const __nv_bfloat16* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ delta,
               __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
               Geom g) {
  constexpr int QS = D + 8, TS = kRows + 8;
  constexpr int KD = D / 16, ND = D / 8, NH = 4;   // NH n-tiles per half
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Vs = Ks + kKeys * QS;    // [64 keys][QS]
  __nv_bfloat16* Qs = Vs + kKeys * QS;    // [64 rows][QS]
  __nv_bfloat16* dOs = Qs + kRows * QS;   // [64 rows][QS]
  __nv_bfloat16* Qt = dOs + kRows * QS;   // [D][TS]
  __nv_bfloat16* dOt = Qt + D * TS;       // [D][TS]
  float* lse_s = reinterpret_cast<float*>(dOt + D * TS);
  float* dl_s = lse_s + kRows;

  const int key0 = blockIdx.x * kKeys, kvh = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const int klo = 16 * warp + gq, khi = klo + 8;   // the lane's two keys
  const long long stride = static_cast<long long>(g.Hkv) * D;
  const long long kv0 = (static_cast<long long>(b) * g.Lk + key0) * stride +
                        static_cast<long long>(kvh) * D;
  load_kv<D>(Ks, nullptr, Vs, nullptr, k, v, kv0, stride);

  float dka[ND][4], dva[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) dka[n][c] = dva[n][c] = 0.f;

  const int n_rows = g.Lq * g.G;
  int r_start = 0;
  if (g.causal) {
    const int pos0 = max(0, key0 - g.q_offset);   // first row seeing key0
    r_start = min(n_rows, pos0 * g.G) / kRows * kRows;
  }
  for (int r0 = r_start; r0 < n_rows; r0 += kRows) {
    __syncthreads();   // the previous tile's reads are done
    load_rows_t<D>(Qs, Qt, q, g, b, kvh, r0);
    load_rows_t<D>(dOs, dOt, dout, g, b, kvh, r0);
    if (threadIdx.x < kRows) {
      const long long so = stat_off(g, b, kvh, r0 + threadIdx.x);
      lse_s[threadIdx.x] = lse[so];
      dl_s[threadIdx.x] = delta[so];
    }
    __syncthreads();
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float s[NH][4], dp[NH][4];
#pragma unroll
      for (int j = 0; j < NH; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[j][c] = dp[j][c] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        const int ko = 16 * kk + 2 * tq;
        const uint32_t ak[4] = {ld32(Ks + klo * QS + ko),
                                ld32(Ks + khi * QS + ko),
                                ld32(Ks + klo * QS + ko + 8),
                                ld32(Ks + khi * QS + ko + 8)};
        const uint32_t av[4] = {ld32(Vs + klo * QS + ko),
                                ld32(Vs + khi * QS + ko),
                                ld32(Vs + klo * QS + ko + 8),
                                ld32(Vs + khi * QS + ko + 8)};
#pragma unroll
        for (int j = 0; j < NH; ++j) {
          const int o = (8 * (NH * half + j) + gq) * QS + ko;
          mma16816(s[j], ak, ld32(Qs + o), ld32(Qs + o + 8));
          mma16816(dp[j], av, ld32(dOs + o), ld32(dOs + o + 8));
        }
      }
      // p^T in s, ds^T in dp; column = query row, row = key
#pragma unroll
      for (int j = 0; j < NH; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int rr = 8 * (NH * half + j) + 2 * tq + (c & 1);
          const int key = key0 + (c >= 2 ? khi : klo);
          const int vis =
              g.causal ? (r0 + rr) / g.G + g.q_offset : g.Lk - 1;
          const float p =
              key <= vis ? expf(s[j][c] * g.scale - lse_s[rr]) : 0.f;
          s[j][c] = p;
          dp[j][c] = p * (dp[j][c] - dl_s[rr]) * g.scale;
        }
#pragma unroll
      for (int x = 0; x < NH / 2; ++x) {
        uint32_t pa[4], da[4];
        a_frag(s[2 * x], s[2 * x + 1], pa);
        a_frag(dp[2 * x], dp[2 * x + 1], da);
        const int ro = 16 * (2 * half + x) + 2 * tq;   // rows of this step
#pragma unroll
        for (int n = 0; n < ND; ++n) {
          const int t = (8 * n + gq) * TS + ro;
          mma16816(dva[n], pa, ld32(dOt + t), ld32(dOt + t + 8));
          mma16816(dka[n], da, ld32(Qt + t), ld32(Qt + t + 8));
        }
      }
    }
  }
  const long long o_lo = kv0 + klo * stride, o_hi = kv0 + khi * stride;
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    const int d = 8 * n + 2 * tq;
    *reinterpret_cast<uint32_t*>(dk + o_lo + d) = pack(dka[n][0], dka[n][1]);
    *reinterpret_cast<uint32_t*>(dk + o_hi + d) = pack(dka[n][2], dka[n][3]);
    *reinterpret_cast<uint32_t*>(dv + o_lo + d) = pack(dva[n][0], dva[n][1]);
    *reinterpret_cast<uint32_t*>(dv + o_hi + d) = pack(dva[n][2], dva[n][3]);
  }
}

template <int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, void* dk, void* dv,
               const Geom& g, cudaStream_t stream) {
  const size_t smem = sizeof(__nv_bfloat16) * (4 * kRows * (D + 8) +
                                               2 * D * (kRows + 8)) +
                      sizeof(float) * 2 * kRows;
  if (g.Lk % kKeys != 0) return -1;
  cudaError_t err = set_smem(dkv_kernel<D>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(g.Lk / kKeys, g.Hkv, g.B);
  dkv_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<const __nv_bfloat16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), g);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace mma

// ------------------------------------------------------------- launches
// key tiles: dK/dV as the forward (64, 32 at D 256); dQ 32 keys at
// D >= 128, which keeps two blocks per SM at D 128
template <int D>
struct DqTile {
  static constexpr int value = D >= 128 ? 32 : 64;
};

template <typename T, int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, void* dk, void* dv,
               const Geom& g, cudaStream_t stream) {
  constexpr int BK = KeyTile<D>::value;
  const size_t smem = sizeof(float) * (2 * D * (BK + 1) + 2 * kRows * (D + 4) +
                                       2 * kRows * (BK + 4) + 2 * kRows);
  if (g.Lk % BK != 0) return -1;
  cudaError_t err = set_smem(dkv_kernel<T, D, BK>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(g.Lk / BK, g.Hkv, g.B);
  dkv_kernel<T, D, BK><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dk), static_cast<T*>(dv), g);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, void* dq, const Geom& g,
              cudaStream_t stream) {
  constexpr int BK = DqTile<D>::value;
  const size_t smem = sizeof(float) * (2 * kRows * (D + 4) + D * (BK + 1) +
                                       kRows * (BK + 4) + 2 * kRows);
  if (g.Lk % BK != 0) return -1;
  cudaError_t err = set_smem(dq_kernel<T, D, BK>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(g.Lq * g.G / kRows, g.Hkv, g.B);
  dq_kernel<T, D, BK><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dq), g);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dkv_d(int D, const void* q, const void* k, const void* v,
          const void* dout, const void* lse, const void* delta, void* dk,
          void* dv, const Geom& g, cudaStream_t s) {
  switch (D) {
    case 64: return launch_dkv<T, 64>(q, k, v, dout, lse, delta, dk, dv, g, s);
    case 128:
      return launch_dkv<T, 128>(q, k, v, dout, lse, delta, dk, dv, g, s);
    case 256:
      return launch_dkv<T, 256>(q, k, v, dout, lse, delta, dk, dv, g, s);
    default: return -1;
  }
}

template <typename T>
int dq_d(int D, const void* q, const void* k, const void* v, const void* dout,
         const void* lse, const void* delta, void* dq, const Geom& g,
         cudaStream_t s) {
  switch (D) {
    case 64: return launch_dq<T, 64>(q, k, v, dout, lse, delta, dq, g, s);
    case 128: return launch_dq<T, 128>(q, k, v, dout, lse, delta, dq, g, s);
    case 256: return launch_dq<T, 256>(q, k, v, dout, lse, delta, dq, g, s);
    default: return -1;
  }
}

inline bool make_geom(ptf::Geom* g, int B, int H, int Hkv, int Lq, int Lk,
                      int causal, float scale) {
  if (Hkv <= 0 || H % Hkv != 0) return false;
  *g = ptf::Geom{B, H, Hkv, H / Hkv, Lq, Lk, Lk - Lq, causal, scale};
  return (Lq * g->G) % kRows == 0 && !(causal && Lq > Lk);
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
// lse/delta f32 [B, H, Lq]; geometry as flash_attention_fwd.
extern "C" int flash_attention_bwd_dkv(int dtype, const void* q,
                                       const void* k, const void* v,
                                       const void* dout, const void* lse,
                                       const void* delta, void* dk, void* dv,
                                       int B, int H, int Hkv, int Lq, int Lk,
                                       int D, int causal, float scale,
                                       void* stream) {
  ptf::Geom g;
  if (!ptf::make_geom(&g, B, H, Hkv, Lq, Lk, causal, scale)) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return ptf::dkv_d<float>(D, q, k, v, dout, lse, delta, dk, dv, g, s);
    case 1:   // bf16: the tensor cores where the fragments fit registers
      switch (D) {
        case 64:
          return ptf::mma::launch_dkv<64>(q, k, v, dout, lse, delta, dk, dv,
                                          g, s);
        case 128:
          return ptf::mma::launch_dkv<128>(q, k, v, dout, lse, delta, dk, dv,
                                           g, s);
        case 256:
          return ptf::launch_dkv<__nv_bfloat16, 256>(q, k, v, dout, lse,
                                                     delta, dk, dv, g, s);
        default: return -1;
      }
    case 2:
      return ptf::dkv_d<__half>(D, q, k, v, dout, lse, delta, dk, dv, g, s);
    default: return -1;
  }
}

// dq [B, Lq, H*D] in `dtype`; the other operands as flash_attention_bwd_dkv.
extern "C" int flash_attention_bwd_dq(int dtype, const void* q, const void* k,
                                      const void* v, const void* dout,
                                      const void* lse, const void* delta,
                                      void* dq, int B, int H, int Hkv, int Lq,
                                      int Lk, int D, int causal, float scale,
                                      void* stream) {
  ptf::Geom g;
  if (!ptf::make_geom(&g, B, H, Hkv, Lq, Lk, causal, scale)) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return ptf::dq_d<float>(D, q, k, v, dout, lse, delta, dq, g, s);
    case 1:   // bf16: the tensor cores where the fragments fit registers
      switch (D) {
        case 64:
          return ptf::mma::launch_dq<64>(q, k, v, dout, lse, delta, dq, g, s);
        case 128:
          return ptf::mma::launch_dq<128>(q, k, v, dout, lse, delta, dq, g,
                                          s);
        case 256:
          return ptf::launch_dq<__nv_bfloat16, 256>(q, k, v, dout, lse, delta,
                                                    dq, g, s);
        default: return -1;
      }
    case 2: return ptf::dq_d<__half>(D, q, k, v, dout, lse, delta, dq, g, s);
    default: return -1;
  }
}
