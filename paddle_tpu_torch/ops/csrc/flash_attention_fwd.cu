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
// Block (row tile, kv head, batch) holds 64 flattened query rows of the
// kv head's G query heads (flash_tile.cuh) and sweeps the key tiles with
// an f32 online softmax: scores s = q.k * scale, running max m (init
// -1e30), denominator l and accumulator rescaled by exp(m_old - m_new),
// masked keys given probability exactly 0, out = acc / max(l, 1e-30) in
// the input dtype, lse = m + log(max(l, 1e-30)) in f32 [B, H, Lq].  The
// causal mask is bottom-right aligned (query position p sees keys
// <= p + Lk - Lq) and key tiles past a row tile's last visible key are
// skipped; causal row tiles run last-first so the longest blocks start
// first.
//
// What bounds it on the card: operations, 4·D per (query head, visible
// key) pair — far above the bytes of q, k, v and out at training shapes.
// One K/V tile in shared memory feeds all G heads (K/V traffic / G).  For
// bf16 at head_dim 64/128 (the training path) both products run on the
// tensor cores (mma.sync, the `mma` path below); f32, f16 and head_dim
// 256 take a CUDA-core path in which each thread computes a 4 x 4 score
// and a 4 x D/16 output micro-tile from registers.  wgmma, TMA loads,
// a pipelined K/V ring and warp specialisation are later work.  As in
// the reference, p is rounded to the input dtype before p·V while l sums
// it unrounded.
#include "flash_tile.cuh"

namespace ptf {

template <typename T, int D, int BK>
__global__ void __launch_bounds__(kThreads)
    fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, T* __restrict__ out,
               float* __restrict__ lse, Geom g) {
  constexpr int QS = D + 4, KS = BK + 1, PS = BK + 4;
  constexpr int CJ = BK / 16, CD = D / 16;
  constexpr int KVF = D * KS > BK * D ? D * KS : BK * D;
  extern __shared__ float smem[];
  float* Qs = smem;              // [64][QS]
  float* KV = Qs + kRows * QS;   // K^T [D][KS], then V [BK][D]
  float* Ps = KV + KVF;          // [64][PS]

  const int n_tiles = g.Lq * g.G / kRows;
  const int tile = g.causal ? n_tiles - 1 - blockIdx.x : blockIdx.x;
  const int r0 = tile * kRows, kvh = blockIdx.y, b = blockIdx.z;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;

  load_rows<T, D>(Qs, QS, q, g, b, kvh, r0);

  int vis[4];   // last key each of the thread's rows may see
  float m[4], l[4], acc[4][CD];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    vis[i] = g.causal ? (r0 + 4 * ty + i) / g.G + g.q_offset : g.Lk - 1;
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
    __syncthreads();
    float s[4][CJ];
    tile_dot<D, CJ>(s, Qs, QS, KV, KS, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = neg_inf();
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const int key = key0 + tx + 16 * j;
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
#pragma unroll
    for (int c = 0; c < CD; ++c)
      out[o + tx + 16 * c] = from_f32<T>(acc[i][c] / ls);
    if (tx == 0) lse[stat_off(g, b, kvh, r)] = m[i] + logf(ls);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out, void* lse,
           const Geom& g, cudaStream_t stream) {
  constexpr int BK = KeyTile<D>::value;
  constexpr int KVF = D * (BK + 1) > BK * D ? D * (BK + 1) : BK * D;
  const size_t smem =
      sizeof(float) * (kRows * (D + 4) + KVF + kRows * (BK + 4));
  if (g.Lk % BK != 0) return -1;
  cudaError_t err = set_smem(fwd_kernel<T, D, BK>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(g.Lq * g.G / kRows, g.Hkv, g.B);
  fwd_kernel<T, D, BK><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out),
      static_cast<float*>(lse), g);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------- tensor-core path (bf16)
// The same function for bf16 inputs at head_dim 64/128, with the two
// products on the tensor cores (mma.sync m16n8k16, bf16 in, f32
// accumulate).  Block = 4 warps over the same 64 flattened query rows;
// warp w owns rows 16w..16w+15 and keeps their q fragments in registers
// for the whole sweep.  Per 64-key tile: K row-major and V transposed in
// shared memory (rows padded by 8 elements: conflict-free fragment
// loads), S = q·K^T into f32 accumulators, the online softmax on the
// accumulator fragments (a row's 4 lanes reduce by shuffles), p rounded
// to bf16 straight into the A fragments of p·V (the reference's rounding
// point; l sums the unrounded p).
namespace mma {

template <int D>
__global__ void __launch_bounds__(kThreads)
    fwd_kernel(const __nv_bfloat16* __restrict__ q,
               const __nv_bfloat16* __restrict__ k,
               const __nv_bfloat16* __restrict__ v,
               __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
               Geom g) {
  constexpr int QS = D + 8, VS = kKeys + 8;
  constexpr int KD = D / 16, NT = kKeys / 8, ND = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Ks = Qs + kRows * QS;   // [64 keys][QS]
  __nv_bfloat16* Vt = Ks + kKeys * QS;   // [D][VS]

  const int n_tiles = g.Lq * g.G / kRows;
  const int tile = g.causal ? n_tiles - 1 - blockIdx.x : blockIdx.x;
  const int r0 = tile * kRows, kvh = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gq = lane >> 2, tq = lane & 3;

  load_rows<D>(Qs, q, g, b, kvh, r0);
  __syncthreads();
  const int lo = 16 * warp + gq, hi = lo + 8;     // the lane's two rows
  uint32_t qa[KD][4];
#pragma unroll
  for (int kk = 0; kk < KD; ++kk) {
    qa[kk][0] = ld32(Qs + lo * QS + 16 * kk + 2 * tq);
    qa[kk][1] = ld32(Qs + hi * QS + 16 * kk + 2 * tq);
    qa[kk][2] = ld32(Qs + lo * QS + 16 * kk + 8 + 2 * tq);
    qa[kk][3] = ld32(Qs + hi * QS + 16 * kk + 8 + 2 * tq);
  }
  const int vis_lo = g.causal ? (r0 + lo) / g.G + g.q_offset : g.Lk - 1;
  const int vis_hi = g.causal ? (r0 + hi) / g.G + g.q_offset : g.Lk - 1;
  float m_lo = kNegInf, m_hi = kNegInf, l_lo = 0.f, l_hi = 0.f;
  float o[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;

  const int key_end =
      g.causal ? min(g.Lk, (r0 + kRows - 1) / g.G + g.q_offset + 1) : g.Lk;
  const long long stride = static_cast<long long>(g.Hkv) * D;
  const long long kv0 = static_cast<long long>(b) * g.Lk * stride +
                        static_cast<long long>(kvh) * D;

  for (int key0 = 0; key0 < key_end; key0 += kKeys) {
    __syncthreads();   // the previous tile's K and V reads are done
    load_kv<D>(Ks, nullptr, nullptr, Vt, k, v, kv0 + key0 * stride, stride);
    __syncthreads();
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      const __nv_bfloat16* kr = Ks + (8 * j + gq) * QS + 2 * tq;
#pragma unroll
      for (int kk = 0; kk < KD; ++kk)
        mma16816(s[j], qa[kk], ld32(kr + 16 * kk), ld32(kr + 16 * kk + 8));
    }
    float mx_lo = neg_inf(), mx_hi = neg_inf();
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int key = key0 + 8 * j + 2 * tq;
      s[j][0] = key <= vis_lo ? s[j][0] * g.scale : neg_inf();
      s[j][1] = key + 1 <= vis_lo ? s[j][1] * g.scale : neg_inf();
      s[j][2] = key <= vis_hi ? s[j][2] * g.scale : neg_inf();
      s[j][3] = key + 1 <= vis_hi ? s[j][3] * g.scale : neg_inf();
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
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk) {
      uint32_t pa[4];
      a_frag(s[2 * kk], s[2 * kk + 1], pa);
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        const __nv_bfloat16* vr = Vt + (8 * n + gq) * VS + 16 * kk + 2 * tq;
        mma16816(o[n], pa, ld32(vr), ld32(vr + 8));
      }
    }
  }

  const float ls_lo = fmaxf(l_lo, 1e-30f), ls_hi = fmaxf(l_hi, 1e-30f);
  const long long o_lo = row_off<D>(g, b, kvh, r0 + lo);
  const long long o_hi = row_off<D>(g, b, kvh, r0 + hi);
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    *reinterpret_cast<uint32_t*>(out + o_lo + 8 * n + 2 * tq) =
        pack(o[n][0] / ls_lo, o[n][1] / ls_lo);
    *reinterpret_cast<uint32_t*>(out + o_hi + 8 * n + 2 * tq) =
        pack(o[n][2] / ls_hi, o[n][3] / ls_hi);
  }
  if (tq == 0) {
    lse[stat_off(g, b, kvh, r0 + lo)] = m_lo + logf(ls_lo);
    lse[stat_off(g, b, kvh, r0 + hi)] = m_hi + logf(ls_hi);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* out, void* lse,
           const Geom& g, cudaStream_t stream) {
  const size_t smem = sizeof(__nv_bfloat16) *
                      ((kRows + kKeys) * (D + 8) + D * (kKeys + 8));
  if (g.Lk % kKeys != 0) return -1;
  cudaError_t err = set_smem(fwd_kernel<D>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(g.Lq * g.G / kRows, g.Hkv, g.B);
  fwd_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<__nv_bfloat16*>(out), static_cast<float*>(lse), g);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace mma

template <typename T>
int dispatch_d(int D, const void* q, const void* k, const void* v, void* out,
               void* lse, const Geom& g, cudaStream_t s) {
  switch (D) {
    case 64: return launch<T, 64>(q, k, v, out, lse, g, s);
    case 128: return launch<T, 128>(q, k, v, out, lse, g, s);
    case 256: return launch<T, 256>(q, k, v, out, lse, g, s);
    default: return -1;
  }
}

}  // namespace ptf

// dtype: 0 float32, 1 bfloat16, 2 float16 (q, k, v and out).  q/out
// [B, Lq, H*D], k/v [B, Lk, Hkv*D], lse f32 [B, H, Lq]; H % Hkv == 0,
// D in {64, 128, 256}, Lq*G a multiple of 64, Lk a multiple of 64 (32 at
// D 256), causal requires Lq <= Lk.  Returns the launch's cudaError_t
// (0 = ok, -1 = a shape the kernel does not take).
extern "C" int flash_attention_fwd(int dtype, const void* q, const void* k,
                                   const void* v, void* out, void* lse, int B,
                                   int H, int Hkv, int Lq, int Lk, int D,
                                   int causal, float scale, void* stream) {
  if (Hkv <= 0 || H % Hkv != 0) return -1;
  const ptf::Geom g{B, H, Hkv, H / Hkv, Lq, Lk, Lk - Lq, causal, scale};
  if ((Lq * g.G) % ptf::kRows != 0 || (causal && Lq > Lk)) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return ptf::dispatch_d<float>(D, q, k, v, out, lse, g, s);
    case 1:   // bf16: the tensor cores where the fragments fit registers
      switch (D) {
        case 64: return ptf::mma::launch<64>(q, k, v, out, lse, g, s);
        case 128: return ptf::mma::launch<128>(q, k, v, out, lse, g, s);
        case 256:
          return ptf::launch<__nv_bfloat16, 256>(q, k, v, out, lse, g, s);
        default: return -1;
      }
    case 2: return ptf::dispatch_d<__half>(D, q, k, v, out, lse, g, s);
    default: return -1;
  }
}
