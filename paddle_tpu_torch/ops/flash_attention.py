"""Flash attention: GQA-native, on the packed projection layout.

Counterpart of ``paddle_tpu/ops/flash_attention.py``.  q ``[B, Lq, H*D]``
and k/v ``[B, Lk, Hkv*D]`` are consumed as the projections produce them;
query head ``h`` reads kv head ``h // G`` (``G = H / Hkv``).
``flash_attention_packed`` is a ``torch.autograd.Function`` (the
reference's ``custom_vjp``): the forward saves ``(q, k, v, out, lse)``,
the backward runs delta, then dK/dV, then dQ.  On CUDA tensors each step
launches its hand-written kernel (``ops/flash_attention_cuda.py``: K1/K2
forward, K3 delta, K4 dK/dV, K5 dQ) or raises; on CPU tensors it runs the
plain PyTorch version below — there is no fallback on the card.

The plain versions compute the same functions in f32 over blocks of
query rows (so the ``[.., rows, Lk]`` scores stay bounded at long
context), rounding ``p`` and ``ds`` to the input dtype where they enter a
product (``p·V``, ``p^T·dO``, ``ds^T·q``, ``ds·k``) as the reference
does; the forward returns ``out`` in the input dtype and
``lse = m + log(l)`` f32 ``[B, H, Lq]`` (the reference stores the same
rows as ``[B, Hkv, 8, Lq*G]``, sublane-replicated for TPU tiling); the
backward rebuilds ``p = exp(s - lse)`` exactly as the kernels do.  The
causal mask is bottom-right aligned (``q_offset = Lk - Lq``); causal with
``Lq > Lk`` is rejected, as in the reference.  Segment ids and in-kernel
RoPE (the reference's ``flash_attention_packed_segmented`` and
``flash_attention_packed_rope``) are not ported yet.
"""
from __future__ import annotations

import torch

from paddle_tpu_torch.core.device import resolve_impl

__all__ = ["available", "flash_attention_blhd", "flash_attention_packed",
           "flash_attention_packed_rope", "flash_attention_packed_segmented",
           "flash_bwd_reference", "flash_delta_reference",
           "flash_fwd_reference", "repeat_kv", "validate_gqa"]

#: runs of the plain versions, by step (plain integers)
plain_runs = {"fwd": 0, "delta": 0, "bwd": 0}

_QBLOCK = 1024      # query positions per block of the plain versions


def validate_gqa(h, hkv, name="attention"):
    """The GQA head-grouping contract; returns the group size."""
    if hkv <= 0 or h % hkv:
        raise ValueError(
            f"{name}: query heads ({h}) must be an integer multiple of "
            f"kv heads ({hkv})")
    return h // hkv


def _reject_causal_lq_gt_lk(lq, lk, causal, name):
    """Causal with Lq > Lk leaves rows with no live key under the
    bottom-right aligned mask; their lse would poison the backward."""
    if causal and lq > lk:
        raise ValueError(
            f"{name}: causal attention requires Lq <= Lk (got Lq={lq}, "
            f"Lk={lk}); rows before the cached prefix would have no live "
            "keys. Use the dense fallback for this shape.")


def repeat_kv(k, v, rep):
    """``[B, L, Hkv, D] -> [B, L, Hkv*rep, D]``: query head ``j`` reads kv
    head ``j // rep`` — the one grouping convention of every path."""
    if rep == 1:
        return k, v
    return (torch.repeat_interleave(k, rep, dim=2),
            torch.repeat_interleave(v, rep, dim=2))


def available(q_shape, k_shape=None, causal=False):
    """Whether the flash path takes this ``[B, L, H, D]`` shape (else the
    dense composition): head_dim 64/128/256, L >= 128 and a multiple of
    128, GQA-divisible heads, and causal only with Lq <= Lk — the
    reference's gate without its TPU test."""
    if len(q_shape) != 4:
        return False
    _, l, h, d = q_shape
    if k_shape is not None:
        hkv = k_shape[2]
        if hkv <= 0 or h % hkv or k_shape[1] % 128:
            return False
        if causal and q_shape[1] > k_shape[1]:
            return False
    return d in (64, 128, 256) and l >= 128 and l % 128 == 0


# ------------------------------------------------------------ plain versions
def _heads_q(x, num_heads, num_kv_heads):
    """packed ``[B, L, H*D]`` -> f32 ``[B, Hkv, G, L, D]``."""
    b, l, hd = x.shape
    g, d = num_heads // num_kv_heads, hd // num_heads
    return x.float().view(b, l, num_kv_heads, g, d).permute(0, 2, 3, 1, 4)


def _heads_kv(x, num_kv_heads):
    """packed ``[B, L, Hkv*D]`` -> f32 ``[B, Hkv, L, D]``."""
    b, l, hd = x.shape
    return x.float().view(b, l, num_kv_heads, hd // num_kv_heads) \
        .permute(0, 2, 1, 3)


def _packed(x, dtype):
    """``[B, Hkv, G, L, D]`` -> packed ``[B, L, H*D]`` in ``dtype``."""
    b, hkv, g, l, d = x.shape
    return x.permute(0, 3, 1, 2, 4).reshape(b, l, hkv * g * d).to(dtype)


def _scale(scale, d):
    return float(scale if scale is not None else 1.0 / (d ** 0.5))


def _scores(qb, kf, scale, causal, q0, q_offset):
    """f32 scores ``[B, Hkv, G, rows, Lk]`` of query positions
    ``q0..q0+rows`` with the causal mask applied as ``-inf``."""
    s = torch.einsum("bhgqd,bhkd->bhgqk", qb, kf) * scale
    if causal:
        rows, lk = s.shape[-2], s.shape[-1]
        pos = q_offset + q0 + torch.arange(rows, device=s.device)
        dead = torch.arange(lk, device=s.device)[None, :] > pos[:, None]
        s = s.masked_fill(dead, float("-inf"))
    return s


def flash_fwd_reference(q, k, v, num_heads, num_kv_heads, causal=False,
                        scale=None):
    """Plain forward: ``(out [B, Lq, H*D] in q's dtype, lse [B, H, Lq]
    f32)``, softmax in f32."""
    plain_runs["fwd"] += 1
    b, lq, hd = q.shape
    lk = k.shape[1]
    d = hd // num_heads
    scale = _scale(scale, d)
    qf = _heads_q(q, num_heads, num_kv_heads)
    kf, vf = _heads_kv(k, num_kv_heads), _heads_kv(v, num_kv_heads)
    out = torch.empty(qf.shape, dtype=torch.float32, device=q.device)
    lse = torch.empty(qf.shape[:-1], dtype=torch.float32, device=q.device)
    for q0 in range(0, lq, _QBLOCK):
        q1 = min(lq, q0 + _QBLOCK)
        s = _scores(qf[:, :, :, q0:q1], kf, scale, causal, q0, lk - lq)
        m = s.amax(dim=-1, keepdim=True)
        p = torch.exp(s - m)
        l = p.sum(dim=-1, keepdim=True)
        # p·V takes p rounded to the input dtype (the reference's rounding
        # point); l sums it unrounded
        pv = p.to(q.dtype).float()
        out[:, :, :, q0:q1] = torch.einsum("bhgqk,bhkd->bhgqd", pv, vf) / l
        lse[:, :, :, q0:q1] = (m + torch.log(l))[..., 0]
    return _packed(out, q.dtype), lse.reshape(b, num_heads, lq)


def flash_delta_reference(dout, out, num_heads):
    """Plain delta: ``rowsum(dout * out)`` f32 ``[B, H, L]``."""
    plain_runs["delta"] += 1
    b, l, hd = dout.shape
    prod = dout.float() * out.float()
    return prod.view(b, l, num_heads, hd // num_heads).sum(-1) \
        .permute(0, 2, 1).contiguous()


def flash_bwd_reference(q, k, v, dout, lse, delta, num_heads, num_kv_heads,
                        causal=False, scale=None):
    """Plain backward from the forward's ``lse`` and ``delta``:
    ``(dq, dk, dv)`` in the inputs' dtypes, accumulated in f32."""
    plain_runs["bwd"] += 1
    b, lq, hd = q.shape
    lk = k.shape[1]
    g, d = num_heads // num_kv_heads, hd // num_heads
    scale = _scale(scale, d)
    qf, dof = (_heads_q(q, num_heads, num_kv_heads),
               _heads_q(dout, num_heads, num_kv_heads))
    kf, vf = _heads_kv(k, num_kv_heads), _heads_kv(v, num_kv_heads)
    lse5 = lse.view(b, num_kv_heads, g, lq)
    dl5 = delta.view(b, num_kv_heads, g, lq)
    dq = torch.empty(qf.shape, dtype=torch.float32, device=q.device)
    dk = torch.zeros(kf.shape, dtype=torch.float32, device=q.device)
    dv = torch.zeros(vf.shape, dtype=torch.float32, device=q.device)
    for q0 in range(0, lq, _QBLOCK):
        q1 = min(lq, q0 + _QBLOCK)
        qb, dob = qf[:, :, :, q0:q1], dof[:, :, :, q0:q1]
        s = _scores(qb, kf, scale, causal, q0, lk - lq)
        p = torch.exp(s - lse5[..., q0:q1, None])     # masked: exp(-inf)
        dv += torch.einsum("bhgqk,bhgqd->bhkd", p.to(q.dtype).float(), dob)
        dp = torch.einsum("bhgqd,bhkd->bhgqk", dob, vf)
        # ds from the unrounded p, rounded once for both of its products
        ds = (p * (dp - dl5[..., q0:q1, None]) * scale).to(q.dtype).float()
        dq[:, :, :, q0:q1] = torch.einsum("bhgqk,bhkd->bhgqd", ds, kf)
        dk += torch.einsum("bhgqk,bhgqd->bhkd", ds, qb)

    def kv_packed(x, dtype):
        return x.permute(0, 2, 1, 3).reshape(b, lk, num_kv_heads * d) \
            .to(dtype)
    return (_packed(dq, q.dtype), kv_packed(dk, k.dtype),
            kv_packed(dv, v.dtype))


# ------------------------------------------------------------------ routing
def _forward(q, k, v, num_heads, num_kv_heads, causal, scale):
    if resolve_impl(None, q.device, "flash_attention") == "reference":
        return flash_fwd_reference(q, k, v, num_heads, num_kv_heads, causal,
                                   scale)
    from paddle_tpu_torch.ops import flash_attention_cuda as fc

    return fc.flash_fwd(q, k, v, num_heads, num_kv_heads, causal, scale)


def _backward(q, k, v, out, lse, dout, num_heads, num_kv_heads, causal,
              scale):
    if resolve_impl(None, q.device, "flash_attention") == "reference":
        delta = flash_delta_reference(dout, out, num_heads)
        return flash_bwd_reference(q, k, v, dout, lse, delta, num_heads,
                                   num_kv_heads, causal, scale)
    from paddle_tpu_torch.ops import flash_attention_cuda as fc

    delta = fc.flash_delta(dout, out, num_heads)
    dk, dv = fc.flash_bwd_dkv(q, k, v, dout, lse, delta, num_heads,
                              num_kv_heads, causal, scale)
    dq = fc.flash_bwd_dq(q, k, v, dout, lse, delta, num_heads, num_kv_heads,
                         causal, scale)
    return dq, dk, dv


class _FlashAttentionPacked(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, num_heads, num_kv_heads, causal, scale):
        out, lse = _forward(q, k, v, num_heads, num_kv_heads, causal, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.cfg = (num_heads, num_kv_heads, causal, scale)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _backward(q, k, v, out, lse, dout.contiguous(),
                               *ctx.cfg)
        return dq, dk, dv, None, None, None, None


def flash_attention_packed(q, k, v, num_heads, num_kv_heads, causal=False,
                           scale=None):
    """GQA flash attention in the projection layout: q ``[B, Lq, H*D]``,
    k/v ``[B, Lk, Hkv*D]`` -> ``[B, Lq, H*D]``; differentiable."""
    lq, lk = q.shape[1], k.shape[1]
    _reject_causal_lq_gt_lk(lq, lk, causal, "flash_attention")
    validate_gqa(num_heads, num_kv_heads, "flash_attention")
    d = q.shape[2] // num_heads
    return _FlashAttentionPacked.apply(
        q.contiguous(), k.contiguous(), v.contiguous(), int(num_heads),
        int(num_kv_heads), bool(causal), _scale(scale, d))


def flash_attention_packed_segmented(*args, **kwargs):
    raise NotImplementedError(
        "flash attention with segment ids (padding/varlen masks) is not "
        "ported yet: the BERT/varlen slice brings it")


def flash_attention_packed_rope(*args, **kwargs):
    raise NotImplementedError(
        "flash attention with in-kernel RoPE (K10) is not ported yet; the "
        "training path rotates with the fused RoPE kernel (ops/fused_rope)")


def flash_attention_blhd(q, k, v, causal=False, scale=None, q_segments=None,
                         k_segments=None):
    """Flash attention on ``[B, L, H, D]`` (k/v may carry fewer kv heads):
    a packing wrapper over ``flash_attention_packed``."""
    if q_segments is not None or k_segments is not None:
        return flash_attention_packed_segmented()
    b, lq, h, d = q.shape
    lk, hkv = k.shape[1], k.shape[2]
    validate_gqa(h, hkv, "flash_attention_blhd")
    out = flash_attention_packed(q.reshape(b, lq, h * d),
                                 k.reshape(b, lk, hkv * d),
                                 v.reshape(b, lk, hkv * d), h, hkv, causal,
                                 scale)
    return out.view(b, lq, h, d)
