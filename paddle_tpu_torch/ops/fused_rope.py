"""Fused rotary position embedding on the PACKED projection layout.

Counterpart of ``paddle_tpu/ops/fused_rope.py``: one pass rotates q
``[B, L, nh*D]`` and k ``[B, L, nkv*D]`` straight off the projections,
half-split (llama/HF) convention::

    rotated = x * cos + swap(x) * signed_sin
    swap(x) = concat(x[D/2:], x[:D/2]),  signed_sin = concat(-sin_lo, sin_hi)

The backward is the same pass with sin negated (the rotation is
orthogonal: R^T = R(-theta)).  ``fused_rope`` is a
``torch.autograd.Function``; on CUDA tensors it launches the hand-written
kernel K6 (``ops/fused_rope_cuda.py``) or raises, on CPU tensors it runs
``rope_reference``.  ``available`` is the reference's gate without its
TPU and VMEM terms: head_dim and L multiples of 128; other shapes take
the model's plain rotation (``models/llama._apply_rope``), as in the
reference.
"""
from __future__ import annotations

import torch

from paddle_tpu_torch.core.device import resolve_impl

__all__ = ["available", "fused_rope", "rope_reference", "signed_sin"]

#: runs of the plain version (a plain integer)
plain_runs = 0


def signed_sin(sin):
    """Fold rot_half's sign into the sin table: concat(-sin_lo, sin_hi)."""
    d2 = sin.shape[-1] // 2
    return torch.cat([-sin[..., :d2], sin[..., d2:]], dim=-1)


def rope_reference(q, k, cos, sin, nh, nkv, neg=False):
    """The plain version: the kernel's arithmetic (f32 products and sum,
    one rounding to the input dtype) on the tables cast to q's dtype."""
    global plain_runs
    plain_runs += 1
    b, l, _ = q.shape
    d = q.shape[2] // nh
    c = cos.to(q.dtype).float()
    s = signed_sin(sin.to(q.dtype)).float()
    if neg:
        s = -s

    def rot(x, h):
        xf = x.float().view(b, l, h, d)
        sw = torch.cat([xf[..., d // 2:], xf[..., :d // 2]], dim=-1)
        out = xf * c[None, :, None, :] + sw * s[None, :, None, :]
        return out.reshape(b, l, h * d).to(x.dtype)

    return rot(q, nh), rot(k, nkv)


def _rope(q, k, cos, sin, nh, nkv, neg):
    if resolve_impl(None, q.device, "fused_rope") == "reference":
        return rope_reference(q, k, cos, sin, nh, nkv, neg)
    from paddle_tpu_torch.ops import fused_rope_cuda

    return fused_rope_cuda.rope(q.contiguous(), k.contiguous(), cos, sin, nh,
                                nkv, neg)


class _FusedRope(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, cos, sin, nh, nkv):
        ctx.save_for_backward(cos, sin)
        ctx.heads = (nh, nkv)
        return _rope(q, k, cos, sin, nh, nkv, False)

    @staticmethod
    def backward(ctx, dq, dk):
        cos, sin = ctx.saved_tensors
        dq_raw, dk_raw = _rope(dq.contiguous(), dk.contiguous(), cos, sin,
                               *ctx.heads, True)
        # the tables are position constants: no gradient
        return dq_raw, dk_raw, None, None, None, None


def fused_rope(q, k, cos, sin, nh, nkv):
    """Rotate packed q ``[B, L, nh*D]`` and k ``[B, L, nkv*D]`` by the
    standard (unsigned, half-duplicated) tables ``[L, D]``; returns the
    rotated ``(q, k)`` in the same layout."""
    return _FusedRope.apply(q, k, cos, sin, int(nh), int(nkv))


def available(q_shape, k_shape, nh, nkv):
    """Fast-path gate: head_dim a multiple of 128, L >= 128 and a
    multiple of 128 (the reference's, without its TPU and VMEM terms)."""
    _, l, qd = q_shape
    d = qd // nh
    if d * nh != qd or k_shape[2] != nkv * d:
        return False
    return d % 128 == 0 and l >= 128 and l % 128 == 0
