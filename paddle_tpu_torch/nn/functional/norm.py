"""RMSNorm with the reference's custom backward.

Counterpart of ``paddle_tpu/nn/functional/norm.py`` (``rms_norm``,
``_rms_norm_weighted`` :219-253).  The forward normalises in f32 and
rounds the normalised rows to the input dtype BEFORE the multiply by the
gain.  The backward keeps ``(a, w, rstd)`` — the input and one f32
scalar per row, not the f32 normalised tensor — and recomputes in f32
exactly as the reference's ``_rmsw_bwd``; plain autograd of the formula
would round differently in bf16 and keep a full-size f32 residual.
"""
from __future__ import annotations

import torch

__all__ = ["rms_norm"]


class _RMSNormWeighted(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, w, eps):
        af = a.float()
        r = torch.rsqrt(af.square().mean(dim=-1, keepdim=True) + eps)
        ctx.save_for_backward(a, w, r)
        return (af * r).to(a.dtype) * w

    @staticmethod
    def backward(ctx, gy):
        a, w, r = ctx.saved_tensors
        af, gyf, wf = a.float(), gy.float(), w.float()
        n = af * r                                   # normalised rows
        gn = gyf * wf
        s = (gn * af).sum(dim=-1, keepdim=True)
        ga = (r * gn - n * (r * r) * (s / af.shape[-1])).to(a.dtype)
        gw = (gyf * n).sum(dim=tuple(range(gy.dim() - 1))).to(w.dtype)
        return ga, gw, None


def rms_norm(x, weight=None, epsilon=1e-6):
    """RMSNorm over the last axis; the weighted form carries the custom
    backward above."""
    if weight is not None:
        return _RMSNormWeighted.apply(x, weight, float(epsilon))
    xf = x.float()
    return (xf * torch.rsqrt(xf.square().mean(dim=-1, keepdim=True)
                             + epsilon)).to(x.dtype)
