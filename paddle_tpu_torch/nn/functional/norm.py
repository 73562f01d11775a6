"""RMSNorm and LayerNorm with the reference's custom backwards.

Counterpart of ``paddle_tpu/nn/functional/norm.py`` (``rms_norm``,
``_rms_norm_weighted`` :219-253; ``layer_norm``, ``_ln_affine``
:150-216).  Each forward normalises in f32 and rounds the normalised
rows to the input dtype BEFORE the gain (and bias).  Each backward keeps
the input and one or two f32 scalars per row — not the f32 normalised
tensor — and recomputes in f32 exactly as the reference's: RMSNorm from
``(a, w, rstd)``, LayerNorm from ``(a, w, b, mean, rstd)`` with one
dual reduction (``sum(gn)``, ``sum(gn * xhat)``) per row.  Plain
autograd of the formulas would round differently in bf16 and keep
full-size f32 residuals.
"""
from __future__ import annotations

import torch

__all__ = ["layer_norm", "rms_norm"]


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


class _LayerNormAffine(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, w, b, n_axes, eps):
        dims = tuple(range(a.dim() - n_axes, a.dim()))
        af = a.float()
        m = af.mean(dim=dims, keepdim=True)
        rstd = torch.rsqrt((af - m).square().mean(dim=dims, keepdim=True)
                           + eps)
        y = ((af - m) * rstd).to(a.dtype)
        if w is not None:
            y = y * w
        if b is not None:
            y = y + b
        ctx.save_for_backward(a, w, m, rstd)
        ctx.cfg = (dims, b is not None, None if b is None else b.dtype)
        return y

    @staticmethod
    def backward(ctx, gy):
        a, w, m, rstd = ctx.saved_tensors
        dims, has_b, b_dtype = ctx.cfg
        gyf = gy.float()
        xhat = (a.float() - m) * rstd
        n = 1
        for d in dims:
            n *= a.shape[d]
        tokens = tuple(range(a.dim() - len(dims)))   # gw/gb reduce these
        gw = None if w is None else (gyf * xhat).sum(dim=tokens).to(w.dtype)
        gb = gyf.sum(dim=tokens).to(b_dtype) if has_b else None
        gn = gyf * w.float() if w is not None else gyf
        s1 = gn.sum(dim=dims, keepdim=True)
        s2 = (gn * xhat).sum(dim=dims, keepdim=True)
        ga = (rstd * (gn - s1 / n - xhat * (s2 / n))).to(a.dtype)
        return ga, gw, gb, None, None


def layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-05):
    """LayerNorm over the trailing ``normalized_shape`` axes (the
    reference's ``F.layer_norm``), with the custom backward above."""
    if isinstance(normalized_shape, int):
        normalized_shape = [normalized_shape]
    n = len(normalized_shape)
    if tuple(x.shape[x.dim() - n:]) != tuple(normalized_shape):
        raise ValueError(f"layer_norm: input {tuple(x.shape)} does not end "
                         f"in {tuple(normalized_shape)}")
    return _LayerNormAffine.apply(x, weight, bias, n, float(epsilon))
