"""Gradient clipping.

Counterpart of ``paddle_tpu/nn/clip.py``: clip objects are callables an
optimizer applies to ``[(param, grad), ...]`` and get the list back with
clipped gradients (``ClipGradByValue`` :22, ``ClipGradByNorm`` :38,
``ClipGradByGlobalNorm`` :55, the ``GradientClip*`` aliases :80-83);
``clip_grad_norm_`` (:86) and ``clip_grad_value_`` (:107) clip
``p.grad`` in place.  A parameter is skipped where
``getattr(p, "need_clip", True)`` is false, as in the reference.

The reference multiplies a bf16 gradient by an f32 0-d scale in f32 and
rounds once (jnp promotes); PyTorch would keep that product in bf16 (a
0-d tensor does not promote a dimensioned one), so every product here is
written out as ``(g.float() * scale).to(g.dtype)``.  Norms are f32 sums
of f32 squares, and the global norm adds the per-tensor sums one by one
in parameter order, as the reference's ``sum(sq)``.  The factors stay
device tensors: clipping reads nothing back to the host.
"""
from __future__ import annotations

import torch

__all__ = ["ClipGradBase", "ClipGradByGlobalNorm", "ClipGradByNorm",
           "ClipGradByValue", "GradientClipBase", "GradientClipByGlobalNorm",
           "GradientClipByNorm", "GradientClipByValue", "clip_grad_norm_",
           "clip_grad_value_"]


def _clipped(p, g):
    return g is not None and getattr(p, "need_clip", True)


def _scaled(g, scale):
    """``g * scale`` in f32, rounded once to ``g``'s dtype."""
    return (g.float() * scale).to(g.dtype)


def _over(c, x):
    """``c / x`` for a Python ``c``, rounded once in ``x``'s dtype
    (PyTorch's ``c / tensor`` multiplies by a rounded reciprocal)."""
    return torch.full_like(x, c) / x


def _ordered_sum(terms):
    """The f32 sum of 0-d tensors, added in order (Python's ``sum``)."""
    total = terms[0]
    for t in terms[1:]:
        total = total + t
    return total


class ClipGradBase:
    def __call__(self, params_grads):
        return self._dygraph_clip(params_grads)

    def _dygraph_clip(self, params_grads):
        raise NotImplementedError


class ClipGradByValue(ClipGradBase):
    """Clamp every element to ``[min, max]`` (``min`` defaults to
    ``-max``)."""

    def __init__(self, max, min=None):
        self.max = float(max)
        self.min = float(min) if min is not None else -self.max

    @torch.no_grad()
    def _dygraph_clip(self, params_grads):
        return [(p, torch.clamp(g, self.min, self.max) if _clipped(p, g)
                 else g) for p, g in params_grads]


class ClipGradByNorm(ClipGradBase):
    """Scale each gradient to an L2 norm of at most ``clip_norm``."""

    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    @torch.no_grad()
    def _dygraph_clip(self, params_grads):
        out = []
        for p, g in params_grads:
            if not _clipped(p, g):
                out.append((p, g))
                continue
            norm = g.float().square().sum().sqrt()
            scale = torch.clamp(_over(self.clip_norm,
                                      torch.clamp(norm, min=1e-12)), max=1.0)
            out.append((p, _scaled(g, scale)))
        return out


class ClipGradByGlobalNorm(ClipGradBase):
    """Scale all gradients by one factor, ``min(clip_norm / global_norm,
    1)``, the global norm taken over every clipped gradient in f32."""

    def __init__(self, clip_norm, group_name="default_group",
                 auto_skip_clip=False):
        self.clip_norm = float(clip_norm)
        self.group_name = group_name

    def global_scale(self, params_grads):
        """The f32 0-d clip factor of ``params_grads`` (None when no
        gradient is clipped)."""
        sq = [g.float().square().sum() for p, g in params_grads
              if _clipped(p, g)]
        if not sq:
            return None
        norm = _ordered_sum(sq).sqrt()
        return torch.clamp(_over(self.clip_norm, torch.clamp(norm, min=1e-12)),
                           max=1.0)

    @torch.no_grad()
    def _dygraph_clip(self, params_grads):
        scale = self.global_scale(params_grads)
        if scale is None:
            return params_grads
        return [(p, _scaled(g, scale) if _clipped(p, g) else g)
                for p, g in params_grads]


GradientClipBase = ClipGradBase
GradientClipByValue = ClipGradByValue
GradientClipByNorm = ClipGradByNorm
GradientClipByGlobalNorm = ClipGradByGlobalNorm


def _as_list(parameters):
    return [parameters] if isinstance(parameters, torch.Tensor) \
        else list(parameters)


@torch.no_grad()
def clip_grad_norm_(parameters, max_norm, norm_type=2.0,
                    error_if_nonfinite=False):
    """Clip ``p.grad`` in place to a total ``norm_type`` norm of at most
    ``max_norm``; returns the total norm (a 0-d tensor).  The inf norm is
    taken in the gradients' dtype, the p-norms in f32, as the
    reference's."""
    parameters = _as_list(parameters)
    grads = [p.grad for p in parameters if p.grad is not None]
    if not grads:
        return torch.zeros(())
    if norm_type == float("inf"):
        total = torch.stack([g.abs().max() for g in grads]).max()
    else:
        total = torch.pow(_ordered_sum(
            [torch.pow(g.float().abs(), norm_type).sum() for g in grads]),
            1.0 / norm_type)
    coef = torch.clamp(_over(max_norm, total + 1e-6), max=1.0)
    for g in grads:
        g.copy_((g * coef) if coef.dtype == g.dtype else _scaled(g, coef))
    return total


@torch.no_grad()
def clip_grad_value_(parameters, clip_value):
    """Clamp every ``p.grad`` to ``[-clip_value, clip_value]`` in place."""
    for p in _as_list(parameters):
        if p.grad is not None:
            p.grad.clamp_(-clip_value, clip_value)
