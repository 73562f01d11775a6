"""Dropout.

Counterpart of ``paddle_tpu/nn/functional/common.py:29-47`` in its
``upscale_in_train`` mode: in training each element is kept with
probability ``1 - p`` and scaled by ``1 / (1 - p)``; out of training, or
at ``p == 0``, the input passes through unchanged.  The keep mask is
drawn from a ``torch.Generator`` the caller passes (PyTorch's default
generator for the tensor's device when it is None).  The reference draws
from ``jax.random``; no bits are shared, so the two agree in
distribution, not element by element.
"""
from __future__ import annotations

import torch

from paddle_tpu_torch.amp.auto_cast import amp_op

__all__ = ["dropout", "linear"]


def dropout(x, p=0.5, training=True, generator=None):
    if not 0.0 <= p <= 1.0:
        raise ValueError(f"dropout: p must be in [0, 1], got {p}")
    if not training or p == 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) \
        < 1.0 - p
    return torch.where(keep, x / (1.0 - p),
                       torch.zeros((), dtype=x.dtype,
                                   device=x.device)).to(x.dtype)


@amp_op("linear")
def linear(x, weight, bias=None):
    if x.dtype != weight.dtype:
        dt = torch.promote_types(x.dtype, weight.dtype)
        x, weight = x.to(dt), weight.to(dt)
    y = x @ weight
    return y if bias is None else y + bias.to(y.dtype)
