"""Activations of the BERT encoder.

Counterpart of ``paddle_tpu/nn/functional/activation.py`` (``gelu``,
``tanh``): the reference applies ``jax.nn.gelu`` (the exact erf form, or
the tanh approximation with ``approximate=True``) and ``jnp.tanh`` in
the input dtype; PyTorch's kernels compute a bf16 input in f32 and round
once.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["gelu", "tanh"]


def gelu(x, approximate=False):
    """``x * Φ(x)``: the erf form, or the tanh approximation."""
    return F.gelu(x, approximate="tanh" if approximate else "none")


def tanh(x):
    return torch.tanh(x)
