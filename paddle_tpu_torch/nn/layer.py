"""Layers of the BERT encoder, under the reference's parameter names.

Counterparts of ``paddle_tpu/nn/layer/common.py`` (``Linear``,
``Embedding``, ``Dropout``) and ``paddle_tpu/nn/layer/norm.py``
(``LayerNorm``): ``Linear`` holds ``weight [in, out]`` (the reference's
layout, not PyTorch's ``[out, in]``) and ``bias [out]`` and computes in
the promoted dtype of its input and weight, as ``jnp.matmul`` does; ``LayerNorm``
``weight`` and ``bias``; ``Embedding`` ``weight [num, dim]``.
``reset_parameters(generator)`` initialises each as the reference does —
Xavier-normal weights and zero biases, unit-normal embeddings, unit gains
and zero shifts — drawing in f32 and rounding once to the parameter's
dtype.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from paddle_tpu_torch.nn.functional import dropout, layer_norm

__all__ = ["Dropout", "Embedding", "LayerNorm", "Linear"]


def _draw(p, generator, fill):
    buf = torch.empty(p.shape, dtype=torch.float32, device=p.device)
    fill(buf)
    with torch.no_grad():
        p.copy_(buf)


class Linear(nn.Module):
    """``y = x @ weight + bias`` with ``weight [in, out]``."""

    def __init__(self, in_features, out_features, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(
            (in_features, out_features), dtype=dtype, device=device))
        self.bias = nn.Parameter(torch.zeros(out_features, dtype=dtype,
                                             device=device))

    def reset_parameters(self, generator):
        fan_in, fan_out = self.weight.shape
        std = math.sqrt(2.0 / (fan_in + fan_out))
        _draw(self.weight, generator,
              lambda b: b.normal_(0.0, std, generator=generator))
        with torch.no_grad():
            self.bias.zero_()

    def forward(self, x):
        # mixed dtypes promote as in the reference (a bf16 input into an
        # f32 head computes in f32)
        dt = torch.promote_types(x.dtype, self.weight.dtype)
        return x.to(dt) @ self.weight.to(dt) + self.bias.to(dt)


class Embedding(nn.Module):
    def __init__(self, num_embeddings, embedding_dim, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(
            (num_embeddings, embedding_dim), dtype=dtype, device=device))

    def reset_parameters(self, generator):
        _draw(self.weight, generator,
              lambda b: b.normal_(0.0, 1.0, generator=generator))

    def forward(self, ids):
        return F.embedding(ids, self.weight)


class LayerNorm(nn.Module):
    def __init__(self, normalized_shape, epsilon=1e-05, dtype=torch.float32,
                 device=None):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = [normalized_shape]
        self._shape = list(normalized_shape)
        self._epsilon = epsilon
        self.weight = nn.Parameter(torch.ones(self._shape, dtype=dtype,
                                              device=device))
        self.bias = nn.Parameter(torch.zeros(self._shape, dtype=dtype,
                                             device=device))

    def reset_parameters(self, generator=None):
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()

    def forward(self, x):
        return layer_norm(x, self._shape, self.weight, self.bias,
                          self._epsilon)


class Dropout(nn.Module):
    """``F.dropout`` in training mode, identity in ``eval()``; the keep
    masks come from ``generator`` (PyTorch's default when None)."""

    def __init__(self, p=0.5, generator=None):
        super().__init__()
        self.p = p
        self.generator = generator

    def forward(self, x):
        return dropout(x, self.p, training=self.training,
                       generator=self.generator)
