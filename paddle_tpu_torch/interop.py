"""Carry weights from the JAX reference into the port, as numpy arrays.

The two packages never share a process-level object: the tests (the only
code that imports both) convert the reference's leaves with
``np.asarray`` and hand them over here.  bfloat16 leaves (numpy's
``ml_dtypes`` bfloat16, which ``torch.from_numpy`` cannot take) cross
by their raw 16-bit patterns, so every value arrives bit for bit —
int8 codes and f16 scales of quantized decode weights, and an
optimizer's int8 first moments, f32 scales, bf16 second moments and f32
master weights alike.
"""
from __future__ import annotations

import numpy as np
import torch

from paddle_tpu_torch.core.device import resolve_device

__all__ = ["decode_params_from_numpy", "load_module_state",
           "optimizer_states_from_numpy", "tensor_from_numpy"]


def tensor_from_numpy(array):
    """numpy array -> CPU tensor of the same dtype and bits."""
    a = np.ascontiguousarray(array)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


@torch.no_grad()
def load_module_state(module, state):
    """Load the reference's ``Layer.functional_state()`` — its ``(params,
    buffers)`` pair or the params dict alone, every leaf converted by
    ``np.asarray`` — into any ported ``nn.Module`` whose parameter names
    are the reference's.  Names must match one to one and shapes exactly
    (a ``ValueError`` says which do not); values are copied in place,
    bit for bit in the parameter's dtype (bfloat16 included), so views
    of the parameters (the serving path's decode params) keep aliasing
    them."""
    if isinstance(state, tuple):
        state = state[0]
    own = dict(module.named_parameters())
    missing = sorted(set(own) - set(state))
    unexpected = sorted(set(state) - set(own))
    if missing or unexpected:
        raise ValueError(f"load_module_state: missing {missing}, "
                         f"unexpected {unexpected}")
    for name, p in own.items():
        src = tensor_from_numpy(np.asarray(state[name]))
        if tuple(src.shape) != tuple(p.shape):
            raise ValueError(
                f"load_module_state: {name} has shape {tuple(src.shape)}, "
                f"expected {tuple(p.shape)}")
        p.copy_(src.to(p.dtype))


def decode_params_from_numpy(tree, device=None):
    """The reference's ``extract_decode_params`` pytree, converted leaf by
    leaf with ``np.asarray``, -> the port's decode params (the same dict
    structure: ``embed``, ``norm``, ``layers`` [list of per-layer dicts],
    optional ``lm_head`` and ``_rope``) on ``device``."""
    dev = resolve_device(device)

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(conv(v) for v in x)
        return tensor_from_numpy(np.asarray(x)).to(dev)
    return conv(tree)


def optimizer_states_from_numpy(states, device=None):
    """The reference's optimizer state dict ``{acc_name: {param_name:
    array}}`` (``Optimizer.functional_init_states`` layout, as a
    ``TrainStep`` carries it: ``moment1``/``moment2``, ``moment1@scale``
    under int8 moments, ``master_weight`` under multi_precision),
    converted leaf by leaf with ``np.asarray`` -> the port's, on
    ``device``, every leaf bit for bit in its own dtype."""
    dev = resolve_device(device)
    return {n: {k: tensor_from_numpy(np.asarray(v)).to(dev)
                for k, v in d.items()}
            for n, d in states.items()}
