"""Activation recompute.

Counterpart of ``paddle_tpu/distributed/fleet/recompute.py:29-70``: the
region's inputs are kept and its forward re-runs in the backward —
``torch.utils.checkpoint`` with ``use_reentrant=False`` (the reference's
``jax.checkpoint``).  Policy ``None``/``"full"`` (save only the region
inputs) is ported; the selective policies are not yet.
"""
from __future__ import annotations

from torch.utils.checkpoint import checkpoint

__all__ = ["recompute"]

_POLICIES = (None, "full", "dots", "dots_no_batch", "named")


def recompute(function, *args, policy=None, **kwargs):
    """Run ``function(*args, **kwargs)`` keeping only its inputs for the
    backward (the non-reentrant checkpoint)."""
    if policy not in _POLICIES:
        raise ValueError(
            f"unknown recompute policy {policy!r}; one of {_POLICIES}")
    if policy not in (None, "full"):
        raise NotImplementedError(
            f"recompute policy {policy!r} (save selected activations) is "
            "not ported yet; None/'full' is")
    return checkpoint(function, *args, use_reentrant=False, **kwargs)
