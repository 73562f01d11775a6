"""Activation recompute, with the reference's selective policies.

Counterpart of ``paddle_tpu/distributed/fleet/recompute.py:18-70``: the
region's inputs are kept and its forward re-runs in the backward —
``torch.utils.checkpoint`` with ``use_reentrant=False`` (the reference's
``jax.checkpoint``).  The policies map onto selective checkpointing
(``context_fn=create_selective_checkpoint_contexts(policy)``), which
keeps the outputs of the ops a policy names and recomputes the rest:

* ``None`` / ``"full"``: keep only the region's inputs;
* ``"dots"`` (``dots_saveable``): keep the matmul-family aten ops
  (``mm``, ``addmm``, ``bmm``, ``baddbmm``);
* ``"dots_no_batch"`` (``dots_with_no_batch_dims_saveable``): keep those
  without a batch dimension (``mm``, ``addmm``);
* ``"named"`` (``save_only_these_names("ckpt")``): keep only the outputs
  of ``ckpt_name``, an identity op registered with ``torch.library``
  under the port's namespace (``paddle_tpu_torch::ckpt_name``) that the
  Llama attention applies to its output under this policy
  (``models/llama.py``, the reference's ``checkpoint_name(x, "ckpt")``).

What a policy keeps comes back from the first forward in the recompute;
every other op, and any Python code — a kernel launched through its
wrapper — runs again.  So ``"named"`` does not spare the flash forward
its second launch, as the reference's spared the Pallas kernel: the
kernels are not aten ops the policy can see (ROADMAP §C).  The region
runs under the amp state it was called under, re-entered for the
recompute (``amp.auto_cast.bind_state``).
"""
from __future__ import annotations

import functools

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts,
)

from paddle_tpu_torch.amp.auto_cast import bind_state

__all__ = ["ckpt_name", "recompute"]

_POLICIES = (None, "full", "dots", "dots_no_batch", "named")


@torch.library.custom_op("paddle_tpu_torch::ckpt_name", mutates_args=())
def ckpt_name(x: torch.Tensor) -> torch.Tensor:
    """Identity that tags its output for the ``"named"`` policy."""
    return x.clone()


@ckpt_name.register_fake
def _(x):
    return torch.empty_like(x)


ckpt_name.register_autograd(lambda ctx, g: g)


def _saved_ops(policy):
    aten = torch.ops.aten
    if policy == "dots":
        return (aten.mm.default, aten.addmm.default, aten.bmm.default,
                aten.baddbmm.default)
    if policy == "dots_no_batch":
        return (aten.mm.default, aten.addmm.default)
    return (torch.ops.paddle_tpu_torch.ckpt_name.default,)


@functools.lru_cache(maxsize=None)
def _policy_fn(policy):
    saved = _saved_ops(policy)

    def fn(ctx, op, *args, **kwargs):
        return (CheckpointPolicy.MUST_SAVE if op in saved
                else CheckpointPolicy.PREFER_RECOMPUTE)
    return fn


def recompute(function, *args, policy=None, **kwargs):
    """Run ``function(*args, **kwargs)`` keeping only its inputs (and the
    outputs ``policy`` names) for the backward."""
    if policy not in _POLICIES:
        raise ValueError(
            f"unknown recompute policy {policy!r}; one of {_POLICIES}")
    fn = bind_state(function)
    if policy in (None, "full"):
        return checkpoint(fn, *args, use_reentrant=False, **kwargs)
    ctx = functools.partial(create_selective_checkpoint_contexts,
                            _policy_fn(policy))
    return checkpoint(fn, *args, use_reentrant=False, context_fn=ctx,
                      **kwargs)
