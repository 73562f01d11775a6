"""The training step: forward, backward and optimizer update.

Counterpart of ``paddle_tpu/static/functionalize.py:73-284``
(``TrainStep``, ``build_train_step``).  Where the reference traces the
Layer into one jitted program over its functional state, the port runs
eagerly: the forward under autograd, ``torch.autograd.grad`` for the
trainable parameters' gradients (``requires_grad``; frozen parameters
get no update; a trainable parameter the loss does not reach, such as
BERT's pooler under the masked-LM loss, gets a zero gradient, as
``jax.value_and_grad`` gives it, so weight decay still applies), then
the optimizer's ``functional_update`` over flat
``{name: tensor}`` dicts with the step counter as the bias-correction
step.  After each step the module's parameters hold the new values: they
are copied in place, so every view of a parameter (the serving path's
decode params alias them) sees the update.  Optimizer state lives on the
step object, as in the reference, and is carried in each tensor's own
storage dtype — with ``moment_dtype="int8"`` int8 codes, f32 scales and
bf16 second moments, never widened between steps.  On the card the
fused int8 AdamW (K7) updates parameters and state in place, so the
copy back is a self copy, which PyTorch skips.

The reference's knobs, in its order (:89-264):

* ``amp_level`` ``"O1"``/``"OD"``/``"O2"`` runs the forward under
  ``amp.auto_cast(level, amp_dtype)``; the backward runs outside it, as
  the reference's ``value_and_grad`` differentiates the cast forward
  (a recompute re-enters the forward's amp state);
* ``optimizer._grad_rescale`` multiplies the gradients (:162-167);
* ``optimizer._grad_clip`` clips the micro-gradients — or, when the
  optimizer merges gradients (``k_steps > 1``), is handed to it as
  ``_merged_clip`` to clip the merged gradient once at apply time
  (``_apply_clip`` :61, :170-189);
* gradient merge: ``GradientMergeOptimizer.functional_update`` decides
  apply or accumulate on the host from the step counter
  (``incubate/optimizer/gradient_merge.py`` says why it cannot copy the
  reference's select);
* the learning rate is read before the update and
  ``optimizer._lr_scheduler``, where one is set, is stepped after every
  call (:262-264).  The reference's optimizer never sets that attribute
  itself: a scheduler passed as ``learning_rate`` is stepped by the
  caller, as in Paddle, unless the caller also sets it there.

Every step runs under the ``train.step`` span and books its dispatch in
``CompileCacheMonitor("functionalize")`` (program ``train_step``), as
the reference does (``paddle_tpu/static/functionalize.py:36, :44``): the
first step of a ``TrainStep`` at a new set of input shapes and dtypes —
what ``jax.jit`` retraced on — counts a trace.

ZeRO sharding belongs to the distributed-training slice and raises.
"""
from __future__ import annotations

import contextlib
import functools
import itertools

import torch

from paddle_tpu_torch.amp.auto_cast import auto_cast
from paddle_tpu_torch.distributed.fleet.recompute import recompute as _remat
from paddle_tpu_torch.observability.compilecache import CompileCacheMonitor
from paddle_tpu_torch.observability.trace import span

__all__ = ["TrainStep", "build_train_step"]

_mon = CompileCacheMonitor("functionalize")
_train_span = span("train.step")
_serials = itertools.count()


def _apply_clip(clip, grads, params):
    """Run a clip object over ``{name: grad}`` (None entries, frozen
    parameters, pass through), handing it the parameters themselves so it
    reads their ``need_clip``."""
    keys = [k for k, g in grads.items() if g is not None]
    clipped = clip([(params[k], grads[k]) for k in keys])
    out = dict(grads)
    for k, (_, g) in zip(keys, clipped):
        out[k] = g
    return out


class TrainStep:
    """Callable ``step(*inputs, label) -> loss`` (``loss_fn`` given) or
    ``step(*inputs) -> loss`` (the network returns its loss)."""

    def __init__(self, network, loss_fn, optimizer, recompute=False,
                 amp_level=None, amp_dtype="bfloat16"):
        if optimizer is None:
            raise ValueError("TrainStep needs an optimizer")
        if amp_level not in (None, "O0", "OD", "O1", "O2"):
            raise ValueError(f"amp_level must be O0/OD/O1/O2, got "
                             f"{amp_level!r}")
        if getattr(optimizer, "_group_sharded_level", 0):
            raise NotImplementedError(
                "ZeRO sharding is not ported yet (the distributed-training "
                "slice brings it)")
        self._network = network
        self._loss_fn = loss_fn
        self._optimizer = optimizer
        self._recompute = bool(recompute)
        self._amp_level = None if amp_level in (None, "O0") else amp_level
        self._amp_dtype = amp_dtype
        self._merge_k = max(int(getattr(optimizer, "k_steps", 1) or 1),
                            int(getattr(optimizer, "_acc_steps", 1) or 1))
        self._states = optimizer.functional_init_states(
            {n: p.detach() for n, p in network.named_parameters()})
        self._step_count = int(getattr(optimizer, "_global_step", 0) or 0)
        self._serial = next(_serials)   # one jitted program a TrainStep

    def _loss(self, *datas):
        if self._loss_fn is not None:
            return self._loss_fn(self._network(*datas[:-1]), datas[-1])
        return self._network(*datas)

    def __call__(self, *datas):
        _mon.dispatch("train_step", (self._serial,) + tuple(
            (tuple(d.shape), d.dtype) if isinstance(d, torch.Tensor)
            else type(d) for d in datas))
        with _train_span:
            return self._step(*datas)

    def _step(self, *datas):
        self._step_count += 1
        opt = self._optimizer
        params = dict(self._network.named_parameters())
        train = {n: p for n, p in params.items() if p.requires_grad}
        amp = (auto_cast(level=self._amp_level, dtype=self._amp_dtype)
               if self._amp_level else contextlib.nullcontext())
        with torch.enable_grad():
            with amp:
                loss = (_remat(self._loss, *datas) if self._recompute
                        else self._loss(*datas))
            grads = torch.autograd.grad(loss, list(train.values()),
                                        allow_unused=True,
                                        materialize_grads=True)
        grads = dict(zip(train, grads))
        rescale = float(getattr(opt, "_grad_rescale", 1.0) or 1.0)
        if rescale != 1.0:
            grads = {k: g * rescale for k, g in grads.items()}
        clip = getattr(opt, "_grad_clip", None)
        # always reset: a hook from an earlier TrainStep must not survive
        opt._merged_clip = None
        if clip is not None:
            if self._merge_k > 1:
                opt._merged_clip = functools.partial(_apply_clip, clip,
                                                     params=train)
            else:
                grads = _apply_clip(clip, grads, train)
        lr = opt.get_lr()
        prev = opt._global_step
        opt._global_step = self._step_count
        try:
            new, self._states = opt.functional_update(
                {n: p.detach() for n, p in params.items()}, grads,
                self._states, lr)
        finally:
            opt._global_step = prev
        with torch.no_grad():
            for n, p in params.items():
                if grads.get(n) is not None:
                    p.copy_(new[n])
        sched = getattr(opt, "_lr_scheduler", None)
        if sched is not None:
            sched.step()
        return loss.detach()


def build_train_step(network, loss_fn, optimizer, recompute=False,
                     amp_level=None, amp_dtype="bfloat16"):
    return TrainStep(network, loss_fn, optimizer, recompute=recompute,
                     amp_level=amp_level, amp_dtype=amp_dtype)
