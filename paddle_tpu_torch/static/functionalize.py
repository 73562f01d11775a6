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

Every step runs under the ``train.step`` span and books its dispatch in
``CompileCacheMonitor("functionalize")`` (program ``train_step``), as
the reference does (``paddle_tpu/static/functionalize.py:36, :44``): the
first step of a ``TrainStep`` at a new set of input shapes and dtypes —
what ``jax.jit`` retraced on — counts a trace.

Gradient clipping, amp, ZeRO sharding and gradient merge are not ported
yet and raise.
"""
from __future__ import annotations

import itertools

import torch
from torch.utils.checkpoint import checkpoint

from paddle_tpu_torch.observability.compilecache import CompileCacheMonitor
from paddle_tpu_torch.observability.trace import span

__all__ = ["TrainStep", "build_train_step"]

_mon = CompileCacheMonitor("functionalize")
_train_span = span("train.step")
_serials = itertools.count()


class TrainStep:
    """Callable ``step(*inputs, label) -> loss`` (``loss_fn`` given) or
    ``step(*inputs) -> loss`` (the network returns its loss)."""

    def __init__(self, network, loss_fn, optimizer, recompute=False,
                 amp_level=None):
        if optimizer is None:
            raise ValueError("TrainStep needs an optimizer")
        if amp_level not in (None, "O0"):
            raise NotImplementedError("amp (auto_cast) in the training step "
                                      "is not ported yet")
        if getattr(optimizer, "_grad_clip", None) is not None:
            raise NotImplementedError("gradient clipping is not ported yet")
        if max(int(getattr(optimizer, "k_steps", 1) or 1),
               int(getattr(optimizer, "_acc_steps", 1) or 1)) > 1:
            raise NotImplementedError("gradient merge is not ported yet")
        if getattr(optimizer, "_group_sharded_level", 0):
            raise NotImplementedError("ZeRO sharding is not ported yet")
        self._network = network
        self._loss_fn = loss_fn
        self._optimizer = optimizer
        self._recompute = bool(recompute)
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
        params = dict(self._network.named_parameters())
        train = {n: p for n, p in params.items() if p.requires_grad}
        with torch.enable_grad():
            if self._recompute:
                loss = checkpoint(self._loss, *datas, use_reentrant=False)
            else:
                loss = self._loss(*datas)
            grads = torch.autograd.grad(loss, list(train.values()),
                                        allow_unused=True,
                                        materialize_grads=True)
        grads = dict(zip(train, grads))
        opt = self._optimizer
        prev = opt._global_step
        opt._global_step = self._step_count
        try:
            new, self._states = opt.functional_update(
                {n: p.detach() for n, p in params.items()}, grads,
                self._states, opt.get_lr())
        finally:
            opt._global_step = prev
        with torch.no_grad():
            for n, p in params.items():
                if grads.get(n) is not None:
                    p.copy_(new[n])
        return loss.detach()


def build_train_step(network, loss_fn, optimizer, recompute=False,
                     amp_level=None):
    return TrainStep(network, loss_fn, optimizer, recompute=recompute,
                     amp_level=amp_level)
