"""Adam and AdamW.

Counterpart of ``paddle_tpu/optimizer/optimizers.py`` (``_pow_t``,
``Adam``, ``AdamW`` :14-83, :152-188): the same update, elementwise in
f32 on plain tensors.  AdamW decays decoupled from the gradient:
``p * (1 - lr * coeff) - lr * mhat / (sqrt(vhat) + eps)``.  The bias
corrections use the step counter the training step sets
(``_global_step``).  No kernel computes this update in the reference's
f32-moment path either; the fused int8-moment kernel (K7) is the next
slice's.
"""
from __future__ import annotations

import torch

from paddle_tpu_torch.optimizer.optimizer import Optimizer

__all__ = ["Adam", "AdamW"]


def _f32(x):
    return torch.tensor(x, dtype=torch.float32)


def _pow_t(beta, t):
    """``beta ** t`` in float32, as the reference computes it."""
    return torch.pow(_f32(beta), _f32(float(t)))


class Adam(Optimizer):
    _accum_names = ("moment1", "moment2")

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, lazy_mode=False, multi_precision=False,
                 use_multi_tensor=False, amsgrad=False, moment_dtype=None,
                 name=None):
        if amsgrad:
            raise NotImplementedError("amsgrad is not ported yet")
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision=multi_precision,
                         moment_dtype=moment_dtype)
        self._beta1, self._beta2, self._eps = beta1, beta2, epsilon

    def _moments(self, g, state):
        t = self._global_step
        m = self._beta1 * state["moment1"] + (1 - self._beta1) * g
        v = self._beta2 * state["moment2"] + (1 - self._beta2) * g.square()
        mhat = m / (1 - _pow_t(self._beta1, t))
        vhat = v / (1 - _pow_t(self._beta2, t))
        return mhat, vhat, {"moment1": m, "moment2": v}

    def _update(self, p, g, state, lr, name=""):
        mhat, vhat, new_state = self._moments(g, state)
        upd = _f32(lr) * mhat / (vhat.sqrt() + self._eps)
        return p.float() - upd, new_state


class AdamW(Adam):
    """Decoupled weight decay (``weight_decay`` is its coefficient)."""

    _decoupled = True

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None,
                 lazy_mode=False, multi_precision=False, amsgrad=False,
                 moment_dtype=None, name=None):
        if lr_ratio is not None:
            raise NotImplementedError("lr_ratio is not ported yet")
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         None, grad_clip, lazy_mode, multi_precision,
                         amsgrad=amsgrad, moment_dtype=moment_dtype,
                         name=name)
        self._coeff = (float(weight_decay)
                       if isinstance(weight_decay, (int, float)) else 0.01)
        self._apply_decay_param_fun = apply_decay_param_fun

    def _update(self, p, g, state, lr, name=""):
        decay = self._coeff
        if (self._apply_decay_param_fun is not None
                and not self._apply_decay_param_fun(name)):
            decay = 0.0
        lr32 = _f32(lr)
        p_decayed = p.float() * (1.0 - lr32 * decay)
        mhat, vhat, new_state = self._moments(g, state)
        return p_decayed - lr32 * mhat / (vhat.sqrt() + self._eps), new_state
