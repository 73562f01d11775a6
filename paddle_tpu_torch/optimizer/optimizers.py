"""Adam and AdamW.

Counterpart of ``paddle_tpu/optimizer/optimizers.py`` (``_pow_t``,
``Adam``, ``AdamW`` :14-188): the same update, elementwise in f32 on
plain tensors.  AdamW decays decoupled from the gradient:
``p * (1 - lr * coeff) - lr * mhat / (sqrt(vhat) + eps)``.  The bias
corrections use the step counter the training step sets
(``_global_step``).  No kernel computes the f32-moment update, in the
reference either.  With ``moment_dtype="int8"`` on the card, every
parameter goes through the fused kernel K7 (``_update_param``, the
counterpart of the reference's ``_try_fused_q8`` :85-149) whatever its
size: the kernel handles a ragged last block itself, where the reference
sent sizes that are not multiples of 256 to its jnp path.
"""
from __future__ import annotations

import torch

from paddle_tpu_torch.ops.fused_adamw import adamw_scalars, fused_adamw_q8
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

    def _decay_of(self, name):
        return 0.0

    def _update_param(self, k, p, g, states, masters, lr):
        """Route an int8-moment parameter on the card through K7 (one
        pass: decode, AdamW, re-encode), in place.  ``None`` where the
        kernel does not apply: other moment storage, or CPU tensors,
        which take the decode / ``_update`` / encode path as the
        reference does off the TPU."""
        m = states.get("moment1", {}).get(k)
        v = states.get("moment2", {}).get(k)
        sc = states.get("moment1@scale", {}).get(k)
        if m is None or v is None or sc is None:
            return None
        if m.dtype != torch.int8 or v.dtype != torch.bfloat16 \
                or m.device.type != "cuda":
            return None
        scal = adamw_scalars(self._beta1, self._beta2, self._eps, lr,
                             self._global_step, self._decay_of(k))
        p, master, m, sc, v = fused_adamw_q8(p, g.contiguous(), m, sc, v,
                                             scal, master=masters.get(k))
        new = {"moment1": m, "moment1@scale": sc, "moment2": v}
        if master is not None:
            new["master_weight"] = master
        return p, new


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

    def _decay_of(self, name):
        if (self._apply_decay_param_fun is not None
                and not self._apply_decay_param_fun(name)):
            return 0.0
        return self._coeff

    def _update(self, p, g, state, lr, name=""):
        decay = self._decay_of(name)
        lr32 = _f32(lr)
        p_decayed = p.float() * (1.0 - lr32 * decay)
        mhat, vhat, new_state = self._moments(g, state)
        return p_decayed - lr32 * mhat / (vhat.sqrt() + self._eps), new_state
