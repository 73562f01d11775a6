"""The optimizers.

Counterpart of ``paddle_tpu/optimizer/optimizers.py``: ``SGD``,
``Momentum``, ``Adam``, ``AdamW``, ``Adamax``, ``Adagrad``,
``Adadelta``, ``RMSProp``, ``NAdam``, ``RAdam``, ``Lamb``, ``ASGD`` and
``Rprop``, each with the reference's accumulator names and its
``_update`` written out on plain tensors.  ``lr`` arrives as an f32 0-d
tensor, as the reference's TrainStep passes it, so where the reference
lets jnp promote a low-precision operand against it (SGD and Momentum
compute in the parameter's dtype) the casts are written out; the bias
corrections take the step counter the training step sets
(``_global_step``) and ``beta ** t`` in f32 (``_pow_t``).

Adam and AdamW take ``amsgrad`` (a ``moment2_max`` accumulator, the
running maximum of the second moment); AdamW takes ``lr_ratio``, which
the reference stores and reads only to route the parameter off its fused
path (:112): its update never multiplies by it, and neither does this
one.  With ``moment_dtype="int8"`` on the card every Adam/AdamW
parameter goes through the fused kernel K7 (``_update_param``, the
counterpart of the reference's ``_try_fused_q8``), whatever its size —
except under ``amsgrad`` or ``lr_ratio``, which send it to the generic
update as the reference's routing does.  That is a choice by
configuration, made before any kernel runs.  No kernel computes the
other updates, in the reference either.  ``Momentum`` takes
``moment_dtype`` as well (the reference's reads it off the base);
``"int8"`` stores ``velocity`` as int8 codes.
"""
from __future__ import annotations

import numpy as np
import torch

from paddle_tpu_torch.ops.fused_adamw import adamw_scalars, fused_adamw_q8
from paddle_tpu_torch.optimizer.optimizer import (
    Optimizer, _ArrayParam, _f32,
)

__all__ = ["ASGD", "Adadelta", "Adagrad", "Adam", "AdamW", "Adamax",
           "Lamb", "Momentum", "NAdam", "RAdam", "RMSProp", "Rprop", "SGD"]


def _pow_t(beta, t):
    """``beta ** t`` in float32, as the reference computes it."""
    return torch.pow(_f32(float(beta)), _f32(float(t)))


class SGD(Optimizer):
    _accum_names = ()

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, multi_precision=False,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision=multi_precision)

    def _update(self, p, g, state, lr, name=""):
        # p - lr * g.astype(p.dtype): the product against the f32 rate
        # promotes to f32
        return p.float() - lr * g.to(p.dtype).float(), {}


class Momentum(Optimizer):
    _accum_names = ("velocity",)

    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 use_nesterov=False, weight_decay=None, grad_clip=None,
                 multi_precision=False, rescale_grad=1.0, moment_dtype=None,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision=multi_precision,
                         moment_dtype=moment_dtype)
        self._momentum = momentum
        self._use_nesterov = use_nesterov
        self._rescale = rescale_grad

    def _update(self, p, g, state, lr, name=""):
        g = g * self._rescale
        v = state["velocity"] * self._momentum + g
        step = g + self._momentum * v if self._use_nesterov else v
        return p.float() - lr * step.to(p.dtype).float(), {"velocity": v}


class Adam(Optimizer):
    _accum_names = ("moment1", "moment2")

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, lazy_mode=False, multi_precision=False,
                 use_multi_tensor=False, amsgrad=False, moment_dtype=None,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision=multi_precision,
                         moment_dtype=moment_dtype)
        self._beta1, self._beta2, self._eps = beta1, beta2, epsilon
        self._amsgrad = bool(amsgrad)
        if self._amsgrad:
            self._accum_names = ("moment1", "moment2", "moment2_max")

    def _moments(self, g, state):
        t = self._global_step
        m = self._beta1 * state["moment1"] + (1 - self._beta1) * g
        v = self._beta2 * state["moment2"] + (1 - self._beta2) * g.square()
        mhat = m / (1 - _pow_t(self._beta1, t))
        new_state = {"moment1": m, "moment2": v}
        if self._amsgrad:
            v = torch.maximum(state["moment2_max"], v)
            new_state["moment2_max"] = v
        vhat = v / (1 - _pow_t(self._beta2, t))
        return mhat, vhat, new_state

    def _update(self, p, g, state, lr, name=""):
        mhat, vhat, new_state = self._moments(g, state)
        upd = lr * mhat / (vhat.sqrt() + self._eps)
        return p.float() - upd, new_state

    def _decay_of(self, name):
        return 0.0

    def _fused(self):
        """Whether int8-moment parameters may take K7: not under
        ``amsgrad`` (the kernel keeps no running maximum) nor ``lr_ratio``
        — the reference's routing (``_try_fused_q8``)."""
        return not self._amsgrad

    def _update_param(self, k, p, g, states, masters, lr):
        """Route an int8-moment parameter on the card through K7 (one
        pass: decode, AdamW, re-encode), in place.  ``None`` where the
        kernel does not apply: other moment storage, ``amsgrad`` or
        ``lr_ratio``, or CPU tensors, which take the decode / ``_update``
        / encode path as the reference does off the TPU."""
        if not self._fused():
            return None
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
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         None, grad_clip, lazy_mode, multi_precision,
                         amsgrad=amsgrad, moment_dtype=moment_dtype,
                         name=name)
        self._coeff = (float(weight_decay)
                       if isinstance(weight_decay, (int, float)) else 0.01)
        self._apply_decay_param_fun = apply_decay_param_fun
        # stored and routed on, never multiplied in (the reference's
        # jnp update ignores it too)
        self._lr_ratio = lr_ratio

    def _fused(self):
        return super()._fused() and self._lr_ratio is None

    def _decay_of(self, name):
        if (self._apply_decay_param_fun is not None
                and not self._apply_decay_param_fun(name)):
            return 0.0
        return self._coeff

    def _update(self, p, g, state, lr, name=""):
        p_decayed = p.float() * (1.0 - lr * self._decay_of(name))
        mhat, vhat, new_state = self._moments(g, state)
        return p_decayed - lr * mhat / (vhat.sqrt() + self._eps), new_state


class Adamax(Optimizer):
    _accum_names = ("moment", "inf_norm")

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._beta1, self._beta2, self._eps = beta1, beta2, epsilon

    def _update(self, p, g, state, lr, name=""):
        t = self._global_step
        m = self._beta1 * state["moment"] + (1 - self._beta1) * g
        u = torch.maximum(self._beta2 * state["inf_norm"], g.abs())
        upd = lr / (1 - _pow_t(self._beta1, t)) * m / (u + self._eps)
        return p.float() - upd, {"moment": m, "inf_norm": u}


class Adagrad(Optimizer):
    _accum_names = ("moment",)

    def __init__(self, learning_rate, epsilon=1e-6, parameters=None,
                 weight_decay=None, grad_clip=None,
                 initial_accumulator_value=0.0, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._eps = epsilon
        self._init_value = initial_accumulator_value

    def _eager_init_state(self, name, p):
        return torch.full(p.shape, self._init_value, dtype=torch.float32,
                          device=p.device)

    def _update(self, p, g, state, lr, name=""):
        acc = state["moment"] + g.square()
        return p.float() - lr * g / (acc.sqrt() + self._eps), {"moment": acc}


class Adadelta(Optimizer):
    _accum_names = ("avg_squared_grad", "avg_squared_update")

    def __init__(self, learning_rate=0.001, epsilon=1e-6, rho=0.95,
                 parameters=None, weight_decay=None, grad_clip=None,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._eps, self._rho = epsilon, rho

    def _update(self, p, g, state, lr, name=""):
        rho = self._rho
        sg = rho * state["avg_squared_grad"] + (1 - rho) * g.square()
        upd = g * (state["avg_squared_update"] + self._eps).sqrt() \
            / (sg + self._eps).sqrt()
        su = rho * state["avg_squared_update"] + (1 - rho) * upd.square()
        return p.float() - lr * upd, {"avg_squared_grad": sg,
                                      "avg_squared_update": su}


class RMSProp(Optimizer):
    _accum_names = ("mean_square", "mean_grad", "momentum_acc")

    def __init__(self, learning_rate, rho=0.95, epsilon=1e-6, momentum=0.0,
                 centered=False, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._rho, self._eps = rho, epsilon
        self._momentum, self._centered = momentum, centered

    def _update(self, p, g, state, lr, name=""):
        rho = self._rho
        ms = rho * state["mean_square"] + (1 - rho) * g.square()
        if self._centered:
            mg = rho * state["mean_grad"] + (1 - rho) * g
            denom = (ms - mg.square() + self._eps).sqrt()
        else:
            mg = state["mean_grad"]
            denom = (ms + self._eps).sqrt()
        mom = self._momentum * state["momentum_acc"] + lr * g / denom
        return p.float() - mom, {"mean_square": ms, "mean_grad": mg,
                                 "momentum_acc": mom}


class NAdam(Optimizer):
    _accum_names = ("moment1", "moment2", "mu_product")

    def __init__(self, learning_rate=0.002, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, momentum_decay=0.004, parameters=None,
                 weight_decay=None, grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._beta1, self._beta2, self._eps = beta1, beta2, epsilon
        self._psi = momentum_decay

    def _eager_init_state(self, name, p):
        if name == "mu_product":
            return torch.ones((), dtype=torch.float32, device=p.device)
        return None

    def _update(self, p, g, state, lr, name=""):
        t, b1, b2 = self._global_step, self._beta1, self._beta2
        mu_t = b1 * (1 - 0.5 * 0.96 ** (t * self._psi))
        mu_t1 = b1 * (1 - 0.5 * 0.96 ** ((t + 1) * self._psi))
        mu_prod = state["mu_product"] * mu_t
        m = b1 * state["moment1"] + (1 - b1) * g
        v = b2 * state["moment2"] + (1 - b2) * g.square()
        mhat = mu_t1 * m / (1 - mu_prod * mu_t1) \
            + (1 - mu_t) * g / (1 - mu_prod)
        vhat = v / (1 - _pow_t(b2, t))
        return (p.float() - lr * mhat / (vhat.sqrt() + self._eps),
                {"moment1": m, "moment2": v, "mu_product": mu_prod})


class RAdam(Optimizer):
    _accum_names = ("moment1", "moment2")

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._beta1, self._beta2, self._eps = beta1, beta2, epsilon

    def _update(self, p, g, state, lr, name=""):
        t, b1, b2 = self._global_step, self._beta1, self._beta2
        m = b1 * state["moment1"] + (1 - b1) * g
        v = b2 * state["moment2"] + (1 - b2) * g.square()
        mhat = m / (1 - _pow_t(b1, t))
        # the rectification term is host arithmetic on f32 scalars, as
        # the reference's (its branch needs a concrete value)
        rho_inf = 2.0 / (1 - b2) - 1
        bt = _pow_t(b2, t)
        rho_t = rho_inf - 2.0 * t * bt / (1 - bt)
        if float(rho_t) > 4:
            vhat = (v / (1 - bt)).sqrt()
            r = np.sqrt(((rho_t - 4) * (rho_t - 2) * rho_inf).numpy()
                        / ((rho_inf - 4) * (rho_inf - 2) * rho_t).numpy())
            upd = lr * torch.from_numpy(np.asarray(r, np.float32)) \
                * mhat / (vhat + self._eps)
        else:
            upd = lr * mhat
        return p.float() - upd, {"moment1": m, "moment2": v}


class Lamb(Optimizer):
    _accum_names = ("moment1", "moment2")

    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01,
                 beta1=0.9, beta2=0.999, epsilon=1e-6, parameters=None,
                 grad_clip=None, exclude_from_weight_decay_fn=None,
                 multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, None, grad_clip, name,
                         multi_precision=multi_precision)
        self._beta1, self._beta2, self._eps = beta1, beta2, epsilon
        self._lamb_decay = lamb_weight_decay
        self._exclude_fn = exclude_from_weight_decay_fn

    def _update(self, p, g, state, lr, name=""):
        t, b1, b2 = self._global_step, self._beta1, self._beta2
        m = b1 * state["moment1"] + (1 - b1) * g
        v = b2 * state["moment2"] + (1 - b2) * g.square()
        mhat = m / (1 - _pow_t(b1, t))
        vhat = v / (1 - _pow_t(b2, t))
        decay = self._lamb_decay
        if self._exclude_fn is not None \
                and self._exclude_fn(_ArrayParam(p, name)):
            decay = 0.0
        p32 = p.float()
        r = mhat / (vhat.sqrt() + self._eps) + decay * p32
        w_norm = p32.square().sum().sqrt()
        r_norm = r.square().sum().sqrt()
        trust = torch.where((w_norm > 0) & (r_norm > 0), w_norm / r_norm,
                            torch.ones_like(w_norm))
        return p32 - lr * trust * r, {"moment1": m, "moment2": v}


class ASGD(Optimizer):
    _accum_names = ("d", "ys")

    def __init__(self, learning_rate=0.001, batch_num=1, parameters=None,
                 weight_decay=None, grad_clip=None, multi_precision=False,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._batch_num = batch_num

    def _update(self, p, g, state, lr, name=""):
        d = state["d"] - state["ys"] + g
        return p.float() - lr * d / self._batch_num, {"d": d, "ys": g}


class Rprop(Optimizer):
    _accum_names = ("prev_grad", "lr_scale")

    def __init__(self, learning_rate=0.001, learning_rate_range=(1e-5, 50),
                 parameters=None, etas=(0.5, 1.2), grad_clip=None,
                 multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, None, grad_clip, name)
        self._lr_min, self._lr_max = learning_rate_range
        self._eta_minus, self._eta_plus = etas

    def _eager_init_state(self, name, p):
        if name == "lr_scale":
            return torch.full(p.shape, self.get_lr(), dtype=torch.float32,
                              device=p.device)
        return None

    def _update(self, p, g, state, lr, name=""):
        sign = torch.sign(g * state["prev_grad"])
        ls = state["lr_scale"]
        scale = torch.where(sign > 0, ls * self._eta_plus,
                            torch.where(sign < 0, ls * self._eta_minus, ls))
        scale = torch.clamp(scale, self._lr_min, self._lr_max)
        g_eff = torch.where(sign < 0, torch.zeros_like(g), g)
        return (p.float() - scale * torch.sign(g_eff),
                {"prev_grad": g_eff, "lr_scale": scale})

