"""Optimizer base: accumulator dtypes and the functional update.

Counterpart of ``paddle_tpu/optimizer/optimizer.py`` (:91-100,
:238-336).  Each optimizer defines ``_update(param, grad, state, lr)`` on
plain tensors; ``functional_init_states`` and ``functional_update`` run it
over flat ``{name: tensor}`` dicts — what the training step
(``static/functionalize.py``) calls.  As in the reference:

* moments of bf16/f16 parameters are kept in f32 (``moment_dtype=None``),
  or stored as ``"float32"``/``"bfloat16"`` and widened to f32 for the
  update math;
* a bf16 gradient is widened to f32, and the new parameter is cast back
  to the parameter's dtype;
* ``multi_precision=True`` keeps f32 master weights of low-precision
  parameters, updated in f32.

``moment_dtype="int8"`` (int8 first moments with a scale per 256 values,
updated by the fused AdamW kernel K7) is not ported yet: the next slice
brings it.  Gradient clipping and learning-rate schedulers are not
ported yet either.
"""
from __future__ import annotations

import torch

__all__ = ["Optimizer"]

_LOW = (torch.bfloat16, torch.float16)
_MOMENT_DTYPES = {None: None, "float32": torch.float32,
                  "bfloat16": torch.bfloat16}


class Optimizer:
    _accum_names: tuple = ()

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None,
                 multi_precision=False, moment_dtype=None):
        if not isinstance(learning_rate, (int, float)):
            raise NotImplementedError(
                "learning-rate schedulers are not ported yet: pass a float")
        if grad_clip is not None:
            raise NotImplementedError("gradient clipping is not ported yet")
        if moment_dtype == "int8":
            raise NotImplementedError(
                "moment_dtype='int8' (int8 first moments, updated by the "
                "fused AdamW kernel K7) is not ported yet: the next slice "
                "brings it; use None, 'float32' or 'bfloat16'")
        if moment_dtype not in _MOMENT_DTYPES:
            raise ValueError(f"unknown moment_dtype {moment_dtype!r}; one of "
                             f"{sorted(k for k in _MOMENT_DTYPES if k)}, None")
        self._learning_rate = float(learning_rate)
        if isinstance(weight_decay, (int, float)):
            self._l2_coeff = float(weight_decay)
        elif weight_decay is None:
            self._l2_coeff = 0.0
        else:
            raise NotImplementedError(
                "regularizer objects as weight_decay are not ported yet")
        self._global_step = 0
        self._multi_precision = bool(multi_precision)
        self._moment_dtype = _MOMENT_DTYPES[moment_dtype]

    def get_lr(self):
        return self._learning_rate

    def _update(self, p, g, state, lr, name=""):
        """``(new_param f32, new_state)`` from the param (or its master)
        named ``name``, its f32 gradient and f32 state.  Overridden per
        optimizer."""
        raise NotImplementedError

    def _acc_dtype(self, v):
        if self._moment_dtype is not None and v.is_floating_point():
            return self._moment_dtype
        return torch.float32 if v.dtype in _LOW else v.dtype

    def functional_init_states(self, params):
        """``{acc_name: {param_name: zeros}}`` (plus ``master_weight``
        under multi_precision) for ``params {name: tensor}``."""
        states = {n: {k: torch.zeros(v.shape, dtype=self._acc_dtype(v),
                                     device=v.device)
                      for k, v in params.items()}
                  for n in self._accum_names}
        if self._multi_precision:
            states["master_weight"] = {
                k: v.detach().float() for k, v in params.items()
                if v.dtype in _LOW}
        return states

    @torch.no_grad()
    def functional_update(self, params, grads, states, lr):
        """One update over flat dicts: returns ``(new_params,
        new_states)``.  ``grads[k] is None`` passes a parameter (and its
        state) through untouched."""
        new_params = {}
        new_states = {n: {} for n in states}
        masters = states.get("master_weight", {})
        for k, p in params.items():
            g = grads.get(k)
            if g is None:
                new_params[k] = p
                for n in states:
                    if k in states[n]:
                        new_states[n][k] = states[n][k]
                continue
            g = g.float() if g.dtype == torch.bfloat16 else g
            base = masters.get(k, p)
            if self._l2_coeff and not getattr(self, "_decoupled", False):
                g = g + self._l2_coeff * base.to(g.dtype)
            st = {n: states[n][k].float() for n in self._accum_names}
            new_p, ns = self._update(base, g, st, lr, k)
            new_params[k] = new_p.to(p.dtype)
            if k in masters:
                new_states["master_weight"][k] = new_p.float()
            for n, v in ns.items():
                new_states[n][k] = v.to(states[n][k].dtype)
        return new_params, new_states
