"""Optimizer base: accumulator dtypes and the functional update.

Counterpart of ``paddle_tpu/optimizer/optimizer.py`` (:91-100,
:212-336).  Each optimizer defines ``_update(param, grad, state, lr)`` on
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

``moment_dtype="int8"`` stores FIRST moments (``moment1``, ``moment``,
``velocity``, ``avg_grad``) as int8 codes with one f32 absmax scale per
256 values of the flat tensor (``<name>@scale``, ``ceil(n / 256)``
long) and second moments as bf16 (``_moment_storage``).  On the CPU the
update decodes the codes, runs ``_update`` in f32 and re-encodes, as the
reference does off the TPU; on the card an optimizer may update a
parameter its own way instead (``_update_param``: Adam and AdamW route
every int8-moment parameter through K7, ``ops/fused_adamw.py``, which
updates the parameter and its state in place).  Gradient clipping and
learning-rate schedulers are not ported yet.
"""
from __future__ import annotations

import torch

from paddle_tpu_torch.ops.fused_adamw import q8_decode, q8_encode

__all__ = ["Optimizer"]

_LOW = (torch.bfloat16, torch.float16)
_MOMENT_DTYPES = {None: None, "float32": torch.float32,
                  "bfloat16": torch.bfloat16, "int8": torch.int8}
#: the accumulators ``moment_dtype="int8"`` stores as int8 codes
_FIRST_MOMENTS = ("moment1", "moment", "velocity", "avg_grad")


class Optimizer:
    _accum_names: tuple = ()
    #: weight decay applied to the parameter, not added to the gradient
    _decoupled = False

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None,
                 multi_precision=False, moment_dtype=None):
        if not isinstance(learning_rate, (int, float)):
            raise NotImplementedError(
                "learning-rate schedulers are not ported yet: pass a float")
        if grad_clip is not None:
            raise NotImplementedError("gradient clipping is not ported yet")
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

    def _update_param(self, k, p, g, states, masters, lr):
        """Update parameter ``k`` another way than decode / ``_update`` /
        encode (a fused kernel): ``(new_param, {acc_name: new_state})``,
        with a new master under ``"master_weight"``, or ``None`` for the
        generic path.  ``g`` is the gradient as it arrived (plus the L2
        term); the generic path widens it to f32 after this hook."""
        return None

    def _moment_storage(self, name):
        """Storage dtype of accumulator ``name`` (``None``: f32 for low
        precision parameters, else the parameter's).  ``"int8"`` makes
        first moments int8 and second moments bf16: grad² spans too much
        range for linear int8."""
        md = self._moment_dtype
        if md == torch.int8:
            return torch.int8 if name in _FIRST_MOMENTS else torch.bfloat16
        return md

    def functional_init_states(self, params):
        """``{acc_name: {param_name: zeros}}`` (plus ``<acc>@scale`` for
        int8 accumulators and ``master_weight`` under multi_precision)
        for ``params {name: tensor}``."""
        states = {}
        for n in self._accum_names:
            stor = self._moment_storage(n)

            def acc_dtype(v, stor=stor):
                if stor is not None and v.is_floating_point():
                    return stor
                return torch.float32 if v.dtype in _LOW else v.dtype

            states[n] = {k: torch.zeros(v.shape, dtype=acc_dtype(v),
                                        device=v.device)
                         for k, v in params.items()}
            if stor == torch.int8:
                states[n + "@scale"] = {
                    k: torch.zeros((-(-v.numel() // 256),),
                                   dtype=torch.float32, device=v.device)
                    for k, v in params.items() if v.is_floating_point()}
        if self._multi_precision:
            states["master_weight"] = {
                k: v.detach().float() for k, v in params.items()
                if v.dtype in _LOW}
        return states

    def _decode_state(self, states, n, k):
        sv = states[n][k]
        if sv.dtype == torch.int8 and n + "@scale" in states:
            return q8_decode(sv, states[n + "@scale"][k])
        return sv.float()

    @torch.no_grad()
    def functional_update(self, params, grads, states, lr):
        """One update over flat dicts: returns ``(new_params,
        new_states)``.  ``grads[k] is None`` passes a parameter (and its
        state) through untouched.  A parameter the fused int8 kernel
        takes is updated in place, with its state; the returned dicts
        then hold the same tensors."""
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
            base = masters.get(k, p)
            # the reference widens a bf16 gradient to f32, then adds the
            # L2 term; the fused kernel widens in registers (exact), so
            # without an L2 term it reads the gradient as it is
            if self._l2_coeff and not self._decoupled:
                g = g.float() if g.dtype == torch.bfloat16 else g
                g = g + self._l2_coeff * base.to(g.dtype)
            res = self._update_param(k, p, g, states, masters, lr)
            if res is not None:
                new_params[k] = res[0]
                for n, t in res[1].items():
                    new_states[n][k] = t
                continue
            g = g.float() if g.dtype == torch.bfloat16 else g
            st = {n: self._decode_state(states, n, k)
                  for n in self._accum_names}
            new_p, ns = self._update(base, g, st, lr, k)
            new_params[k] = new_p.to(p.dtype)
            if k in masters:
                new_states["master_weight"][k] = new_p.float()
            for n, v in ns.items():
                if states[n][k].dtype == torch.int8 \
                        and n + "@scale" in states:
                    new_states[n][k], new_states[n + "@scale"][k] = \
                        q8_encode(v)
                else:
                    new_states[n][k] = v.to(states[n][k].dtype)
        return new_params, new_states
