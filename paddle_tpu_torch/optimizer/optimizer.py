"""Optimizer base: learning rate, clipping, accumulator dtypes, the
functional update and the eager API.

Counterpart of ``paddle_tpu/optimizer/optimizer.py``.  Each optimizer
defines ``_update(param, grad, state, lr)`` on plain tensors;
``functional_init_states`` and ``functional_update`` run it over flat
``{name: tensor}`` dicts — what the training step
(``static/functionalize.py``) calls.  As in the reference:

* ``learning_rate`` is a float or an ``LRScheduler`` (``get_lr`` reads
  ``scheduler()``; ``set_lr`` refuses a scheduler, ``set_lr_scheduler``
  installs one, :46-80);
* ``grad_clip`` is a clip object (``nn/clip.py``) applied to
  ``[(param, grad), ...]`` before the update (:137-138);
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
updates the parameter and its state in place).

The eager API (``step`` :120, ``clear_grad`` :164, ``minimize`` :171)
reads ``p.grad`` after ``loss.backward()`` and runs the same
``functional_update`` over the optimizer's own state, so an eager loop
and ``build_train_step`` launch the same kernels in the same order.  Its
state starts as the reference's eager accumulators do
(``_eager_init_state``: master weights for every low-precision
parameter, and the initial values Adagrad, NAdam and Rprop give), and a
parameter's ``optimize_attr["learning_rate"]`` scales its rate (:146).
``state_dict`` / ``set_state_dict`` (:183-216) keep it under the
reference's keys, ``<param name>_<accumulator>``, with the scheduler
under ``LR_Scheduler``.
"""
from __future__ import annotations

import torch

from paddle_tpu_torch.ops.fused_adamw import q8_decode, q8_encode
from paddle_tpu_torch.optimizer.lr import LRScheduler

__all__ = ["Optimizer"]

_LOW = (torch.bfloat16, torch.float16)
_MOMENT_DTYPES = {None: None, "float32": torch.float32,
                  "bfloat16": torch.bfloat16, "int8": torch.int8}
#: the accumulators ``moment_dtype="int8"`` stores as int8 codes
_FIRST_MOMENTS = ("moment1", "moment", "velocity", "avg_grad")


class _ArrayParam:
    """What ``_update`` receives as the parameter where an optimizer hands
    it to a user callable (Lamb's ``exclude_from_weight_decay_fn``): its
    name and its value, as the reference's ``_ArrayParam``."""

    __slots__ = ("data", "name")

    def __init__(self, data, name=""):
        self.data = data
        self.name = name


class Optimizer:
    _accum_names: tuple = ()
    #: weight decay applied to the parameter, not added to the gradient
    _decoupled = False

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None,
                 multi_precision=False, moment_dtype=None):
        if moment_dtype not in _MOMENT_DTYPES:
            raise ValueError(f"unknown moment_dtype {moment_dtype!r}; one of "
                             f"{sorted(k for k in _MOMENT_DTYPES if k)}, None")
        if isinstance(learning_rate, LRScheduler):
            self._learning_rate = learning_rate
        else:
            self._learning_rate = float(learning_rate)
        self._is_lr_scheduler = isinstance(learning_rate, LRScheduler)
        self._parameter_list = self._flatten_params(parameters)
        self._grad_clip = grad_clip
        self._name = name
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
        self._eager_states = None

    @staticmethod
    def _flatten_params(parameters):
        if parameters is None:
            return None
        out = []
        for p in parameters:
            if isinstance(p, dict):      # a parameter group
                out.extend(p["params"])
            else:
                out.append(p)
        return out

    # ------------------------------------------------------------------ lr
    def get_lr(self):
        if self._is_lr_scheduler:
            return float(self._learning_rate())
        return float(self._learning_rate)

    def set_lr(self, value):
        if self._is_lr_scheduler:
            raise RuntimeError("cannot set_lr when using an LRScheduler")
        self._learning_rate = float(value)

    def set_lr_scheduler(self, scheduler):
        self._learning_rate = scheduler
        self._is_lr_scheduler = True

    # --------------------------------------------------------- functional
    def _update(self, p, g, state, lr, name=""):
        """``(new_param, new_state)`` from the param (or its master)
        named ``name``, its gradient (f32 where the parameter is low
        precision), its f32 state and the f32 0-d rate ``lr``.
        Overridden per optimizer."""
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
        new_states)``.  ``lr`` is one rate, or ``{name: rate}``.
        ``grads[k] is None`` passes a parameter (and its state) through
        untouched.  A parameter the fused int8 kernel takes is updated in
        place, with its state; the returned dicts then hold the same
        tensors."""
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
            plr = lr[k] if isinstance(lr, dict) else lr
            base = masters.get(k, p)
            # the reference widens a bf16 gradient to f32, then adds the
            # L2 term; the fused kernel widens in registers (exact), so
            # without an L2 term it reads the gradient as it is
            if self._l2_coeff and not self._decoupled:
                g = g.float() if g.dtype == torch.bfloat16 else g
                g = g + self._l2_coeff * base.to(g.dtype)
            res = self._update_param(k, p, g, states, masters, plr)
            if res is not None:
                new_params[k] = res[0]
                for n, t in res[1].items():
                    new_states[n][k] = t
                continue
            g = g.float() if g.dtype == torch.bfloat16 else g
            st = {n: self._decode_state(states, n, k)
                  for n in self._accum_names}
            new_p, ns = self._update(base, g, st, _f32(plr), k)
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

    # ---------------------------------------------------------------- eager
    def _eager_init_state(self, name, p):
        """The reference eager accumulator ``name`` of ``p`` where it is
        not zeros (Adagrad's initial value, NAdam's scalar product,
        Rprop's rate), else None."""
        return None

    def _named_parameters(self):
        if self._parameter_list is None:
            raise ValueError("Optimizer created without parameters; pass "
                             "parameters=model.parameters()")
        return {getattr(p, "name", None) or f"param_{i}": p
                for i, p in enumerate(self._parameter_list)}

    def _ensure_eager_states(self, named):
        if self._eager_states is not None:
            return self._eager_states
        vals = {k: p.detach() for k, p in named.items()}
        st = self.functional_init_states(vals)
        for n in self._accum_names:
            for k, p in vals.items():
                init = self._eager_init_state(n, p)
                if init is not None:
                    st[n][k] = init
        # the reference's eager step keeps an f32 master of every
        # low-precision parameter, whatever multi_precision says
        st.setdefault("master_weight", {})
        for k, v in vals.items():
            if v.dtype in _LOW and k not in st["master_weight"]:
                st["master_weight"][k] = v.float()
        self._eager_states = st
        return st

    @torch.no_grad()
    def step(self):
        """One update from ``p.grad`` of every trainable parameter."""
        named = self._named_parameters()
        live = {k: p for k, p in named.items()
                if p.requires_grad and p.grad is not None
                and getattr(p, "trainable", True)}
        pgs = [(p, p.grad) for p in live.values()]
        rescale = float(getattr(self, "_grad_rescale", 1.0) or 1.0)
        if rescale != 1.0:
            pgs = [(p, g * rescale) for p, g in pgs]
        if self._grad_clip is not None:
            pgs = self._grad_clip(pgs)
        grads = {k: g for k, (_, g) in zip(live, pgs)}
        lr = self.get_lr()
        rates = {k: lr * p.optimize_attr.get("learning_rate", 1.0)
                 if hasattr(p, "optimize_attr") else lr
                 for k, p in live.items()}
        states = self._ensure_eager_states(named)
        self._global_step += 1
        new, self._eager_states = self.functional_update(
            {k: p.detach() for k, p in live.items()}, grads, states, rates)
        for k, p in live.items():
            p.copy_(new[k])

    def clear_grad(self, set_to_zero=True):
        for p in self._parameter_list or ():
            p.grad = None

    clear_gradients = clear_grad

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        loss.backward()
        self.step()
        self.clear_grad()
        return None, None

    def _state_names(self):
        names = list(self._accum_names) + ["master_weight"]
        return names + [n + "@scale" for n in self._accum_names]

    def state_dict(self):
        sd = {}
        st = self._eager_states or {}
        for pname in self._named_parameters() \
                if self._parameter_list is not None else ():
            for n in self._state_names():
                if pname in st.get(n, {}):
                    sd[f"{pname}_{n}"] = st[n][pname]
        sd["global_step"] = self._global_step
        if self._is_lr_scheduler:
            sd["LR_Scheduler"] = self._learning_rate.state_dict()
        return sd

    def set_state_dict(self, state_dict):
        self._global_step = int(state_dict.get("global_step", 0))
        if self._is_lr_scheduler and "LR_Scheduler" in state_dict:
            self._learning_rate.set_state_dict(state_dict["LR_Scheduler"])
        if self._parameter_list is None:
            return
        named = self._named_parameters()
        st = self._ensure_eager_states(named)
        for pname, p in named.items():
            for n in self._state_names():
                key = f"{pname}_{n}"
                if key in state_dict:
                    st.setdefault(n, {})[pname] = torch.as_tensor(
                        state_dict[key]).to(p.device).clone()


def _f32(x):
    """A Python rate as an f32 0-d tensor (the reference's TrainStep
    passes ``jnp.asarray(lr, float32)``); a tensor passes through."""
    if isinstance(x, torch.Tensor):
        return x
    return torch.tensor(x, dtype=torch.float32)
