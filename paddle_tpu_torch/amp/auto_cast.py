"""auto_cast: the reference's per-op white/black-list casting.

Counterpart of ``paddle_tpu/amp/auto_cast.py``.  The reference casts at
one chokepoint: its eager tape (``autograd.engine.apply``) hands every
op's name and inputs to ``cast_op_inputs`` (:100-135).  The port has no
tape, so the same lists and the same thread-local state are applied in
two places:

* at the port's own entry points — ``nn.functional`` ``linear``,
  ``rms_norm``, ``layer_norm``, ``scaled_dot_product_attention`` /
  ``flash_attention``, the Llama RoPE and its chunked loss — each
  wrapped by ``amp_op(name)`` under the reference's op name.  The body
  then runs with casting suspended, as the body of a reference op runs
  on raw arrays;
* for plain torch calls (``F.linear``, ``torch.matmul``, ``torch.exp``,
  ``softmax``, the arithmetic operators ...), through a
  ``torch.overrides.TorchFunctionMode`` (``_AmpMode``) that maps each
  function to the reference's op name (``_OP_NAMES``); a function with
  no name there is not cast, as an op on neither list.

``torch.autocast`` is not the mechanism: its op lists are not the
reference's (it keeps ``softmax`` and ``layer_norm`` under its own rules
and has no ``rms_norm`` entry).  Dtype-management ops are never re-cast
(:111-114).  Casting applies to the forward: inside a backward pass
(autograd's graph task) nothing is cast — except where a recompute
re-runs a forward, which restores the state the forward ran under
(``bind_state``), so the recomputed ops see the casts they saw.
"""
from __future__ import annotations

import contextlib
import functools
import threading

import torch
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode

__all__ = ["BLACK_LIST", "WHITE_LIST", "amp_guard", "amp_op", "amp_state",
           "auto_cast", "bind_state", "black_list", "cast_op_inputs",
           "decorate", "get_amp_dtype", "is_auto_cast_enabled",
           "white_list"]

# the reference's lists (amp_lists.py): ops that are numerically safe and
# fast in low precision
WHITE_LIST = {
    "matmul", "linear", "bmm", "mm", "mv", "einsum", "conv1d", "conv2d",
    "conv3d", "conv1d_transpose", "conv2d_transpose", "conv3d_transpose",
    "addmm", "scaled_dot_product_attention", "flash_attention", "lstm",
    "gru", "rnn_tanh", "simple_rnn_cell", "lstm_cell", "gru_cell",
}
# ops kept in float32 for numeric safety
BLACK_LIST = {
    "exp", "log", "log2", "log10", "log1p", "expm1", "pow", "square", "sqrt",
    "rsqrt", "softmax", "log_softmax", "cross_entropy", "nll_loss",
    "binary_cross_entropy", "bce_with_logits", "kl_div", "mse_loss",
    "l1_loss", "smooth_l1_loss", "layer_norm", "batch_norm", "group_norm",
    "instance_norm", "rms_norm", "mean", "sum", "cumsum", "logsumexp",
    "norm", "softmax_with_cross_entropy", "ctc_loss", "sigmoid_focal_loss",
    "reciprocal", "cosine_similarity",
}
#: never re-cast (casting a cast's input would recurse under O2)
_DTYPE_OPS = ("cast", "clone", "getitem", "setitem")
_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
           "float32": torch.float32}

_T = torch.Tensor
#: torch function -> the reference's op name
_OP_NAMES = {}
for _name, _fns in {
        "matmul": (torch.matmul, _T.matmul, _T.__matmul__, _T.__rmatmul__),
        "linear": (F.linear,),
        "mm": (torch.mm, _T.mm), "bmm": (torch.bmm, _T.bmm),
        "mv": (torch.mv, _T.mv), "addmm": (torch.addmm, _T.addmm),
        "einsum": (torch.einsum,),
        "conv1d": (F.conv1d,), "conv2d": (F.conv2d,), "conv3d": (F.conv3d,),
        "conv1d_transpose": (F.conv_transpose1d,),
        "conv2d_transpose": (F.conv_transpose2d,),
        "conv3d_transpose": (F.conv_transpose3d,),
        "scaled_dot_product_attention": (F.scaled_dot_product_attention,),
        "exp": (torch.exp, _T.exp), "log": (torch.log, _T.log),
        "log2": (torch.log2, _T.log2), "log10": (torch.log10, _T.log10),
        "log1p": (torch.log1p, _T.log1p), "expm1": (torch.expm1, _T.expm1),
        "pow": (torch.pow, _T.pow, _T.__pow__, _T.__rpow__),
        "square": (torch.square, _T.square), "sqrt": (torch.sqrt, _T.sqrt),
        "rsqrt": (torch.rsqrt, _T.rsqrt),
        "reciprocal": (torch.reciprocal, _T.reciprocal),
        "softmax": (torch.softmax, F.softmax, _T.softmax),
        "log_softmax": (torch.log_softmax, F.log_softmax, _T.log_softmax),
        "cross_entropy": (F.cross_entropy,), "nll_loss": (F.nll_loss,),
        "binary_cross_entropy": (F.binary_cross_entropy,),
        "bce_with_logits": (F.binary_cross_entropy_with_logits,),
        "kl_div": (F.kl_div,), "mse_loss": (F.mse_loss,),
        "l1_loss": (F.l1_loss,), "smooth_l1_loss": (F.smooth_l1_loss,),
        "layer_norm": (F.layer_norm,), "batch_norm": (F.batch_norm,),
        "group_norm": (F.group_norm,), "instance_norm": (F.instance_norm,),
        "mean": (torch.mean, _T.mean), "sum": (torch.sum, _T.sum),
        "cumsum": (torch.cumsum, _T.cumsum),
        "logsumexp": (torch.logsumexp, _T.logsumexp),
        "norm": (torch.norm, _T.norm, torch.linalg.norm,
                 torch.linalg.vector_norm),
        "cosine_similarity": (F.cosine_similarity,),
        "embedding": (F.embedding,), "silu": (F.silu,), "gelu": (F.gelu,),
        "tanh": (torch.tanh, _T.tanh), "sigmoid": (torch.sigmoid,
                                                    _T.sigmoid),
        "add": (torch.add, _T.add, _T.__add__, _T.__radd__),
        "subtract": (torch.sub, _T.sub, _T.__sub__, _T.__rsub__),
        "multiply": (torch.mul, _T.mul, _T.__mul__, _T.__rmul__),
        "divide": (torch.div, _T.div, _T.__truediv__, _T.__rtruediv__),
        "reshape": (torch.reshape, _T.reshape),
        "concat": (torch.cat,), "stack": (torch.stack,),
}.items():
    for _fn in _fns:
        _OP_NAMES[_fn] = _name

_tls = threading.local()


def _state():
    st = getattr(_tls, "amp", None)
    if st is None:
        st = _tls.amp = {"enable": False, "dtype": None, "level": "O1",
                         "white": WHITE_LIST, "black": BLACK_LIST,
                         "depth": 0, "forced": False, "mode": None}
    return st


def is_auto_cast_enabled():
    return _state()["enable"]


def get_amp_dtype():
    return _state()["dtype"]


def amp_state():
    return _state()


def white_list():
    return set(_state()["white"])


def black_list():
    return set(_state()["black"])


def _resolve_dtype(dtype):
    if dtype is None:
        return torch.bfloat16
    if isinstance(dtype, torch.dtype):
        return dtype
    if dtype not in _DTYPES:
        raise ValueError(f"amp dtype must be bfloat16 or float16, got "
                         f"{dtype!r}")
    return _DTYPES[dtype]


def _target(st, op_name):
    """The dtype the reference casts ``op_name``'s float inputs to, or
    None (the op is left alone)."""
    base = op_name.split("_grad")[0]
    if base in _DTYPE_OPS:
        return None
    in_black = base in st["black"]
    if st["level"] == "O2":
        return torch.float32 if in_black else st["dtype"]
    if base in st["white"]:
        return st["dtype"]
    if in_black:
        return torch.float32
    return None


def _active(st):
    """Casting applies: amp is on, no op body is running, and this is a
    forward (or a recompute restoring its forward's state), not a
    backward pass."""
    return st["enable"] and not st["depth"] and (
        st["forced"] or torch._C._current_graph_task_id() == -1)


def _cast(x, target):
    if isinstance(x, torch.Tensor) and x.is_floating_point() \
            and x.dtype != target and x.dtype != torch.float64:
        return x.to(target)
    if isinstance(x, (list, tuple)) and any(isinstance(v, torch.Tensor)
                                            for v in x):
        return type(x)(_cast(v, target) for v in x)
    return x


def cast_op_inputs(op_name, leaves):
    """The inputs of op ``op_name`` with the amp casts applied: float
    tensors to the amp dtype (white list, or any non-black op under O2)
    or to float32 (black list); unchanged when amp is off or the op is
    on neither list."""
    st = _state()
    if not st["enable"]:
        return leaves
    target = _target(st, op_name)
    if target is None:
        return leaves
    return [_cast(x, target) for x in leaves]


def amp_op(name):
    """Decorate a port entry point as the reference op ``name``: its
    arguments are cast under the amp rules, then its body runs with
    casting suspended (a reference op's body runs on raw arrays)."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            st = _state()
            if not _active(st):
                return fn(*args, **kwargs)
            target = _target(st, name)
            if target is not None:
                args = tuple(_cast(a, target) for a in args)
                kwargs = {k: _cast(v, target) for k, v in kwargs.items()}
            st["depth"] += 1
            try:
                return fn(*args, **kwargs)
            finally:
                st["depth"] -= 1
        return wrapper
    return deco


class _AmpMode(TorchFunctionMode):
    """Casts the inputs of plain torch calls by their reference op
    name."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = _OP_NAMES.get(func)
        if name is not None:
            st = _state()
            if _active(st):
                target = _target(st, name)
                if target is not None:
                    args = tuple(_cast(a, target) for a in args)
                    kwargs = {k: _cast(v, target) for k, v in kwargs.items()}
        return func(*args, **kwargs)


@contextlib.contextmanager
def _entered(values):
    """Set the amp state to ``values`` (and push the function mode while
    it is enabled), restoring the previous state on exit."""
    st = _state()
    prev = dict(st)
    st.update(values)
    mode = None
    if st["enable"] and st["mode"] is None:
        mode = st["mode"] = _AmpMode()
        mode.__enter__()
    try:
        yield
    finally:
        if mode is not None:
            mode.__exit__(None, None, None)
        st.update(prev)


def auto_cast(enable=True, custom_white_list=None, custom_black_list=None,
              level="O1", dtype="bfloat16", use_promote=True):
    """``paddle.amp.auto_cast``: O1/OD cast white-list ops to ``dtype``
    and black-list ops to float32; O2 casts every op not on the black
    list to ``dtype``; O0 leaves everything alone."""
    if level not in ("O0", "OD", "O1", "O2"):
        raise ValueError(f"level must be O0/OD/O1/O2, got {level}")
    white, black = set(WHITE_LIST), set(BLACK_LIST)
    if custom_white_list:
        white |= set(custom_white_list)
        black -= set(custom_white_list)
    if custom_black_list:
        black |= set(custom_black_list)
        white -= set(custom_black_list)
    return _entered(dict(enable=bool(enable) and level != "O0",
                         dtype=_resolve_dtype(dtype), level=level,
                         white=white, black=black, forced=False))


amp_guard = auto_cast


def bind_state(fn):
    """``fn`` bound to the amp state of this moment: a recompute that
    re-runs it in the backward re-enters that state (casting forced on
    inside the backward's graph task), so the recomputed forward casts
    as the original did."""
    st = _state()
    snap = {k: st[k] for k in ("enable", "dtype", "level", "white",
                               "black")}
    if not snap["enable"]:
        return fn

    @functools.wraps(fn)
    def run(*args, **kwargs):
        with _entered(dict(snap, forced=True, depth=0)):
            return fn(*args, **kwargs)
    return run


def _norm_layers():
    from paddle_tpu_torch.nn.layer import LayerNorm

    return (LayerNorm,)


@torch.no_grad()
def decorate(models, optimizers=None, level="O2", dtype="bfloat16",
             master_weight=None, save_dtype=None, master_grad=False,
             excluded_layers=None):
    """``paddle.amp.decorate``: under O2 cast every float parameter to the
    amp dtype, except those of norm layers (``LayerNorm``) and of
    ``excluded_layers``.  Master weights live in the optimizer
    (``multi_precision``), as in the reference."""
    single = isinstance(models, torch.nn.Module)
    model_list = [models] if single else list(models)
    if level == "O2":
        amp_dtype = _resolve_dtype(dtype)
        excluded = _norm_layers()
        if excluded_layers:
            excluded = excluded + tuple(
                e if isinstance(e, type) else type(e)
                for e in excluded_layers)
        for model in model_list:
            for layer in model.modules():
                if isinstance(layer, excluded):
                    continue
                for p in layer._parameters.values():
                    if p is not None and p.is_floating_point():
                        p.data = p.data.to(amp_dtype)
    out = models if single else model_list
    return out if optimizers is None else (out, optimizers)
