"""K7 — fused int8-moment AdamW: a hand-written Hopper kernel and its
plain PyTorch version.

Replaces the TPU kernel ``_fused_adamw_q8``
(``paddle_tpu/ops/fused_adamw.py``, its ``pallas_call`` at :169 for
native 2-D tiles and :211 for the flat ``[nb, 256]`` view, kernel body
``_kernel`` :30).  One AdamW step over a parameter whose first moment is
stored as int8 codes with one f32 absmax scale per 256 values (the flat
parameter's blocks, the last one zero-padded) and whose second moment
is bf16, with an optional f32 master weight: decode, update and
re-encode in one pass.  The kernel source is ``csrc/fused_adamw.cu``;
its note says what bounds it on the card.

``fused_adamw_q8`` is the one entry: on CPU tensors it runs the plain
version, on CUDA tensors it launches the kernel or raises.  Both update
their operands IN PLACE — the parameter (and the master), the codes, the
scales and the second moment — where the JAX package's jitted step
donated them; the training step owns those buffers.  ``launches`` counts
kernel launches and ``plain_runs`` plain-version runs.

The plain version is the reference kernel's arithmetic step by step:
``m = code * s``; ``m' = b1 m + (1-b1) g``; ``v' = b2 v + ((1-b2) g) g``;
``p' = p wd - lr (m'/c1) / (sqrt(v'/c2) + eps)``; ``s' = max|m'| / 127``
per block, computed as ``max|m'| * f32(1/127)`` because that is what XLA
compiles the reference's division by the constant into (seen on its CPU
backend: the jitted program multiplies by the reciprocal);
``codes = round_half_even(m' / max(s', 1e-30))`` (no clip); v' rounds to
bf16 and p' to the parameter's dtype.  The scalars come
from the host (``adamw_scalars``), ``1-b1`` and ``1-b2`` included, as
the reference computes them (its review r5: an in-kernel
``f32(1) - f32(b1)`` differs by ~2e-7 and can flip codes).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from paddle_tpu_torch.core.device import resolve_impl

__all__ = ["INV127", "Q8_BLOCK", "adamw_scalars", "fused_adamw_q8",
           "fused_adamw_q8_reference", "q8_decode", "q8_encode"]

Q8_BLOCK = 256
#: f32(1 / 127): XLA turns ``x / 127.0`` into ``x * INV127`` when it
#: compiles the reference, so the port multiplies to give the same bits
INV127 = float(np.float32(1.0) / np.float32(127.0))
#: kernel launches made by ``fused_adamw_q8``
launches = 0
#: runs of the plain version
plain_runs = 0

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_F32, _BF16 = torch.float32, torch.bfloat16
#: (the value updated: master or parameter, gradient, parameter) dtypes
#: the kernel is built for — what the optimizer passes
_KERNEL_DTYPES = {(_BF16, _BF16, _BF16), (_BF16, _F32, _BF16),
                  (_F32, _BF16, _BF16), (_F32, _F32, _BF16),
                  (_F32, _F32, _F32)}
_SCALARS = ("b1", "b2", "eps", "lr", "c1", "c2", "wd", "omb1", "omb2")


def adamw_scalars(beta1, beta2, eps, lr, step, decay):
    """The kernel's host scalars, each an f32 value as a Python float:
    ``b1, b2, eps, lr``; the bias corrections ``c1 = 1 - b1^t`` and
    ``c2 = 1 - b2^t`` (``b^t`` in f32, as the optimizer's ``_pow_t``);
    the decay factor ``wd = 1 - lr * decay`` in f32; ``omb1 = f32(1 -
    beta1)`` and ``omb2 = f32(1 - beta2)`` from the Python floats, as
    the reference's folded constants."""
    f = np.float32
    t = f(float(step))
    with np.errstate(all="ignore"):
        c1 = f(1.0) - f(torch.pow(torch.tensor(f(beta1)),
                                  torch.tensor(t)).item())
        c2 = f(1.0) - f(torch.pow(torch.tensor(f(beta2)),
                                  torch.tensor(t)).item())
        wd = f(1.0) - f(lr) * f(decay)
    vals = (f(beta1), f(beta2), f(eps), f(lr), c1, c2, wd,
            f(1.0 - beta1), f(1.0 - beta2))
    return dict(zip(_SCALARS, (float(x) for x in vals)))


def q8_encode(x):
    """``x`` (f32) -> (int8 codes of x's shape, f32 scales
    ``[ceil(n / 256)]``): the reference's ``Optimizer._q8_encode`` (as
    XLA compiles it) on the flat view, the last block zero-padded."""
    flat = x.reshape(-1)
    n = flat.numel()
    nb = -(-n // Q8_BLOCK)
    fp = F.pad(flat, (0, nb * Q8_BLOCK - n)).view(nb, Q8_BLOCK)
    s = fp.abs().amax(dim=1) * INV127
    codes = torch.round(fp / torch.clamp(s, min=1e-30)[:, None])
    return codes.reshape(-1)[:n].reshape(x.shape).to(torch.int8), s.float()


def q8_decode(codes, scales):
    """Inverse of ``q8_encode``: f32 values of the codes' shape."""
    flat = codes.reshape(-1).float()
    n = flat.numel()
    nb = scales.shape[0]
    fp = F.pad(flat, (0, nb * Q8_BLOCK - n)).view(nb, Q8_BLOCK) \
        * scales[:, None]
    return fp.reshape(-1)[:n].reshape(codes.shape)


def _check(p, g, codes, scales, v, master):
    n = p.numel()
    nb = -(-n // Q8_BLOCK)
    if codes.dtype != torch.int8 or codes.numel() != n:
        raise ValueError("fused_adamw_q8: codes must be int8 with the "
                         "parameter's size")
    if scales.dtype != torch.float32 or tuple(scales.shape) != (nb,):
        raise ValueError(f"fused_adamw_q8: scales must be float32 [{nb}] "
                         f"(one per {Q8_BLOCK} values)")
    if v.dtype != torch.bfloat16 or v.numel() != n:
        raise ValueError("fused_adamw_q8: the second moment must be "
                         "bfloat16 with the parameter's size")
    if g.numel() != n or g.dtype not in _DTYPE_CODE:
        raise ValueError("fused_adamw_q8: the gradient must be float32 or "
                         "bfloat16 with the parameter's size")
    if p.dtype not in _DTYPE_CODE:
        raise ValueError(f"fused_adamw_q8: parameter dtype {p.dtype}: "
                         "float32 or bfloat16")
    if master is not None and (master.dtype != torch.float32
                               or master.numel() != n):
        raise ValueError("fused_adamw_q8: the master weight must be "
                         "float32 with the parameter's size")


def fused_adamw_q8_reference(p, g, codes, scales, v, scalars, master=None):
    """The plain version: one step, in place, of the operands
    ``fused_adamw_q8`` takes."""
    global plain_runs
    _check(p, g, codes, scales, v, master)
    plain_runs += 1
    # the scalars live on the data's device: PyTorch's CUDA kernels turn
    # a division by a CPU scalar into a multiply by its reciprocal
    sc = {k: torch.tensor(scalars[k], dtype=torch.float32, device=p.device)
          for k in _SCALARS}
    base = master if master is not None else p
    gf = g.float()
    m = q8_decode(codes, scales)
    m_new = sc["b1"] * m + sc["omb1"] * gf
    v_new = sc["b2"] * v.float() + sc["omb2"] * gf * gf
    upd = sc["lr"] * (m_new / sc["c1"]) \
        / (torch.sqrt(v_new / sc["c2"]) + sc["eps"])
    p_new = base.float() * sc["wd"] - upd
    q, s = q8_encode(m_new)
    if master is not None:
        master.copy_(p_new)
    p.copy_(p_new.to(p.dtype))
    codes.copy_(q)
    scales.copy_(s)
    v.copy_(v_new.to(torch.bfloat16))
    return p, master, codes, scales, v


def fused_adamw_q8(p, g, codes, scales, v, scalars, master=None, impl=None):
    """One int8-moment AdamW step, IN PLACE.

    ``p``: the parameter (f32/bf16); ``master``: its f32 master weight
    (of a bf16 parameter) or ``None`` (the update then reads ``p``
    widened to f32); ``g``: the gradient (f32/bf16, widened in
    registers); ``codes`` int8 and ``v`` bf16 of ``p``'s size,
    ``scales`` f32 ``[ceil(n / 256)]``; ``scalars``:
    ``adamw_scalars(...)``.  Updates ``master`` (when given), ``p``,
    ``codes``, ``scales`` and ``v`` and returns them.  ``impl``:
    ``None`` by device, ``"reference"`` the plain version, ``"cuda"``
    the kernel."""
    impl = resolve_impl(impl, p.device, "fused_adamw_q8")
    if impl == "reference":
        return fused_adamw_q8_reference(p, g, codes, scales, v, scalars,
                                        master)
    return _launch(p, g, codes, scales, v, scalars, master)


def _launch(p, g, codes, scales, v, scalars, master):
    global launches
    from paddle_tpu_torch.ops import _build

    _check(p, g, codes, scales, v, master)
    dev = p.device
    ops = (("p", p), ("g", g), ("codes", codes), ("scales", scales),
           ("v", v)) + ((("master", master),) if master is not None else ())
    for name, x in ops:
        if x.device != dev or not x.is_contiguous():
            raise ValueError(f"fused_adamw_q8: {name} must be a contiguous "
                             f"tensor on {dev}")
    p_in = master if master is not None else p
    if (p_in.dtype, g.dtype, p.dtype) not in _KERNEL_DTYPES:
        raise ValueError(
            f"fused_adamw_q8: the kernel is not built for a {p.dtype} "
            f"parameter{' with a master' if master is not None else ''} "
            f"and a {g.dtype} gradient")
    n = p.numel()
    lib = _build.load("fused_adamw")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.fused_adamw_q8(
            _DTYPE_CODE[p_in.dtype], _DTYPE_CODE[g.dtype],
            _DTYPE_CODE[p.dtype], p_in.data_ptr(), g.data_ptr(),
            codes.data_ptr(), scales.data_ptr(), v.data_ptr(),
            master.data_ptr() if master is not None else None,
            p.data_ptr(), n, *(scalars[k] for k in _SCALARS), stream)
    if rc != 0:
        raise RuntimeError(
            f"fused_adamw_q8: kernel launch failed with CUDA error {rc}")
    launches += 1
    return p, master, codes, scales, v
