"""Device choice for the PyTorch/CUDA port.

Counterpart of ``paddle_tpu/core/device.py`` (device choice only).  The
port's entry points run on the card: ``device=None`` resolves to
``cuda``, and a machine without one raises instead of quietly running on
the CPU.  The CPU is used only when the caller asks for it
(``device="cpu"``), which is what the tests do — there every kernel
wrapper runs its plain PyTorch version.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["compute_capability", "resolve_device", "resolve_impl", "h2d",
           "torch_dtype"]

IMPLS = (None, "reference", "cuda")
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def torch_dtype(name):
    """Float dtype name -> torch dtype."""
    if name not in _DTYPES:
        raise ValueError(f"unsupported dtype {name!r}: expected one of "
                         f"{', '.join(_DTYPES)}")
    return _DTYPES[name]


def resolve_device(device=None):
    """``None`` -> ``cuda``; ``"cpu"``/``"cuda[:i]"``/``torch.device``
    pass through.  Raises when CUDA is asked for (or defaulted to) on a
    machine without a usable card."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev!s}: expected cuda or cpu")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available — the port runs on the card by "
            "default; pass device='cpu' to run the plain PyTorch versions")
    return dev


def compute_capability(device=None):
    """``(major, minor)`` compute capability of the CUDA card ``device``
    (default: the current one); raises without a card.  The port's
    kernels are built for 9.0 (Hopper, ``sm_90a``)."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError(f"compute_capability: {dev} is not a CUDA device")
    return tuple(torch.cuda.get_device_capability(dev))


def resolve_impl(impl, device, where):
    """Resolve an ``impl`` knob against the tensors' device: ``None``
    picks the hand-written kernel on ``cuda`` and the plain PyTorch
    version on ``cpu``; ``"cuda"`` on a CPU tensor raises (a kernel has
    no CPU build); ``"reference"`` names the plain version explicitly."""
    if impl not in IMPLS:
        raise ValueError(
            f"{where}: unknown impl {impl!r} — supported: None (by device), "
            "'reference' (plain PyTorch), 'cuda' (hand-written kernel)")
    dev = torch.device(device)
    if impl is None:
        return "cuda" if dev.type == "cuda" else "reference"
    if impl == "cuda" and dev.type != "cuda":
        raise ValueError(
            f"{where}: impl='cuda' needs CUDA tensors, got {dev.type} — "
            "the kernel has no CPU build")
    return impl


def h2d(array, device):
    """Host numpy array -> tensor on ``device`` without stalling the
    stream: on ``cuda`` the bytes are staged in pinned memory and copied
    asynchronously (PyTorch's pinned allocator keeps the staging block
    alive until the copy lands); on ``cpu`` the result is a private copy,
    so later edits of the host mirror never alias into it."""
    t = torch.from_numpy(np.ascontiguousarray(array))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.clone()
