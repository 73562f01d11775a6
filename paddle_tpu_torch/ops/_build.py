"""Build and load the port's hand-written CUDA kernels.

Counterpart of the JAX package's native-runtime binding
(``paddle_tpu/core/native``): each ``csrc/<name>.cu`` exposes a plain C
interface, is compiled by ``nvcc`` for Hopper (``sm_90a``) into its own
shared library at FIRST USE — never at import, so the CPU tests import
every module without a compiler — and is loaded with ``ctypes``.
Libraries are named by a digest of their sources and flags and land in
``ops/_build/`` (listed in ``.gitignore``); a source edit builds a new
library instead of loading a stale one.  ``build()`` starts one ``nvcc``
per source, all at once, and waits for them together.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

__all__ = ["build", "check_card", "load", "ptxas_report", "SOURCES"]

_CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
SOURCES = ("paged_decode_attention", "prefill_attention",
           "flash_attention_fwd", "flash_attention_bwd", "fused_rope",
           "fused_adamw")
_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
          "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
#: the only card the libraries are built for (compute capability 9.0)
TARGET = "sm_90a"
#: extra ``-D`` flags for every build (``flash_probe.py`` sets the flash
#: kernels' tile sizes and ring stages with them: ``PTF_FWD_KEYS``,
#: ``PTF_FWD_STAGES``, ``PTF_DKV_STAGES``, ``PTF_DQ_STAGES``); part of
#: each library's digest
DEFINES = ()

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_L = ctypes.c_longlong
# C entry points of each source and their signatures (every pointer and
# the stream as void*, ints as int); the flash entry points take q, k, v
# (and dout, lse, delta), the segment ids, the four rope tables, then
# their outputs
_FLASH_BWD = [_I, _P, _P, _P, _P, _P, _P]
_PREFILL = [_I] + [_P] * 9 + [_I] * 10 + [_F, _P]
_SIGNATURES = {
    "paged_decode_attention": {
        "paged_decode_attention": [_I] + [_P] * 12 + [_I] * 11 + [_F, _P]},
    "prefill_attention": {
        "prefill_attention": _PREFILL,
        "prefill_attention_mma": _PREFILL[:10] + [_P] * 3 + _PREFILL[10:]},
    "flash_attention_fwd": {
        "flash_attention_fwd": [_I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                _P, _I, _I, _I, _I, _I, _I, _I, _F, _P]},
    "flash_attention_bwd": {
        "flash_attention_delta": [_I, _P, _P, _P, _I, _I, _I, _I, _P],
        "flash_attention_bwd_dkv": _FLASH_BWD + [
            _P] * 8 + [_I, _I, _I, _I, _I, _I, _I, _F, _P],
        "flash_attention_bwd_dq": _FLASH_BWD + [
            _P] * 7 + [_I, _I, _I, _I, _I, _I, _I, _F, _P]},
    "fused_rope": {
        "fused_rope": [_I, _P, _P, _P, _P, _P, _P,
                       _I, _I, _I, _I, _I, _I, _I, _P]},
    "fused_adamw": {
        "fused_adamw_q8": [_I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _L]
        + [_F] * 9 + [_P]},
}

_lock = threading.Lock()
_libs = {}


def _nvcc():
    from torch.utils.cpp_extension import CUDA_HOME

    cands = [shutil.which("nvcc")]
    if CUDA_HOME:
        cands.append(os.path.join(CUDA_HOME, "bin", "nvcc"))
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError(
        "nvcc not found (neither on PATH nor under CUDA_HOME): the port's "
        "CUDA kernels are built from source at first use")


def _lib_path(name, defines=None):
    flags = _FLAGS + tuple(DEFINES if defines is None else defines)
    h = hashlib.sha1(" ".join(flags).encode())
    h.update((_CSRC / f"{name}.cu").read_bytes())
    for hdr in sorted(_CSRC.glob("*.cuh")):
        h.update(hdr.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names=SOURCES, defines=None):
    """Compile every library in ``names`` that is not built yet: one
    ``nvcc`` per source, all started together, with ``defines`` (default
    ``DEFINES``) added.  Returns ``{name: seconds it took}`` (0.0 for a
    library already built).  Raises with the compiler's output if any
    build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    defines = tuple(DEFINES if defines is None else defines)
    procs, out = {}, {}
    for name in names:
        path = _lib_path(name, defines)
        if path.exists():
            out[name] = 0.0
            continue
        tmp = path.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
        cmd = [_nvcc(), *_FLAGS, *defines, "-o", str(tmp),
               str(_CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, path, time.perf_counter())
    errors = []
    for name, (proc, tmp, path, t0) in procs.items():
        log, _ = proc.communicate()
        out[name] = time.perf_counter() - t0
        path.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name}.cu "
                          f"(exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, path)
    if errors:
        raise RuntimeError("\n".join(errors))
    return out


def check_card():
    """Raise unless the current CUDA card is the one the libraries are
    built for: compute capability 9.0, i.e. ``sm_90a`` (H100/H200).
    Another card would only fail later, at ``ctypes`` load or launch,
    with an error that does not say why."""
    from paddle_tpu_torch.core import device

    cc = device.compute_capability()
    if cc != (9, 0):
        raise RuntimeError(
            f"the port's CUDA kernels are built for {TARGET} (compute "
            f"capability 9.0, NVIDIA Hopper: H100/H200); this card reports "
            f"{cc[0]}.{cc[1]} — run on a Hopper card")


def load(name):
    """The ctypes handle of kernel library ``name``, built if needed, with
    the signatures of its C entry points set.  Raises on a card that is
    not ``sm_90a``."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            check_card()
            build((name,))
            lib = ctypes.CDLL(str(_lib_path(name)))
            for fn_name, argtypes in _SIGNATURES[name].items():
                fn = getattr(lib, fn_name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _libs[name] = lib
        return lib


def ptxas_report(name):
    """What ``ptxas -v`` said about ``name``'s kernels when its current
    library was built (registers, shared memory, spills); empty if it was
    not built here."""
    p = _lib_path(name).with_suffix(".log")
    return p.read_text() if p.exists() else ""
