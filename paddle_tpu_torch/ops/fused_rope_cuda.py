"""K6 — fused RoPE: the wrapper of the hand-written Hopper kernel.

Replaces the TPU kernel ``_rope_pallas``
(``paddle_tpu/ops/fused_rope.py:73``, ``pallas_call`` :84); the kernel
source is ``csrc/fused_rope.cu``, whose note says what bounds it on the
card.  The plain version, the ``autograd.Function`` and the gate live in
``ops/fused_rope.py``; ``launches`` counts kernel launches.
"""
from __future__ import annotations

import torch

__all__ = ["rope"]

#: kernel launches made by ``rope`` (a plain integer; callers may reset it)
launches = 0

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def rope(q, k, cos, sin, nh, nkv, neg=False):
    """Rotate packed q ``[B, L, nh*D]`` and k ``[B, L, nkv*D]`` (CUDA,
    contiguous, one float dtype) by the unsigned tables ``[L, D]`` (cast
    to q's dtype here, as the reference does); ``neg`` applies the inverse
    rotation.  Returns the rotated ``(q, k)``."""
    global launches
    from paddle_tpu_torch.ops import _build

    if q.device.type != "cuda":
        raise ValueError(f"fused_rope: needs CUDA tensors, got {q.device}")
    if q.dim() != 3 or k.dim() != 3 or q.shape[:2] != k.shape[:2]:
        raise ValueError(f"fused_rope: q [B, L, nh*D] and k [B, L, nkv*D] "
                         f"expected, got {tuple(q.shape)}, {tuple(k.shape)}")
    b, l, qd = q.shape
    d = qd // nh
    if d * nh != qd or k.shape[2] != nkv * d or d % 2:
        raise ValueError(f"fused_rope: widths {qd}/{k.shape[2]} do not split "
                         f"into {nh}/{nkv} heads of one even head_dim")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype:
        raise ValueError(f"fused_rope: q/k must share one of float32/"
                         f"bfloat16/float16, got {q.dtype}/{k.dtype}")
    cos = cos.to(q.dtype).contiguous()
    sin = sin.to(q.dtype).contiguous()
    if tuple(cos.shape) != (l, d) or tuple(sin.shape) != (l, d):
        raise ValueError(f"fused_rope: tables must be [{l}, {d}], got "
                         f"{tuple(cos.shape)}, {tuple(sin.shape)}")
    for name, x in (("q", q), ("k", k), ("cos", cos), ("sin", sin)):
        if x.device != q.device or not x.is_contiguous():
            raise ValueError(f"fused_rope: {name} must be a contiguous "
                             f"tensor on {q.device}")
    oq = torch.empty_like(q)
    ok = torch.empty_like(k)
    lib = _build.load("fused_rope")
    with torch.cuda.device(q.device):
        rc = lib.fused_rope(
            _DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), cos.data_ptr(),
            sin.data_ptr(), oq.data_ptr(), ok.data_ptr(), b, l, nh, nkv, d,
            int(bool(neg)), torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fused_rope: kernel launch failed with CUDA "
                           f"error {rc}")
    launches += 1
    return oq, ok
