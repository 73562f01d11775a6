"""K1-K5 — flash attention: wrappers of the hand-written Hopper kernels.

Replaces the TPU kernels of ``paddle_tpu/ops/flash_attention.py``: the
forward (K1 resident ``pallas_call`` :653, K2 streamed :571; one kernel
here, ``csrc/flash_attention_fwd.cu``) and the backward's delta (K3
:714), dK/dV (K4 :1131) and dQ (K5 :1242, streamed :1175) passes
(``csrc/flash_attention_bwd.cu``).  Each source's note says what bounds
its kernels on the card and how the design answers that.

Every wrapper takes CUDA tensors in the packed projection layout
(q/out ``[B, Lq, H*D]``, k/v ``[B, Lk, Hkv*D]``, contiguous, one dtype of
float32/bfloat16/float16) and row statistics ``[B, H, Lq]`` f32,
launches its kernel on the current stream, and raises on anything the
kernel does not take.  The plain PyTorch versions and the routing live in
``ops/flash_attention.py``; ``launches`` counts the launches of each
kernel.
"""
from __future__ import annotations

import torch

__all__ = ["flash_fwd", "flash_delta", "flash_bwd_dkv", "flash_bwd_dq",
           "HEAD_DIMS"]

#: kernel launches by kernel (plain integers; callers may reset them to 0)
launches = {"fwd": 0, "delta": 0, "dkv": 0, "dq": 0}

HEAD_DIMS = (64, 128, 256)
_ROWS = 64          # flattened (position, group head) rows per kernel tile
_KEYS = 64          # Lk multiple every kernel's key tile divides
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def _geometry(where, q, k, v, num_heads, num_kv_heads, causal):
    """Validate the packed operands; return (B, Lq, Lk, D)."""
    if q.device.type != "cuda":
        raise ValueError(f"{where}: needs CUDA tensors, got {q.device}")
    if q.dim() != 3 or k.dim() != 3 or v.shape != k.shape:
        raise ValueError(f"{where}: q [B, Lq, H*D], k/v [B, Lk, Hkv*D] "
                         f"expected, got {tuple(q.shape)}, {tuple(k.shape)},"
                         f" {tuple(v.shape)}")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise ValueError(f"{where}: q/k/v must share one of float32/"
                         f"bfloat16/float16, got {q.dtype}/{k.dtype}/"
                         f"{v.dtype}")
    b, lq, hd = q.shape
    lk = k.shape[1]
    if num_kv_heads <= 0 or num_heads % num_kv_heads or hd % num_heads:
        raise ValueError(f"{where}: heads {num_heads}/{num_kv_heads} do not "
                         f"divide the packed width {hd}")
    d = hd // num_heads
    g = num_heads // num_kv_heads
    if d not in HEAD_DIMS:
        raise ValueError(f"{where}: head_dim {d} — the kernels take "
                         f"{HEAD_DIMS}")
    if k.shape[0] != b or k.shape[2] != num_kv_heads * d:
        raise ValueError(f"{where}: k {tuple(k.shape)} does not match q "
                         f"{tuple(q.shape)} with {num_kv_heads} kv heads")
    if (lq * g) % _ROWS or lk % _KEYS:
        raise ValueError(f"{where}: Lq*G ({lq * g}) must be a multiple of "
                         f"{_ROWS} and Lk ({lk}) of {_KEYS}")
    if causal and lq > lk:
        raise ValueError(f"{where}: causal attention requires Lq <= Lk "
                         f"(got Lq={lq}, Lk={lk})")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.device != q.device or not x.is_contiguous():
            raise ValueError(f"{where}: {name} must be a contiguous tensor "
                             f"on {q.device}")
    return b, lq, lk, d


def _check_stats(where, dev, b, h, lq, **stats):
    for name, x in stats.items():
        if x.dtype != torch.float32 or tuple(x.shape) != (b, h, lq) \
                or x.device != dev or not x.is_contiguous():
            raise ValueError(f"{where}: {name} must be a contiguous float32 "
                             f"[{b}, {h}, {lq}] tensor on {dev}")


def _ok(where, rc, kernel):
    if rc != 0:
        raise RuntimeError(f"{where}: kernel launch failed with CUDA error "
                           f"{rc}")
    launches[kernel] += 1


def flash_fwd(q, k, v, num_heads, num_kv_heads, causal, scale):
    """K1/K2: ``(out [B, Lq, H*D] in q's dtype, lse [B, H, Lq] f32)``."""
    from paddle_tpu_torch.ops import _build

    b, lq, lk, d = _geometry("flash_fwd", q, k, v, num_heads, num_kv_heads,
                             causal)
    out = torch.empty_like(q)
    lse = torch.empty((b, num_heads, lq), dtype=torch.float32,
                      device=q.device)
    lib = _build.load("flash_attention_fwd")
    with torch.cuda.device(q.device):
        rc = lib.flash_attention_fwd(
            _DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), lse.data_ptr(), b, num_heads, num_kv_heads, lq,
            lk, d, int(bool(causal)), float(scale), _stream(q.device))
    _ok("flash_fwd", rc, "fwd")
    return out, lse


def flash_delta(dout, out, num_heads):
    """K3: ``delta [B, H, L] f32 = rowsum(dout * out)`` per (position,
    head)."""
    from paddle_tpu_torch.ops import _build

    if dout.device.type != "cuda":
        raise ValueError(f"flash_delta: needs CUDA tensors, got "
                         f"{dout.device}")
    if dout.shape != out.shape or dout.dim() != 3 \
            or dout.dtype not in _DTYPE_CODE or out.dtype != dout.dtype \
            or not dout.is_contiguous() or not out.is_contiguous() \
            or out.device != dout.device:
        raise ValueError("flash_delta: dout and out must be contiguous "
                         "[B, L, H*D] tensors of one float dtype on one "
                         "device")
    b, lq, hd = dout.shape
    if hd % num_heads:
        raise ValueError(f"flash_delta: {num_heads} heads do not divide "
                         f"{hd}")
    delta = torch.empty((b, num_heads, lq), dtype=torch.float32,
                        device=dout.device)
    lib = _build.load("flash_attention_bwd")
    with torch.cuda.device(dout.device):
        rc = lib.flash_attention_delta(
            _DTYPE_CODE[dout.dtype], dout.data_ptr(), out.data_ptr(),
            delta.data_ptr(), b, lq, num_heads, hd // num_heads,
            _stream(dout.device))
    _ok("flash_delta", rc, "delta")
    return delta


def _bwd_operands(where, q, k, v, dout, lse, delta, num_heads, num_kv_heads,
                  causal):
    geo = _geometry(where, q, k, v, num_heads, num_kv_heads, causal)
    if dout.shape != q.shape or dout.dtype != q.dtype \
            or dout.device != q.device or not dout.is_contiguous():
        raise ValueError(f"{where}: dout must be a contiguous tensor like q")
    _check_stats(where, q.device, geo[0], num_heads, geo[1], lse=lse,
                 delta=delta)
    return geo


def flash_bwd_dkv(q, k, v, dout, lse, delta, num_heads, num_kv_heads,
                  causal, scale):
    """K4: ``(dk, dv)`` in k's dtype, each kv head summed over its G query
    heads in-kernel."""
    from paddle_tpu_torch.ops import _build

    b, lq, lk, d = _bwd_operands("flash_bwd_dkv", q, k, v, dout, lse, delta,
                                 num_heads, num_kv_heads, causal)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    lib = _build.load("flash_attention_bwd")
    with torch.cuda.device(q.device):
        rc = lib.flash_attention_bwd_dkv(
            _DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), b, num_heads, num_kv_heads, lq, lk, d,
            int(bool(causal)), float(scale), _stream(q.device))
    _ok("flash_bwd_dkv", rc, "dkv")
    return dk, dv


def flash_bwd_dq(q, k, v, dout, lse, delta, num_heads, num_kv_heads, causal,
                 scale):
    """K5: ``dq`` in q's dtype."""
    from paddle_tpu_torch.ops import _build

    b, lq, lk, d = _bwd_operands("flash_bwd_dq", q, k, v, dout, lse, delta,
                                 num_heads, num_kv_heads, causal)
    dq = torch.empty_like(q)
    lib = _build.load("flash_attention_bwd")
    with torch.cuda.device(q.device):
        rc = lib.flash_attention_bwd_dq(
            _DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            b, num_heads, num_kv_heads, lq, lk, d, int(bool(causal)),
            float(scale), _stream(q.device))
    _ok("flash_bwd_dq", rc, "dq")
    return dq
