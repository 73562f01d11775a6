"""K1-K5 — flash attention: wrappers of the hand-written Hopper kernels.

Replaces the TPU kernels of ``paddle_tpu/ops/flash_attention.py``: the
forward (K1 resident ``pallas_call`` :653, K2 streamed :571; one kernel
here, ``csrc/flash_attention_fwd.cu``) and the backward's delta (K3
:714), dK/dV (K4 :1131) and dQ (K5 :1242, streamed :1175) passes
(``csrc/flash_attention_bwd.cu``), each with and without the reference's
segment masks (``segmented=True``: int32 ``q_segments [B, Lq]`` and
``k_segments [B, Lk]``, a compile-time switch of the same templates).
The ``rope`` operand (K10: the reference's ``rope=True`` branches of the
forward, dK/dV and dQ kernels, reached through
``flash_attention_packed_rope`` :1370) hands the forward, K4 and K5 four
tables — ``qcos``/``qsin [Lq, D]`` and ``kcos``/``ksin [Lk, D]`` in the
input dtype, sin pre-signed (``ops/flash_attention.rope_kernel_tables``)
— with which they rotate raw q and k inside the kernel and rotate dq and
dk back before their cast (another compile-time switch, ``ROPE``,
without segments, at head_dim 128 and 256).  Each source's note says what
bounds its kernels on the card and how the design answers that.

Every wrapper takes CUDA tensors in the packed projection layout
(q/out ``[B, Lq, H*D]``, k/v ``[B, Lk, Hkv*D]``, contiguous, one dtype of
float32/bfloat16/float16) and row statistics ``[B, H, Lq]`` f32,
launches its kernel on the current stream, and raises on anything the
kernel does not take.  The plain PyTorch versions and the routing live in
``ops/flash_attention.py``; ``launches`` counts the launches of each
kernel, the segmented instances under ``*_seg``, the rope ones under
``*_rope``; the launches of the forward, dK/dV and dQ that went to their
wgmma instances (``flash_instance``: bf16 at head_dim 64/128) are counted
again under ``*_wgmma``, so a run can show that all of them did.
"""
from __future__ import annotations

import torch

__all__ = ["flash_fwd", "flash_delta", "flash_bwd_dkv", "flash_bwd_dq",
           "flash_instance", "HEAD_DIMS", "ROPE_HEAD_DIMS",
           "WGMMA_HEAD_DIMS"]

#: kernel launches by kernel (plain integers; callers may reset them to 0)
launches = {"fwd": 0, "delta": 0, "dkv": 0, "dq": 0, "fwd_seg": 0,
            "dkv_seg": 0, "dq_seg": 0, "fwd_rope": 0, "dkv_rope": 0,
            "dq_rope": 0, "fwd_wgmma": 0, "fwd_seg_wgmma": 0,
            "fwd_rope_wgmma": 0, "dkv_wgmma": 0, "dkv_seg_wgmma": 0,
            "dkv_rope_wgmma": 0, "dq_wgmma": 0, "dq_seg_wgmma": 0,
            "dq_rope_wgmma": 0}

HEAD_DIMS = (64, 128, 256)
ROPE_HEAD_DIMS = (128, 256)     # the head dims of the ROPE instances
WGMMA_HEAD_DIMS = (64, 128)     # the wgmma instances' head dims
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


def _check_segments(where, dev, b, lq, lk, qseg, kseg):
    """Validate optional segment ids; return their two pointers (None for
    unsegmented attention) and the counter's suffix."""
    if qseg is None and kseg is None:
        return None, None, ""
    for name, x, l in (("q_segments", qseg, lq), ("k_segments", kseg, lk)):
        if x is None or x.dtype != torch.int32 or tuple(x.shape) != (b, l) \
                or x.device != dev or not x.is_contiguous():
            raise ValueError(f"{where}: {name} must be a contiguous int32 "
                             f"[{b}, {l}] tensor on {dev}")
    return qseg.data_ptr(), kseg.data_ptr(), "_seg"


def _check_rope(where, q, lq, lk, d, rope, segmented):
    """Validate the optional rope tables ``(qcos, qsin, kcos, ksin)``:
    contiguous, 16-byte aligned (the tensor-core kernels read them 16
    bytes at a time), in q's dtype, on q's device, ``[Lq, D]`` and
    ``[Lk, D]``.
    Return their four pointers (None without rope) and the counter's
    suffix."""
    if rope is None:
        return (None,) * 4, ""
    if segmented:
        raise ValueError(f"{where}: the rope kernels take no segment ids")
    if d not in ROPE_HEAD_DIMS:
        raise ValueError(f"{where}: head_dim {d} — the rope kernels take "
                         f"{ROPE_HEAD_DIMS}")
    if len(rope) != 4:
        raise ValueError(f"{where}: rope must be (qcos, qsin, kcos, ksin)")
    for name, x, l in zip(("qcos", "qsin", "kcos", "ksin"), rope,
                          (lq, lq, lk, lk)):
        if x.dtype != q.dtype or tuple(x.shape) != (l, d) \
                or x.device != q.device or not x.is_contiguous() \
                or x.data_ptr() % 16:
            raise ValueError(f"{where}: {name} must be a contiguous, "
                             f"16-byte aligned {q.dtype} [{l}, {d}] tensor "
                             f"on {q.device}")
    return tuple(x.data_ptr() for x in rope), "_rope"


def flash_instance(dtype, head_dim):
    """The instance of the forward, dK/dV and dQ kernels these inputs
    take: ``"wgmma"`` (Hopper's asynchronous tensor-core path: TMA ring,
    warp-specialised blocks) for bf16 at head_dim 64/128, ``"simt"`` (f32
    on the CUDA cores) otherwise."""
    if dtype == torch.bfloat16 and head_dim in WGMMA_HEAD_DIMS:
        return "wgmma"
    return "simt"


_FAILURES = {-1: "a shape the kernel does not take",
             -2: "the driver refused a TMA tensor map (pointers must be "
                 "16-byte aligned)",
             -3: "the kernel was built with too few registers for its "
                 "warpgroup split"}


def _ok(where, rc, kernel, wgmma=False):
    if rc != 0:
        why = _FAILURES.get(rc, f"CUDA error {rc}")
        raise RuntimeError(f"{where}: kernel launch failed: {why}")
    launches[kernel] += 1
    if wgmma:
        launches[kernel + "_wgmma"] += 1


def flash_fwd(q, k, v, num_heads, num_kv_heads, causal, scale, qseg=None,
              kseg=None, rope=None):
    """K1/K2: ``(out [B, Lq, H*D] in q's dtype, lse [B, H, Lq] f32)``;
    with segment ids, rows with a negative q segment come out zero; with
    ``rope`` tables (K10), q and k are rotated in the kernel."""
    from paddle_tpu_torch.ops import _build

    b, lq, lk, d = _geometry("flash_fwd", q, k, v, num_heads, num_kv_heads,
                             causal)
    qs, ks, tag = _check_segments("flash_fwd", q.device, b, lq, lk, qseg,
                                  kseg)
    rp, rtag = _check_rope("flash_fwd", q, lq, lk, d, rope, qs is not None)
    out = torch.empty_like(q)
    lse = torch.empty((b, num_heads, lq), dtype=torch.float32,
                      device=q.device)
    lib = _build.load("flash_attention_fwd")
    with torch.cuda.device(q.device):
        rc = lib.flash_attention_fwd(
            _DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), lse.data_ptr(), qs, ks, *rp, b, num_heads,
            num_kv_heads, lq, lk, d, int(bool(causal)), float(scale),
            _stream(q.device))
    _ok("flash_fwd", rc, "fwd" + tag + rtag,
        flash_instance(q.dtype, d) == "wgmma")
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
                  causal, scale, qseg=None, kseg=None, rope=None):
    """K4: ``(dk, dv)`` in k's dtype, each kv head summed over its G query
    heads in-kernel; with segment ids, ``dout`` of padding rows must be
    zero; with ``rope`` tables (K10), q and k are the raw residuals and
    dk comes out in raw space."""
    from paddle_tpu_torch.ops import _build

    b, lq, lk, d = _bwd_operands("flash_bwd_dkv", q, k, v, dout, lse, delta,
                                 num_heads, num_kv_heads, causal)
    qs, ks, tag = _check_segments("flash_bwd_dkv", q.device, b, lq, lk,
                                  qseg, kseg)
    rp, rtag = _check_rope("flash_bwd_dkv", q, lq, lk, d, rope,
                           qs is not None)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    lib = _build.load("flash_attention_bwd")
    with torch.cuda.device(q.device):
        rc = lib.flash_attention_bwd_dkv(
            _DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), qs, ks, *rp,
            dk.data_ptr(), dv.data_ptr(), b, num_heads, num_kv_heads, lq, lk,
            d, int(bool(causal)), float(scale), _stream(q.device))
    _ok("flash_bwd_dkv", rc, "dkv" + tag + rtag,
        flash_instance(q.dtype, d) == "wgmma")
    return dk, dv


def flash_bwd_dq(q, k, v, dout, lse, delta, num_heads, num_kv_heads, causal,
                 scale, qseg=None, kseg=None, rope=None):
    """K5: ``dq`` in q's dtype (segment ids and ``rope`` as
    ``flash_bwd_dkv``)."""
    from paddle_tpu_torch.ops import _build

    b, lq, lk, d = _bwd_operands("flash_bwd_dq", q, k, v, dout, lse, delta,
                                 num_heads, num_kv_heads, causal)
    qs, ks, tag = _check_segments("flash_bwd_dq", q.device, b, lq, lk, qseg,
                                  kseg)
    rp, rtag = _check_rope("flash_bwd_dq", q, lq, lk, d, rope,
                           qs is not None)
    dq = torch.empty_like(q)
    lib = _build.load("flash_attention_bwd")
    with torch.cuda.device(q.device):
        rc = lib.flash_attention_bwd_dq(
            _DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), qs, ks, *rp,
            dq.data_ptr(), b, num_heads, num_kv_heads, lq, lk, d,
            int(bool(causal)), float(scale), _stream(q.device))
    _ok("flash_bwd_dq", rc, "dq" + tag + rtag,
        flash_instance(q.dtype, d) == "wgmma")
    return dq
