"""K9 — fused chunked-prefill attention + KV append: a hand-written
Hopper kernel and its plain PyTorch version.

Replaces the TPU kernel ``fused_prefill_attention``
(``paddle_tpu/ops/prefill_attention_pallas.py:328``, its ``pallas_call``
at :418, kernel body ``_prefill_kernel`` :102) for float caches and,
with ``quant=True`` (:217-234, :265-267, :296-300), for int8 ``(data,
scale)`` caches: the append quantizes each new row bit for bit as
``decode_attention._q8_quantize`` does, and the chunk's own rows attend
through their quantized-then-dequantized values.  The kernel source is
``csrc/prefill_attention.cu``.

``prefill_attention`` is the one entry: on CPU tensors it runs the plain
version (``ops/decode_attention._prefill_reference``: append, then the
chunked read), on CUDA tensors it launches the kernel or raises.  The
kernel writes the chunk's K/V into the cache in place and attends over
the written prefix plus the chunk's own causal triangle, using the new
rows ROUNDED TO THE CACHE DTYPE (the reference reads them back from the
cache after its scatter).  ``launches`` / ``plain_runs`` count the two
paths.

Alignment contract (as in the reference): ``offset`` is a multiple of
the chunk width ``T`` — the engine's chunk walker guarantees it, and the
wrapper checks it.
"""
from __future__ import annotations

import torch

from paddle_tpu_torch.core.device import resolve_impl
from paddle_tpu_torch.ops.paged_attention_cuda import _ptr, cache_operands

__all__ = ["fused_prefill_supported", "prefill_attention",
           "prefill_attention_reference"]

#: kernel launches made by ``prefill_attention``
launches = 0
#: runs of the plain version
plain_runs = 0

_KEYS = 32
_MAX_D = 256


def fused_prefill_supported(chunk_size, lmax, t, paged, head_dim):
    """Geometry gate for the K9 kernel: ``None`` when supported, else the
    reason.  The reference gate — ``chunk_size`` (the cache-read chunk,
    the pool block when paged) divides the span, the prefill chunk ``t``
    and ``chunk_size`` divide one another, dense appends stay in the row
    — plus the kernel's tiling (32-key sub-tiles, ``head_dim <= 256``)."""
    if chunk_size is None:
        return ("chunk_size=None selects the single full-length read "
                "(no uniform blocks for the fused prefill sweep)")
    c = int(chunk_size)
    if c > lmax or lmax % c:
        return (f"chunk_size ({c}) must divide the cache span ({lmax}) "
                "for uniform kernel blocks")
    if t % c and c % t:
        return (f"prefill chunk ({t}) and cache chunk ({c}) must divide "
                "one another for block-aligned fused appends")
    if not paged and lmax % t:
        return (f"prefill chunk ({t}) must divide the cache span "
                f"({lmax}) so dense fused appends stay in bounds")
    if c % _KEYS:
        return (f"chunk_size ({c}) must be a multiple of {_KEYS} (the "
                "kernel's key sub-tile)")
    if head_dim > _MAX_D:
        return f"head_dim ({head_dim}) exceeds the kernel's {_MAX_D}"
    return None


def prefill_attention_reference(q, k_new, v_new, k_cache, v_cache, slot,
                                offset, scale, chunk_size, block_table=None):
    """The plain version (append + chunked read); same contract as
    ``prefill_attention``."""
    global plain_runs
    from paddle_tpu_torch.ops.decode_attention import _prefill_reference

    plain_runs += 1
    return _prefill_reference(q, k_new, v_new, k_cache, v_cache, slot,
                              offset, scale, chunk_size, block_table)


def prefill_attention(q, k_new, v_new, k_cache, v_cache, slot, offset, scale,
                      chunk_size, block_table=None, impl=None):
    """One admission chunk: q ``[1, T, H, D]``, k_new/v_new
    ``[1, T, Hkv, D]``; caches dense ``[B, Lmax, Hkv, D]`` (rows of slot
    ``slot``) or a pool ``[N, C, Hkv, D]`` through ``block_table
    [1, W]`` (the slot's table row), float or int8 ``(data, scale)``
    pairs.  ``offset`` (host int) is the write
    cursor.  Returns ``(out [1, T, H, D] in q.dtype, k_cache, v_cache)``
    with the chunk appended in place."""
    impl = resolve_impl(impl, q.device, "prefill_attention")
    if impl == "reference":
        return prefill_attention_reference(
            q, k_new, v_new, k_cache, v_cache, slot, offset, scale,
            chunk_size, block_table)
    return _launch(q, k_new, v_new, k_cache, v_cache, int(slot),
                   int(offset), scale, chunk_size, block_table)


def _launch(q, k_new, v_new, k_cache, v_cache, slot, offset, scale,
            chunk_size, block_table):
    global launches
    from paddle_tpu_torch.ops import _build

    if q.dim() != 4 or q.shape[0] != 1:
        raise ValueError("prefill_attention: q must be [1, T, H, D]")
    _, t, h, d = q.shape
    hkv = k_new.shape[2]
    g = h // hkv
    dev = q.device
    code, kd, vd, ks, vs = cache_operands(k_cache, v_cache,
                                          "prefill_attention")
    if k_new.shape != (1, t, hkv, d) or v_new.shape != k_new.shape:
        raise ValueError("prefill_attention: k_new/v_new must be "
                         f"[1, {t}, Hkv, {d}]")
    for name, x in (("k_cache", kd), ("v_cache", vd), ("k_new", k_new),
                    ("v_new", v_new)):
        if x.device != dev:
            raise ValueError(f"prefill_attention: {name} is not on {dev}")
    if kd.dim() != 4 or kd.shape[2] != hkv or kd.shape[3] != d:
        raise ValueError(
            f"prefill_attention: caches must be [., ., {hkv}, {d}], got "
            f"{tuple(kd.shape)}")
    paged = block_table is not None
    if paged:
        if block_table.dtype != torch.int32 or block_table.dim() != 2 \
                or block_table.shape[0] != 1 or block_table.device != dev:
            raise ValueError("prefill_attention: block_table must be the "
                             f"slot's int32 [1, W] row on {dev}")
        block_table = block_table.contiguous()
        c = kd.shape[1]
        w = block_table.shape[1]
        span = w * c
        n_blocks = kd.shape[0]
        if chunk_size is not None and int(chunk_size) != c:
            raise ValueError(
                f"prefill_attention: chunk_size ({chunk_size}) must equal "
                f"the pool block ({c})")
    else:
        if not 0 <= slot < kd.shape[0]:
            raise ValueError(f"prefill_attention: slot {slot} out of range")
        span = kd.shape[1]
        w, n_blocks = 0, 0
    reason = fused_prefill_supported(chunk_size, span, t, paged, d)
    if reason is not None:
        raise ValueError(f"prefill_attention: {reason}")
    if offset < 0 or offset % t:
        raise ValueError(
            f"prefill_attention: offset ({offset}) must be a non-negative "
            f"multiple of the chunk width ({t}) — the fused append's "
            "alignment contract")
    if offset >= span:
        raise ValueError(f"prefill_attention: offset ({offset}) is past the "
                         f"cache span ({span})")
    c = int(chunk_size)
    # [1, T, H, D] -> [Hkv, G*T, D]: row g*T + t of kv head k is query
    # head k*G + g at chunk token t (the reference kernel's layout)
    q2 = q.reshape(t, hkv, g, d).permute(1, 2, 0, 3).reshape(hkv, g * t, d) \
        .float().contiguous()
    # the new rows are rounded to the cache dtype BEFORE attention, as the
    # reference reads them back from the cache after its scatter; an int8
    # cache takes them in f32 (exact) and quantizes them in the kernel
    new_dt = torch.float32 if ks is not None else kd.dtype
    kn = k_new.reshape(t, hkv, d).to(new_dt).contiguous()
    vn = v_new.reshape(t, hkv, d).to(new_dt).contiguous()
    out = torch.empty((hkv, g * t, d), dtype=torch.float32, device=dev)
    lib = _build.load("prefill_attention")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.prefill_attention(
            code, q2.data_ptr(), kn.data_ptr(), vn.data_ptr(), kd.data_ptr(),
            vd.data_ptr(), _ptr(ks), _ptr(vs), _ptr(block_table),
            out.data_ptr(),
            hkv, g, t, d, c, w, n_blocks, span, slot, offset, float(scale),
            stream)
    if rc != 0:
        raise RuntimeError(
            f"prefill_attention: kernel launch failed with CUDA error {rc}")
    launches += 1
    out = out.reshape(hkv, g, t, d).permute(2, 0, 1, 3).reshape(1, t, h, d)
    return out.to(q.dtype), k_cache, v_cache
