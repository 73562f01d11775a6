"""Incremental-decode attention over a preallocated KV cache.

Counterpart of ``paddle_tpu/ops/decode_attention.py``.  Two cache
geometries, both with the head axis at index 2:

* DENSE ``[B, Lmax, Hkv, D]`` — one contiguous row span per slot;
* PAGED — a global block pool ``[N, C, Hkv, D]`` indirected through a
  per-slot ``[B, W]`` int32 block table (logical position ``l`` of row
  ``b`` lives in pool block ``table[b, l // C]`` at row ``l % C``;
  entries ``>= N`` are unmapped sentinels).

The caches are updated IN PLACE (the JAX package donated them to its
jitted programs instead); every function still returns them so call
sites read like the reference.  Porting notes, kept as invariants:

* **Out-of-bounds semantics are explicit.**  JAX drops scatter writes
  past capacity (``mode="drop"``) and clamps gathers; PyTorch raises on
  the CPU and device-asserts on CUDA.  ``_append`` reproduces the drop
  with a masked write (``_write_rows``) that never leaves the
  device, and every gather clamps its index.
* **Where dtypes round** follows the reference: queries are upcast to
  f32 before attention and the read runs in f32 whatever the cache
  dtype.
* **Integer widths**: lengths, offsets and block tables are int32.

``dtype="int8"`` makes each of k/v a ``(data int8 [..., D], scale f16
[...])`` pair: one symmetric absmax scale per (position, head), stored
with the same indices minus the head-dim axis.  Rows are quantized
INSIDE the append (``_q8_quantize``: ``scale = f16(amax / 127)``, codes
``clip(round(x / f32(scale)), ±127)`` through the reciprocal of the
f16-ROUNDED scale, so dequantization with the stored scale reproduces
each element to within half a step) and dequantized inside every read
(``code * f32(scale)``, exact in f32).

The cache READ has two implementations behind one wrapper per kernel:
the plain PyTorch online-softmax loop here (``_attend_read``, the CPU
path and the reference the kernels are held against) and the
hand-written Hopper kernels — K8 (``ops/paged_attention_cuda.py``) for
decode and K9 (``ops/prefill_attention_cuda.py``) for a chunked-prefill
step, which also appends the chunk's K/V.  ``impl=None`` picks the
kernel for CUDA tensors and the plain version for CPU tensors; nothing
falls back silently.
"""
from __future__ import annotations

import torch

from paddle_tpu_torch.core.device import resolve_device, torch_dtype
from paddle_tpu_torch.ops.fused_adamw import INV127
from paddle_tpu_torch.ops import paged_attention_cuda as _k8
from paddle_tpu_torch.ops import prefill_attention_cuda as _k9

__all__ = ["init_kv_cache", "init_kv_pool", "decode_attention", "kv_data",
           "kv_dtype", "masked_lengths", "slot_prefill_attention"]

_NEG_INF = -1e30

_KV_DTYPES = ("float32", "float16", "bfloat16", "int8")
_Q8_MAX = 127.0
#: the per-(position, head) scale of an int8 cache: f16 keeps the bytes
#: per token at (D + 2) / (2 D) of a bf16 cache
Q8_SCALE_DTYPE = torch.float16


def kv_dtype(dtype, where):
    """Validate a cache dtype (name or ``torch.dtype``) -> torch dtype
    (``torch.int8`` for the quantized cache); anything else unsupported
    is a ValueError."""
    name = str(dtype).replace("torch.", "")
    if name not in _KV_DTYPES:
        raise ValueError(f"{where}: unsupported KV cache dtype {dtype!r} — "
                         f"supported: {', '.join(_KV_DTYPES)}")
    return torch.int8 if name == "int8" else torch_dtype(name)


def kv_data(cache):
    """The storage leaf of one cache operand (an int8 cache is a
    ``(data, scale)`` pair)."""
    return cache[0] if isinstance(cache, tuple) else cache


def _alloc(shape, dt, dev):
    if dt == torch.int8:
        return (torch.zeros(shape, dtype=torch.int8, device=dev),
                torch.zeros(shape[:-1], dtype=Q8_SCALE_DTYPE, device=dev))
    return torch.zeros(shape, dtype=dt, device=dev)


def init_kv_cache(batch, max_len, num_kv_heads, head_dim, dtype="bfloat16",
                  device=None):
    """Preallocate a dense (k, v) cache pair ``[B, Lmax, Hkv, D]`` (for
    ``"int8"`` each a ``(data, scale [B, Lmax, Hkv] f16)`` pair)."""
    dt = kv_dtype(dtype, "init_kv_cache")
    shape = (batch, max_len, num_kv_heads, head_dim)
    dev = resolve_device(device)
    return _alloc(shape, dt, dev), _alloc(shape, dt, dev)


def init_kv_pool(num_blocks, block, num_kv_heads, head_dim,
                 dtype="bfloat16", device=None):
    """Preallocate a paged (k, v) pool pair ``[N, C, Hkv, D]`` (for
    ``"int8"`` each a ``(data, scale [N, C, Hkv] f16)`` pair sharing the
    block-table indirection)."""
    dt = kv_dtype(dtype, "init_kv_pool")
    shape = (num_blocks, block, num_kv_heads, head_dim)
    dev = resolve_device(device)
    return _alloc(shape, dt, dev), _alloc(shape, dt, dev)


def _q8_quantize(x):
    """Symmetric absmax int8 quantization over the trailing (D) axis:
    ``(codes int8 [..., D], scale f16 [...])``.  ``scale = f16(amax *
    f32(1/127))`` — what XLA compiles the reference's ``amax / 127``
    into inside its serving programs — and the codes divide by the
    f16-ROUNDED scale (through its f32 reciprocal) and clip to ±127."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1)
    scale = (amax * INV127).to(Q8_SCALE_DTYPE)
    inv = 1.0 / torch.clamp(scale.float(), min=1e-8)
    q = torch.clamp(torch.round(xf * inv[..., None]), -_Q8_MAX, _Q8_MAX)
    return q.to(torch.int8), scale


def _q8_dequant(q, scale):
    """Inverse of ``_q8_quantize``: f32 values (``code * f32(scale)``,
    exact in f32)."""
    return q.float() * scale.float()[..., None]


def _as_f32(cache):
    """A cache operand (or a slice/gather of one) as f32 values."""
    if isinstance(cache, tuple):
        return _q8_dequant(*cache)
    return cache.float()


def masked_lengths(lengths, live, lmax):
    """Write gating for continuous batching: slots that are not ``live``
    get offset ``lmax``, so every append lands past capacity and is
    dropped, and the slot's cache survives the step untouched."""
    lengths = torch.as_tensor(lengths)
    live = torch.as_tensor(live, device=lengths.device)
    return torch.where(live, lengths.to(torch.int32),
                       torch.full_like(lengths, int(lmax),
                                       dtype=torch.int32))


def _write_rows(leaves, lengths, block_table=None):
    """Write each ``(cache, rows [B, T, ...])`` of ``leaves`` in place at
    per-row offsets ``lengths [B]``; every leaf has the same leading
    ``[B, Lmax]`` (dense) or ``[N, C]`` (pool) axes, so the positions and
    the drop rule are computed once for all of them.  Writes past the
    capacity are DROPPED, never clamped; with ``block_table [B, W]`` any
    position past the table's ``W*C`` span, or mapped to a sentinel
    entry ``>= N``, is dropped too — parked slots (offset ``lmax``) write
    nothing.  Device-side only (no host sync): a dropped write is
    re-pointed at the FIRST valid write's target with that write's value
    — a duplicate index carrying an identical value, so the result does
    not depend on the order ``index_put_`` applies them — or, when
    nothing is valid, at row 0 with row 0's current value.  Every index
    is a 1-element tensor: indexing with a 0-d tensor would turn into a
    host read (``.item()``) and stall the stream."""
    cache0, new0 = leaves[0]
    for cache, _ in leaves:
        if not cache.is_contiguous():
            raise ValueError("_append: the cache must be contiguous")
    b, t = new0.shape[0], new0.shape[1]
    dev = cache0.device
    l = lengths.to(device=dev, dtype=torch.int32)[:, None] \
        + torch.arange(t, dtype=torch.int32, device=dev)[None, :]  # [B, T]
    if block_table is None:
        lmax = cache0.shape[1]
        valid = l < lmax
        rows = torch.arange(b, device=dev, dtype=torch.int64)[:, None]
        target = rows * lmax + l.clamp(0, lmax - 1).to(torch.int64)
    else:
        n_blocks, c = cache0.shape[0], cache0.shape[1]
        w = block_table.shape[1]
        tbl = block_table.to(device=dev, dtype=torch.int64)
        blk = torch.gather(tbl, 1, (l // c).clamp(0, w - 1).to(torch.int64))
        valid = (l < w * c) & (blk >= 0) & (blk < n_blocks)
        target = blk.clamp(0, n_blocks - 1) * c + (l % c).to(torch.int64)
    target, valid = target.reshape(-1), valid.reshape(-1)
    j = torch.argmax(valid.to(torch.int32)).reshape(1)
    any_valid = valid.any()
    t_fb = torch.where(any_valid, target.index_select(0, j),
                       torch.zeros_like(j))
    idx = torch.where(valid, target, t_fb)
    for cache, new in leaves:
        flat = cache.view(cache.shape[0] * cache.shape[1], *cache.shape[2:])
        values = new.reshape(b * t, *new.shape[2:]).to(cache.dtype)
        v_fb = torch.where(any_valid, values.index_select(0, j),
                           flat.index_select(0, t_fb))
        shape = (-1,) + (1,) * (values.dim() - 1)
        flat.index_put_((idx,), torch.where(valid.view(shape), values, v_fb))


def _leaves(cache, new):
    """``(storage leaf, rows)`` pairs of one cache operand: an int8
    ``(data, scale)`` cache quantizes ``new`` here, inside the append, and
    writes codes and scales with the same indices, so the drop rules hold
    for both."""
    if isinstance(cache, tuple):
        qn, sn = _q8_quantize(new)
        return [(cache[0], qn), (cache[1], sn)]
    return [(cache, new)]


def _append(cache, new, lengths, block_table=None):
    """Write ``new [B, T, Hkv, D]`` into ``cache`` (in place) at per-row
    offsets ``lengths [B]`` under ``_write_rows``'s drop rules."""
    _write_rows(_leaves(cache, new), lengths, block_table)
    return cache


def _append_kv(k_cache, v_cache, k_new, v_new, lengths, block_table=None):
    """``_append`` of K and V together: one position computation for
    every leaf of both caches."""
    _write_rows(_leaves(k_cache, k_new) + _leaves(v_cache, v_new), lengths,
                block_table)


def _attend_full(qg, k_cache, v_cache, q_pos, scale):
    """Single masked read over the whole dense ``[Lmax]`` cache."""
    lmax = kv_data(k_cache).shape[1]
    s = torch.einsum("bkgtd,blkd->bkgtl", qg, _as_f32(k_cache)) * scale
    k_idx = torch.arange(lmax, dtype=torch.int32, device=qg.device)
    live = k_idx[None, None, :] <= q_pos[:, :, None]            # [B, T, L]
    s = torch.where(live[:, None, None], s, _NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bkgtl,blkd->bkgtd", p, _as_f32(v_cache))


def _attend_chunked(qg, k_cache, v_cache, lengths, q_pos, scale, chunk,
                    block_table=None):
    """Online-softmax loop over ``[C]``-sized cache chunks (the
    reference's ``lax.while_loop``).  The trip count
    ``ceil((max live length + T) / C)`` is read on the host — this is the
    plain version; on the card the kernels carry the loop.  Parked slots
    (length ``>= lmax``) do not extend it and come back as finite
    garbage.  With ``block_table`` the chunk ``i`` of row ``b`` is pool
    block ``clamp(table[b, i], 0, N-1)`` (a sentinel reads a real block
    whose rows the causal mask discards).  int8 caches dequantize each
    chunk right after its slice / gather, scales through the same
    indices."""
    b, hkv, g, t, d = qg.shape
    c = int(chunk)
    dev = qg.device
    k_data = kv_data(k_cache)
    if block_table is not None:
        if k_data.shape[1] != c:
            raise ValueError(
                f"paged _attend_chunked: chunk ({c}) must equal the pool "
                f"block size ({k_data.shape[1]})")
        tbl = block_table.to(device=dev, dtype=torch.int64)
        lmax = tbl.shape[1] * c
        n_blocks = k_data.shape[0]
    else:
        lmax = k_data.shape[1]
    n_chunks = -(-lmax // c)
    lengths = lengths.to(device=dev, dtype=torch.int32)
    eff = torch.where(lengths < lmax, lengths, torch.zeros_like(lengths))
    trip = min(max((int(eff.max()) + t + c - 1) // c, 1), n_chunks)
    m = torch.full((b, hkv, g, t), _NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((b, hkv, g, t), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, hkv, g, t, d), dtype=torch.float32, device=dev)
    for i in range(trip):
        start = min(i * c, lmax - c)  # clamped tail start
        if block_table is not None:
            idx = tbl[:, i].clamp(0, n_blocks - 1)

            def read(cache):
                return _as_f32(tuple(x[idx] for x in cache)
                               if isinstance(cache, tuple) else cache[idx])
        else:
            def read(cache):
                return _as_f32(tuple(x[:, start:start + c] for x in cache)
                               if isinstance(cache, tuple)
                               else cache[:, start:start + c])
        kb = read(k_cache).transpose(1, 2)                     # [B, Hkv, C, D]
        vb = read(v_cache).transpose(1, 2)
        s = torch.einsum("bkgtd,bkcd->bkgtc", qg, kb) * scale
        k_idx = start + torch.arange(c, dtype=torch.int32, device=dev)
        # causal AND not already folded (the clamped tail re-reads
        # [start, i*c), which belongs to the previous chunk)
        live = (k_idx[None, None, :] <= q_pos[:, :, None]) \
            & (k_idx >= i * c)[None, None, :]                  # [B, T, C]
        live = live[:, None, None]
        s = torch.where(live, s, _NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        # explicit zero on masked lanes: a fully-masked row has
        # s == m_new == _NEG_INF and exp(0) == 1 otherwise
        p = torch.where(live, torch.exp(s - m_new[..., None]), 0.0)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bkgtc,bkcd->bkgtd", p, vb)
        m = m_new
    return acc / torch.clamp(l, min=1e-30)[..., None]


def _attend_read(qg, k_cache, v_cache, lengths, scale, chunk_size,
                 block_table=None):
    """The plain cache read for ``qg [B, Hkv, G, T, D]`` f32 at positions
    ``lengths + t``: the chunked online softmax when paged or when
    ``chunk_size`` is below the span, else the single full read.
    Returns ``[B, Hkv, G, T, D]`` f32."""
    t = qg.shape[3]
    dev = qg.device
    lengths = lengths.to(device=dev, dtype=torch.int32)
    q_pos = lengths[:, None] + torch.arange(t, dtype=torch.int32,
                                            device=dev)[None, :]
    if block_table is not None:
        return _attend_chunked(qg, k_cache, v_cache, lengths, q_pos, scale,
                               int(chunk_size), block_table)
    lmax = kv_data(k_cache).shape[1]
    if chunk_size is not None and int(chunk_size) < lmax:
        return _attend_chunked(qg, k_cache, v_cache, lengths, q_pos, scale,
                               int(chunk_size))
    return _attend_full(qg, k_cache, v_cache, q_pos, scale)


def _group_queries(q, hkv):
    """``q [B, T, H, D]`` -> ``[B, Hkv, G, T, D]`` f32 (the GQA layout
    every read takes; queries are upcast before attention)."""
    b, t, h, d = q.shape
    return q.reshape(b, t, hkv, h // hkv, d).permute(0, 2, 3, 1, 4) \
        .float().contiguous()


def _ungroup(out, dtype):
    """``[B, Hkv, G, T, D]`` -> ``[B, T, H, D]`` in ``dtype``."""
    b, hkv, g, t, d = out.shape
    return out.permute(0, 3, 1, 2, 4).reshape(b, t, hkv * g, d).to(dtype)


def decode_attention(q, k_new, v_new, k_cache, v_cache, lengths, scale=None,
                     chunk_size=None, block_table=None, impl=None):
    """One decode step: append the new K/V (in place), attend causally
    over the cache.

    q ``[B, T, H, D]``; k_new/v_new ``[B, T, Hkv, D]``; caches dense
    ``[B, Lmax, Hkv, D]`` or, with ``block_table [B, W]`` (int32), a pool
    ``[N, C, Hkv, D]`` read through the table (``chunk_size`` must then
    equal ``C``); an int8 cache is a ``(data, scale)`` pair of each.
    ``lengths [B]`` int32: valid positions BEFORE this
    step; query ``t`` sits at ``lengths + t`` and sees every position up
    to it.  ``impl`` selects the read: ``None`` by device, ``"reference"``
    the plain loop, ``"cuda"`` the K8 kernel (raising on a geometry it
    does not cover).  Returns ``(out [B, T, H, D], k_cache, v_cache,
    lengths + T)``."""
    b, t, h, d = q.shape
    hkv = k_new.shape[2]
    if block_table is not None:
        blk = kv_data(k_cache).shape[1]
        if chunk_size is None or int(chunk_size) != blk:
            raise ValueError(
                f"decode_attention: paged caches require chunk_size == pool "
                f"block size ({blk}), got {chunk_size}")
    if hkv <= 0 or h % hkv:
        raise ValueError(
            f"decode_attention: query heads ({h}) must be an integer "
            f"multiple of kv heads ({hkv})")
    scale = float(scale if scale is not None else 1.0 / (d ** 0.5))
    lengths = lengths.to(torch.int32)
    _append_kv(k_cache, v_cache, k_new, v_new, lengths, block_table)
    qg = _group_queries(q, hkv)
    out = _k8.paged_decode_attention(qg, k_cache, v_cache, lengths, scale,
                                     chunk_size, block_table, impl=impl)
    return _ungroup(out, q.dtype), k_cache, v_cache, lengths + t


def _prefill_reference(q, k_new, v_new, k_cache, v_cache, slot, offset,
                       scale, chunk_size, block_table=None):
    """Plain chunked-prefill step (the reference's scatter + chunked
    read): append the chunk's rows at ``offset`` (dense: into row
    ``slot``; paged: through the slot's ``[1, W]`` table row), then read
    them back with every earlier row under the causal mask."""
    hkv = k_new.shape[2]
    off = torch.full((1,), int(offset), dtype=torch.int32, device=q.device)
    qg = _group_queries(q, hkv)
    if block_table is not None:
        _append_kv(k_cache, v_cache, k_new, v_new, off, block_table)
        out = _attend_read(qg, k_cache, v_cache, off, scale, chunk_size,
                           block_table)
    else:
        def row(cache):                # views: the appends land in place
            if isinstance(cache, tuple):
                return tuple(x[slot:slot + 1] for x in cache)
            return cache[slot:slot + 1]
        ks, vs = row(k_cache), row(v_cache)
        _append_kv(ks, vs, k_new, v_new, off)
        out = _attend_read(qg, ks, vs, off, scale, chunk_size)
    return _ungroup(out, q.dtype), k_cache, v_cache


def slot_prefill_attention(q, k_new, v_new, k_cache, v_cache, slot, offset,
                           scale=None, chunk_size=None, block_table=None,
                           impl=None):
    """Chunked-prefill attention for ONE slot of the batch cache.

    The chunk's rows are written (in place) at positions ``offset + i``
    of slot ``slot`` (rows past capacity are dropped), and query ``i``
    attends to every row ``< offset`` plus the chunk's causal prefix —
    chaining chunks at offsets 0, P, 2P, ... reproduces a monolithic
    prefill.  ``slot`` and ``offset`` are host ints.  With
    ``block_table [B, W]`` the caches are a pool read and written through
    the slot's table row (``chunk_size`` must equal the pool block).
    ``impl``: ``None`` by device, ``"reference"`` the plain append +
    chunked read, ``"cuda"`` the K9 kernel (attention and append in one
    launch; it needs ``offset`` to be a multiple of the chunk width).

    q ``[1, P, H, D]``; k_new/v_new ``[1, P, Hkv, D]``.  Returns
    ``(out [1, P, H, D], k_cache, v_cache)``; an int8 cache (a ``(data,
    scale)`` pair of each) quantizes the chunk's rows on append."""
    b, t, h, d = q.shape
    if b != 1:
        raise ValueError(
            f"slot_prefill_attention: chunk batch must be 1 (got {b})")
    hkv = k_new.shape[2]
    if hkv <= 0 or h % hkv:
        raise ValueError(
            f"slot_prefill_attention: query heads ({h}) must be an integer "
            f"multiple of kv heads ({hkv})")
    scale = float(scale if scale is not None else 1.0 / (d ** 0.5))
    slot, offset = int(slot), int(offset)
    trow = None
    if block_table is not None:
        blk = kv_data(k_cache).shape[1]
        if chunk_size is None or int(chunk_size) != blk:
            raise ValueError(
                f"slot_prefill_attention: paged caches require "
                f"chunk_size == kv_block (the pool block size): got "
                f"chunk_size={chunk_size!r} with kv_block={blk}")
        trow = block_table[slot:slot + 1]
    elif not 0 <= slot < kv_data(k_cache).shape[0]:
        raise ValueError(f"slot_prefill_attention: slot {slot} out of range "
                         f"[0, {kv_data(k_cache).shape[0]})")
    return _k9.prefill_attention(q, k_new, v_new, k_cache, v_cache, slot,
                                 offset, scale, chunk_size, trow, impl=impl)
