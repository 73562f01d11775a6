"""K8 — paged decode attention: a hand-written Hopper kernel and its plain
PyTorch version.

Replaces the TPU kernel ``fused_decode_attention``
(``paddle_tpu/ops/paged_attention_pallas.py:195``, its ``pallas_call``
at :259, kernel body ``_fused_kernel`` :118) for float caches and, with
``quant=True`` (:160-163), for int8 caches: a ``(data int8, scale f16)``
pair per K and V, dequantized in the kernel as ``code * f32(scale)``.
The kernel source is ``csrc/paged_decode_attention.cu``; its note says
what bounds it on the card and how the design answers that: a split-K
launch over spans of ``_SPLIT`` keys whose partials the last CTA of each
row group merges, in one launch.  The partials' workspace and the
merge's tickets live in a buffer cached per device and size
(``workspace``), allocated once — no memset, nothing per call.

``paged_decode_attention`` is the one entry: on CPU tensors it runs the
plain version (``ops/decode_attention._attend_read``, the reference's
chunked online softmax), on CUDA tensors it launches the kernel or
raises — there is no fallback.  ``launches`` counts kernel launches
(``launches_t`` the same launches by ``T``, the query rows a slot: 1
for a decode step, ``k+1`` for a speculative verify) and ``plain_runs``
counts plain-version runs, so a run can show which path it went
through.  The kernel takes any ``T``: the ``G*T`` query rows of a kv
head go ``_ROWS`` to a CTA, each row masked causally at ``lengths +
t``.

``hidden [B, T, 2]`` (int32, optional) gives each (slot, query row) a
half-open key range ``[lo, hi)`` it must not see — top-2 tree
verification hides the linear chain from the branch row this way, where
the reference passed an additive bias of -1e30 over those keys (and its
fused kernel refused any bias, ``paged_attention_pallas.py:89-90``).
The kernel gives a hidden key no weight, as a key past the causal
limit; a span of keys wholly hidden for a row merges with weight 0.  A
launch with a range is counted in ``launches_hidden`` as well (and under
its ``T`` in ``launches_t``); without one the kernel is the same
instance as before.
"""
from __future__ import annotations

import torch

from paddle_tpu_torch.core.device import resolve_impl

__all__ = ["fused_decode_supported", "paged_decode_attention",
           "paged_decode_attention_reference"]

#: kernel launches made by ``paged_decode_attention`` (a plain integer;
#: callers may reset it to 0)
launches = 0
#: the same launches by T, the query rows a slot (callers may clear it)
launches_t = {}
#: the launches that carried a hidden key range
launches_hidden = 0
#: runs of the plain version
plain_runs = 0

_KEYS = 32          # keys per kernel sub-tile (one warp lane per key)
_MAX_D = 256        # head_dim the kernel's register accumulator covers
_SPLIT = 64         # keys a CTA folds (the fastest span measured on the card)
_ROWS = 16          # query rows a CTA holds
#: head_dims with a 16-byte-load instance of the kernel
_VEC_D = (64, 128, 256)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2,
               torch.int8: 3}


def cache_operands(k_cache, v_cache, where):
    """``(dtype code, k data, v data, k scale or None, v scale or None)``
    of a float cache pair or an int8 ``(data, scale)`` pair — checked for
    matching shapes and dtypes, contiguity, and the 16-byte alignment the
    int8 loads need."""
    if isinstance(k_cache, tuple) != isinstance(v_cache, tuple):
        raise ValueError(f"{where}: k and v caches must both be int8 "
                         "(data, scale) pairs or both float tensors")
    if isinstance(k_cache, tuple):
        (kd, ks), (vd, vs) = k_cache, v_cache
        if kd.dtype != torch.int8 or vd.dtype != torch.int8 \
                or ks.dtype != torch.float16 or vs.dtype != torch.float16 \
                or ks.shape != kd.shape[:-1] or vs.shape != vd.shape[:-1]:
            raise ValueError(f"{where}: an int8 cache is (data int8 "
                             "[..., D], scale float16 [...]) per K and V")
        if any(x.data_ptr() % 16 for x in (kd, vd)):
            raise ValueError(f"{where}: int8 cache data must be 16-byte "
                             "aligned")
    else:
        kd, vd, ks, vs = k_cache, v_cache, None, None
        if kd.dtype not in _DTYPE_CODE or kd.dtype == torch.int8:
            raise ValueError(
                f"{where}: cache dtype {kd.dtype} — the kernel takes "
                "float32/bfloat16/float16 or an int8 (data, scale) pair")
    if vd.dtype != kd.dtype or vd.shape != kd.shape:
        raise ValueError(f"{where}: k and v caches differ: "
                         f"{kd.dtype} {tuple(kd.shape)} vs {vd.dtype} "
                         f"{tuple(vd.shape)}")
    for x in (kd, vd, ks, vs):
        if x is not None and not x.is_contiguous():
            raise ValueError(f"{where}: the caches must be contiguous")
    return _DTYPE_CODE[kd.dtype], kd, vd, ks, vs


def _ptr(x):
    return x.data_ptr() if x is not None else None


def _aligned(*xs):
    """Whether every tensor given (None skipped) starts on 16 bytes."""
    return all(x.data_ptr() % 16 == 0 for x in xs if x is not None)


def workspace_numel(b, hkv, rows, d, lmax):
    """``(partial rows, tickets)`` the split-K merge needs for ``b`` batch
    rows, ``hkv`` kv heads, ``rows = G * T`` query rows over a span of
    ``lmax`` keys: each of the ``ceil(lmax / _SPLIT)`` spans of a (row,
    head) keeps ``rows`` partial rows (``acc [d]`` and ``(m, l)`` in f32);
    one int32 ticket per group of ``_ROWS`` query rows."""
    spans = -(-lmax // _SPLIT)
    return b * hkv * spans * rows, b * hkv * -(-rows // _ROWS)


#: (device, partial rows, d, tickets) -> (acc, ml, tickets)
_WORKSPACES = {}


def workspace(dev, n_rows, d, n_tickets):
    """The cached workspace of a split-K merge: ``acc`` f32
    ``[n_rows * d]``, ``ml`` f32 ``[n_rows * 2]`` and ``n_tickets`` int32
    tickets at 0.  The kernels leave the tickets at 0 and write every
    partial before they read it, so one buffer serves every later launch
    of either kernel on the same stream (and keeps its address, as a
    captured CUDA graph needs)."""
    key = (dev, n_rows, d, n_tickets)
    ws = _WORKSPACES.get(key)
    if ws is None:
        buf = torch.empty(n_rows * (d + 2), dtype=torch.float32, device=dev)
        ws = (buf[:n_rows * d], buf[n_rows * d:],
              torch.zeros(n_tickets, dtype=torch.int32, device=dev))
        _WORKSPACES[key] = ws
    return ws


def fused_decode_supported(chunk_size, lmax, head_dim):
    """Geometry gate for the K8 kernel: ``None`` when supported, else
    the reason.  The reference gate (``chunk_size`` set and dividing the
    span) plus the kernel's own tiling: chunks made of whole 32-key
    sub-tiles, and ``head_dim <= 256``."""
    if chunk_size is None:
        return ("chunk_size=None selects the single full-length read, "
                "which the kernel does not implement")
    c = int(chunk_size)
    if c > lmax or lmax % c:
        return (f"chunk_size ({c}) must divide the cache span ({lmax}) "
                "for uniform kernel blocks")
    if c % _KEYS:
        return (f"chunk_size ({c}) must be a multiple of {_KEYS} (the "
                "kernel's key sub-tile)")
    if head_dim > _MAX_D:
        return f"head_dim ({head_dim}) exceeds the kernel's {_MAX_D}"
    return None


def paged_decode_attention_reference(qg, k_cache, v_cache, lengths, scale,
                                     chunk_size, block_table=None,
                                     hidden=None):
    """The plain version: ``qg [B, Hkv, G, T, D]`` f32 against the dense
    ``[B, Lmax, Hkv, D]`` cache or the ``[N, C, Hkv, D]`` pool through
    ``block_table [B, W]`` (float, or int8 ``(data, scale)`` pairs), with
    the optional hidden key ranges; returns ``[B, Hkv, G, T, D]`` f32."""
    global plain_runs
    from paddle_tpu_torch.ops.decode_attention import _attend_read

    plain_runs += 1
    return _attend_read(qg, k_cache, v_cache, lengths, scale, chunk_size,
                        block_table, hidden)


def paged_decode_attention(qg, k_cache, v_cache, lengths, scale, chunk_size,
                           block_table=None, impl=None, hidden=None):
    """Decode attention read for ``T`` query rows per batch row.

    ``qg [B, Hkv, G, T, D]`` f32 (queries at positions ``lengths + t``),
    caches dense ``[B, Lmax, Hkv, D]`` or paged ``[N, C, Hkv, D]`` with
    ``block_table [B, W]`` int32 — float tensors or int8 ``(data,
    scale)`` pairs —, ``lengths [B]`` int32 (pre-append;
    parked slots at ``>= lmax`` return finite garbage), ``hidden [B, T,
    2]`` int32 the optional hidden key ranges (module docstring).
    ``impl``: ``None`` by device, ``"reference"`` the plain version,
    ``"cuda"`` the kernel.  Returns ``[B, Hkv, G, T, D]`` f32."""
    impl = resolve_impl(impl, qg.device, "paged_decode_attention")
    if impl == "reference":
        return paged_decode_attention_reference(
            qg, k_cache, v_cache, lengths, scale, chunk_size, block_table,
            hidden)
    return _launch(qg, k_cache, v_cache, lengths, scale, chunk_size,
                   block_table, hidden)


def _launch(qg, k_cache, v_cache, lengths, scale, chunk_size, block_table,
            hidden):
    global launches, launches_hidden
    from paddle_tpu_torch.ops import _build

    if qg.dim() != 5 or qg.dtype != torch.float32 or not qg.is_contiguous():
        raise ValueError("paged_decode_attention: qg must be a contiguous "
                         "[B, Hkv, G, T, D] float32 tensor")
    b, hkv, g, t, d = qg.shape
    dev = qg.device
    code, kd, vd, ks, vs = cache_operands(k_cache, v_cache,
                                          "paged_decode_attention")
    for name, x in (("k_cache", kd), ("v_cache", vd), ("lengths", lengths)):
        if x.device != dev or not x.is_contiguous():
            raise ValueError(f"paged_decode_attention: {name} must be a "
                             f"contiguous tensor on {dev}")
    if kd.dim() != 4 or kd.shape[2] != hkv or kd.shape[3] != d:
        raise ValueError(
            f"paged_decode_attention: cache shape {tuple(kd.shape)} "
            f"does not match qg {tuple(qg.shape)}")
    if lengths.dtype != torch.int32 or tuple(lengths.shape) != (b,):
        raise ValueError("paged_decode_attention: lengths must be int32 [B]")
    if hidden is not None and (
            hidden.dtype != torch.int32 or tuple(hidden.shape) != (b, t, 2)
            or hidden.device != dev or not hidden.is_contiguous()):
        raise ValueError("paged_decode_attention: hidden must be a "
                         f"contiguous int32 [B, T, 2] tensor on {dev}")
    if block_table is not None:
        if block_table.dtype != torch.int32 or block_table.dim() != 2 \
                or block_table.shape[0] != b or block_table.device != dev \
                or not block_table.is_contiguous():
            raise ValueError("paged_decode_attention: block_table must be "
                             f"a contiguous int32 [B, W] tensor on {dev}")
        c = kd.shape[1]
        n_chunks = block_table.shape[1]
        lmax = n_chunks * c
        n_blocks = kd.shape[0]
        if chunk_size is not None and int(chunk_size) != c:
            raise ValueError(
                f"paged_decode_attention: chunk_size ({chunk_size}) must "
                f"equal the pool block ({c})")
    else:
        if kd.shape[0] != b:
            raise ValueError("paged_decode_attention: dense cache batch "
                             f"{kd.shape[0]} != {b}")
        lmax = kd.shape[1]
        n_blocks = 0
    reason = fused_decode_supported(chunk_size, lmax, d)
    if reason is not None:
        raise ValueError(f"paged_decode_attention: {reason}")
    c = int(chunk_size)
    n_chunks = lmax // c
    out = torch.empty((b, hkv, g, t, d), dtype=torch.float32, device=dev)
    n_rows, n_tickets = workspace_numel(b, hkv, g * t, d, lmax)
    ws_acc, ws_ml, tickets = workspace(dev, n_rows, d, n_tickets)
    vec = d in _VEC_D and _aligned(kd, vd)
    lib = _build.load("paged_decode_attention")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.paged_decode_attention(
            code, qg.data_ptr(), kd.data_ptr(), vd.data_ptr(), _ptr(ks),
            _ptr(vs), _ptr(block_table), lengths.data_ptr(), _ptr(hidden),
            out.data_ptr(), ws_acc.data_ptr(),
            ws_ml.data_ptr(), tickets.data_ptr(), b, hkv, g, t, d, c,
            n_chunks, lmax, n_blocks, _SPLIT, int(vec), float(scale),
            stream)
    if rc != 0:
        raise RuntimeError(
            f"paged_decode_attention: kernel launch failed with CUDA error "
            f"{rc}")
    launches += 1
    launches_t[t] = launches_t.get(t, 0) + 1
    if hidden is not None:
        launches_hidden += 1
    return out
