"""Flash attention: GQA-native, on the packed projection layout.

Counterpart of ``paddle_tpu/ops/flash_attention.py``.  q ``[B, Lq, H*D]``
and k/v ``[B, Lk, Hkv*D]`` are consumed as the projections produce them;
query head ``h`` reads kv head ``h // G`` (``G = H / Hkv``).
``flash_attention_packed`` is a ``torch.autograd.Function`` (the
reference's ``custom_vjp``): the forward saves ``(q, k, v, out, lse)``,
the backward runs delta, then dK/dV, then dQ.  On CUDA tensors each step
launches its hand-written kernel (``ops/flash_attention_cuda.py``: K1/K2
forward, K3 delta, K4 dK/dV, K5 dQ) or raises; on CPU tensors it runs the
plain PyTorch version below — there is no fallback on the card.

The plain versions compute the same functions in f32 over blocks of
query rows (so the ``[.., rows, Lk]`` scores stay bounded at long
context), rounding ``p`` and ``ds`` to the input dtype where they enter a
product (``p·V``, ``p^T·dO``, ``ds^T·q``, ``ds·k``) as the reference
does; the forward returns ``out`` in the input dtype and
``lse = m + log(l)`` f32 ``[B, H, Lq]`` (the reference stores the same
rows as ``[B, Hkv, 8, Lq*G]``, sublane-replicated for TPU tiling); the
backward rebuilds ``p = exp(s - lse)`` exactly as the kernels do.  The
causal mask is bottom-right aligned (``q_offset = Lk - Lq``); causal with
``Lq > Lk`` is rejected, as in the reference.

Segment ids (``flash_attention_packed_segmented``, the reference's :1286;
int32 ``q_segments [B, Lq]``, ``k_segments [B, Lk]``) restrict attention
to same-segment pairs — the padding and varlen masks:

* a cross-segment score is the reference's finite sentinel -1e30
  (``_NEG_INF``), a causally masked one stays ``-inf``; the running max
  starts at -1e30, so a row whose leading key tiles are all out of
  segment self-corrects when its first same-segment key arrives
  (``exp(-1e30 - m) = 0`` wipes what it summed);
* a row with a non-negative segment and no same-segment key (a dead row:
  an all-padding ``attention_mask`` row) therefore averages V over every
  key it can see, as the reference's kernel, ``_sdpa_ref`` and
  ``blockwise_attention`` do.  Its ``lse`` is ``-1e30`` (``log(Lk)`` does
  not survive in f32), so the backward cannot rebuild ``p = 1/Lk`` from
  it: it takes ``p = 1/n`` (n the keys the row sees) for a row whose lse
  is at the sentinel and gives no masked pair a ds — the gradient of that
  mean, as the reference's dense and blockwise paths have it (the
  reference's kernel rebuilds ``p = 1`` there);
* rows with a negative q segment come out zero, and their ``dout`` is
  zeroed before delta, dK/dV and dQ, so they add nothing to any gradient
  (the reference's :595-598, :674-678, :996-1000);
* causal composes by global position: per-sequence causality for packed
  sequences.

In-kernel RoPE (``flash_attention_packed_rope``, the reference's :1370):
q and k arrive raw in the projection layout with the standard tables
``cos``/``sin [Lk, D]``, and the kernels rotate them (K10: the ``rope``
branches of the forward, dK/dV and dQ kernels).  ``rope_kernel_tables``
casts the tables to the input dtype, pre-signs sin and aligns the q
tables to the last Lq positions (bottom-right, as the causal mask); the
plain versions take those tables as ``rope=(qcos, qsin, kcos, ksin)``,
rotate q and k in the input dtype as the reference's kernels do (each
product and the sum rounded to it: three roundings at bf16, unlike K6's
one), attend, and in the backward accumulate dq and dk in rotated space
and rotate them back with -sin in f32 before the one cast; dv is not
rotated.  cos and sin get zero gradients.  The model does not route here
(the reference's ``models/llama.py`` rotates with K6 and calls
``flash_attention_packed``); ``rope_fusable`` is the reference's gate
without its TPU test.
"""
from __future__ import annotations

import torch

from paddle_tpu_torch.core.device import resolve_impl
from paddle_tpu_torch.ops.fused_rope import signed_sin

__all__ = ["available", "blockwise_attention", "flash_attention_blhd",
           "flash_attention_packed", "flash_attention_packed_rope",
           "flash_attention_packed_segmented", "flash_bwd_reference",
           "flash_delta_reference", "flash_fwd_reference", "repeat_kv",
           "rope_fusable", "rope_kernel_tables", "validate_gqa"]

#: runs of the plain versions, by step (plain integers)
plain_runs = {"fwd": 0, "delta": 0, "bwd": 0}

_QBLOCK = 1024      # query positions per block of the plain versions
_NEG_INF = -1e30    # the reference's finite mask sentinel and max init
#: an lse at or below this is a dead row's (its max stayed at _NEG_INF)
DEAD_LSE = 0.5 * _NEG_INF


def validate_gqa(h, hkv, name="attention"):
    """The GQA head-grouping contract; returns the group size."""
    if hkv <= 0 or h % hkv:
        raise ValueError(
            f"{name}: query heads ({h}) must be an integer multiple of "
            f"kv heads ({hkv})")
    return h // hkv


def _reject_causal_lq_gt_lk(lq, lk, causal, name):
    """Causal with Lq > Lk leaves rows with no live key under the
    bottom-right aligned mask; their lse would poison the backward."""
    if causal and lq > lk:
        raise ValueError(
            f"{name}: causal attention requires Lq <= Lk (got Lq={lq}, "
            f"Lk={lk}); rows before the cached prefix would have no live "
            "keys. Use the dense fallback for this shape.")


def repeat_kv(k, v, rep):
    """``[B, L, Hkv, D] -> [B, L, Hkv*rep, D]``: query head ``j`` reads kv
    head ``j // rep`` — the one grouping convention of every path."""
    if rep == 1:
        return k, v
    return (torch.repeat_interleave(k, rep, dim=2),
            torch.repeat_interleave(v, rep, dim=2))


def available(q_shape, k_shape=None, causal=False):
    """Whether the flash path takes this ``[B, L, H, D]`` shape (else the
    dense composition): head_dim 64/128/256, L >= 128 and a multiple of
    128, GQA-divisible heads, and causal only with Lq <= Lk — the
    reference's gate without its TPU test."""
    if len(q_shape) != 4:
        return False
    _, l, h, d = q_shape
    if k_shape is not None:
        hkv = k_shape[2]
        if hkv <= 0 or h % hkv or k_shape[1] % 128:
            return False
        if causal and q_shape[1] > k_shape[1]:
            return False
    return d in (64, 128, 256) and l >= 128 and l % 128 == 0


# ------------------------------------------------------------ plain versions
def _heads_q(x, num_heads, num_kv_heads):
    """packed ``[B, L, H*D]`` -> f32 ``[B, Hkv, G, L, D]``."""
    b, l, hd = x.shape
    g, d = num_heads // num_kv_heads, hd // num_heads
    return x.float().view(b, l, num_kv_heads, g, d).permute(0, 2, 3, 1, 4)


def _heads_kv(x, num_kv_heads):
    """packed ``[B, L, Hkv*D]`` -> f32 ``[B, Hkv, L, D]``."""
    b, l, hd = x.shape
    return x.float().view(b, l, num_kv_heads, hd // num_kv_heads) \
        .permute(0, 2, 1, 3)


def _packed(x, dtype):
    """``[B, Hkv, G, L, D]`` -> packed ``[B, L, H*D]`` in ``dtype``."""
    b, hkv, g, l, d = x.shape
    return x.permute(0, 3, 1, 2, 4).reshape(b, l, hkv * g * d).to(dtype)


def _scale(scale, d):
    return float(scale if scale is not None else 1.0 / (d ** 0.5))


def _rot(x, c, s, dtype=torch.float32):
    """The reference's ``_rot_tile`` on f32 ``[..., L, D]`` with f32 tables
    ``[L, D]`` (``s`` signed; ``-s`` rotates back): ``x*c + swap(x)*s``,
    ``swap(x) = concat(x[D/2:], x[:D/2])``, in ``dtype``'s arithmetic —
    each product and the sum formed in f32 and rounded to ``dtype``, as
    the reference computes on input-dtype tiles (returned widened)."""
    d2 = x.shape[-1] // 2
    sw = torch.cat([x[..., d2:], x[..., :d2]], dim=-1)

    def r(t):
        return t.to(dtype).float()
    return r(r(x * c) + r(sw * s))


def _rope_qk(qf, kf, rope, dtype):
    """Rotate the widened q ``[B, Hkv, G, Lq, D]`` and k ``[B, Hkv, Lk, D]``
    by the kernel tables in the input dtype ``dtype``."""
    qc, qs, kc, ks = (t.float() for t in rope)
    return _rot(qf, qc, qs, dtype), _rot(kf, kc, ks, dtype)


def _scores(qb, kf, scale, causal, q0, q_offset, qseg=None, kseg=None):
    """f32 scores ``[B, Hkv, G, rows, Lk]`` of query positions
    ``q0..q0+rows``: cross-segment pairs at -1e30, the causal mask as
    ``-inf``.  Also returns the causally visible cross-segment pairs
    (``[B, 1, 1, rows, Lk]`` bool, or None)."""
    s = torch.einsum("bhgqd,bhkd->bhgqk", qb, kf) * scale
    rows, lk = s.shape[-2], s.shape[-1]
    cross = None
    if qseg is not None:
        cross = (qseg[:, q0:q0 + rows, None] != kseg[:, None, :])[:, None,
                                                                  None]
        s = s.masked_fill(cross, _NEG_INF)
    if causal:
        pos = q_offset + q0 + torch.arange(rows, device=s.device)
        dead = torch.arange(lk, device=s.device)[None, :] > pos[:, None]
        s = s.masked_fill(dead, float("-inf"))
        if cross is not None:
            cross = cross & ~dead
    return s, cross


def flash_fwd_reference(q, k, v, num_heads, num_kv_heads, causal=False,
                        scale=None, q_segments=None, k_segments=None,
                        rope=None):
    """Plain forward: ``(out [B, Lq, H*D] in q's dtype, lse [B, H, Lq]
    f32)``, softmax in f32; optional int32 segment ids ``[B, Lq]`` /
    ``[B, Lk]`` (rows with a negative q segment come out zero); optional
    ``rope=(qcos, qsin, kcos, ksin)`` kernel tables (``rope_kernel_tables``)
    that rotate the raw q and k first."""
    plain_runs["fwd"] += 1
    b, lq, hd = q.shape
    lk = k.shape[1]
    d = hd // num_heads
    scale = _scale(scale, d)
    qf = _heads_q(q, num_heads, num_kv_heads)
    kf, vf = _heads_kv(k, num_kv_heads), _heads_kv(v, num_kv_heads)
    if rope is not None:
        qf, kf = _rope_qk(qf, kf, rope, q.dtype)
    out = torch.empty(qf.shape, dtype=torch.float32, device=q.device)
    lse = torch.empty(qf.shape[:-1], dtype=torch.float32, device=q.device)
    for q0 in range(0, lq, _QBLOCK):
        q1 = min(lq, q0 + _QBLOCK)
        s, _ = _scores(qf[:, :, :, q0:q1], kf, scale, causal, q0, lk - lq,
                       q_segments, k_segments)
        # the kernels' running max starts at the -1e30 sentinel
        m = s.amax(dim=-1, keepdim=True).clamp(min=_NEG_INF)
        p = torch.exp(s - m)
        l = p.sum(dim=-1, keepdim=True)
        # p·V takes p rounded to the input dtype (the reference's rounding
        # point); l sums it unrounded
        pv = p.to(q.dtype).float()
        out[:, :, :, q0:q1] = torch.einsum("bhgqk,bhkd->bhgqd", pv, vf) / l
        lse[:, :, :, q0:q1] = (m + torch.log(l))[..., 0]
    out = _packed(out, q.dtype)
    if q_segments is not None:
        out = out.masked_fill((q_segments < 0)[:, :, None], 0)
    return out, lse.reshape(b, num_heads, lq)


def flash_delta_reference(dout, out, num_heads):
    """Plain delta: ``rowsum(dout * out)`` f32 ``[B, H, L]``."""
    plain_runs["delta"] += 1
    b, l, hd = dout.shape
    prod = dout.float() * out.float()
    return prod.view(b, l, num_heads, hd // num_heads).sum(-1) \
        .permute(0, 2, 1).contiguous()


def flash_bwd_reference(q, k, v, dout, lse, delta, num_heads, num_kv_heads,
                        causal=False, scale=None, q_segments=None,
                        k_segments=None, rope=None):
    """Plain backward from the forward's ``lse`` and ``delta``:
    ``(dq, dk, dv)`` in the inputs' dtypes, accumulated in f32.  With
    segment ids, ``dout`` of rows with a negative q segment must already
    be zero (``flash_attention_packed_segmented`` zeroes it).  With
    ``rope`` tables, q and k are the raw residuals: they are rotated again,
    and dq and dk, accumulated in rotated space, are rotated back with
    -sin in f32 before their cast."""
    plain_runs["bwd"] += 1
    b, lq, hd = q.shape
    lk = k.shape[1]
    g, d = num_heads // num_kv_heads, hd // num_heads
    scale = _scale(scale, d)
    qf, dof = (_heads_q(q, num_heads, num_kv_heads),
               _heads_q(dout, num_heads, num_kv_heads))
    kf, vf = _heads_kv(k, num_kv_heads), _heads_kv(v, num_kv_heads)
    if rope is not None:
        qf, kf = _rope_qk(qf, kf, rope, q.dtype)
    lse5 = lse.view(b, num_kv_heads, g, lq)
    dl5 = delta.view(b, num_kv_heads, g, lq)
    dq = torch.empty(qf.shape, dtype=torch.float32, device=q.device)
    dk = torch.zeros(kf.shape, dtype=torch.float32, device=q.device)
    dv = torch.zeros(vf.shape, dtype=torch.float32, device=q.device)
    for q0 in range(0, lq, _QBLOCK):
        q1 = min(lq, q0 + _QBLOCK)
        qb, dob = qf[:, :, :, q0:q1], dof[:, :, :, q0:q1]
        s, cross = _scores(qb, kf, scale, causal, q0, lk - lq, q_segments,
                           k_segments)
        lse_b = lse5[..., q0:q1, None]
        p = torch.exp(s - lse_b)                      # masked: exp(-inf)
        if cross is not None:
            # a dead row spreads 1/n over the n keys it sees (its lse is
            # the sentinel); cross-segment pairs get no ds
            n = (lk if not causal else
                 (lk - lq + torch.arange(q0, q1, device=q.device) + 1)
                 .clamp(max=lk).float()[:, None])
            p = torch.where(cross, torch.where(lse_b <= DEAD_LSE, 1.0 / n,
                                               0.0), p)
        dv += torch.einsum("bhgqk,bhgqd->bhkd", p.to(q.dtype).float(), dob)
        dp = torch.einsum("bhgqd,bhkd->bhgqk", dob, vf)
        # ds from the unrounded p, rounded once for both of its products
        ds = p * (dp - dl5[..., q0:q1, None]) * scale
        if cross is not None:
            ds = ds.masked_fill(cross, 0.0)
        ds = ds.to(q.dtype).float()
        dq[:, :, :, q0:q1] = torch.einsum("bhgqk,bhkd->bhgqd", ds, kf)
        dk += torch.einsum("bhgqk,bhgqd->bhkd", ds, qb)
    if rope is not None:
        qc, qs, kc, ks = (t.float() for t in rope)
        dq, dk = _rot(dq, qc, -qs), _rot(dk, kc, -ks)

    def kv_packed(x, dtype):
        return x.permute(0, 2, 1, 3).reshape(b, lk, num_kv_heads * d) \
            .to(dtype)
    return (_packed(dq, q.dtype), kv_packed(dk, k.dtype),
            kv_packed(dv, v.dtype))


# ------------------------------------------------------------------ routing
def _forward(q, k, v, num_heads, num_kv_heads, causal, scale, qseg, kseg,
             rope=None):
    if resolve_impl(None, q.device, "flash_attention") == "reference":
        return flash_fwd_reference(q, k, v, num_heads, num_kv_heads, causal,
                                   scale, qseg, kseg, rope)
    from paddle_tpu_torch.ops import flash_attention_cuda as fc

    return fc.flash_fwd(q, k, v, num_heads, num_kv_heads, causal, scale,
                        qseg, kseg, rope)


def _backward(q, k, v, out, lse, dout, num_heads, num_kv_heads, causal,
              scale, qseg, kseg, rope=None):
    if resolve_impl(None, q.device, "flash_attention") == "reference":
        delta = flash_delta_reference(dout, out, num_heads)
        return flash_bwd_reference(q, k, v, dout, lse, delta, num_heads,
                                   num_kv_heads, causal, scale, qseg, kseg,
                                   rope)
    from paddle_tpu_torch.ops import flash_attention_cuda as fc

    delta = fc.flash_delta(dout, out, num_heads)
    dk, dv = fc.flash_bwd_dkv(q, k, v, dout, lse, delta, num_heads,
                              num_kv_heads, causal, scale, qseg, kseg, rope)
    dq = fc.flash_bwd_dq(q, k, v, dout, lse, delta, num_heads, num_kv_heads,
                         causal, scale, qseg, kseg, rope)
    return dq, dk, dv


class _FlashAttentionPacked(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, qseg, kseg, num_heads, num_kv_heads, causal,
                scale):
        out, lse = _forward(q, k, v, num_heads, num_kv_heads, causal, scale,
                            qseg, kseg)
        ctx.save_for_backward(q, k, v, out, lse, qseg, kseg)
        ctx.cfg = (num_heads, num_kv_heads, causal, scale)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse, qseg, kseg = ctx.saved_tensors
        dout = dout.contiguous()
        if qseg is not None:
            # padding rows: their lse is garbage, a zero dout kills every
            # contribution they would make (the reference's :996-1000)
            dout = dout.masked_fill((qseg < 0)[:, :, None], 0)
        dq, dk, dv = _backward(q, k, v, out, lse, dout, *ctx.cfg, qseg, kseg)
        return dq, dk, dv, None, None, None, None, None, None


def flash_attention_packed(q, k, v, num_heads, num_kv_heads, causal=False,
                           scale=None):
    """GQA flash attention in the projection layout: q ``[B, Lq, H*D]``,
    k/v ``[B, Lk, Hkv*D]`` -> ``[B, Lq, H*D]``; differentiable."""
    lq, lk = q.shape[1], k.shape[1]
    _reject_causal_lq_gt_lk(lq, lk, causal, "flash_attention")
    validate_gqa(num_heads, num_kv_heads, "flash_attention")
    d = q.shape[2] // num_heads
    return _FlashAttentionPacked.apply(
        q.contiguous(), k.contiguous(), v.contiguous(), None, None,
        int(num_heads), int(num_kv_heads), bool(causal), _scale(scale, d))


def _segments(seg, b, l, device, name):
    seg = torch.as_tensor(seg, device=device)
    if seg.is_floating_point() or tuple(seg.shape) != (b, l):
        raise ValueError(f"flash_attention: {name} must be integer [{b}, "
                         f"{l}], got {seg.dtype} {tuple(seg.shape)}")
    return seg.to(torch.int32).contiguous()


def flash_attention_packed_segmented(q, k, v, q_segments, k_segments,
                                     num_heads, num_kv_heads, causal=False,
                                     scale=None):
    """Segment-masked GQA flash attention in the projection layout:
    ``q_segments [B, Lq]`` / ``k_segments [B, Lk]`` integer ids restrict
    attention to equal-segment pairs; a negative q segment is a padding
    row (zero output, zero gradients).  Differentiable in q, k, v."""
    b, lq, lk = q.shape[0], q.shape[1], k.shape[1]
    _reject_causal_lq_gt_lk(lq, lk, causal, "flash_attention")
    validate_gqa(num_heads, num_kv_heads, "flash_attention")
    d = q.shape[2] // num_heads
    qseg = _segments(q_segments, b, lq, q.device, "q_segments")
    kseg = _segments(k_segments, b, lk, q.device, "k_segments")
    return _FlashAttentionPacked.apply(
        q.contiguous(), k.contiguous(), v.contiguous(), qseg, kseg,
        int(num_heads), int(num_kv_heads), bool(causal), _scale(scale, d))


_VMEM_BUDGET = 12 * 1024 * 1024   # the reference's _stream_kv threshold


def rope_kernel_tables(cos, sin, lq, lk, dtype):
    """The reference's ``_rope_kernel_tables`` (:1325): the standard
    tables ``[Lk, D]`` -> ``(qcos, qsin, kcos, ksin)`` in ``dtype``, sin
    pre-signed (``signed_sin``), the q tables the LAST ``lq`` rows (the
    cached-prefill, bottom-right convention); 2-D and contiguous, as the
    kernels take them (the reference adds a leading 1 for its blocks)."""
    cos = cos.to(dtype)
    sin_s = signed_sin(sin).to(dtype)
    return tuple(t.contiguous() for t in (cos[lk - lq:], sin_s[lk - lq:],
                                          cos, sin_s))


def rope_fusable(q_shape, k_shape, num_heads, num_kv_heads):
    """Gate for ``flash_attention_packed_rope`` (the reference's :1346
    without its TPU test): head_dim a multiple of 128 that the kernels are
    built for (128 or 256; the reference's flash gate ``available`` takes
    no larger one either), G*head_dim a multiple of 128, Lq and Lk
    multiples of 128, and the reference's residency budget with the rope
    tables counted like another K/V pair (``16*Lk*D <= 12 MiB``)."""
    _, lq, qd = q_shape
    lk = k_shape[1]
    d = qd // num_heads
    if d * num_heads != qd or d not in (128, 256):
        return False
    g = num_heads // num_kv_heads
    if g * num_kv_heads != num_heads or (g * d) % 128:
        return False
    if 16 * lk * d > _VMEM_BUDGET:
        return False
    return lq % 128 == 0 and lk % 128 == 0


class _FlashAttentionPackedRope(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, cos, sin, num_heads, num_kv_heads, causal,
                scale):
        tables = rope_kernel_tables(cos, sin, q.shape[1], k.shape[1],
                                    q.dtype)
        out, lse = _forward(q, k, v, num_heads, num_kv_heads, causal, scale,
                            None, None, tables)
        ctx.save_for_backward(q, k, v, out, lse, *tables)
        ctx.cfg = (num_heads, num_kv_heads, causal, scale)
        ctx.table_meta = [(t.shape, t.dtype, t.device) for t in (cos, sin)]
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse, *tables = ctx.saved_tensors
        dq, dk, dv = _backward(q, k, v, out, lse, dout.contiguous(),
                               *ctx.cfg, None, None, tuple(tables))
        # the tables are positional constants: zero cotangents (:1411)
        dcos, dsin = (
            torch.zeros(shape, dtype=dtype, device=dev) if need else None
            for need, (shape, dtype, dev) in zip(ctx.needs_input_grad[3:5],
                                                 ctx.table_meta))
        return dq, dk, dv, dcos, dsin, None, None, None, None


def flash_attention_packed_rope(q, k, v, cos, sin, num_heads, num_kv_heads,
                                causal=False, scale=None):
    """GQA flash attention with RoPE inside the kernels (K10): q
    ``[B, Lq, H*D]`` and k ``[B, Lk, Hkv*D]`` arrive RAW in the projection
    layout and are rotated by the standard half-duplicated tables
    ``cos``/``sin [Lk, D]`` (the first Lk rows are used; the queries take
    the last Lq positions), v ``[B, Lk, Hkv*D]``; returns
    ``[B, Lq, H*D]``, differentiable in q, k, v (cos and sin get zero
    gradients).  Raises ``ValueError`` where the reference does: G*head_dim
    not a multiple of 128 (the reference wires rotation only into its
    packed one-head-per-program kernels), ``8*Lk*D > 12 MiB`` (its
    streamed kernels have no rotation), causal with Lq > Lk; and where the
    tables cannot cover the positions (Lq > Lk, or fewer than Lk rows).
    Gate with ``rope_fusable``."""
    _, lq, hd = q.shape
    lk = k.shape[1]
    _reject_causal_lq_gt_lk(lq, lk, causal, "flash_attention")
    g = validate_gqa(num_heads, num_kv_heads, "flash_attention")
    d = hd // num_heads
    if (g * d) % 128:
        raise ValueError(
            f"flash_attention_packed_rope: G*head_dim = {g}*{d} is not a "
            "multiple of 128 — in-kernel rotation is only wired for the "
            "packed one-head-per-program kernels; gate with rope_fusable()")
    if 8 * lk * d > _VMEM_BUDGET:
        raise ValueError(
            f"flash_attention_packed_rope: Lk={lk} at head_dim {d} takes the "
            "reference's streamed kernels, which have no in-kernel rotation; "
            "gate with rope_fusable()")
    if lq > lk:
        raise ValueError(
            f"flash_attention_packed_rope: Lq={lq} > Lk={lk} — the q tables "
            "are the last Lq of the Lk positions")
    for name, t in (("cos", cos), ("sin", sin)):
        if t.dim() != 2 or t.shape[0] < lk or t.shape[1] != d:
            raise ValueError(f"flash_attention_packed_rope: {name} must be "
                             f"[>= {lk}, {d}], got {tuple(t.shape)}")
    return _FlashAttentionPackedRope.apply(
        q.contiguous(), k.contiguous(), v.contiguous(), cos[:lk], sin[:lk],
        int(num_heads), int(num_kv_heads), bool(causal), _scale(scale, d))


def flash_attention_blhd(q, k, v, causal=False, scale=None, q_segments=None,
                         k_segments=None):
    """Flash attention on ``[B, L, H, D]`` (k/v may carry fewer kv heads):
    a packing wrapper over ``flash_attention_packed``, or over
    ``flash_attention_packed_segmented`` when segment ids are given."""
    b, lq, h, d = q.shape
    lk, hkv = k.shape[1], k.shape[2]
    validate_gqa(h, hkv, "flash_attention_blhd")
    qp, kp, vp = (q.reshape(b, lq, h * d), k.reshape(b, lk, hkv * d),
                  v.reshape(b, lk, hkv * d))
    if (q_segments is None) != (k_segments is None):
        raise ValueError("flash_attention_blhd: give both q_segments and "
                         "k_segments, or neither")
    if q_segments is None:
        out = flash_attention_packed(qp, kp, vp, h, hkv, causal, scale)
    else:
        out = flash_attention_packed_segmented(qp, kp, vp, q_segments,
                                               k_segments, h, hkv, causal,
                                               scale)
    return out.view(b, lq, h, d)


def blockwise_attention(q, k, v, causal=False, scale=None, block_k=512,
                        q_segments=None, k_segments=None):
    """Memory-bounded attention on ``[B, L, H, D]`` as an online softmax
    over key blocks, in f32 (the reference's :1418-1503, without the
    ring attention's offsets and carry): the plain path for shapes
    outside the flash gate.  The causal mask is top-left aligned (query
    i sees keys <= i, self-attention lengths); segment ids restrict
    attention to same-segment pairs, and rows with a negative q segment
    come out zero.  Both masks use the finite -1e30 sentinel, so a row
    with no live key averages V.  Differentiable by autograd."""
    b, lq, h, d = q.shape
    lk, hkv = k.shape[1], k.shape[2]
    g = validate_gqa(h, hkv, "blockwise_attention")
    scale = _scale(scale, d)
    block_k = min(int(block_k), lk)
    while lk % block_k:
        block_k //= 2
    qt = q.transpose(1, 2).float().mul(scale).reshape(b, hkv, g, lq, d)
    kt, vt = k.transpose(1, 2).float(), v.transpose(1, 2).float()
    q_idx = torch.arange(lq, device=q.device)
    acc = torch.zeros((b, h, lq, d), dtype=torch.float32, device=q.device)
    m = torch.full((b, h, lq), _NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, h, lq), dtype=torch.float32, device=q.device)
    for k0 in range(0, lk, block_k):
        s = torch.einsum("bkgqd,bkcd->bkgqc", qt, kt[:, :, k0:k0 + block_k]) \
            .reshape(b, h, lq, block_k)
        if causal:
            k_idx = k0 + torch.arange(block_k, device=q.device)
            s = s.masked_fill(q_idx[:, None] < k_idx[None, :], _NEG_INF)
        if k_segments is not None:
            cross = q_segments[:, :, None] != \
                k_segments[:, None, k0:k0 + block_k]
            s = s.masked_fill(cross[:, None], _NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bkgqc,bkcd->bkgqd", p.reshape(b, hkv, g, lq, block_k),
            vt[:, :, k0:k0 + block_k]).reshape(b, h, lq, d)
        m = m_new
    out = acc / l.clamp(min=1e-30)[..., None]
    if q_segments is not None:
        out = out.masked_fill((q_segments < 0)[:, None, :, None], 0.0)
    return out.transpose(1, 2).to(q.dtype)
