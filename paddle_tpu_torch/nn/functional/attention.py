"""Scaled dot-product attention routing.

Counterpart of ``paddle_tpu/nn/functional/attention.py``: on
``[batch, seq, heads, head_dim]`` inputs (k/v may carry fewer kv heads),
the flash path (``ops/flash_attention.flash_attention_blhd``: the K1-K5
kernels on the card, their plain versions on the CPU) is taken when its
gate passes and there is no dropout: with no mask, or with a boolean
key-padding mask (``[B, Lk]`` or ``[B, 1, 1, Lk]``), which lowers onto the
segment-masked kernels (key segment 0 for live keys, -2 for padded ones,
query segment 0 on every row, so padded query rows still attend to live
keys as in the dense path).  Otherwise the dense composition
``_sdpa_ref`` runs; attention dropout always takes it, with a Bernoulli
keep mask drawn from a ``torch.Generator`` (the reference has no
in-kernel dropout either).  A kernel error propagates — nothing falls
back to the dense path behind it.

``flash_attn_unpadded`` (varlen over packed sequences) tags each token
with its sequence index and runs one segment-masked pass, causal
composing with the segments into per-sequence causality.

Under ``auto_cast`` the first two are the reference's white-listed
``scaled_dot_product_attention`` and ``flash_attention``: f32 inputs
arrive in the amp dtype, so the flash kernels take bf16.
"""
from __future__ import annotations

import torch

from paddle_tpu_torch.amp.auto_cast import amp_op
from paddle_tpu_torch.ops.flash_attention import (
    available, blockwise_attention, flash_attention_blhd, repeat_kv,
    validate_gqa,
)

__all__ = ["flash_attention", "flash_attn_unpadded",
           "scaled_dot_product_attention"]

#: runs of the dense composition (a plain integer)
dense_runs = 0


def _sdpa_ref(q, k, v, mask=None, causal=False, scale=None, dropout_p=0.0,
              generator=None):
    """Dense attention, ``[B, L, H, D]``: scores in the input dtype, the
    softmax in f32 with ``p`` cast back to the input dtype before ``p·V``
    (the reference's rounding points), the causal mask bottom-right
    aligned, rows with no live key (causal Lq > Lk) zeroed, and with
    ``dropout_p`` each probability kept with ``1 - dropout_p`` and scaled
    up by ``1 / (1 - dropout_p)``."""
    global dense_runs
    dense_runs += 1
    d = q.shape[-1]
    if k.shape[2] != q.shape[2]:
        rep = validate_gqa(q.shape[2], k.shape[2],
                           "scaled_dot_product_attention")
        k, v = repeat_kv(k, v, rep)
    s = scale if scale is not None else 1.0 / (d ** 0.5)
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    scores = torch.einsum("bhqd,bhkd->bhqk", qt, kt) * s
    dead_rows = 0
    neg = torch.tensor(-1e30, dtype=scores.dtype, device=scores.device)
    if causal:
        ql, kl = scores.shape[-2], scores.shape[-1]
        cmask = torch.ones((ql, kl), dtype=torch.bool,
                           device=scores.device).tril(kl - ql)
        scores = torch.where(cmask, scores, neg)
        dead_rows = max(ql - kl, 0)
    if mask is not None:
        if mask.dtype == torch.bool:
            scores = torch.where(mask, scores, neg)
        else:
            scores = scores + mask
    p = torch.softmax(scores.float(), dim=-1).to(q.dtype)
    if dropout_p > 0.0:
        keep = torch.rand(p.shape, generator=generator,
                          device=p.device) < 1.0 - dropout_p
        p = torch.where(keep, p / (1.0 - dropout_p),
                        torch.zeros((), dtype=p.dtype,
                                    device=p.device)).to(p.dtype)
    out = torch.einsum("bhqk,bhkd->bhqd", p, vt)
    if dead_rows:
        row = torch.arange(out.shape[2], device=out.device)[None, None, :,
                                                            None]
        out = torch.where(row < dead_rows, torch.zeros_like(out), out)
    return out.transpose(1, 2)


def _is_key_padding_mask(mask, q_shape, k_shape):
    """A boolean per-key mask ``[B, Lk]`` or ``[B, 1, 1, Lk]``."""
    if mask.dtype != torch.bool:
        return False
    b, lk = q_shape[0], k_shape[1]
    return tuple(mask.shape) in ((b, lk), (b, 1, 1, lk))


@amp_op("scaled_dot_product_attention")
def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True, generator=None):
    """``[batch, seq, heads, head_dim]`` attention (the reference's
    ``paddle.nn.functional.scaled_dot_product_attention``); ``generator``
    draws the dropout mask (PyTorch's default generator when None)."""
    use_dropout = dropout_p > 0.0 and training
    if not use_dropout and available(query.shape, key.shape,
                                     causal=is_causal):
        if attn_mask is None:
            return flash_attention_blhd(query, key, value, causal=is_causal)
        if _is_key_padding_mask(attn_mask, query.shape, key.shape):
            live = attn_mask.reshape(attn_mask.shape[0], -1)
            kseg = torch.where(live, 0, -2).to(torch.int32)
            qseg = torch.zeros(query.shape[:2], dtype=torch.int32,
                               device=query.device)
            return flash_attention_blhd(query, key, value, causal=is_causal,
                                        q_segments=qseg, k_segments=kseg)
    mask = attn_mask
    if mask is not None and mask.dtype == torch.bool and mask.dim() == 2:
        mask = mask[:, None, None, :]          # [B, Lk] key padding
    return _sdpa_ref(query, key, value, mask, is_causal,
                     dropout_p=dropout_p if use_dropout else 0.0,
                     generator=generator)


@amp_op("flash_attention")
def flash_attention(query, key, value, dropout=0.0, causal=False,
                    return_softmax=False, training=True, generator=None):
    """The reference's ``flash_attention``: ``(out, None)``."""
    out = scaled_dot_product_attention(query, key, value, None, dropout,
                                       causal, training, generator)
    return out, None


def flash_attn_unpadded(query, key, value, cu_seqlens_q, cu_seqlens_k,
                        max_seqlen_q=None, max_seqlen_k=None, scale=None,
                        dropout=0.0, causal=False, return_softmax=False,
                        training=True):
    """Varlen attention over packed sequences (the reference's :149-210):
    q/k/v ``[total, heads, head_dim]``, ``cu_seqlens_*`` the ``[batch+1]``
    prefix sums of the lengths.  Each token is tagged with its sequence
    (``searchsorted`` over ``cu[1:]``); tokens past ``cu[-1]`` (a static
    pad tail) get q segment -1 (zero output) and k segment -2 (no query
    sees them).  The segmented flash path runs where its gate passes,
    else ``blockwise_attention``.  ``causal`` assumes self-attention
    lengths; it composes with the segments by global position.  Returns
    ``(out, None)``."""
    if dropout > 0.0 and training:
        raise NotImplementedError(
            "flash_attn_unpadded: dropout inside the varlen kernel is not "
            "supported; apply dropout outside attention")

    def segments(cu, total, pad):
        cu = torch.as_tensor(cu, device=query.device).to(torch.int32)
        pos = torch.arange(total, dtype=torch.int32, device=query.device)
        seg = torch.searchsorted(cu[1:].contiguous(), pos,
                                 right=True).to(torch.int32)
        return torch.where(pos < cu[-1], seg, pad).to(torch.int32)

    seg_q = segments(cu_seqlens_q, query.shape[0], -1)[None]
    seg_k = segments(cu_seqlens_k, key.shape[0], -2)[None]
    q1, k1, v1 = query[None], key[None], value[None]
    if available(q1.shape, k1.shape, causal=causal):
        out = flash_attention_blhd(q1, k1, v1, causal=causal, scale=scale,
                                   q_segments=seg_q, k_segments=seg_k)
    else:
        out = blockwise_attention(q1, k1, v1, causal=causal, scale=scale,
                                  q_segments=seg_q, k_segments=seg_k)
    return out[0], None
