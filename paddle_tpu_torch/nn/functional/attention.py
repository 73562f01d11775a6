"""Scaled dot-product attention routing.

Counterpart of ``paddle_tpu/nn/functional/attention.py:20-136``: on
``[batch, seq, heads, head_dim]`` inputs (k/v may carry fewer kv heads),
the flash path (``ops/flash_attention.flash_attention_blhd``: the K1-K5
kernels on the card, their plain versions on the CPU) is taken when its
gate passes and there is no mask; otherwise the dense composition
``_sdpa_ref`` runs.  A kernel error propagates — nothing falls back to
the dense path behind it.  Key-padding masks (the reference lowers them
onto its segment-masked kernels) and dropout are not ported yet and
raise.
"""
from __future__ import annotations

import torch

from paddle_tpu_torch.ops.flash_attention import (
    available, flash_attention_blhd, repeat_kv, validate_gqa,
)

__all__ = ["scaled_dot_product_attention"]

#: runs of the dense composition (a plain integer)
dense_runs = 0


def _sdpa_ref(q, k, v, mask=None, causal=False, scale=None):
    """Dense attention, ``[B, L, H, D]``: scores in the input dtype, the
    softmax in f32 with ``p`` cast back to the input dtype before ``p·V``
    (the reference's rounding points), the causal mask bottom-right
    aligned, and rows with no live key (causal Lq > Lk) zeroed."""
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


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True):
    """``[batch, seq, heads, head_dim]`` attention (the reference's
    ``paddle.nn.functional.scaled_dot_product_attention``)."""
    if dropout_p > 0.0 and training:
        raise NotImplementedError(
            "attention dropout is not ported yet (the BERT slice brings "
            "it)")
    if attn_mask is None:
        if available(query.shape, key.shape, causal=is_causal):
            return flash_attention_blhd(query, key, value, causal=is_causal)
        return _sdpa_ref(query, key, value, None, is_causal)
    if _is_key_padding_mask(attn_mask, query.shape, key.shape):
        raise NotImplementedError(
            "key-padding masks (the segment-masked flash kernels) are not "
            "ported yet (the BERT slice brings them)")
    return _sdpa_ref(query, key, value, attn_mask, is_causal)
