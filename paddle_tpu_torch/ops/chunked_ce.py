"""Chunked token cross-entropy (the big-vocab LM loss).

Counterpart of ``paddle_tpu/ops/chunked_ce.py``: the vocab-head product
and the f32 log-softmax run on ``chunk_size`` tokens at a time, each
chunk under ``torch.utils.checkpoint``, so the ``[B*L, V]`` logits never
materialise — the backward recomputes one chunk's logits at a time.  The
token count is padded to a multiple of the chunk with label -1.  Labels
< 0 are ignored; the mean is over valid labels.

The logits are f32 products of the model-dtype operands with f32 sums
(the reference's ``preferred_element_type=f32``).  On the card a bf16 or
f16 chunk is one tensor-core GEMM with an f32 result (``torch.mm`` with
``out_dtype``); elsewhere, and for f32 operands, both are widened to f32
first — the same products and sums, in another order.  The backward is
the reference's transpose: the f32 cotangent against the widened other
operand, rounded once to the operand's dtype.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

__all__ = ["chunked_token_ce"]


class _F32Logits(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, w):
        ctx.save_for_backward(h, w)
        if h.is_cuda and h.dtype in (torch.bfloat16, torch.float16):
            return torch.mm(h, w, out_dtype=torch.float32)
        return h.float() @ w.float()

    @staticmethod
    def backward(ctx, g):
        h, w = ctx.saved_tensors
        dh = (g @ w.float().t()).to(h.dtype)
        dw = (h.float().t() @ g).to(w.dtype)
        return dh, dw


def _chunk_loss(hx, lx, w):
    logits = _F32Logits.apply(hx, w)
    lse = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(1, lx.clamp(min=0)[:, None])[:, 0]
    valid = (lx >= 0).float()
    return ((lse - gold) * valid).sum(), valid.sum()


def chunked_token_ce(h, labels, w, chunk_size, pad_label=-1):
    """Mean CE over valid tokens: h ``[B, L, H]``, labels ``[B, L]`` int
    (negative = ignored), w ``[H, V]`` (the llama lm_head layout)."""
    b, l, hid = h.shape
    n = b * l
    if n == 0:      # seq_len 1 next-token case: no targets exist
        return torch.zeros((), dtype=torch.float32, device=h.device)
    h2 = h.reshape(n, hid)
    lab = labels.reshape(n).long()
    c = min(int(chunk_size), n)
    pad = (-n) % c
    if pad:         # an ignored label pads the tail out of the mean
        h2 = torch.cat([h2, h2.new_zeros((pad, hid))], dim=0)
        lab = torch.cat([lab, lab.new_full((pad,), pad_label)], dim=0)
    total = count = None
    for i in range(0, n + pad, c):
        s, k = checkpoint(_chunk_loss, h2[i:i + c], lab[i:i + c], w,
                          use_reentrant=False)
        total = s if total is None else total + s
        count = k if count is None else count + k
    return total / torch.clamp(count, min=1.0)
