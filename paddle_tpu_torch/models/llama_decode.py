"""Step-wise greedy decoding of ``LlamaForCausalLM`` over a static KV cache.

Counterpart of ``paddle_tpu/models/llama_decode.py`` for the serving
path: the weight extraction, the per-layer decode step, the chunked
prefill step and the greedy decode loop, all on plain tensors.  Where
the reference compiled each entry point with ``jax.jit`` and carried a
``lax.scan``, the port runs eagerly: ``serving_decode_steps`` is a Python
loop of ``n_steps`` forward steps, and the caches are updated in place
(the reference donated them).  Attention goes through
``ops/decode_attention.py``, which launches the hand-written kernels for
CUDA tensors (K8 decode, K9 prefill) and runs their plain versions for
CPU tensors.

Speculative decoding (``decode_speculative``, ``serving_spec_step``,
``serving_spec_draft_step``) drafts ``k`` tokens — by prompt lookup in
the slot's token history (``_ngram_draft``) or with a draft model — and
verifies them in ONE ``[B, k+1]`` target forward (``_forward_step_all``;
on the card K8 with ``T = k+1`` query rows a slot); ``_verify_and_emit``
keeps the longest matched prefix plus the target's own pick after it, so
every emitted token is the verify forward's greedy pick.  A rejected
draft costs nothing to undo: the lengths rewind to the accepted prefix
and the stale cache rows past them are masked and later overwritten.

``quantize_decode_weights`` makes the seven projections int8 with one
f16 scale per output channel; ``_mm`` then dequantizes in the matmul,
``(x @ w.to(x.dtype)) * s.to(x.dtype)``: a plain ``torch.matmul``, as
the reference left this product to XLA outside any kernel.

Rounding follows the reference: ``_rmsnorm`` normalises in f32 and
casts to the model dtype BEFORE the gain multiply, the RoPE tables are
in the model dtype, attention runs on f32 queries, and logits are cast
to f32 before the argmax (which returns the first maximal index).  RoPE
table lookups clamp their positions (a parked slot sits at ``lmax``,
where JAX's gather clamps and PyTorch's would fault).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from paddle_tpu_torch.ops.decode_attention import (
    decode_attention, init_kv_cache, slot_prefill_attention,
)

__all__ = ["extract_decode_params", "decode_greedy", "decode_speculative",
           "quantize_decode_weights", "serving_prefill_chunk",
           "serving_decode_steps", "serving_spec_step",
           "serving_spec_draft_step"]

#: the projections ``weight_dtype="int8"`` quantizes; norm gains, the
#: embedding and ``lm_head`` keep the checkpoint dtype
QUANT_WEIGHTS = ("wq", "wk", "wv", "wo", "gate", "up", "down")
_WEIGHT_DTYPES = ("int8",)


def extract_decode_params(model):
    """The ``LlamaForCausalLM`` weights as a plain dict of tensors —
    detached views of the parameters (no copy), in the reference's
    structure: ``embed``, ``norm``, ``layers`` (per-layer ``ln1``, ``ln2``,
    ``wq``, ``wk``, ``wv``, ``wo``, ``gate``, ``up``, ``down``) and
    ``lm_head`` unless the embedding is tied."""
    layers = []
    for blk in model.llama.layers:
        a, m = blk.self_attn, blk.mlp
        layers.append({
            "ln1": blk.input_layernorm.weight.detach(),
            "ln2": blk.post_attention_layernorm.weight.detach(),
            "wq": a.q_proj.weight.detach(), "wk": a.k_proj.weight.detach(),
            "wv": a.v_proj.weight.detach(), "wo": a.o_proj.weight.detach(),
            "gate": m.gate_proj.weight.detach(),
            "up": m.up_proj.weight.detach(),
            "down": m.down_proj.weight.detach(),
        })
    p = {"embed": model.llama.embed_tokens.weight.detach(),
         "norm": model.llama.norm.weight.detach(), "layers": layers}
    if not model.config.tie_word_embeddings:
        p["lm_head"] = model.lm_head.weight.detach()
    return p


def canon_weight_dtype(dtype, where):
    """Validate a decode-weight quantization dtype: ``None`` (off) or
    ``"int8"``; anything else is a ValueError."""
    if dtype is not None and str(dtype) not in _WEIGHT_DTYPES:
        raise ValueError(f"{where}: unsupported decode weight dtype "
                         f"{dtype!r} — supported: None, "
                         f"{', '.join(_WEIGHT_DTYPES)}")
    return None if dtype is None else str(dtype)


def quantize_decode_weights(params, weight_dtype="int8"):
    """The seven projections as int8 with symmetric per-OUTPUT-channel
    f16 absmax scales.  Returns a NEW params dict (fresh top level,
    layers list and per-layer dicts; the input — typically the model's
    cached params — is never mutated): each ``lp[name] [in, out]``
    becomes int8 codes plus ``lp[name + "_scale"]`` f16 ``[out]``.  The
    recipe is the KV cache's over the input axis, with ``amax / 127``
    divided as the reference engine runs it (eagerly, at construction):
    ``scale = f16(amax / 127)``, codes ``clip(round(w / f32(scale)),
    ±127)`` through the reciprocal of the f16 scale."""
    if canon_weight_dtype(weight_dtype, "quantize_decode_weights") is None:
        return params

    def quant(w):
        wf = w.float()
        amax = wf.abs().amax(dim=0)
        # a device tensor divisor: PyTorch's CUDA kernels would multiply
        # by the reciprocal of a Python-scalar divisor
        scale = (amax / amax.new_tensor(127.0)).to(torch.float16)
        inv = 1.0 / torch.clamp(scale.float(), min=1e-8)
        q = torch.clamp(torch.round(wf * inv[None, :]), -127.0, 127.0)
        return q.to(torch.int8), scale

    out = dict(params)
    layers = []
    for lp in params["layers"]:
        nlp = dict(lp)
        for name in QUANT_WEIGHTS:
            nlp[name], nlp[name + "_scale"] = quant(lp[name])
        layers.append(nlp)
    out["layers"] = layers
    return out


def _mm(x, lp, name):
    """``x @ lp[name]``; with a sibling ``name + "_scale"`` (int8 weights)
    the codes cast into the activation dtype (exact: |code| <= 127) and
    the per-output-channel scale multiplies the product."""
    w = lp[name]
    s = lp.get(name + "_scale")
    if s is None:
        return x @ w
    return (x @ w.to(x.dtype)) * s.to(x.dtype)


def _rmsnorm(x, w, eps):
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * w


def _rope_tables(lmax, d, theta, dtype, device):
    pos = torch.arange(lmax, dtype=torch.float32, device=device)
    inv = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                        device=device) / d))
    freqs = torch.outer(pos, inv)
    emb = torch.cat([freqs, freqs], dim=-1)                   # [Lmax, D]
    return torch.cos(emb).to(dtype), torch.sin(emb).to(dtype)


def _rope_at(q, k, cos_t, sin_t, positions):
    """Per-batch rope: ``positions [B, T]`` index the tables (clamped —
    parked slots sit at ``lmax``), half-rotate convention."""
    idx = positions.clamp(0, cos_t.shape[0] - 1).long()
    cos = cos_t[idx][:, :, None, :]                          # [B, T, 1, D]
    sin = sin_t[idx][:, :, None, :]

    def rot_half(x):
        x1, x2 = torch.chunk(x, 2, dim=-1)
        return torch.cat([-x2, x1], dim=-1)

    return q * cos + rot_half(q) * sin, k * cos + rot_half(k) * sin


def _pk_axis(program_key, name):
    return getattr(program_key, name, None) if program_key is not None \
        else None


def _layer_step(lp, cfg, h, k_cache, v_cache, lengths, cos_t, sin_t,
                chunk_size=None, block_tables=None, attn_impl=None,
                pos_offsets=None, hidden=None):
    """One decoder layer over T new tokens: h ``[B, T, hidden]`` -> h'
    (the caches are appended in place).

    ``pos_offsets [T]`` (int32) rotates token ``i`` as if it sat at
    ``lengths + pos_offsets[i]`` instead of ``lengths + i`` — the
    tree-verify seam, where a branch token appended at row ``lengths + T
    - 1`` stands at the branch point.  Cache append rows and the causal
    window stay sequential; ``hidden [B, T, 2]`` carves a key range out
    of that window per query (``decode_attention``).  Both default to
    None, the linear path."""
    b, t, _ = h.shape
    nh, nkv, hd, eps = cfg
    x = _rmsnorm(h, lp["ln1"], eps)
    q = _mm(x, lp, "wq").reshape(b, t, nh, hd)
    k = _mm(x, lp, "wk").reshape(b, t, nkv, hd)
    v = _mm(x, lp, "wv").reshape(b, t, nkv, hd)
    offs = (torch.arange(t, dtype=torch.int32, device=h.device)
            if pos_offsets is None else pos_offsets.to(torch.int32))
    positions = lengths[:, None] + offs[None, :]
    q, k = _rope_at(q, k, cos_t, sin_t, positions)
    out, _, _, _ = decode_attention(
        q, k, v, k_cache, v_cache, lengths, chunk_size=chunk_size,
        block_table=block_tables, impl=attn_impl, hidden=hidden)
    h = h + _mm(out.reshape(b, t, nh * hd), lp, "wo")
    x2 = _rmsnorm(h, lp["ln2"], eps)
    return h + _mm(F.silu(_mm(x2, lp, "gate")) * _mm(x2, lp, "up"), lp,
                   "down")


def _lm_logits(params, h):
    if "lm_head" in params:
        return h @ params["lm_head"]
    return h @ params["embed"].T.to(h.dtype)


def _forward(params, cfg, tokens, caches, lengths, last_only, last_idx=None,
             chunk_size=None, block_tables=None, attn_impl=None,
             pos_offsets=None, hidden=None):
    """tokens ``[B, T]`` -> (logits f32, caches, lengths + T): the last
    position's ``[B, V]`` with ``last_only``, one per-row position with
    ``last_idx [B]``, else every position ``[B, T, V]``.  One
    ``block_tables`` operand serves every layer's pool; ``pos_offsets``
    and ``hidden`` reach every layer (``_layer_step``)."""
    h = params["embed"][tokens.long()]
    cos_t, sin_t = params["_rope"]
    lengths = lengths.to(torch.int32)
    for lp, (kc, vc) in zip(params["layers"], caches):
        h = _layer_step(lp, cfg, h, kc, vc, lengths, cos_t, sin_t,
                        chunk_size=chunk_size, block_tables=block_tables,
                        attn_impl=attn_impl, pos_offsets=pos_offsets,
                        hidden=hidden)
    h = _rmsnorm(h, params["norm"], cfg[3])
    if last_idx is not None:
        rows = torch.arange(h.shape[0], device=h.device)
        h = h[rows, last_idx.long().clamp(0, h.shape[1] - 1)]
    elif last_only:
        h = h[:, -1]
    logits = _lm_logits(params, h)
    return logits.float(), caches, lengths + tokens.shape[1]


def _forward_step(params, cfg, tokens, caches, lengths, chunk_size=None,
                  block_tables=None, attn_impl=None):
    """tokens ``[B, T]`` -> (logits_last ``[B, V]``, caches, lengths + T)."""
    return _forward(params, cfg, tokens, caches, lengths, last_only=True,
                    chunk_size=chunk_size, block_tables=block_tables,
                    attn_impl=attn_impl)


def _forward_step_all(params, cfg, tokens, caches, lengths, chunk_size=None,
                      block_tables=None, attn_impl=None, pos_offsets=None,
                      hidden=None):
    """tokens ``[B, T]`` -> (logits f32 of EVERY position ``[B, T, V]``,
    caches, lengths + T): the verify pass of speculative decoding needs
    the target's next-token choice after each drafted token (the tree
    verify passes ``pos_offsets`` and ``hidden``)."""
    return _forward(params, cfg, tokens, caches, lengths, last_only=False,
                    chunk_size=chunk_size, block_tables=block_tables,
                    attn_impl=attn_impl, pos_offsets=pos_offsets,
                    hidden=hidden)


def _set_cols(buf, cols, values, valid):
    """``buf[b, cols[b, t]] = values[b, t]`` in place where ``valid`` —
    the reference's ``.at[...].set(mode="drop")`` on a ``[B, L]`` int
    buffer, without a host sync.  ``cols`` must increase along ``t`` (a
    run of consecutive columns per row).  An invalid in-range entry
    writes its column's current value back; an out-of-range one is
    re-pointed at the row's first column with that column's value, so
    duplicate indices always carry identical values and the result does
    not depend on the order ``scatter_`` applies them."""
    span = buf.shape[1]
    old = torch.gather(buf, 1, cols.clamp(0, span - 1).long())
    vals = torch.where(valid, values.to(buf.dtype), old)
    inb = (cols >= 0) & (cols < span)
    tgt = torch.where(inb, cols, cols[:, :1].clamp(0, span - 1))
    vals = torch.where(inb, vals, vals[:, :1])
    buf.scatter_(1, tgt.long(), vals)
    return buf


def _verify_and_emit(logits, drafts, n_out, out, max_new_tokens, spec_k):
    """Acceptance shared by every speculative loop: greedy picks at every
    verified position of ``logits [B, k+1, V]``, the longest matched
    draft prefix ``j`` (cumulative product of the matches), and the
    emitted block (d1..dj, the target's pick at j) written into ``out
    [B, max_new_tokens]`` (in place) at per-row offsets ``n_out``;
    columns at or past ``max_new_tokens`` drop.  Returns (out, cur' —
    the pick at j —, j, emit [B, k+1]), all int32."""
    b = drafts.shape[0]
    dev = drafts.device
    picks = torch.argmax(logits, dim=-1).to(torch.int32)      # [B, k+1]
    match = picks[:, :spec_k] == drafts                       # [B, k]
    j = torch.cumprod(match.to(torch.int32), dim=1).sum(
        dim=1, dtype=torch.int32)                             # [B] 0..k
    ar = torch.arange(spec_k + 1, dtype=torch.int32, device=dev)[None, :]
    bonus = torch.gather(picks, 1, j[:, None].long())         # [B, 1]
    emit = torch.where(
        ar < j[:, None],
        torch.cat([drafts.to(torch.int32),
                   torch.zeros((b, 1), dtype=torch.int32, device=dev)], 1),
        bonus)                                                # [B, k+1]
    cols = n_out.to(torch.int32)[:, None] + ar
    valid = (ar <= j[:, None]) & (cols < max_new_tokens)
    _set_cols(out, cols, emit, valid)
    return out, bonus[:, 0], j, emit


def _ngram_draft(hist, hist_len, cur, spec_k):
    """Model-free prompt-lookup draft: the ``spec_k`` tokens that followed
    the most recent earlier occurrence of ``cur`` in each row's history
    (``hist [B, lmax]`` int32, valid to ``hist_len [B]``); a miss drafts
    from position 0 — a bad draft only costs speed, never output."""
    lmax = hist.shape[1]
    dev = hist.device
    pos = torch.arange(lmax, dtype=torch.int32, device=dev)[None, :]
    eq = (hist == cur.to(torch.int32)[:, None]) \
        & (pos < (hist_len.to(torch.int32) - 1)[:, None])
    m = torch.where(eq, pos, torch.full_like(pos, -1)).amax(dim=1)  # [B]
    start = torch.where(m >= 0, m + 1, torch.zeros_like(m))
    idx = (start[:, None] + torch.arange(spec_k, dtype=torch.int32,
                                         device=dev)[None, :])
    return torch.gather(hist, 1, idx.clamp(0, lmax - 1).long())   # [B, k]


def _layer_prefill_chunk(lp, cfg, h, k_cache, v_cache, slot, offset, cos_t,
                         sin_t, chunk_size=None, block_tables=None,
                         prefill_impl=None):
    """One decoder layer over a ``[1, P]`` prompt chunk written to (and
    read from) the slot's rows of the batch cache."""
    b, t, _ = h.shape
    nh, nkv, hd, eps = cfg
    x = _rmsnorm(h, lp["ln1"], eps)
    q = _mm(x, lp, "wq").reshape(b, t, nh, hd)
    k = _mm(x, lp, "wk").reshape(b, t, nkv, hd)
    v = _mm(x, lp, "wv").reshape(b, t, nkv, hd)
    positions = offset + torch.arange(t, dtype=torch.int32,
                                      device=h.device)[None, :]
    q, k = _rope_at(q, k, cos_t, sin_t, positions)
    out, _, _ = slot_prefill_attention(
        q, k, v, k_cache, v_cache, slot, offset, chunk_size=chunk_size,
        block_table=block_tables, impl=prefill_impl)
    h = h + _mm(out.reshape(b, t, nh * hd), lp, "wo")
    x2 = _rmsnorm(h, lp["ln2"], eps)
    return h + _mm(F.silu(_mm(x2, lp, "gate")) * _mm(x2, lp, "up"), lp,
                   "down")


def serving_prefill_chunk(params, cfg, tokens, offset, prompt_len, caches,
                          slot, chunk_size=None, block_tables=None,
                          program_key=None, hist=None, hist_len=None):
    """Process the next ``[1, P]`` chunk of an admitted prompt against
    slot ``slot``'s rows of the batch cache (appended in place).

    ``offset`` (host int) is the write cursor — chunk rows land at cache
    positions ``offset + i`` — and ``prompt_len`` (host int) the prompt's
    true length; tail pads past it write garbage rows that are causally
    invisible and overwritten by decode appends.  Every chunk picks the
    greedy token at the prompt's last column relative to itself
    (``clamp(prompt_len - 1 - offset, 0, P - 1)``); only the final
    chunk's pick is the request's first token.  Returns ``(first [1],
    ok [1] — all logits finite —, caches)``, ``first`` and ``ok`` left on
    the device.

    With ``hist [B, lmax]`` / ``hist_len [B]`` (int32, on the device; the
    prompt-lookup history) the slot's row accretes in place: the chunk's
    tokens at ``offset + i`` (columns past ``lmax`` drop) and, on the
    final chunk (``offset + P >= prompt_len``), the first token at
    ``prompt_len`` with ``hist_len[slot] = prompt_len + 1``.  Columns
    past ``hist_len`` may hold a prior occupant's tokens:
    ``_ngram_draft`` masks its scan by ``hist_len``, and a stale draft
    only costs acceptance."""
    t = tokens.shape[1]
    nh, nkv, hd, eps = cfg
    offset, slot = int(offset), int(slot)
    h = params["embed"][tokens.long()]                        # [1, P, hidden]
    cos_t, sin_t = params["_rope"]
    for lp, (kc, vc) in zip(params["layers"], caches):
        h = _layer_prefill_chunk(
            lp, cfg, h, kc, vc, slot, offset, cos_t, sin_t,
            chunk_size=chunk_size, block_tables=block_tables,
            prefill_impl=_pk_axis(program_key, "prefill_impl"))
    h = _rmsnorm(h, params["norm"], eps)
    last_rel = min(max(int(prompt_len) - 1 - offset, 0), t - 1)
    logits = _lm_logits(params, h[:, last_rel]).float()
    first = torch.argmax(logits, dim=-1).to(torch.int32)      # [1]
    ok = torch.isfinite(logits).all(dim=-1)                   # [1]
    if hist is not None:
        lmax = hist.shape[1]
        n = max(0, min(t, lmax - offset))
        if n:
            hist[slot, offset:offset + n] = tokens[0, :n].to(torch.int32)
        if offset + t >= int(prompt_len):
            hist[slot, min(max(int(prompt_len), 0), lmax - 1)] = first[0]
            hist_len[slot] = int(prompt_len) + 1
    return first, ok, caches


def serving_decode_steps(params, cfg, cur, caches, dev_lengths, n_steps=1,
                         chunk_size=None, block_tables=None,
                         program_key=None):
    """``n_steps`` greedy tokens for every slot (a Python loop where the
    reference ran a ``lax.scan``).  Slots parked at offset ``lmax`` drop
    every cache write and read one chunk.  Returns ``(tokens [B,
    n_steps] int32, ok [B] — every step's logits finite for that slot —,
    caches)``, all left on the device."""
    tok = cur.to(torch.int32)
    lengths = dev_lengths.to(torch.int32)
    ok = torch.ones(tok.shape, dtype=torch.bool, device=tok.device)
    toks = []
    for _ in range(int(n_steps)):
        logits, caches, lengths = _forward_step(
            params, cfg, tok[:, None], caches, lengths,
            chunk_size=chunk_size, block_tables=block_tables,
            attn_impl=_pk_axis(program_key, "attn_impl"))
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
        ok = ok & torch.isfinite(logits).all(dim=-1)
        toks.append(tok)
    return torch.stack(toks, dim=1), ok, caches


def _spec_round_out(logits, drafts, dev_lengths, active, spec_k):
    """The verify half of one serving round: ``(emitted [B, k+1] — the
    j+1 accepted tokens, zero-padded —, j, cur', new_len, ok, emit)``;
    ``new_len = dev_lengths + j + 1`` for live slots, untouched for dead
    ones."""
    b = drafts.shape[0]
    dev = drafts.device
    ok = torch.isfinite(logits).all(dim=-1).all(dim=-1)       # [B]
    emitted, cur, j, emit = _verify_and_emit(
        logits, drafts, torch.zeros((b,), dtype=torch.int32, device=dev),
        torch.zeros((b, spec_k + 1), dtype=torch.int32, device=dev),
        spec_k + 1, spec_k)
    step = torch.where(active, j + 1, torch.zeros_like(j))
    return emitted, j, cur, dev_lengths + step, ok, emit, step


def serving_spec_step(params, cfg, cur, caches, dev_lengths, hist, hist_len,
                      active, spec_k=4, chunk_size=None, block_tables=None,
                      program_key=None):
    """One prompt-lookup speculative round per slot: draft ``spec_k``
    tokens from the history (``_ngram_draft``), verify them in one ``[B,
    k+1]`` target forward, accept the longest matched prefix
    (``_verify_and_emit``).  Emission is exactly the verify forward's own
    greedy picks; agreement with the 1-token step holds up to
    floating-point near-ties between the two forward shapes.  The
    history (``hist [B, lmax]``, ``hist_len [B]``, int32) takes the
    accepted tokens in place; dead slots (``active`` False, parked at
    ``lmax``) drop their cache AND history writes.  Returns ``(emitted
    [B, k+1], j [B], cur' [B], new_len [B] — dev_lengths + j + 1 for live
    slots, the carry a pipelined engine feeds into the next dispatch
    without a host sync —, ok [B] — the verify logits finite)``, all left
    on the device."""
    lmax = hist.shape[1]
    cur = cur.to(torch.int32)
    dev_lengths = dev_lengths.to(torch.int32)
    drafts = _ngram_draft(hist, hist_len, cur, spec_k)
    toks = torch.cat([cur[:, None], drafts], dim=1)           # [B, k+1]
    logits, caches, _ = _forward_step_all(
        params, cfg, toks, caches, dev_lengths, chunk_size=chunk_size,
        block_tables=block_tables,
        attn_impl=_pk_axis(program_key, "attn_impl"))
    emitted, j, cur2, new_len, ok, emit, step = _spec_round_out(
        logits, drafts, dev_lengths, active, spec_k)
    ar = torch.arange(spec_k + 1, dtype=torch.int32, device=cur.device)
    hcols = hist_len[:, None] + ar[None, :]
    hvalid = (ar[None, :] <= j[:, None]) & (hcols < lmax) & active[:, None]
    _set_cols(hist, hcols, emit, hvalid)
    hist_len += step
    return emitted, j, cur2, new_len, ok


def _second_choice(logits, first):
    """The index of each row's second-largest logit — ``jax.lax.top_k``'s
    second index, ties to the lower index (``torch.topk`` promises no
    order on ties): the argmax with the first pick masked out."""
    masked = logits.scatter(1, first[:, None].long(), float("-inf"))
    return torch.argmax(masked, dim=-1).to(torch.int32)


def _tree_verify_operands(dlen, spec_k):
    """``(pos_offsets [k+2], hidden [B, k+2, 2])`` of the top-2 tree
    verify over ``(cur, d1..dk, alt1)`` at rows ``dlen .. dlen+k+1``: the
    branch token (last row) is rotated for ``dlen + 1`` and does not see
    the linear chain, rows ``[dlen+1, dlen+k+1)``; every other row hides
    nothing."""
    dev = dlen.device
    pos = torch.cat([torch.arange(spec_k + 1, dtype=torch.int32, device=dev),
                     torch.ones((1,), dtype=torch.int32, device=dev)])
    hidden = torch.zeros((dlen.shape[0], spec_k + 2, 2), dtype=torch.int32,
                         device=dev)
    hidden[:, spec_k + 1, 0] = dlen + 1
    hidden[:, spec_k + 1, 1] = dlen + (spec_k + 1)
    return pos, hidden


def _repair_branch_rows(caches, dlen, br, spec_k):
    """Accepted branch: copy each dense cache's row ``dlen + k + 1`` (the
    branch token's K/V, already rotated for ``dlen + 1``) into row ``dlen
    + 1`` of the slots in ``br``, in place (an int8 cache: its codes and
    its scales); the other slots' writes drop past capacity."""
    from paddle_tpu_torch.ops.decode_attention import _write_rows, kv_data

    lmax = kv_data(caches[0][0]).shape[1]
    rows = torch.arange(dlen.shape[0], device=dlen.device)
    src = (dlen + (spec_k + 1)).clamp(0, lmax - 1).long()
    dst = torch.where(br, dlen + 1, torch.full_like(dlen, lmax))
    leaves = [(leaf, leaf[rows, src][:, None])
              for kc, vc in caches for c in (kc, vc)
              for leaf in (c if isinstance(c, tuple) else (c,))]
    _write_rows(leaves, dst)


def serving_spec_draft_step(params, dparams, cfg, dcfg, cur, caches, dcaches,
                            dev_lengths, active, spec_k=4, chunk_size=None,
                            block_tables=None, draft_tables=None,
                            program_key=None, branch_count=None):
    """One DRAFT-MODEL speculative round per slot: the draft model runs
    ``spec_k + 1`` one-token steps (the last only fills its cache for the
    full-acceptance case), the target verifies the ``spec_k`` candidates
    in one ``[B, k+1]`` forward, and the longest matched prefix is
    accepted — emission is always the verify forward's own greedy picks.

    ``dcaches=None`` is the PAGED layout: draft layer ``l`` reads and
    writes target layer ``l``'s pool arrays through ``draft_tables [B,
    W]`` (the manager hands the draft chain its own blocks).  A list is
    the DENSE layout: separate per-draft-layer ``[B, Lmax]`` caches.
    Both models append from the same ``dev_lengths``, so one rewind
    ``new_len = dev_lengths + j + 1`` serves both.

    ``program_key.spec_tree == "top2"`` (dense caches only) verifies a
    second branch in the same forward: the draft's second choice at the
    first position, ``alt1``, rides as a last token at row ``L+k+1``,
    rotated for ``L+1`` and hiding the linear chain ``L+1 .. L+k``
    (``_tree_verify_operands``; on the card K8 with the hidden range), a
    ``[B, k+2]`` verify.  When the chain rejects at once but the target's
    pick is ``alt1``, the round emits ``(alt1, bonus)`` with ``j = 1`` and
    the branch row's K/V moves to row ``L+1`` (``_repair_branch_rows``).
    The draft cache keeps its rejected row (draft KV only moves the
    accept rate).  ``branch_count`` (optional int64 ``[1]`` on the
    device) adds up the slots whose branch was taken, in place, without
    a host read.  Returns the same 5-tuple as ``serving_spec_step``."""
    tree = _pk_axis(program_key, "spec_tree") == "top2"
    paged = dcaches is None
    if tree and (paged or block_tables is not None):
        raise ValueError(
            "serving_spec_draft_step: spec_tree='top2' requires dense "
            "caches — the branch-row repair copies dense cache rows")
    dc = caches if paged else dcaches
    cur = cur.to(torch.int32)
    dlen = dev_lengths.to(torch.int32)
    attn_impl = _pk_axis(program_key, "attn_impl")
    tok, dl, seq, alt1 = cur, dlen, [], None
    for i in range(int(spec_k) + 1):
        dlg, _, dl = _forward_step(
            dparams, dcfg, tok[:, None], dc, dl, chunk_size=chunk_size,
            block_tables=draft_tables if paged else None,
            attn_impl=attn_impl)
        tok = torch.argmax(dlg, dim=-1).to(torch.int32)
        if tree and i == 0:
            alt1 = _second_choice(dlg, tok)
        seq.append(tok)
    drafts = torch.stack(seq[:spec_k], dim=1)                 # [B, k]
    if not tree:
        toks = torch.cat([cur[:, None], drafts], dim=1)       # [B, k+1]
        logits, caches, _ = _forward_step_all(
            params, cfg, toks, caches, dlen, chunk_size=chunk_size,
            block_tables=block_tables, attn_impl=attn_impl)
        emitted, j, cur2, new_len, ok, _, _ = _spec_round_out(
            logits, drafts, dlen, active, spec_k)
        return emitted, j, cur2, new_len, ok
    toks = torch.cat([cur[:, None], drafts, alt1[:, None]], dim=1)  # k+2
    pos, hidden = _tree_verify_operands(dlen, spec_k)
    logits, caches, _ = _forward_step_all(
        params, cfg, toks, caches, dlen, chunk_size=chunk_size,
        attn_impl=attn_impl, pos_offsets=pos, hidden=hidden)
    emitted, j, cur2, _, _, _, _ = _spec_round_out(
        logits[:, :spec_k + 1], drafts, dlen, active, spec_k)
    ok = torch.isfinite(logits).all(dim=-1).all(dim=-1)       # [B]
    picks0 = torch.argmax(logits[:, 0], dim=-1).to(torch.int32)
    bonus = torch.argmax(logits[:, spec_k + 1], dim=-1).to(torch.int32)
    br = (j == 0) & (picks0 == alt1) & active
    btok = torch.cat([alt1[:, None], bonus[:, None],
                      torch.zeros((cur.shape[0], spec_k - 1),
                                  dtype=torch.int32, device=cur.device)], 1)
    emitted = torch.where(br[:, None], btok, emitted)
    j = torch.where(br, torch.ones_like(j), j)
    cur2 = torch.where(br, bonus, cur2)
    _repair_branch_rows(caches, dlen, br, spec_k)
    if branch_count is not None:
        branch_count += br.sum()
    new_len = dlen + torch.where(active, j + 1, torch.zeros_like(j))
    return emitted, j, cur2, new_len, ok


def _decode_params_of(model, lmax):
    """(params incl. the ``_rope`` tables for ``lmax``, cfg tuple), cached
    on the model while its embedding tensor and ``lmax`` are unchanged
    (weights loaded in place keep the cache valid: the params alias the
    parameters)."""
    cfg = model.config
    hd = cfg.hidden_size // cfg.num_attention_heads
    live_w = model.llama.embed_tokens.weight
    cached = getattr(model, "_decode_cache", None)
    if cached is not None and cached[0] is live_w and cached[1] == lmax:
        params = cached[2]
    else:
        params = dict(extract_decode_params(model))
        params["_rope"] = _rope_tables(lmax, hd, cfg.rope_theta,
                                       live_w.dtype, live_w.device)
        model._decode_cache = (live_w, lmax, params)
    return params, (cfg.num_attention_heads, cfg.num_key_value_heads, hd,
                    cfg.rms_norm_eps)


@torch.no_grad()
def decode_greedy(model, input_ids, max_new_tokens=32, max_len=None,
                  chunk_size=None, impl=None):
    """Greedy-decode ``max_new_tokens`` tokens for a batch of equal-length
    prompts ``input_ids [B, prompt_len]`` on a dense cache; returns
    ``[B, max_new_tokens]`` int32.  Runs on the model's device: the whole
    prompt goes through one forward step, then one step per token.  On
    the card the attention read is the K8 kernel, which needs
    ``chunk_size`` dividing ``max_len``; ``chunk_size=None`` (the
    reference's default full read) is for the plain version."""
    dev = model.llama.embed_tokens.weight.device
    ids = torch.as_tensor(input_ids, device=dev).to(torch.int32)
    b, prompt_len = ids.shape
    lmax = int(max_len if max_len is not None
               else prompt_len + max_new_tokens)
    params, cfg = _decode_params_of(model, lmax)
    nh, nkv, hd, eps = cfg
    caches = [init_kv_cache(b, lmax, nkv, hd, params["embed"].dtype, dev)
              for _ in params["layers"]]
    lengths = torch.zeros((b,), dtype=torch.int32, device=dev)
    logits, caches, lengths = _forward_step(
        params, cfg, ids, caches, lengths, chunk_size=chunk_size,
        attn_impl=impl)
    out = [torch.argmax(logits, dim=-1).to(torch.int32)]
    for _ in range(1, int(max_new_tokens)):
        logits, caches, lengths = _forward_step(
            params, cfg, out[-1][:, None], caches, lengths,
            chunk_size=chunk_size, attn_impl=impl)
        out.append(torch.argmax(logits, dim=-1).to(torch.int32))
    return torch.stack(out, dim=1)


@torch.no_grad()
def decode_speculative(model, draft_model=None, input_ids=None,
                       max_new_tokens=32, max_len=None, spec_k=4,
                       chunk_size=None, impl=None):
    """Lossless speculative greedy decoding of a batch of equal-length
    prompts ``input_ids [B, prompt_len]``; returns ``[B, max_new_tokens]``
    int32.  ``draft_model`` (same vocabulary, any smaller config)
    proposes ``spec_k`` tokens a round; ``draft_model=None`` drafts by
    prompt lookup (the tokens that followed the most recent earlier
    occurrence of the current token in the prompt + generated history).
    The target verifies a round's drafts in one forward and keeps the
    longest matching prefix plus its own next pick, so every emitted
    token is the argmax of a target logit vector: the output equals
    ``decode_greedy``'s up to near-ties between the 1-token and
    (k+1)-token forwards.  A bad draft only costs speed.

    Where the reference runs the rounds in one ``lax.while_loop``, this
    is a Python loop that reads one flag per round from the device (are
    all rows done).  ``chunk_size`` / ``impl`` are ``decode_greedy``'s:
    on the card the attention read is K8, which needs ``chunk_size``
    dividing ``max_len``."""
    if draft_model is not None and not hasattr(draft_model, "config"):
        raise TypeError(
            "decode_speculative: draft_model must be a LlamaForCausalLM "
            f"or None (got {type(draft_model).__name__}) — did you mean "
            "decode_speculative(model, None, input_ids)?")
    if input_ids is None:
        raise ValueError(
            "decode_speculative: input_ids is required — note the "
            "signature is (model, draft_model, input_ids, ...); pass "
            "draft_model=None for model-free prompt-lookup drafting")
    if draft_model is not None and \
            model.config.vocab_size != draft_model.config.vocab_size:
        raise ValueError("speculative decoding requires a shared vocabulary")
    dev = model.llama.embed_tokens.weight.device
    ids = torch.as_tensor(input_ids, device=dev).to(torch.int32)
    b, prompt_len = ids.shape
    k, max_new = int(spec_k), int(max_new_tokens)
    need = prompt_len + max_new + k + 1
    if max_len is not None and int(max_len) < need:
        # the verify forward writes k+1 cache rows before the rewind; an
        # undersized cache would drop writes and break losslessness
        raise ValueError(
            f"decode_speculative: max_len={max_len} < {need} "
            f"(prompt + max_new_tokens + spec_k + 1); the verification "
            "forward needs spec_k+1 rows of headroom past the last token")
    lmax = int(max_len if max_len is not None else need + 1)
    params, cfg = _decode_params_of(model, lmax)

    def new_caches(p, c):
        return [init_kv_cache(b, lmax, c[1], c[2], p["embed"].dtype, dev)
                for _ in p["layers"]]

    fwd = dict(chunk_size=chunk_size, attn_impl=impl)
    caches = new_caches(params, cfg)
    lengths = torch.zeros((b,), dtype=torch.int32, device=dev)
    logits, caches, lengths = _forward_step(params, cfg, ids, caches,
                                            lengths, **fwd)
    cur = torch.argmax(logits, dim=-1).to(torch.int32)
    if draft_model is not None:
        dparams, dcfg = _decode_params_of(draft_model, lmax)
        dcaches = new_caches(dparams, dcfg)
        _, dcaches, dlengths = _forward_step(
            dparams, dcfg, ids, dcaches,
            torch.zeros((b,), dtype=torch.int32, device=dev), **fwd)
    else:
        hist = torch.zeros((b, lmax), dtype=torch.int32, device=dev)
        hist[:, :prompt_len] = ids
        hist[:, prompt_len] = cur
        hist_len = torch.full((b,), prompt_len + 1, dtype=torch.int32,
                              device=dev)
    out = torch.zeros((b, max_new), dtype=torch.int32, device=dev)
    out[:, 0] = cur
    n_out = torch.ones((b,), dtype=torch.int32, device=dev)
    ar = torch.arange(k + 1, dtype=torch.int32, device=dev)[None, :]
    while bool((n_out < max_new).any()):      # one host read a round
        if draft_model is not None:
            tok, seq = cur, []
            for _ in range(k + 1):
                dl, dcaches, dlengths = _forward_step(
                    dparams, dcfg, tok[:, None], dcaches, dlengths, **fwd)
                tok = torch.argmax(dl, dim=-1).to(torch.int32)
                seq.append(tok)
            drafts = torch.stack(seq[:k], dim=1)
        else:
            drafts = _ngram_draft(hist, hist_len, cur, k)
        toks = torch.cat([cur[:, None], drafts], dim=1)
        logits, caches, lengths = _forward_step_all(
            params, cfg, toks, caches, lengths, **fwd)
        out, cur, j, emit = _verify_and_emit(logits, drafts, n_out, out,
                                             max_new, k)
        if draft_model is not None:
            dlengths = dlengths + j - k
        else:
            hcols = hist_len[:, None] + ar
            _set_cols(hist, hcols, emit, (ar <= j[:, None]) & (hcols < lmax))
            hist_len = hist_len + j + 1
        # rewind to the accepted prefix: -(k+1) + (j+1)
        lengths = lengths + j - k
        n_out = n_out + j + 1
    return out
