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

__all__ = ["extract_decode_params", "decode_greedy", "quantize_decode_weights",
           "serving_prefill_chunk", "serving_decode_steps"]

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
                chunk_size=None, block_tables=None, attn_impl=None):
    """One decoder layer over T new tokens: h ``[B, T, hidden]`` -> h'
    (the caches are appended in place)."""
    b, t, _ = h.shape
    nh, nkv, hd, eps = cfg
    x = _rmsnorm(h, lp["ln1"], eps)
    q = _mm(x, lp, "wq").reshape(b, t, nh, hd)
    k = _mm(x, lp, "wk").reshape(b, t, nkv, hd)
    v = _mm(x, lp, "wv").reshape(b, t, nkv, hd)
    positions = lengths[:, None] + torch.arange(t, dtype=torch.int32,
                                                device=h.device)[None, :]
    q, k = _rope_at(q, k, cos_t, sin_t, positions)
    out, _, _, _ = decode_attention(
        q, k, v, k_cache, v_cache, lengths, chunk_size=chunk_size,
        block_table=block_tables, impl=attn_impl)
    h = h + _mm(out.reshape(b, t, nh * hd), lp, "wo")
    x2 = _rmsnorm(h, lp["ln2"], eps)
    return h + _mm(F.silu(_mm(x2, lp, "gate")) * _mm(x2, lp, "up"), lp,
                   "down")


def _lm_logits(params, h):
    if "lm_head" in params:
        return h @ params["lm_head"]
    return h @ params["embed"].T.to(h.dtype)


def _forward(params, cfg, tokens, caches, lengths, last_only, last_idx=None,
             chunk_size=None, block_tables=None, attn_impl=None):
    """tokens ``[B, T]`` -> (logits f32, caches, lengths + T): the last
    position's ``[B, V]`` with ``last_only``, one per-row position with
    ``last_idx [B]``, else every position ``[B, T, V]``.  One
    ``block_tables`` operand serves every layer's pool."""
    h = params["embed"][tokens.long()]
    cos_t, sin_t = params["_rope"]
    lengths = lengths.to(torch.int32)
    for lp, (kc, vc) in zip(params["layers"], caches):
        h = _layer_step(lp, cfg, h, kc, vc, lengths, cos_t, sin_t,
                        chunk_size=chunk_size, block_tables=block_tables,
                        attn_impl=attn_impl)
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
                          program_key=None):
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
    the device."""
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
