"""Llama-family causal LM: the config, the weight tree and the forward.

Counterpart of ``paddle_tpu/models/llama.py``.  ``LlamaConfig`` is a copy
of the reference dataclass.  ``LlamaForCausalLM`` is an ``nn.Module``
that holds the weights under the reference's parameter names
(``llama.layers.0.self_attn.q_proj.weight`` ...) in the reference's
``[in, out]`` projection layout, initialised from an explicit
``torch.Generator`` the way the reference initialises them (Xavier-
uniform projections, unit-normal embedding, unit norm gains).

``LlamaForCausalLM(input_ids, labels=None)`` is the training forward
(:85-391 of the reference): RMSNorm with its custom backward, the fused
RoPE (K6) on the packed projections where its gate passes, attention
through ``nn.functional.scaled_dot_product_attention`` (the flash
kernels K1-K5), per-layer recompute of the first ``recompute_layers``
layers (under ``recompute_policy``; ``"named"`` tags the attention
output with ``ckpt_name``), and the LM loss — chunked
(``loss_chunk_size``) or over full f32 logits.  Under ``amp.auto_cast``
the model's ops carry the reference's op names (``linear`` for every
projection and the head, ``rope``, ``chunked_lm_loss``; see
``amp/auto_cast.py``).  The parameters require gradients; the serving path
(``models/llama_decode.py``) reads detached views of them under
``no_grad``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from paddle_tpu_torch.amp.auto_cast import amp_op
from paddle_tpu_torch.core.device import resolve_device, torch_dtype
from paddle_tpu_torch.distributed.fleet.recompute import ckpt_name, recompute
from paddle_tpu_torch.nn.functional import (
    linear, rms_norm, scaled_dot_product_attention,
)
from paddle_tpu_torch.ops import fused_rope
from paddle_tpu_torch.ops.chunked_ce import chunked_token_ce

__all__ = ["LlamaConfig", "LlamaForCausalLM"]


@dataclass
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int = 32
    max_position_embeddings: int = 4096
    rms_norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    tie_word_embeddings: bool = False
    dtype: str = "bfloat16"
    use_flash_attention: bool = True
    sep_axis: str | None = None
    recompute: bool = False
    sequence_parallel: bool = False
    loss_chunk_size: int = 0
    recompute_policy: str | None = None
    recompute_layers: int | None = None

    # tiny preset used by tests
    @staticmethod
    def tiny(**kw):
        base = dict(vocab_size=256, hidden_size=64, intermediate_size=128,
                    num_hidden_layers=2, num_attention_heads=4,
                    num_key_value_heads=2, max_position_embeddings=128)
        base.update(kw)
        return LlamaConfig(**base)


def _rope_cos_sin(seq_len, head_dim, theta, dtype, device):
    """The standard (unsigned, half-duplicated) ``[L, D]`` tables, computed
    in f32 and rounded once to ``dtype``."""
    pos = torch.arange(seq_len, dtype=torch.float32, device=device)
    inv = 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                        device=device) / head_dim))
    freqs = torch.outer(pos, inv)                            # [L, D/2]
    emb = torch.cat([freqs, freqs], dim=-1)                  # [L, D]
    return torch.cos(emb).to(dtype), torch.sin(emb).to(dtype)


def _apply_rope(q, k, theta):
    """The plain rotation of ``[B, L, H, D]`` q/k (the reference's jnp
    chain, in the input dtype): the path for shapes the fused RoPE's gate
    refuses."""
    seq_len, head_dim = q.shape[1], q.shape[-1]
    cos, sin = _rope_cos_sin(seq_len, head_dim, theta, q.dtype, q.device)
    cos = cos[None, :, None, :]
    sin = sin[None, :, None, :]

    def rot_half(x):
        x1, x2 = torch.chunk(x, 2, dim=-1)
        return torch.cat([-x2, x1], dim=-1)

    return q * cos + rot_half(q) * sin, k * cos + rot_half(k) * sin


class _Weight(nn.Module):
    """One named ``weight`` parameter — the reference's Linear (``[in,
    out]``, no bias), Embedding and RMSNorm all expose exactly that."""

    def __init__(self, shape, dtype, device):
        super().__init__()
        self.weight = nn.Parameter(
            torch.empty(shape, dtype=dtype, device=device))


class _Attention(nn.Module):
    def __init__(self, cfg, dtype, device):
        super().__init__()
        self.config = cfg
        h, nh, nkv = (cfg.hidden_size, cfg.num_attention_heads,
                      cfg.num_key_value_heads)
        hd = h // nh
        self.head_dim = hd
        self.q_proj = _Weight((h, nh * hd), dtype, device)
        self.k_proj = _Weight((h, nkv * hd), dtype, device)
        self.v_proj = _Weight((h, nkv * hd), dtype, device)
        self.o_proj = _Weight((nh * hd, h), dtype, device)

    def forward(self, x):
        cfg = self.config
        b, l, _ = x.shape
        nh, nkv, hd = (cfg.num_attention_heads, cfg.num_key_value_heads,
                       self.head_dim)
        qp = linear(x, self.q_proj.weight)
        kp = linear(x, self.k_proj.weight)
        vp = linear(x, self.v_proj.weight)
        qp, kp = _rope(qp, kp, nh, nkv, hd, cfg.rope_theta)
        out = scaled_dot_product_attention(
            qp.view(b, l, nh, hd), kp.view(b, l, nkv, hd),
            vp.view(b, l, nkv, hd), is_causal=l > 1)
        if cfg.recompute and cfg.recompute_policy == "named":
            # kept by the "named" policy (the reference's
            # checkpoint_name(out, "ckpt"))
            out = ckpt_name(out)
        return linear(out.reshape(b, l, nh * hd), self.o_proj.weight)


@amp_op("rope")
def _rope(qp, kp, nh, nkv, hd, theta):
    """RoPE on the packed projections: the fused kernel (K6) where its
    gate passes, else the plain rotation."""
    b, l, _ = qp.shape
    if fused_rope.available(qp.shape, kp.shape, nh, nkv):
        cos, sin = _rope_cos_sin(l, hd, theta, qp.dtype, qp.device)
        return fused_rope.fused_rope(qp, kp, cos, sin, nh, nkv)
    q4, k4 = _apply_rope(qp.view(b, l, nh, hd), kp.view(b, l, nkv, hd),
                         theta)
    return q4.reshape(b, l, nh * hd), k4.reshape(b, l, nkv * hd)


class _MLP(nn.Module):
    def __init__(self, cfg, dtype, device):
        super().__init__()
        h, i = cfg.hidden_size, cfg.intermediate_size
        self.gate_proj = _Weight((h, i), dtype, device)
        self.up_proj = _Weight((h, i), dtype, device)
        self.down_proj = _Weight((i, h), dtype, device)

    def forward(self, x):
        return linear(F.silu(linear(x, self.gate_proj.weight))
                      * linear(x, self.up_proj.weight),
                      self.down_proj.weight)


class _DecoderLayer(nn.Module):
    def __init__(self, cfg, dtype, device):
        super().__init__()
        self.eps = cfg.rms_norm_eps
        self.self_attn = _Attention(cfg, dtype, device)
        self.mlp = _MLP(cfg, dtype, device)
        self.input_layernorm = _Weight((cfg.hidden_size,), dtype, device)
        self.post_attention_layernorm = _Weight((cfg.hidden_size,), dtype,
                                                device)

    def forward(self, h):
        h = h + self.self_attn(rms_norm(h, self.input_layernorm.weight,
                                        self.eps))
        return h + self.mlp(rms_norm(h, self.post_attention_layernorm.weight,
                                     self.eps))


class _LlamaModel(nn.Module):
    def __init__(self, cfg, dtype, device):
        super().__init__()
        self.config = cfg
        self.embed_tokens = _Weight((cfg.vocab_size, cfg.hidden_size),
                                    dtype, device)
        self.layers = nn.ModuleList(
            _DecoderLayer(cfg, dtype, device)
            for _ in range(cfg.num_hidden_layers))
        self.norm = _Weight((cfg.hidden_size,), dtype, device)

    def forward(self, input_ids):
        cfg = self.config
        h = F.embedding(input_ids, self.embed_tokens.weight)
        for i, layer in enumerate(self.layers):
            if cfg.recompute and (cfg.recompute_layers is None
                                  or i < cfg.recompute_layers):
                h = recompute(layer, h, policy=cfg.recompute_policy)
            else:
                h = layer(h)
        return rms_norm(h, self.norm.weight, cfg.rms_norm_eps)


@amp_op("chunked_lm_loss")
def _chunked_lm_loss(h, labels, w, chunk_size):
    return chunked_token_ce(h, labels, w, chunk_size)


class LlamaForCausalLM(nn.Module):
    """The Llama weight tree.  ``device=None`` places it on ``cuda``
    (raising without a card); ``generator`` (a ``torch.Generator`` on the
    same device) or ``seed`` makes the random initialisation
    reproducible."""

    def __init__(self, config, device=None, generator=None, seed=0):
        super().__init__()
        if config.sequence_parallel or config.sep_axis is not None:
            raise NotImplementedError(
                "sequence/context parallelism is not ported yet (the "
                "distributed-training slice brings it)")
        self.config = config
        dev = resolve_device(device)
        dtype = torch_dtype(config.dtype)
        self.llama = _LlamaModel(config, dtype, dev)
        if not config.tie_word_embeddings:
            self.lm_head = _Weight((config.hidden_size, config.vocab_size),
                                   dtype, dev)
        if generator is None:
            generator = torch.Generator(device=dev)
            generator.manual_seed(int(seed))
        self._init_weights(generator)

    def _head_weight(self):
        """The ``[hidden, vocab]`` LM-head weight (the transposed embedding
        when tied)."""
        if self.config.tie_word_embeddings:
            return self.llama.embed_tokens.weight.t()
        return self.lm_head.weight

    def forward(self, input_ids, labels=None):
        """Logits ``[B, L, V]`` (model dtype), or with ``labels`` the mean
        next-token cross-entropy (f32 scalar): chunked when
        ``loss_chunk_size > 0``, else over full f32 logits."""
        h = self.llama(input_ids)
        w = self._head_weight()
        if labels is not None and self.config.loss_chunk_size > 0:
            return _chunked_lm_loss(h[:, :-1, :], labels[:, 1:], w,
                                    self.config.loss_chunk_size)
        logits = linear(h, w)
        if labels is None:
            return logits
        b, l, v = logits.shape
        return F.cross_entropy(
            logits[:, :-1, :].float().reshape(b * (l - 1), v),
            labels[:, 1:].reshape(b * (l - 1)).long())

    @torch.no_grad()
    def numpy_state(self):
        """``{name: np.ndarray}`` of every parameter (the reverse of
        ``load_numpy_state``); bfloat16 leaves widen exactly to float32."""
        out = {}
        for name, p in self.named_parameters():
            t = p.detach().cpu()
            if t.dtype == torch.bfloat16:
                t = t.float()
            out[name] = t.numpy().copy()
        return out

    @torch.no_grad()
    def _init_weights(self, gen):
        for name, p in self.named_parameters():
            if name.endswith("norm.weight"):
                p.fill_(1.0)
                continue
            # draw in f32 then round once to the model dtype
            buf = torch.empty(p.shape, dtype=torch.float32, device=p.device)
            if name.endswith("embed_tokens.weight"):
                buf.normal_(0.0, 1.0, generator=gen)
            else:
                fan_in, fan_out = p.shape
                a = math.sqrt(6.0 / (fan_in + fan_out))
                buf.uniform_(-a, a, generator=gen)
            p.copy_(buf)

    def load_numpy_state(self, state):
        """Load weights from the reference's ``Layer.functional_state()``
        (see ``interop.load_module_state``): names one to one, values
        copied in place bit for bit, so cached decode params keep
        aliasing the model."""
        from paddle_tpu_torch.interop import load_module_state

        load_module_state(self, state)
