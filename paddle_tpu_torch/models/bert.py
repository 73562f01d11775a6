"""BERT/ERNIE masked-LM encoder.

Counterpart of ``paddle_tpu/models/bert.py``.  ``BertConfig`` is a copy
of the reference dataclass.  The modules hold their weights under the
reference's parameter names (``bert.encoder.0.attention.q_proj.weight``
...) in its ``[in, out]`` projection layout, initialised from an
explicit ``torch.Generator`` with the reference's initialisers
(``nn/layer.py``); a model whose ``dtype`` is not float32 is drawn in f32
and rounded once, as the reference's ``Layer.to(dtype=...)`` does.

The encoder is post-LN: LayerNorm with its custom backward, three
attention projections with bias, ``scaled_dot_product_attention`` with
``is_causal=False`` — a float or int ``attention_mask`` ``[B, L]``
becomes a boolean key-padding mask, which the flash path lowers onto the
segment-masked kernels (K1/K2, K4, K5) — and an exact-erf GELU FFN.
The task heads (``BertForMaskedLM``'s ``transform`` and
``transform_norm``, ``BertForSequenceClassification``'s ``classifier``)
stay float32 whatever ``dtype`` is, as in the reference, whose
``Layer.to`` converts only the encoder: a bf16 model's hidden states
enter the head and the masked-LM loss in f32.
``BertForMaskedLM`` returns the chunked masked-LM loss
(``ops/chunked_ce.py`` over the tied ``[V, H]`` word embedding, labels
-100 ignored) when ``return_logits=False``, else the dense head's logits
and their cross-entropy.  Dropout draws from the model's own generator
(``dropout_generator``), made from ``seed + 1`` on the model's device.
``ErnieConfig``/``ErnieModel``/``ErnieForMaskedLM``/
``ErnieForSequenceClassification`` alias the BERT classes, as in the
reference.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from paddle_tpu_torch.core.device import resolve_device, torch_dtype
from paddle_tpu_torch.nn.functional import (
    gelu, scaled_dot_product_attention, tanh,
)
from paddle_tpu_torch.nn.layer import Dropout, Embedding, LayerNorm, Linear
from paddle_tpu_torch.ops.chunked_ce import chunked_token_ce

__all__ = ["BertConfig", "BertForMaskedLM", "BertForSequenceClassification",
           "BertModel", "ErnieConfig", "ErnieForMaskedLM",
           "ErnieForSequenceClassification", "ErnieModel"]

#: tokens per chunk of the masked-LM loss (the reference's default)
MLM_CHUNK = 8192


@dataclass
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    hidden_dropout_prob: float = 0.1
    dtype: str = "bfloat16"

    @staticmethod
    def tiny(**kw):
        base = dict(vocab_size=256, hidden_size=64, num_hidden_layers=2,
                    num_attention_heads=4, intermediate_size=128,
                    max_position_embeddings=64, hidden_dropout_prob=0.0,
                    dtype="float32")
        base.update(kw)
        return BertConfig(**base)


class _Ctx:
    """What every layer is built with: dtype, device, dropout rate and
    generator."""

    def __init__(self, cfg, device, generator):
        self.cfg = cfg
        self.dtype = torch_dtype(cfg.dtype)
        self.device = device
        self.generator = generator

    def linear(self, i, o, dtype=None):
        return Linear(i, o, dtype or self.dtype, self.device)

    def norm(self, dtype=None):
        return LayerNorm(self.cfg.hidden_size, self.cfg.layer_norm_eps,
                         dtype or self.dtype, self.device)

    def dropout(self):
        return Dropout(self.cfg.hidden_dropout_prob,
                       generator=self.generator)


class BertEmbeddings(nn.Module):
    def __init__(self, ctx):
        super().__init__()
        cfg = ctx.cfg
        self.word_embeddings = Embedding(cfg.vocab_size, cfg.hidden_size,
                                         ctx.dtype, ctx.device)
        self.position_embeddings = Embedding(
            cfg.max_position_embeddings, cfg.hidden_size, ctx.dtype,
            ctx.device)
        self.token_type_embeddings = Embedding(
            cfg.type_vocab_size, cfg.hidden_size, ctx.dtype, ctx.device)
        self.layer_norm = ctx.norm()
        self.dropout = ctx.dropout()

    def forward(self, input_ids, token_type_ids=None):
        s = input_ids.shape[1]
        pos = torch.arange(s, device=input_ids.device)[None, :]
        emb = self.word_embeddings(input_ids) + self.position_embeddings(pos)
        if token_type_ids is not None:
            emb = emb + self.token_type_embeddings(token_type_ids)
        return self.dropout(self.layer_norm(emb))


class BertSelfAttention(nn.Module):
    def __init__(self, ctx):
        super().__init__()
        cfg = ctx.cfg
        self.num_heads = cfg.num_attention_heads
        self.head_dim = cfg.hidden_size // cfg.num_attention_heads
        h = cfg.hidden_size
        self.q_proj = ctx.linear(h, h)
        self.k_proj = ctx.linear(h, h)
        self.v_proj = ctx.linear(h, h)
        self.out = ctx.linear(h, h)

    def forward(self, h, attn_mask=None):
        b, s, d = h.shape

        def heads(t):
            return t.view(b, s, self.num_heads, self.head_dim)
        ctx = scaled_dot_product_attention(
            heads(self.q_proj(h)), heads(self.k_proj(h)),
            heads(self.v_proj(h)), attn_mask=attn_mask, is_causal=False,
            training=self.training)
        return self.out(ctx.reshape(b, s, d))


class BertLayer(nn.Module):
    """Post-LN encoder block (the BERT/ERNIE convention)."""

    def __init__(self, ctx):
        super().__init__()
        cfg = ctx.cfg
        self.attention = BertSelfAttention(ctx)
        self.attn_norm = ctx.norm()
        self.ffn_in = ctx.linear(cfg.hidden_size, cfg.intermediate_size)
        self.ffn_out = ctx.linear(cfg.intermediate_size, cfg.hidden_size)
        self.ffn_norm = ctx.norm()
        self.dropout = ctx.dropout()

    def forward(self, h, attn_mask=None):
        h = self.attn_norm(h + self.dropout(self.attention(h, attn_mask)))
        ffn = self.ffn_out(gelu(self.ffn_in(h)))
        return self.ffn_norm(h + self.dropout(ffn))


class BertPooler(nn.Module):
    def __init__(self, ctx):
        super().__init__()
        self.dense = ctx.linear(ctx.cfg.hidden_size, ctx.cfg.hidden_size)

    def forward(self, h):
        return tanh(self.dense(h[:, 0]))


class _BertModule(nn.Module):
    """A weight tree's root: device, initialisation and weight exchange.
    ``device=None`` places it on ``cuda`` (raising without a card);
    ``generator`` (on the same device) or ``seed`` makes the
    initialisation reproducible.  A tree nested in another (the encoder
    of a task head) is built with its parent's ``_ctx`` instead."""

    def _setup(self, config, device, generator, seed, ctx):
        self.config = config
        if ctx is not None:
            return ctx, None
        dev = resolve_device(device)
        self.dropout_generator = torch.Generator(device=dev)
        self.dropout_generator.manual_seed(int(seed) + 1)
        if generator is None:
            generator = torch.Generator(device=dev)
            generator.manual_seed(int(seed))
        return _Ctx(config, dev, self.dropout_generator), generator

    @torch.no_grad()
    def _init_weights(self, generator):
        if generator is None:           # nested: the root initialises
            return
        for mod in self.modules():
            if hasattr(mod, "reset_parameters"):
                mod.reset_parameters(generator)

    @torch.no_grad()
    def numpy_state(self):
        """``{name: np.ndarray}`` of every parameter; bfloat16 leaves
        widen exactly to float32."""
        out = {}
        for name, p in self.named_parameters():
            t = p.detach().cpu()
            if t.dtype == torch.bfloat16:
                t = t.float()
            out[name] = np.array(t.numpy())
        return out

    def load_numpy_state(self, state):
        """Load the reference's ``Layer.functional_state()`` (see
        ``interop.load_module_state``)."""
        from paddle_tpu_torch.interop import load_module_state

        load_module_state(self, state)


class BertModel(_BertModule):
    def __init__(self, config, device=None, generator=None, seed=0,
                 _ctx=None):
        super().__init__()
        ctx, generator = self._setup(config, device, generator, seed, _ctx)
        self.embeddings = BertEmbeddings(ctx)
        self.encoder = nn.ModuleList(
            BertLayer(ctx) for _ in range(config.num_hidden_layers))
        self.pooler = BertPooler(ctx)
        self._init_weights(generator)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None):
        """``(hidden [B, L, H], pooled [B, H])``."""
        if attention_mask is not None:
            # a 1/0 mask -> the boolean key-padding mask that the flash
            # path lowers onto the segment-masked kernels
            attention_mask = attention_mask.to(torch.bool)
        h = self.embeddings(input_ids, token_type_ids)
        for blk in self.encoder:
            h = blk(h, attention_mask)
        return h, self.pooler(h)


class BertForMaskedLM(_BertModule):
    def __init__(self, config, device=None, generator=None, seed=0):
        super().__init__()
        ctx, generator = self._setup(config, device, generator, seed, None)
        self.bert = BertModel(config, _ctx=ctx)
        # the head stays f32 (the reference converts only the encoder)
        self.transform = ctx.linear(config.hidden_size, config.hidden_size,
                                    torch.float32)
        self.transform_norm = ctx.norm(torch.float32)
        self._init_weights(generator)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None,
                labels=None, return_logits=True):
        """Logits ``[B, L, V]``; with ``labels`` (-100 ignored) the mean
        masked-LM cross-entropy and the logits, or, with
        ``return_logits=False``, the chunked loss and None."""
        h, _ = self.bert(input_ids, token_type_ids, attention_mask)
        h = self.transform_norm(gelu(self.transform(h)))
        w = self.bert.embeddings.word_embeddings.weight
        if labels is not None and not return_logits:
            loss = chunked_token_ce(h, labels, w, MLM_CHUNK, pad_label=-100,
                                    vh_weight=True)
            return loss, None
        logits = h @ w.t().to(h.dtype)
        if labels is None:
            return logits
        loss = F.cross_entropy(
            logits.reshape(-1, self.config.vocab_size).float(),
            labels.reshape(-1).long(), ignore_index=-100)
        return loss, logits


class BertForSequenceClassification(_BertModule):
    def __init__(self, config, num_classes=2, device=None, generator=None,
                 seed=0):
        super().__init__()
        ctx, generator = self._setup(config, device, generator, seed, None)
        self.bert = BertModel(config, _ctx=ctx)
        self.classifier = ctx.linear(config.hidden_size, num_classes,
                                     torch.float32)
        self.dropout = ctx.dropout()
        self._init_weights(generator)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None,
                labels=None):
        _, pooled = self.bert(input_ids, token_type_ids, attention_mask)
        logits = self.classifier(self.dropout(pooled))
        if labels is None:
            return logits
        return F.cross_entropy(logits.float(), labels.long()), logits


# ERNIE = the BERT encoder with ERNIE defaults (knowledge masking lives in
# data preparation)
ErnieConfig = BertConfig
ErnieModel = BertModel
ErnieForMaskedLM = BertForMaskedLM
ErnieForSequenceClassification = BertForSequenceClassification
