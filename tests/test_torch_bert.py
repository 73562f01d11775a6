"""The port's BERT/ERNIE masked-LM training path against the JAX package.

Weights are made by the JAX model and carried across by name
(``interop.load_module_state``); inputs come from numpy seeds.  The JAX
model on the CPU takes its dense attention (``_sdpa_ref``) with the
boolean key-padding mask; at seq 128 and head_dim 64 the port takes its
segment-masked flash path (the plain versions of the segmented K1/K2,
K4 and K5), so the comparison also holds that path against the
reference's math.  All in f32 unless stated:

* ``layer_norm`` forward and both gradients against ``_ln_affine`` (the
  reference's custom backward): f32 within 1e-6 (gradients 1e-5, the
  dual reduction summed in another order), bf16 within one bf16 ulp;
* the tiny ``BertModel`` with a float ``attention_mask`` and
  ``token_type_ids``: hidden states and pooled output within 1e-4;
* ``BertForMaskedLM``'s chunked (``return_logits=False``) and dense
  losses within 1e-6 relative, and their gradients within 1e-5 + 1e-4
  relative; ``BertForSequenceClassification`` within the same; in bf16
  (the encoder; the heads stay f32 in both) the chunked loss within
  1e-3 relative, and the weights cross bit for bit in their dtypes;
* three AdamW steps (lr 1e-4, weight decay 0.01) of ``build_train_step``
  over ``BertForMaskedLM`` with a padding mask, as ``bench.py``'s
  ``bench_bert`` builds it: losses within 1e-6 relative, parameters
  within ``1e-5 + 1e-5·|p|`` for all but 1e-4 of the elements and all
  within ``2·lr·step`` (Adam's first updates turn summation-order noise
  in near-zero gradients into lr-sized moves; see
  ``test_torch_llama_train.py``; the key bias, whose exact gradient is
  zero, only within the bound);
* dropout: the keep rate within 4 standard deviations of ``1 - p``, kept
  values scaled by ``1/(1 - p)``, ``eval()`` the identity — for the
  ``Dropout`` layer and for attention dropout in
  ``scaled_dot_product_attention`` (the dense path, as in the reference).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.models.bert import BertConfig as JConfig
from paddle_tpu.models.bert import BertForMaskedLM as JMLM
from paddle_tpu.models.bert import BertForSequenceClassification as JCls
from paddle_tpu.models.bert import BertModel as JModel
from paddle_tpu.nn.functional.norm import _ln_affine
from paddle_tpu.optimizer import AdamW as JAdamW
from paddle_tpu.static.functionalize import build_train_step as j_build
from paddle_tpu.tensor.tensor import Tensor as JTensor
from paddle_tpu_torch.interop import load_module_state, tensor_from_numpy
from paddle_tpu_torch.models import bert as tbert
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn.functional import attention as tattn
from paddle_tpu_torch.nn.layer import Dropout
from paddle_tpu_torch.ops import flash_attention as tfa
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.static import build_train_step

torch.set_num_threads(1)

TINY = dict(vocab_size=256, hidden_size=64, num_hidden_layers=2,
            num_attention_heads=4, intermediate_size=128,
            max_position_embeddings=64, hidden_dropout_prob=0.0,
            dtype="float32")
# head_dim 64 at seq 128: the port's segment-masked flash path runs
WIDE = dict(TINY, hidden_size=256, intermediate_size=256,
            max_position_embeddings=128)
LR = 1e-4          # bench_bert's learning rate


def _pair(jcls, tcls, cfg, **kw):
    paddle.seed(0)
    jm = jcls(JConfig(**cfg), **kw)
    tm = tcls(tbert.BertConfig(**cfg), device="cpu", **kw)
    state, _ = jm.functional_state()
    load_module_state(tm, {k: np.asarray(v) for k, v in state.items()})
    return jm, tm


def _data(cfg, b, l, seed=0, lengths=None):
    """ids, token types, a float 1/0 padding mask (rows padded to
    ``lengths``) and MLM labels (15% positions, -100 elsewhere and on
    padding)."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, cfg["vocab_size"], (b, l))
    tt = rng.integers(0, 2, (b, l))
    mask = np.ones((b, l), np.float32)
    for i, n in enumerate(lengths or []):
        mask[i, n:] = 0.0
    labels = rng.integers(0, cfg["vocab_size"], (b, l))
    labels[(rng.random((b, l)) > 0.15) | (mask == 0)] = -100
    return ids, tt, mask, labels


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_matches_the_reference_custom_vjp(dtype):
    rng = np.random.default_rng(4)
    x = (3 + 2 * rng.standard_normal((3, 5, 64))).astype(np.float32)
    w = (1 + 0.1 * rng.standard_normal(64)).astype(np.float32)
    b = (0.1 * rng.standard_normal(64)).astype(np.float32)
    gy = rng.standard_normal((3, 5, 64)).astype(np.float32)
    jdt = jnp.dtype(dtype)
    jx, jw, jb, jg = (jnp.asarray(a).astype(jdt) for a in (x, w, b, gy))
    jy, vjp = jax.vjp(lambda a, c, d: _ln_affine(a, c, d, (2,), 1e-5),
                      jx, jw, jb)
    jgrads = vjp(jg)
    tx, tw, tb, tg = (tensor_from_numpy(np.asarray(a))
                      for a in (jx, jw, jb, jg))
    for t in (tx, tw, tb):
        t.requires_grad_(True)
    ty = F.layer_norm(tx, 64, tw, tb, 1e-5)
    ty.backward(tg)
    if dtype == "float32":
        tols = [dict(atol=1e-6, rtol=1e-6)] + [dict(atol=1e-5,
                                                    rtol=1e-5)] * 3
    else:
        tols = [dict(atol=1e-6, rtol=2.0 ** -7)] * 4
    for got, want, tol in zip((ty, tx.grad, tw.grad, tb.grad),
                              (jy, *jgrads), tols):
        assert got.dtype == tx.dtype
        np.testing.assert_allclose(got.detach().float().numpy(),
                                   np.asarray(want).astype(np.float32),
                                   **tol)


def test_load_module_state_is_bitwise_and_refuses_mismatches():
    """The reference's bf16 ``functional_state()`` crosses into the port
    bit for bit, by name and in each leaf's own dtype (the encoder bf16,
    the masked-LM head f32 in both); a missing or extra name or a wrong
    shape raises."""
    paddle.seed(1)
    jm = JMLM(JConfig(**dict(TINY, dtype="bfloat16")))
    state = {k: np.asarray(v) for k, v in jm.functional_state()[0].items()}
    tm = tbert.BertForMaskedLM(tbert.BertConfig(**dict(TINY,
                                                     dtype="bfloat16")),
                               device="cpu", seed=5)
    load_module_state(tm, state)
    for name, p in tm.named_parameters():
        want = state[name]
        assert str(p.dtype).endswith(want.dtype.name), (name, p.dtype)
        if want.dtype.name == "bfloat16":
            assert np.array_equal(p.detach().view(torch.int16).numpy(),
                                  want.view(np.int16)), name
        else:
            assert np.array_equal(p.detach().numpy(), want), name
    name = "bert.pooler.dense.bias"
    with pytest.raises(ValueError, match="missing"):
        load_module_state(tm, {k: v for k, v in state.items() if k != name})
    with pytest.raises(ValueError, match="unexpected"):
        load_module_state(tm, dict(state, extra=state[name]))
    with pytest.raises(ValueError, match="shape"):
        load_module_state(tm, dict(state, **{name: state[name][:-1]}))


@pytest.mark.parametrize("cfg,l", [(TINY, 16), (WIDE, 128)],
                         ids=["dense-seq16", "flash-seq128"])
def test_bert_model_forward_matches_jax(cfg, l):
    jm, tm = _pair(JModel, tbert.BertModel, cfg)
    ids, tt, mask, _ = _data(cfg, 2, l, lengths=[l, l // 2 + 3])
    jh, jp = _jax_apply(jm, ids, tt, mask)
    runs, dense = tfa.plain_runs["fwd"], tattn.dense_runs
    with torch.no_grad():
        th, tp = tm(torch.from_numpy(ids), torch.from_numpy(tt),
                    torch.from_numpy(mask))
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=1e-4,
                               rtol=1e-4)
    layers = cfg["num_hidden_layers"]
    if l == 128:        # the segmented flash path, never the dense one
        assert tfa.plain_runs["fwd"] == runs + layers
        assert tattn.dense_runs == dense
    else:
        assert tattn.dense_runs == dense + layers


def _jax_apply(jm, *inputs):
    """The reference's forward, jitted through ``functional_call``."""
    from paddle_tpu.autograd import engine

    params, buffers = jm.functional_state()

    def fwd(ps, *arrs):
        with engine.no_grad():
            out = jm.functional_call(ps, buffers, *[JTensor(a) for a in arrs])
        return tuple(o.data for o in out)
    return jax.jit(fwd)(params, *map(jnp.asarray, inputs))


def _jax_loss_and_grads(jm, *inputs):
    """The reference's loss of ``jm(*inputs)`` (the first output) and its
    gradients by name, through ``functional_call`` as its train step
    takes them."""
    params, buffers = jm.functional_state()
    arrs = [jnp.asarray(x) for x in inputs]

    def loss_of(ps):
        from paddle_tpu.autograd import engine
        with engine.no_grad():
            out = jm.functional_call(ps, buffers, *[JTensor(a) for a in arrs])
        loss = out[0] if isinstance(out, tuple) else out
        return loss.data
    return jax.jit(jax.value_and_grad(loss_of))(params)


def _grads_close(tm, loss, jloss, jgrads):
    assert abs(float(loss.detach()) - float(jloss)) <= 1e-6 * abs(
        float(jloss))
    names = [n for n, _ in tm.named_parameters()]
    grads = torch.autograd.grad(loss, [p for _, p in tm.named_parameters()],
                                allow_unused=True, materialize_grads=True)
    assert set(names) == set(jgrads)
    for name, g in zip(names, grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(jgrads[name]),
                                   atol=1e-5, rtol=1e-4, err_msg=name)


@pytest.mark.parametrize("chunked", [True, False], ids=["chunked", "dense"])
def test_masked_lm_losses_and_grads_match_jax(chunked):
    jm, tm = _pair(JMLM, tbert.BertForMaskedLM, WIDE)
    ids, tt, mask, labels = _data(WIDE, 2, 128, seed=1, lengths=[128, 77])
    jloss, jgrads = _jax_loss_and_grads(jm, ids, tt, mask, labels,
                                        not chunked)
    loss, logits = tm(*(torch.from_numpy(x) for x in (ids, tt, mask,
                                                       labels)),
                      return_logits=not chunked)
    assert (logits is None) == chunked
    _grads_close(tm, loss, jloss, jgrads)


def test_bf16_masked_lm_loss_matches_jax():
    """bench_bert's precision: a bf16 encoder (the segmented flash path
    at seq 128) under the f32 head, chunked loss within 1e-3 relative of
    the reference's (4.1e-4 measured: bf16 matmuls and elementwise ops
    round at other points in XLA and PyTorch)."""
    cfg = dict(WIDE, dtype="bfloat16")
    jm, tm = _pair(JMLM, tbert.BertForMaskedLM, cfg)
    ids, tt, mask, labels = _data(cfg, 2, 128, seed=1, lengths=[128, 77])
    jloss, _ = _jax_loss_and_grads(jm, ids, tt, mask, labels, False)
    with torch.no_grad():
        loss, _ = tm(*(torch.from_numpy(x) for x in (ids, tt, mask,
                                                      labels)),
                     return_logits=False)
    assert loss.dtype == torch.float32
    assert abs(float(loss) - float(jloss)) <= 1e-3 * abs(float(jloss))


def test_sequence_classification_matches_jax():
    jm, tm = _pair(JCls, tbert.BertForSequenceClassification, TINY,
                   num_classes=3)
    ids, tt, mask, _ = _data(TINY, 4, 16, seed=2, lengths=[16, 9, 5, 16])
    cls = np.random.default_rng(3).integers(0, 3, (4,))
    jloss, jgrads = _jax_loss_and_grads(jm, ids, tt, mask, cls)
    loss, logits = tm(*(torch.from_numpy(x) for x in (ids, tt, mask, cls)))
    assert logits.shape == (4, 3)
    _grads_close(tm, loss, jloss, jgrads)


class _TorchNet(torch.nn.Module):
    """``bench_bert``'s ``_Net`` with the padding mask as an input."""

    def __init__(self, m):
        super().__init__()
        self.m = m

    def forward(self, ids, mask, labels):
        return self.m(ids, attention_mask=mask, labels=labels,
                      return_logits=False)[0]


def _jax_net(m):
    class _Net(paddle.nn.Layer):
        def __init__(self, m):
            super().__init__()
            self.m = m

        def forward(self, ids, mask, labels):
            loss, _ = self.m(ids, attention_mask=mask, labels=labels,
                             return_logits=False)
            return loss
    return _Net(m)


def test_train_steps_match_build_train_step():
    """Three AdamW steps over the masked-LM loss with a padding mask: the
    tied embedding gets gradients from both of its uses, the pooler (not
    on the loss's path) only weight decay, in both packages.  The key
    projection's bias has no gradient in exact arithmetic (adding q·b to
    every score of a query row leaves its softmax unchanged), so Adam
    moves it by about ``lr·sign`` of summation noise, whose sign differs
    between the two packages: it is held to the ``2·lr·step`` bound only
    (at lr 1e-3 about 250 of its 256 elements per layer differed beyond
    1e-5, all other parameters together 5 of a million)."""
    jm, tm = _pair(JMLM, tbert.BertForMaskedLM, WIDE)
    ids, _, mask, labels = _data(WIDE, 2, 128, seed=4, lengths=[128, 90])
    jnet, tnet = _jax_net(jm), _TorchNet(tm)
    jstep = j_build(jnet, None, JAdamW(learning_rate=LR,
                                       parameters=jnet.parameters(),
                                       weight_decay=0.01))
    tstep = build_train_step(tnet, None, AdamW(
        learning_rate=LR, parameters=tnet.parameters(), weight_decay=0.01))
    targs = [torch.from_numpy(x) for x in (ids, mask, labels)]
    jargs = [paddle.to_tensor(x) for x in (ids, mask, labels)]
    pooler0 = tm.bert.pooler.dense.weight.detach().clone()
    for i in range(3):
        jl = float(np.asarray(jstep(*jargs).data))
        tl = float(tstep(*targs))
        assert abs(tl - jl) <= 1e-6 * abs(jl), (i, tl, jl)
        want = {k: np.asarray(v) for k, v in jstep._params.items()}
        got = {f"m.{k}": v for k, v in tm.numpy_state().items()}
        assert set(got) == set(want)
        n_off = n_all = 0
        for name, w in want.items():
            d = np.abs(got[name] - w)
            assert d.max() <= 2 * LR * (i + 1), (name, float(d.max()))
            if name.endswith("k_proj.bias"):
                continue        # pure noise for Adam: see the docstring
            n_off += int((d > 1e-5 + 1e-5 * np.abs(w)).sum())
            n_all += d.size
        assert n_off <= 1e-4 * n_all, (n_off, n_all)
    # weight decay alone moved the pooler: p * (1 - lr * 0.01) per step
    np.testing.assert_allclose(
        tm.bert.pooler.dense.weight.detach().numpy(),
        pooler0.numpy() * np.float32(1 - LR * 0.01) ** 3, rtol=1e-6)


@pytest.mark.parametrize("p", [0.1, 0.5])
def test_dropout_keeps_scales_and_is_identity_in_eval(p):
    x = torch.full((200, 500), 3.0)
    gen = torch.Generator().manual_seed(0)
    layer = Dropout(p, generator=gen)
    y = layer(x)
    kept = y != 0
    rate = float(kept.float().mean())
    sd = (p * (1 - p) / x.numel()) ** 0.5
    assert abs(rate - (1 - p)) <= 4 * sd, rate
    torch.testing.assert_close(y[kept], torch.full_like(y[kept],
                                                        3.0 / (1 - p)))
    layer.eval()
    assert layer(x) is x
    # the same generator state gives the same mask
    gen.manual_seed(0)
    assert torch.equal(Dropout(p, generator=gen)(x), y)
    # attention dropout takes the dense path, even where flash could run
    q = torch.randn((2, 128, 2, 64), generator=gen)
    dense = tattn.dense_runs
    out = F.scaled_dot_product_attention(q, q, q, dropout_p=p,
                                         generator=gen)
    assert tattn.dense_runs == dense + 1 and out.shape == q.shape
    # out of training there is no dropout: the flash path, as without it
    runs = tfa.plain_runs["fwd"]
    torch.testing.assert_close(
        F.scaled_dot_product_attention(q, q, q, dropout_p=p,
                                       training=False),
        tattn._sdpa_ref(q, q, q), atol=2e-5, rtol=2e-5)
    assert tfa.plain_runs["fwd"] == runs + 1
    # the keep mask seen through V = identity rows under uniform scores:
    # each probability 1/n is dropped or scaled to 1/(n (1 - p))
    n = 64
    qk = torch.zeros((1, n, 1, 16))
    eye = torch.eye(n)[None, :, None, :]
    probs = tattn._sdpa_ref(qk, qk, eye, dropout_p=p, generator=gen)[0, :, 0]
    vals = probs[probs != 0]
    torch.testing.assert_close(vals, torch.full_like(vals, 1 / (n * (1 - p))))
    rate = float((probs != 0).float().mean())
    assert abs(rate - (1 - p)) <= 4 * (p * (1 - p) / n / n) ** 0.5
