"""The port's Llama training path against the JAX package, on the CPU.

Weights are made by the JAX model and carried across by name
(``load_numpy_state``); inputs come from numpy seeds.  The JAX model on
the CPU takes its dense attention and plain RoPE; the port takes its
flash and fused-RoPE plain versions wherever their gates pass (head_dim
128 and L 128 here), so the comparison also holds those against the
reference's math.  All in f32:

* forward logits within 1e-4 (the tolerance of the port's decode tests);
* the LM loss, unchunked and chunked (with a padding tail), within 1e-6
  relative;
* three AdamW steps (f32 moments, weight decay 0.01; and int8 first
  moments, the bench's optimizer) of the port's ``build_train_step``
  against the reference's, recompute off and on:
  losses within 1e-6 relative; parameters after each step within
  ``1e-5 + 1e-5·|p|`` for all but 1e-4 of the elements, and all within
  ``2·lr·step``.  The exceptions are Adam's: its first updates are about
  ``lr·g/(|g| + eps)``, so an element whose gradient is a near-cancelled
  sum ~eps moves by a visibly different amount on a different summation
  order.

The chunked loss and RMSNorm are also held to the reference in bf16,
within one bf16 unit in the last place.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.models.llama import LlamaConfig as JConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JModel
from paddle_tpu.nn.functional.norm import _rms_norm_weighted
from paddle_tpu.optimizer import AdamW as JAdamW
from paddle_tpu.static.functionalize import build_train_step as j_build
from paddle_tpu_torch.distributed.fleet import recompute
from paddle_tpu_torch.interop import (
    optimizer_states_from_numpy, tensor_from_numpy,
)
from paddle_tpu_torch.models import llama_decode as tld
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.nn.functional import rms_norm
from paddle_tpu_torch.ops import flash_attention as tfa
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.static import build_train_step

torch.set_num_threads(1)

TINY = dict(vocab_size=256, hidden_size=64, intermediate_size=128,
            num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
            max_position_embeddings=128, dtype="float32")
# head_dim 128 and L 128: the port's flash and fused-RoPE paths run
WIDE = dict(TINY, hidden_size=512, intermediate_size=256)
# __graft_entry__.entry()'s widths, in f32
ENTRY = dict(vocab_size=8192, hidden_size=512, intermediate_size=1408,
             num_hidden_layers=4, num_attention_heads=8,
             num_key_value_heads=8, max_position_embeddings=512,
             dtype="float32")
LR = 1e-3
_MEMO = {}


def _pair(cfg):
    paddle.seed(0)
    jm = JModel(JConfig(**cfg))
    tm = LlamaForCausalLM(LlamaConfig(**cfg), device="cpu")
    state, _ = jm.functional_state()
    tm.load_numpy_state({k: np.asarray(v) for k, v in state.items()})
    return jm, tm


def _data(cfg, b, l, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, cfg["vocab_size"], (b, l)),
            rng.integers(0, cfg["vocab_size"], (b, l)))


@pytest.mark.parametrize("name,cfg,b,l", [
    ("tiny", TINY, 2, 16), ("d128-l128", WIDE, 2, 128),
    ("entry-l256", ENTRY, 2, 256)], ids=["tiny", "d128-l128", "entry-l256"])
def test_forward_logits_match_jax(name, cfg, b, l):
    jm, tm = _pair(cfg)
    ids, _ = _data(cfg, b, l)
    runs = tfa.plain_runs["fwd"]
    jl = np.asarray(jm(paddle.to_tensor(ids)).data)
    with torch.no_grad():
        tl = tm(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(tl, jl, atol=1e-4, rtol=1e-4)
    if name != "tiny":          # flash-eligible: the flash path ran
        assert tfa.plain_runs["fwd"] > runs


@pytest.mark.parametrize("chunk", [0, 100], ids=["unchunked", "chunked"])
def test_loss_matches_jax(chunk):
    """254 target tokens: chunks of 100 leave a 46-token padding tail."""
    cfg = dict(WIDE, loss_chunk_size=chunk)
    jm, tm = _pair(cfg)
    ids, labels = _data(cfg, 2, 128, seed=1)
    jl = float(np.asarray(jm(paddle.to_tensor(ids),
                             paddle.to_tensor(labels)).data))
    with torch.no_grad():
        tl = float(tm(torch.from_numpy(ids), torch.from_numpy(labels)))
    assert abs(tl - jl) <= 1e-6 * abs(jl)


def _jax_run(cfg, steps, moment_dtype=None):
    """(losses, [params after each step], final optimizer states) of the
    reference trainer, memoised per configuration."""
    key = (tuple(sorted(cfg.items())), steps, moment_dtype)
    if key not in _MEMO:
        jm, _ = _pair(cfg)
        ids, labels = _data(cfg, 2, 128, seed=2)
        step = j_build(jm, None, JAdamW(learning_rate=LR,
                                        parameters=jm.parameters(),
                                        weight_decay=0.01,
                                        moment_dtype=moment_dtype))
        losses, params = [], []
        for _ in range(steps):
            losses.append(float(np.asarray(
                step(paddle.to_tensor(ids), paddle.to_tensor(labels)).data)))
            params.append({k: np.asarray(v) for k, v in step._params.items()})
        states = {n: {k: np.asarray(v) for k, v in d.items()}
                  for n, d in step._states.items()}
        _MEMO[key] = (losses, params, states)
    return _MEMO[key]


def _params_close(got, want, step, frac=1e-4):
    n_off = n_all = 0
    for name, w in want.items():
        d = np.abs(got[name] - w)
        assert d.max() <= 2 * LR * step, (name, float(d.max()))
        n_off += int((d > 1e-5 + 1e-5 * np.abs(w)).sum())
        n_all += d.size
    assert n_off <= frac * n_all, (n_off, n_all)


@pytest.mark.parametrize("remat", [False, True],
                         ids=["recompute-off", "recompute-on"])
def test_train_steps_match_build_train_step(remat):
    cfg = dict(WIDE, recompute=remat, recompute_layers=1,
               loss_chunk_size=100 if remat else 0)
    jlosses, jparams, _ = _jax_run(cfg, 3)
    _, tm = _pair(cfg)
    ids, labels = _data(cfg, 2, 128, seed=2)
    step = build_train_step(tm, None, AdamW(learning_rate=LR,
                                            parameters=tm.parameters(),
                                            weight_decay=0.01))
    for i in range(3):
        loss = float(step(torch.from_numpy(ids), torch.from_numpy(labels)))
        assert abs(loss - jlosses[i]) <= 1e-6 * abs(jlosses[i]), (i, loss)
        _params_close(tm.numpy_state(), jparams[i], i + 1)


@pytest.mark.parametrize("remat", [False, True],
                         ids=["recompute-off", "recompute-on"])
def test_int8_moment_train_steps_match_build_train_step(remat):
    """``AdamW(moment_dtype="int8")`` — the bench's optimizer — over three
    steps against the reference's ``build_train_step`` (its CPU path:
    decode, update, re-encode; so is the port's on the CPU).  Losses as
    the f32-moment test.  The gradients differ by summation order, as
    there, and where that noise moves ``m'/s'`` across a rounding
    boundary a first-moment code differs by one: at most 2e-3 of the
    codes (5e-4 measured).  A flipped code moves that element's next
    update by ``lr·s/sqrt(v)``, so parameters beyond ``1e-5`` are allowed
    on 1e-3 of the elements (3e-4 measured), all within ``2·lr·step``;
    the scales within 1/127 relative (a flipped code at a block's largest
    value moves its next scale by up to one code); the bf16 second
    moments within 2 bf16 ulps or 1e-12."""
    cfg = dict(WIDE, recompute=remat, recompute_layers=1,
               loss_chunk_size=100 if remat else 0)
    jlosses, jparams, jstates = _jax_run(cfg, 3, "int8")
    _, tm = _pair(cfg)
    ids, labels = _data(cfg, 2, 128, seed=2)
    step = build_train_step(tm, None, AdamW(learning_rate=LR,
                                            parameters=tm.parameters(),
                                            weight_decay=0.01,
                                            moment_dtype="int8"))
    for i in range(3):
        loss = float(step(torch.from_numpy(ids), torch.from_numpy(labels)))
        assert abs(loss - jlosses[i]) <= 1e-6 * abs(jlosses[i]), (i, loss)
        _params_close(tm.numpy_state(), jparams[i], i + 1, frac=1e-3)
    assert set(step._states) == set(jstates)
    n_off = n_all = 0
    for k, want in jstates["moment1"].items():
        got = step._states["moment1"][k]
        assert got.dtype == torch.int8 and want.dtype == np.int8
        d = np.abs(got.numpy().astype(np.int32) - want.astype(np.int32))
        assert d.max() <= 1, k
        n_off += int((d > 0).sum())
        n_all += d.size
        np.testing.assert_allclose(step._states["moment1@scale"][k].numpy(),
                                   jstates["moment1@scale"][k],
                                   rtol=1 / 127, atol=0)
        v = step._states["moment2"][k]
        assert v.dtype == torch.bfloat16
        np.testing.assert_allclose(
            v.float().numpy(), jstates["moment2"][k].astype(np.float32),
            rtol=2.0 ** -6, atol=1e-12)
    assert n_off <= 2e-3 * n_all, (n_off, n_all)


def test_int8_optimizer_states_cross_bit_for_bit():
    """The reference trainer's int8-moment state (int8 codes, f32 scales,
    bf16 second moments) and a multi_precision one (f32 masters) cross
    into the port's layout leaf by leaf, bit for bit, and the port's
    ``functional_update`` takes the carried state as its own."""
    cfg = dict(WIDE, recompute=False, recompute_layers=1,
               loss_chunk_size=0)
    _, _, jstates = _jax_run(cfg, 3, "int8")
    rng = np.random.default_rng(6)
    jp = {"w": jnp.asarray(rng.standard_normal((4, 300)),
                           jnp.bfloat16)}
    jopt = JAdamW(moment_dtype="int8", multi_precision=True)
    jmaster = jopt.functional_init_states(jp)
    for st in (jstates, {n: {k: np.asarray(v) for k, v in d.items()}
                         for n, d in jmaster.items()}):
        carried = optimizer_states_from_numpy(st, device="cpu")
        assert set(carried) == set(st)
        for n, d in st.items():
            for k, v in d.items():
                t = carried[n][k]
                if v.dtype.name == "bfloat16":
                    assert t.dtype == torch.bfloat16
                    assert np.array_equal(t.view(torch.int16).numpy(),
                                          v.view(np.int16))
                else:
                    assert t.numpy().dtype == v.dtype
                    assert np.array_equal(t.numpy(), v)
    opt = AdamW(moment_dtype="int8", multi_precision=True)
    opt._global_step = 1
    params = {"w": tensor_from_numpy(np.asarray(jp["w"]))}
    new, st = opt.functional_update(params, {"w": torch.ones(4, 300)},
                                    carried, 1e-3)
    assert st["moment1"]["w"].dtype == torch.int8
    assert st["master_weight"]["w"].dtype == torch.float32
    assert new["w"].dtype == torch.bfloat16


def _grads(cfg, seed=3):
    _, tm = _pair(cfg)
    ids, labels = _data(cfg, 2, 128, seed=seed)
    loss = tm(torch.from_numpy(ids), torch.from_numpy(labels))
    names = [n for n, _ in tm.named_parameters()]
    grads = torch.autograd.grad(loss, [p for _, p in tm.named_parameters()])
    return loss.detach(), dict(zip(names, grads))


def test_recompute_on_equals_off_bitwise():
    """Per-layer recompute, and the training step's whole-forward
    recompute, change nothing: loss, gradients and updated parameters
    are bitwise those of the run that keeps every activation."""
    l0, g0 = _grads(dict(WIDE, recompute=False))
    l1, g1 = _grads(dict(WIDE, recompute=True, recompute_layers=None))
    assert torch.equal(l0, l1)
    for name in g0:
        assert torch.equal(g0[name], g1[name]), name
    ids, labels = (torch.from_numpy(x) for x in _data(WIDE, 2, 128))
    runs = []
    for remat in (False, True):
        _, tm = _pair(WIDE)
        step = build_train_step(tm, None, AdamW(parameters=tm.parameters()),
                                recompute=remat)
        runs.append((step(ids, labels), tm.numpy_state()))
    assert torch.equal(runs[0][0], runs[1][0])
    for name, p in runs[0][1].items():
        assert np.array_equal(p, runs[1][1][name]), name


def test_chunked_loss_equals_unchunked():
    l0, g0 = _grads(dict(WIDE, loss_chunk_size=0))
    l1, g1 = _grads(dict(WIDE, loss_chunk_size=100))
    assert abs(float(l0) - float(l1)) <= 1e-6 * abs(float(l0))
    for name in g0:
        torch.testing.assert_close(g1[name], g0[name], atol=1e-6, rtol=1e-5)


@pytest.mark.parametrize("chunk", [512, 128], ids=["one-chunk", "4-chunks"])
def test_bf16_chunked_loss_and_gradients_match_jax(chunk):
    """bf16 h and w through the chunked loss against the reference's
    ``chunked_token_ce_fn`` (f32 logits of the bf16 product): the loss
    within 1e-6 relative; dh and dw within one bf16 unit in the last place
    (near zero, 2^-16 of the largest magnitude).  Over several chunks the
    bf16 w gradient sums the chunks' rounded parts in bf16 in both, so it
    differs from one f32 sum rounded once."""
    from paddle_tpu.ops.chunked_ce import chunked_token_ce_fn
    from paddle_tpu_torch.ops.chunked_ce import chunked_token_ce

    rng = np.random.default_rng(5)
    n, hid, vocab = 512, 64, 300
    h = rng.standard_normal((1, n, hid)).astype(np.float32)
    w = (0.05 * rng.standard_normal((hid, vocab))).astype(np.float32)
    labels = rng.integers(0, vocab, (1, n))
    labels[0, -5:] = -1
    jh, jw = (jnp.asarray(x, jnp.bfloat16) for x in (h, w))
    jl, (jdh, jdw) = jax.value_and_grad(chunked_token_ce_fn(chunk),
                                        argnums=(0, 2))(
        jh, jnp.asarray(labels), jw)
    th, tw = (tensor_from_numpy(np.asarray(x)).requires_grad_(True)
              for x in (jh, jw))
    tl = chunked_token_ce(th, torch.from_numpy(labels), tw, chunk)
    tdh, tdw = torch.autograd.grad(tl, (th, tw))
    assert abs(float(tl) - float(jl)) <= 1e-6 * abs(float(jl))
    for got, want in ((tdh, jdh), (tdw, jdw)):
        assert got.dtype == torch.bfloat16
        want = np.asarray(want).astype(np.float32)
        np.testing.assert_allclose(got.float().numpy(), want, rtol=2.0 ** -7,
                                   atol=2.0 ** -16 * np.abs(want).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_matches_the_reference_custom_vjp(dtype):
    """Forward and both gradients against ``_rms_norm_weighted``: f32
    within 1e-6; bf16 within one bf16 unit in the last place (the
    normalised rows round to bf16 before the gain in both)."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((3, 5, 64)).astype(np.float32)
    w = (1 + 0.1 * rng.standard_normal(64)).astype(np.float32)
    gy = rng.standard_normal((3, 5, 64)).astype(np.float32)
    jdt = jnp.dtype(dtype)
    jx, jw, jg = (jnp.asarray(a).astype(jdt) for a in (x, w, gy))
    jy, vjp = jax.vjp(lambda a, b: _rms_norm_weighted(a, b, 1e-6), jx, jw)
    jga, jgw = vjp(jg)
    tx, tw, tg = (tensor_from_numpy(np.asarray(a)) for a in (jx, jw, jg))
    tx.requires_grad_(True)
    tw.requires_grad_(True)
    ty = rms_norm(tx, tw, 1e-6)
    ty.backward(tg)
    tol = dict(atol=1e-6, rtol=1e-6) if dtype == "float32" else \
        dict(atol=1e-6, rtol=2.0 ** -7)
    for got, want in ((ty, jy), (tx.grad, jga), (tw.grad, jgw)):
        assert got.dtype == tx.dtype
        np.testing.assert_allclose(got.detach().float().numpy(),
                                   np.asarray(want).astype(np.float32),
                                   **tol)


def test_functional_update_matches_the_reference_for_bf16_params():
    """bf16 parameters with f32 master weights and bf16-stored moments:
    the grad widens to f32, the update runs on the master, the new
    parameter rounds back to bf16 — as ``Optimizer.functional_update``."""
    rng = np.random.default_rng(5)
    shapes = {"a": (8, 16), "b": (16,)}
    p32 = {k: rng.standard_normal(s).astype(np.float32)
           for k, s in shapes.items()}
    jp = {k: jnp.asarray(v).astype(jnp.bfloat16) for k, v in p32.items()}
    kw = dict(learning_rate=1e-2, weight_decay=0.01, multi_precision=True,
              moment_dtype="bfloat16")
    jopt, topt = JAdamW(**kw), AdamW(**kw)
    jst = jopt.functional_init_states(jp)
    tp = {k: tensor_from_numpy(np.asarray(v)) for k, v in jp.items()}
    tst = topt.functional_init_states(tp)
    for t in (1, 2):
        g = {k: rng.standard_normal(s).astype(np.float32)
             for k, s in shapes.items()}
        jg = {k: jnp.asarray(v).astype(jnp.bfloat16) for k, v in g.items()}
        jopt._global_step = topt._global_step = t
        jp, jst = jopt.functional_update(jp, jg, jst, jnp.float32(1e-2))
        tg = {k: tensor_from_numpy(np.asarray(v)) for k, v in jg.items()}
        tp, tst = topt.functional_update(tp, tg, tst, 1e-2)
        for k in shapes:
            assert tp[k].dtype == torch.bfloat16
            np.testing.assert_allclose(
                tp[k].float().numpy(), np.asarray(jp[k]).astype(np.float32),
                rtol=2.0 ** -8, atol=1e-6)
            np.testing.assert_allclose(
                tst["master_weight"][k].numpy(),
                np.asarray(jst["master_weight"][k]), rtol=1e-6, atol=1e-7)
            for n in ("moment1", "moment2"):
                assert tst[n][k].dtype == torch.bfloat16
                np.testing.assert_allclose(
                    tst[n][k].float().numpy(),
                    np.asarray(jst[n][k]).astype(np.float32),
                    rtol=2.0 ** -8, atol=1e-12)


def test_int8_moments_and_unported_knobs_raise():
    """int8 moments work; the knobs that are not ported raise."""
    assert AdamW(moment_dtype="int8")._moment_storage("moment2") \
        == torch.bfloat16
    with pytest.raises(NotImplementedError, match="amsgrad"):
        AdamW(moment_dtype="int8", amsgrad=True)
    with pytest.raises(NotImplementedError, match="lr_ratio"):
        AdamW(moment_dtype="int8", lr_ratio=lambda p: 1.0)
    with pytest.raises(ValueError, match="unknown moment_dtype"):
        AdamW(moment_dtype="int4")
    with pytest.raises(NotImplementedError, match="clipping"):
        AdamW(grad_clip=object())
    _, tm = _pair(TINY)
    opt = AdamW(parameters=tm.parameters())
    with pytest.raises(NotImplementedError, match="amp"):
        build_train_step(tm, None, opt, amp_level="O1")
    opt.k_steps = 2
    with pytest.raises(NotImplementedError, match="merge"):
        build_train_step(tm, None, opt)
    with pytest.raises(NotImplementedError, match="not ported"):
        recompute(lambda x: x, torch.zeros(2), policy="named")
    with pytest.raises(ValueError, match="unknown recompute policy"):
        recompute(lambda x: x, torch.zeros(2), policy="bogus")


def test_weights_cross_both_ways_and_serving_sees_the_update():
    """``numpy_state`` is the inverse of ``load_numpy_state`` (bf16 widens
    exactly); a training step updates the parameters in place, so the
    serving path's cached decode params (views of them) see it."""
    cfg = dict(TINY, dtype="bfloat16")
    tm = LlamaForCausalLM(LlamaConfig(**cfg), device="cpu", seed=3)
    st = tm.numpy_state()
    assert all(v.dtype == np.float32 for v in st.values())
    other = LlamaForCausalLM(LlamaConfig(**cfg), device="cpu", seed=4)
    other.load_numpy_state(st)
    for (_, a), (_, b) in zip(tm.named_parameters(),
                              other.named_parameters()):
        assert torch.equal(a, b)
    params, _ = tld._decode_params_of(tm, 64)
    before = params["layers"][0]["wq"].clone()
    ids, labels = _data(cfg, 2, 16)
    build_train_step(tm, None, AdamW(learning_rate=1e-2,
                                     parameters=tm.parameters()))(
        torch.from_numpy(ids), torch.from_numpy(labels))
    after, _ = tld._decode_params_of(tm, 64)
    assert not torch.equal(after["layers"][0]["wq"], before)
    assert torch.equal(after["layers"][0]["wq"],
                       tm.llama.layers[0].self_attn.q_proj.weight.detach())
