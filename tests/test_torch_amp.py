"""The port's amp (``paddle_tpu_torch/amp``) against the JAX package, on
the CPU.

Inputs come from numpy seeds; each check names the reference function it
holds the port to and its tolerance:

* the op lists and the per-op rule (``auto_cast.cast_op_inputs``,
  ``white_list``/``black_list`` with custom lists): equal;
* the Llama loss and every parameter gradient under ``auto_cast`` O1 and
  O2 (f32 parameters; head_dim 128 and L 128, so the port's flash and
  fused-RoPE plain versions run in bf16) against the reference's
  ``functional_call`` under the same ``auto_cast`` through
  ``jax.value_and_grad``, as its TrainStep runs it: the loss within 1e-3
  relative (1.8e-4 measured), each gradient within 2e-2 of its norm
  (1.7e-2 measured, a k_proj weight: bf16 products rounded in another
  order on each side);
* a matmul/softmax/mean function through the function mode, default O1
  and ``custom_black_list={"matmul"}``: the loss within 2e-3 relative,
  gradients within 2e-2 of their norm (f32 within 1e-5);
* ``decorate(level="O2")``: every parameter's dtype as the reference's;
* per-layer recompute under O1 bitwise equal to O1 without it (the
  recompute re-enters the forward's amp state);
* ``GradScaler`` against the reference's: the scale after each step,
  a step with an injected inf skipped (parameters unchanged) and the
  scale halved, unscaled gradients within one f32 rounding.
"""
import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.amp.grad_scaler import GradScaler as JScaler
from paddle_tpu.autograd import engine as jengine
from paddle_tpu.models.llama import LlamaConfig as JConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JModel
from paddle_tpu.tensor.tensor import Tensor as JTensor
from paddle_tpu_torch import amp
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.nn.layer import Linear
from paddle_tpu_torch.optimizer import SGD

torch.set_num_threads(1)

# the packages' ``amp.auto_cast`` names the function; the modules:
jamp = importlib.import_module("paddle_tpu.amp.auto_cast")
tamp_mod = importlib.import_module("paddle_tpu_torch.amp.auto_cast")

WIDE = dict(vocab_size=256, hidden_size=512, intermediate_size=256,
            num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, max_position_embeddings=128,
            dtype="float32")
_MEMO = {}


def _data(seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (2, 128)), rng.integers(0, 256, (2, 128)))


def test_lists_and_rules_match_the_reference():
    """``WHITE_LIST``/``BLACK_LIST``, the custom lists, and the rule
    ``cast_op_inputs`` applies per op name at each level."""
    assert amp.WHITE_LIST == jamp.WHITE_LIST
    assert amp.BLACK_LIST == jamp.BLACK_LIST
    kw = dict(custom_white_list={"exp"}, custom_black_list={"matmul"})
    with paddle.amp.auto_cast(**kw):
        jw, jb = jamp.white_list(), jamp.black_list()
    with amp.auto_cast(**kw):
        assert amp.white_list() == jw and amp.black_list() == jb
    assert not amp.is_auto_cast_enabled()
    x32 = np.ones((2, 2), np.float32)
    for level in ("O1", "O2"):
        for op in ("linear", "exp", "silu", "cast", "getitem", "matmul",
                   "rms_norm", "linear_grad"):
            with paddle.amp.auto_cast(level=level,
                                      custom_black_list={"matmul"}):
                want = jamp.cast_op_inputs(op, [JTensor(jnp.asarray(x32))])
            with amp.auto_cast(level=level, custom_black_list={"matmul"}):
                got = tamp_mod.cast_op_inputs(op, [torch.ones(2, 2)])
            assert str(got[0].dtype).split(".")[-1] == \
                str(want[0].dtype), (level, op)


def _jax_llama(level):
    """(loss, {name: grad}) of the reference Llama under ``auto_cast``,
    through ``functional_call`` and ``jax.value_and_grad`` (what its
    TrainStep traces), memoised per level."""
    if level not in _MEMO:
        if "model" not in _MEMO:
            paddle.seed(0)
            _MEMO["model"] = JModel(JConfig(**WIDE))
        jm = _MEMO["model"]
        params, buffers = jm.functional_state()
        ids, labels = _data()

        def loss_of(ps):
            with jengine.no_grad(), paddle.amp.auto_cast(level=level):
                out = jm.functional_call(ps, buffers, JTensor(ids),
                                         JTensor(labels))
            return out.data
        lval, grads = jax.jit(jax.value_and_grad(loss_of))(params)
        _MEMO[level] = ({k: np.asarray(v) for k, v in params.items()},
                        float(lval),
                        {k: np.asarray(g) for k, g in grads.items()})
    return _MEMO[level]


def _grads_close(got, want, rel):
    for name, w in want.items():
        g = got[name]
        err = np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30)
        assert err <= rel, (name, err)


@pytest.mark.parametrize("level", ["O1", "O2"])
def test_llama_loss_and_grads_under_auto_cast_match_the_reference(level):
    state, jloss, jgrads = _jax_llama(level)
    tm = LlamaForCausalLM(LlamaConfig(**WIDE), device="cpu")
    tm.load_numpy_state(state)
    ids, labels = (torch.from_numpy(x) for x in _data())
    from paddle_tpu_torch.ops import flash_attention as tfa
    runs = dict(tfa.plain_runs)
    with amp.auto_cast(level=level):
        loss = tm(ids, labels)
    names = [n for n, _ in tm.named_parameters()]
    grads = torch.autograd.grad(loss, [p for _, p in tm.named_parameters()])
    assert loss.dtype == torch.float32
    assert abs(float(loss.detach()) - jloss) <= 1e-3 * abs(jloss), jloss
    _grads_close({n: g.float().numpy() for n, g in zip(names, grads)},
                 jgrads, 2e-2)
    assert all(g.dtype == torch.float32 for g in grads)
    assert tfa.plain_runs["fwd"] > runs["fwd"]      # the flash path ran


def _mlp_ref(xs, black):
    """The reference's loss and gradients under ``auto_cast``, traced as
    its TrainStep traces a forward (``no_grad``, ``jax.value_and_grad``)."""
    def loss_of(ws):
        with jengine.no_grad(), paddle.amp.auto_cast(custom_black_list=black):
            x, w1, w2 = map(JTensor, ws)
            h = paddle.matmul(x, w1)
            p = paddle.nn.functional.softmax(h, axis=-1)
            out = paddle.matmul(p, w2)
            return paddle.mean(paddle.exp(out * 0.1)).data
    lval, grads = jax.jit(jax.value_and_grad(loss_of))(
        [jnp.asarray(a) for a in xs])
    return float(lval), [np.asarray(g).astype(np.float32) for g in grads]


def _mlp_port(x, w1, w2, black):
    with amp.auto_cast(custom_black_list=black):
        h = torch.matmul(x, w1)
        p = torch.softmax(h, dim=-1)
        out = p @ w2
        return torch.mean(torch.exp(out * 0.1))


@pytest.mark.parametrize("black", [None, {"matmul"}],
                         ids=["default", "black-matmul"])
def test_function_mode_casts_plain_torch_calls_like_the_reference(black):
    rng = np.random.default_rng(3)
    xs = [rng.standard_normal(s).astype(np.float32)
          for s in ((8, 32), (32, 64), (64, 16))]
    jl, jgrads = _mlp_ref(xs, black)
    tts = [torch.from_numpy(a).requires_grad_(True) for a in xs]
    tl = _mlp_port(*tts, black)
    tl.backward()
    assert tl.dtype == torch.float32
    tol = 1e-5 if black else 2e-3
    assert abs(float(tl) - jl) <= tol * abs(jl)
    _grads_close({i: t.grad.numpy() for i, t in enumerate(tts)},
                 dict(enumerate(jgrads)), 1e-5 if black else 2e-2)


def test_decorate_o2_casts_as_the_reference():
    paddle.seed(0)
    jm = paddle.amp.decorate(JModel(JConfig(**dict(WIDE, hidden_size=64))),
                             level="O2")
    tm = amp.decorate(LlamaForCausalLM(
        LlamaConfig(**dict(WIDE, hidden_size=64)), device="cpu"),
        level="O2")
    want = {n: str(p.dtype) for n, p in jm.named_parameters()}
    got = {n: str(p.dtype).split(".")[-1] for n, p in tm.named_parameters()}
    assert got == want and set(got.values()) == {"bfloat16"}
    ln = amp.decorate(Linear(4, 4), level="O2")
    assert ln.weight.dtype == torch.bfloat16


def test_recompute_under_o1_equals_no_recompute_bitwise():
    """The recompute re-runs each layer's forward under the amp state it
    first ran under: loss and gradients bitwise equal to O1 without
    recompute, with the full and the ``dots`` policy."""
    ids, labels = (torch.from_numpy(x) for x in _data(1))
    runs = []
    for kw in ({}, dict(recompute=True), dict(recompute=True,
                                               recompute_policy="dots")):
        tm = LlamaForCausalLM(LlamaConfig(**WIDE, **kw), device="cpu",
                              seed=2)
        with amp.auto_cast():
            loss = tm(ids, labels)
        runs.append((loss.detach(),
                     torch.autograd.grad(loss, list(tm.parameters()))))
    for other in runs[1:]:
        assert torch.equal(runs[0][0], other[0])
        assert all(torch.equal(a, b) for a, b in zip(runs[0][1], other[1]))


class _JOpt:
    """What the reference GradScaler needs of an optimizer."""

    def __init__(self, params):
        self._parameter_list = params
        self.steps = 0

    def step(self):
        self.steps += 1


def test_grad_scaler_skips_a_non_finite_step_like_the_reference():
    """An f16 ``auto_cast`` on a stack of the port's ``Linear`` layers:
    each step's gradients are handed to the reference scaler too; step 2
    carries an injected inf: it is skipped on both sides (the port's
    parameters do not move) and the scale halves; two good steps after it
    double the scale (``incr_every_n_steps=2``)."""
    g = torch.Generator().manual_seed(0)
    net = torch.nn.Sequential(Linear(16, 32), torch.nn.ReLU(),
                              Linear(32, 4))
    for layer in (net[0], net[2]):
        layer.reset_parameters(g)
    opt = SGD(0.1, parameters=net.parameters())
    kw = dict(init_loss_scaling=1024.0, incr_every_n_steps=2)
    scaler, jscaler = amp.GradScaler(**kw), JScaler(**kw)
    rng = np.random.default_rng(4)
    scales, jscales = [], []
    for i in range(4):
        x = torch.from_numpy(rng.standard_normal((8, 16)).astype(np.float32))
        y = torch.from_numpy(rng.standard_normal((8, 4)).astype(np.float32))
        with amp.auto_cast(dtype="float16"):
            out = net(x)
            assert out.dtype == torch.float16
            loss = ((out.float() - y) ** 2).mean()
        scaler.scale(loss).backward()
        if i == 1:
            net[2].weight.grad[0, 0] = float("inf")
        # a copy: jnp.asarray may alias the numpy buffer, which the
        # port's unscale_ rewrites in place
        jps = [type("P", (), {"grad": JTensor(jnp.asarray(
            p.grad.numpy().copy()))})() for p in net.parameters()]
        jopt = _JOpt(jps)
        before = [p.detach().clone() for p in net.parameters()]
        scaler.step(opt)
        jscaler.step(jopt)
        skipped = all(torch.equal(a, b)
                      for a, b in zip(before, net.parameters()))
        assert skipped == (i == 1) == (jopt.steps == 0)
        for p, jp in zip(net.parameters(), jps):
            np.testing.assert_allclose(p.grad.numpy(),
                                       np.asarray(jp.grad.data),
                                       rtol=1e-6, atol=0)
        scaler.update()
        jscaler.update()
        opt.clear_grad()
        scales.append(scaler.get_init_loss_scaling())
        jscales.append(jscaler.get_init_loss_scaling())
    assert scales == jscales == [1024.0, 512.0, 512.0, 1024.0]
    assert scaler.state_dict() == jscaler.state_dict()
