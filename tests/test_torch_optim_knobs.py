"""The port's training-step knobs against the JAX package, on the CPU.

Inputs come from numpy seeds; each check names the reference function it
holds the port to and its tolerance:

* every learning-rate scheduler of ``paddle_tpu/optimizer/lr.py`` over 40
  steps, exactly (the same Python float arithmetic), and again after a
  ``state_dict`` round trip mid-schedule;
* ``nn/clip.py``'s clips (by value, by norm, by global norm, and the
  in-place ``clip_grad_norm_`` / ``clip_grad_value_``) on random f32 and
  bf16 gradients with a ``need_clip=False`` parameter: exact by value; f32
  within 1e-6 relative (the norms' summation order); bf16 within one bf16
  unit (a scale one f32 ulp apart can round the other way);
* each of the 13 optimizers over 3 ``functional_update`` steps against the
  reference's, with ``amsgrad``, ``lr_ratio``, ``multi_precision`` and
  int8 ``Momentum`` velocity: f32 parameters and states within 1e-5
  relative plus 1e-6; bf16 parameters within one bf16 unit; int8 codes
  within one (against the reference compiled, as its TrainStep runs it),
  their scales within 1/127;
* ``build_train_step`` on ``LlamaConfig.tiny()`` over 4 steps with global
  clipping, a warmup/cosine schedule and gradient merge k=2 against the
  reference's: losses within 1e-6 relative, parameters within
  ``2·lr·step`` and all but 1e-4 of them within 1e-5, bit-equal across the
  non-apply steps, and the rates equal;
* the eager ``step()`` bitwise equal to ``build_train_step`` over the same
  optimizer, and gradient merge's eager window: parameters unchanged on
  non-apply steps, and a ``state_dict`` taken mid-window resumes bit for
  bit;
* recompute ``dots``, ``dots_no_batch`` and ``named`` bitwise equal to
  recompute off within the port.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as paddle
import paddle_tpu.nn.clip as jclip
import paddle_tpu.optimizer as jopt_mod
from paddle_tpu.incubate.optimizer import GradientMergeOptimizer as JGM
from paddle_tpu.models.llama import LlamaConfig as JConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JModel
from paddle_tpu.optimizer import lr as jlr
from paddle_tpu.static.functionalize import build_train_step as j_build
from paddle_tpu.tensor.tensor import Tensor as JTensor
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import optimizer as topt_mod
from paddle_tpu_torch.incubate.optimizer import GradientMergeOptimizer
from paddle_tpu_torch.interop import tensor_from_numpy
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.nn.layer import Linear
from paddle_tpu_torch.optimizer import lr as tlr
from paddle_tpu_torch.static import build_train_step

torch.set_num_threads(1)


# ------------------------------------------------------------ schedulers
def _warm_cos(m):
    return m.LinearWarmup(m.CosineAnnealingDecay(0.1, T_max=20),
                          warmup_steps=5, start_lr=0.01, end_lr=0.1)


SCHEDULES = {
    "noam": lambda m: m.NoamDecay(d_model=64, warmup_steps=10,
                                  learning_rate=1.0),
    "piecewise": lambda m: m.PiecewiseDecay([5, 15, 30],
                                            [0.1, 0.05, 0.01, 0.001]),
    "natural_exp": lambda m: m.NaturalExpDecay(0.1, gamma=0.1),
    "inverse_time": lambda m: m.InverseTimeDecay(0.1, gamma=0.2),
    "polynomial": lambda m: m.PolynomialDecay(0.1, decay_steps=15,
                                              end_lr=1e-3, power=2.0),
    "polynomial_cycle": lambda m: m.PolynomialDecay(0.1, 15, 1e-3,
                                                    cycle=True),
    "warmup_cosine": _warm_cos,
    "warmup_const": lambda m: m.LinearWarmup(0.1, 5, 0.0, 0.1),
    "exponential": lambda m: m.ExponentialDecay(0.1, gamma=0.9),
    "multistep": lambda m: m.MultiStepDecay(0.1, milestones=[5, 12, 30],
                                            gamma=0.5),
    "step": lambda m: m.StepDecay(0.1, step_size=7, gamma=0.5),
    "lambda": lambda m: m.LambdaDecay(0.1, lr_lambda=lambda e: 0.95 ** e),
    "plateau": lambda m: m.ReduceOnPlateau(0.1, patience=2, factor=0.5,
                                           cooldown=1),
    "cosine": lambda m: m.CosineAnnealingDecay(0.1, T_max=15, eta_min=1e-3),
    "multiplicative": lambda m: m.MultiplicativeDecay(
        0.1, lr_lambda=lambda e: 0.97),
    "one_cycle": lambda m: m.OneCycleLR(0.1, total_steps=30),
    "one_cycle_linear": lambda m: m.OneCycleLR(0.1, 30,
                                               anneal_strategy="linear"),
    "cyclic_triangular2": lambda m: m.CyclicLR(0.01, 0.1, step_size_up=5,
                                               step_size_down=8,
                                               mode="triangular2"),
    "cyclic_exp_range": lambda m: m.CyclicLR(0.01, 0.1, 4,
                                             mode="exp_range",
                                             exp_gamma=0.95),
    "linear": lambda m: m.LinearLR(0.1, total_steps=20, start_factor=0.25),
    "warm_restarts": lambda m: m.CosineAnnealingWarmRestarts(
        0.1, T_0=5, T_mult=2, eta_min=1e-3),
}
# a noisy falling loss for ReduceOnPlateau's metric
_METRICS = list(np.maximum.accumulate(
    np.random.default_rng(0).random(40))[::-1] * 3)


def _rates(s, steps, start=0):
    out = []
    for i in range(start, start + steps):
        out.append(s())
        s.step(_METRICS[i]) if isinstance(s, (jlr.ReduceOnPlateau,
                                               tlr.ReduceOnPlateau)) \
            else s.step()
    return out


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_scheduler_rates_match_the_reference_exactly(name):
    """``paddle_tpu/optimizer/lr.py``: 40 rates equal as Python floats;
    a ``state_dict`` taken at step 17 and loaded into a fresh scheduler
    continues with the same rates."""
    ref = _rates(SCHEDULES[name](jlr), 40)
    assert _rates(SCHEDULES[name](tlr), 40) == ref
    s = SCHEDULES[name](tlr)
    head = _rates(s, 17)
    fresh = SCHEDULES[name](tlr)
    fresh.set_state_dict(s.state_dict())
    assert head + _rates(fresh, 23, start=17) == ref


# ------------------------------------------------------------------ clips
class _P:
    """A parameter stand-in: the clips read ``need_clip`` and ``grad``."""

    def __init__(self, need_clip=True, grad=None):
        self.need_clip = need_clip
        self.grad = grad


_CLIP_SHAPES = ((8, 16), (16,), (3, 5, 7), (300,))


def _clip_grads(dtype, scale=3.0):
    rng = np.random.default_rng(1)
    jd = jnp.dtype(dtype)
    return [np.asarray(jnp.asarray(scale * rng.standard_normal(s), jd))
            for s in _CLIP_SHAPES]


def _close(got, want):
    got = got.float().numpy()
    if want.dtype.name == "bfloat16":
        np.testing.assert_allclose(got, want.astype(np.float32),
                                   rtol=2.0 ** -8, atol=0)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["value", "norm", "global"])
def test_clip_objects_match_the_reference(kind, dtype):
    """``ClipGradByValue`` / ``ByNorm`` / ``ByGlobalNorm._dygraph_clip``;
    the third parameter has ``need_clip=False`` and passes unchanged."""
    make = {"value": lambda m: m.ClipGradByValue(0.5, -1.0),
            "norm": lambda m: m.ClipGradByNorm(2.0),
            "global": lambda m: m.ClipGradByGlobalNorm(4.0)}[kind]
    gs = _clip_grads(dtype)
    flags = [True, True, False, True]
    want = make(jclip)([(_P(f), JTensor(jnp.asarray(g)))
                        for f, g in zip(flags, gs)])
    got = make(tnn)([(_P(f), tensor_from_numpy(g))
                     for f, g in zip(flags, gs)])
    for (_, tg), (_, jg), g, f in zip(got, want, gs, flags):
        jg = np.asarray(jg.data)
        assert tg.dtype == tensor_from_numpy(g).dtype
        if kind == "value" or not f:
            assert np.array_equal(tg.float().numpy(),
                                  jg.astype(np.float32))
        else:
            _close(tg, jg)
    assert tnn.GradientClipByGlobalNorm is tnn.ClipGradByGlobalNorm


@pytest.mark.parametrize("norm_type", [2.0, 1.5, float("inf"), "value"],
                         ids=["l2", "p1.5", "inf", "value"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_in_place_clips_match_the_reference(norm_type, dtype):
    """``clip_grad_norm_`` (its returned total norm too) and
    ``clip_grad_value_`` on ``p.grad`` in place."""
    gs = _clip_grads(dtype)
    jps = [_P(grad=JTensor(jnp.asarray(g))) for g in gs]
    tps = [_P(grad=tensor_from_numpy(g)) for g in gs]
    if norm_type == "value":
        jclip.clip_grad_value_(jps, 0.7)
        tnn.clip_grad_value_(tps, 0.7)
    else:
        jt = jclip.clip_grad_norm_(jps, 5.0, norm_type)
        tt = tnn.clip_grad_norm_(tps, 5.0, norm_type)
        _close(tt, np.asarray(jt.data))
    for tp, jp in zip(tps, jps):
        _close(tp.grad, np.asarray(jp.grad.data))


# ------------------------------------------------------------- optimizers
_SHAPES = {"a": (8, 40), "b": (40,), "c": (3, 300)}
LR = 1e-2


def _opt_cases():
    def lamb(m):
        return m.Lamb(LR, exclude_from_weight_decay_fn=lambda p: p.name == "b")
    return {
        "sgd": (lambda m: m.SGD(LR, weight_decay=0.01), {}),
        "sgd-bf16": (lambda m: m.SGD(LR), dict(dtype="bfloat16")),
        "momentum": (lambda m: m.Momentum(LR, weight_decay=0.01), {}),
        "momentum-nesterov": (lambda m: m.Momentum(LR, use_nesterov=True,
                                                   rescale_grad=0.5), {}),
        "momentum-int8": (lambda m: m.Momentum(LR), dict(int8=True)),
        "adam": (lambda m: m.Adam(LR), {}),
        "adam-amsgrad": (lambda m: m.Adam(LR, amsgrad=True), {}),
        "adamw": (lambda m: m.AdamW(LR), {}),
        "adamw-amsgrad": (lambda m: m.AdamW(LR, amsgrad=True), {}),
        "adamw-lr_ratio": (lambda m: m.AdamW(LR, lr_ratio=lambda p: 0.5),
                           {}),
        "adamw-bf16-mp": (lambda m: m.AdamW(LR, multi_precision=True),
                          dict(dtype="bfloat16")),
        "adamax": (lambda m: m.Adamax(LR), {}),
        "adagrad": (lambda m: m.Adagrad(LR), {}),
        "adadelta": (lambda m: m.Adadelta(1.0), {}),
        "rmsprop": (lambda m: m.RMSProp(LR), {}),
        "rmsprop-centered": (lambda m: m.RMSProp(LR, momentum=0.9,
                                                 centered=True), {}),
        "nadam": (lambda m: m.NAdam(LR), {}),
        "radam": (lambda m: m.RAdam(LR), {}),
        "radam-rectified": (lambda m: m.RAdam(LR, beta2=0.99), dict(t0=5)),
        "lamb": (lamb, {}),
        "asgd": (lambda m: m.ASGD(LR, batch_num=2), {}),
        "rprop": (lambda m: m.Rprop(LR), {}),
    }


_OPT_CASES = _opt_cases()


@pytest.mark.parametrize("case", sorted(_OPT_CASES))
def test_optimizer_functional_update_matches_the_reference(case):
    """``Optimizer.functional_update`` of each optimizer over 3 steps, the
    step counter a Python int as the port holds it, the rate an f32
    scalar as the reference's TrainStep passes it."""
    make, kw = _OPT_CASES[case]
    dtype, t0 = kw.get("dtype", "float32"), kw.get("t0", 1)
    rng = np.random.default_rng(7)
    jd = jnp.dtype(dtype)
    jp = {k: jnp.asarray(rng.standard_normal(s), jd)
          for k, s in _SHAPES.items()}
    jo, to = make(jopt_mod), make(topt_mod)
    if kw.get("int8"):
        # the reference's Momentum reads moment_dtype off the base only
        jo._moment_dtype = "int8"
        to = topt_mod.Momentum(LR, moment_dtype="int8")
    jst = jo.functional_init_states(jp)
    tp = {k: tensor_from_numpy(np.asarray(v)) for k, v in jp.items()}
    tst = to.functional_init_states(tp)
    assert {n: set(d) for n, d in tst.items()} == \
        {n: set(d) for n, d in jst.items()}
    # int8 codes: compare with the reference compiled, as its TrainStep
    # runs it (XLA multiplies by 1/127 where eager jnp divides)
    jupd = jax.jit(lambda p, g, s: jo.functional_update(
        p, g, s, jnp.float32(LR))) if kw.get("int8") else \
        (lambda p, g, s: jo.functional_update(p, g, s, jnp.float32(LR)))
    for t in range(t0, t0 + 3):
        g = {k: np.asarray(jnp.asarray(rng.standard_normal(s), jd))
             for k, s in _SHAPES.items()}
        jo._global_step = to._global_step = t
        jp, jst = jupd(jp, {k: jnp.asarray(v) for k, v in g.items()}, jst)
        tp, tst = to.functional_update(
            tp, {k: tensor_from_numpy(v) for k, v in g.items()}, tst, LR)
    for k in _SHAPES:
        want = np.asarray(jp[k])
        assert tp[k].dtype == tensor_from_numpy(want).dtype
        if dtype == "bfloat16":
            np.testing.assert_allclose(tp[k].float().numpy(),
                                       want.astype(np.float32),
                                       rtol=2.0 ** -8, atol=1e-6)
        else:
            np.testing.assert_allclose(tp[k].numpy(), want, rtol=1e-5,
                                       atol=1e-6)
    for n, d in jst.items():
        for k, want in d.items():
            want, got = np.asarray(want), tst[n][k]
            if want.dtype == np.int8:
                assert got.dtype == torch.int8
                assert np.abs(got.numpy().astype(int) - want).max() <= 1
            elif n.endswith("@scale"):
                np.testing.assert_allclose(got.numpy(), want, rtol=1 / 127)
            else:
                np.testing.assert_allclose(
                    got.float().numpy(), want.astype(np.float32),
                    rtol=1e-5, atol=1e-7, err_msg=f"{n}/{k}")


# ------------------------------------------------ the knobs-on trainer
TINY = dict(vocab_size=256, hidden_size=64, intermediate_size=128,
            num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
            max_position_embeddings=128, dtype="float32")
_MEMO = {}


def _knobbed(m, opt_mod, clip_mod, params):
    """AdamW under a warmup/cosine schedule and global-norm clipping,
    merged over 2 micro-steps; the training step steps the schedule."""
    sched = m.LinearWarmup(m.CosineAnnealingDecay(1e-3, T_max=10),
                           warmup_steps=2, start_lr=1e-4, end_lr=1e-3)
    inner = opt_mod.AdamW(learning_rate=sched, parameters=params,
                          weight_decay=0.01,
                          grad_clip=clip_mod.ClipGradByGlobalNorm(0.5))
    inner._lr_scheduler = sched
    return sched, inner


def _data(b, l, seed=2):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, TINY["vocab_size"], (b, l)),
            rng.integers(0, TINY["vocab_size"], (b, l)))


def _jax_knobs_run(steps=4):
    if "knobs" not in _MEMO:
        paddle.seed(0)
        jm = JModel(JConfig(**TINY))
        state = {k: np.asarray(v) for k, v in jm.functional_state()[0]
                 .items()}
        sched, inner = _knobbed(jlr, jopt_mod, jclip, jm.parameters())
        step = j_build(jm, None, JGM(inner, k_steps=2))
        ids, labels = _data(2, 16)
        losses, params, rates = [], [], []
        for _ in range(steps):
            rates.append(inner.get_lr())
            losses.append(float(np.asarray(
                step(paddle.to_tensor(ids), paddle.to_tensor(labels)).data)))
            params.append({k: np.asarray(v) for k, v in step._params.items()})
        _MEMO["knobs"] = (state, losses, params, rates)
    return _MEMO["knobs"]


def test_knobs_on_train_steps_match_build_train_step():
    """Clip + schedule + merge k=2 over 4 steps against the reference's
    ``build_train_step``: losses within 1e-6 relative; parameters after
    each step within ``2·lr·step`` and all but 1e-4 within 1e-5; the
    parameters bit-equal across the non-apply steps (1 and 3); each
    step's rate equal to the reference scheduler's."""
    state, jlosses, jparams, jrates = _jax_knobs_run()
    tm = LlamaForCausalLM(LlamaConfig(**TINY), device="cpu")
    tm.load_numpy_state(state)
    sched, inner = _knobbed(tlr, topt_mod, tnn, tm.parameters())
    step = build_train_step(tm, None, GradientMergeOptimizer(inner, 2))
    ids, labels = (torch.from_numpy(x) for x in _data(2, 16))
    for i in range(4):
        assert inner.get_lr() == jrates[i]
        before = tm.numpy_state()
        loss = float(step(ids, labels))
        assert abs(loss - jlosses[i]) <= 1e-6 * abs(jlosses[i]), (i, loss)
        got = tm.numpy_state()
        if i % 2 == 0:
            assert all(np.array_equal(got[k], before[k]) for k in got)
        n_off = n_all = 0
        for name, w in jparams[i].items():
            d = np.abs(got[name] - w)
            assert d.max() <= 2 * 1e-3 * (i + 1), (name, float(d.max()))
            n_off += int((d > 1e-5 + 1e-5 * np.abs(w)).sum())
            n_all += d.size
        assert n_off <= 1e-4 * n_all, (n_off, n_all)
    assert all(float(t.abs().max()) == 0 for t in step._states["gm_acc"]
               .values())


# ---------------------------------------------------------- eager API
def _mlp(seed=0, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    net = torch.nn.Sequential(Linear(16, 32, dtype=dtype),
                              torch.nn.Tanh(), Linear(32, 4, dtype=dtype))
    for layer in (net[0], net[2]):
        layer.reset_parameters(g)
    return net


def _mlp_batches(n, seed=3):
    rng = np.random.default_rng(seed)
    return [(torch.from_numpy(rng.standard_normal((8, 16)).astype(np.float32)),
             torch.from_numpy(rng.standard_normal((8, 4)).astype(np.float32)))
            for _ in range(n)]


def _mse(out, y):
    return ((out - y) ** 2).mean()


@pytest.mark.parametrize("kind", ["momentum-clip", "adamw-int8",
                                  "lamb-schedule"])
def test_eager_step_equals_build_train_step(kind):
    """``loss.backward(); opt.step(); opt.clear_grad()`` runs the same
    ``functional_update`` as ``build_train_step``: parameters bitwise
    equal after 3 steps."""
    def make(params):
        if kind == "momentum-clip":
            return topt_mod.Momentum(0.1, parameters=params,
                                     grad_clip=tnn.ClipGradByGlobalNorm(0.3))
        if kind == "adamw-int8":
            return topt_mod.AdamW(1e-2, parameters=params,
                                  moment_dtype="int8")
        return topt_mod.Lamb(tlr.StepDecay(0.05, 1, 0.5), parameters=params)
    batches = _mlp_batches(3)
    eager, fused = _mlp(), _mlp()
    opt = make(eager.parameters())
    for x, y in batches:
        opt.minimize(_mse(eager(x), y))
        if kind == "lamb-schedule":
            opt._learning_rate.step()
    fopt = make(fused.parameters())
    if kind == "lamb-schedule":
        fopt._lr_scheduler = fopt._learning_rate
    step = build_train_step(fused, _mse, fopt)
    for x, y in batches:
        step(x, y)
    for a, b in zip(eager.parameters(), fused.parameters()):
        assert torch.equal(a, b)
    assert all(p.grad is None for p in eager.parameters())
    assert opt._global_step == 3


def test_gradient_merge_eager_window_and_state_dict_resume():
    """Eager ``GradientMergeOptimizer.step``: parameters do not move on
    non-apply steps; a ``state_dict`` taken after step 3 (mid-window) and
    loaded into a fresh model and optimizer continues bit for bit, and
    carries the optimizer's state, the step and the scheduler."""
    batches = _mlp_batches(6)

    def make(net):
        sched = tlr.ExponentialDecay(0.05, 0.9)
        return sched, GradientMergeOptimizer(topt_mod.Adam(
            sched, parameters=net.parameters()), k_steps=2)

    def run(net, sched, gm, bs):
        for x, y in bs:
            before = [p.detach().clone() for p in net.parameters()]
            gm.minimize(_mse(net(x), y))
            moved = [not torch.equal(a, b)
                     for a, b in zip(before, net.parameters())]
            assert all(moved) if gm._count % 2 == 0 else not any(moved)
            sched.step()

    full = _mlp()
    run(full, *make(full), batches)
    first = _mlp()
    sched, gm = make(first)
    run(first, sched, gm, batches[:3])
    sd = gm.state_dict()
    assert sd["gradient_merge_count"] == 3 and len(
        sd["gradient_merge_acc"]) == 4
    assert sd["global_step"] == 1 and "LR_Scheduler" in sd
    assert any(k.endswith("_moment1") for k in sd)
    resumed = _mlp(seed=9)
    resumed.load_state_dict(first.state_dict())
    sched2, gm2 = make(resumed)
    gm2.set_state_dict(sd)
    assert sched2() == sched()
    run(resumed, sched2, gm2, batches[3:])
    for a, b in zip(full.parameters(), resumed.parameters()):
        assert torch.equal(a, b)


# ---------------------------------------------------------- recompute
WIDE = dict(TINY, hidden_size=512, intermediate_size=256)


@pytest.mark.parametrize("policy", ["dots", "dots_no_batch", "named"])
def test_selective_recompute_equals_recompute_off_bitwise(policy):
    """Per-layer recompute under each selective policy (the flash and
    fused-RoPE plain versions at head_dim 128) changes nothing: loss and
    every gradient bitwise those of the run that keeps every
    activation."""
    ids, labels = (torch.from_numpy(x) for x in _data(2, 128, seed=4))
    runs = []
    for cfg in (dict(WIDE), dict(WIDE, recompute=True,
                                 recompute_policy=policy)):
        tm = LlamaForCausalLM(LlamaConfig(**cfg), device="cpu", seed=1)
        loss = tm(ids, labels)
        runs.append((loss.detach(), torch.autograd.grad(
            loss, list(tm.parameters()))))
    assert torch.equal(runs[0][0], runs[1][0])
    for a, b in zip(runs[0][1], runs[1][1]):
        assert torch.equal(a, b)
