"""K7, the fused int8-moment AdamW, and the int8 moment storage, against
the JAX package on the CPU.

Inputs are made with numpy from a seed and go through both packages.
The port's plain version (``fused_adamw_q8`` on CPU tensors) is held to
the reference's Pallas kernel ``_fused_adamw_q8`` run in interpret mode,
as the reference's own ``TestFusedAdamQ8`` runs it, at the shapes of that
test (native 2-D tiles and the flat view), with and without an f32
master; a ragged size (100 values, one short block), which the reference
sends to its jnp path, is held to that path.  The JAX side runs
compiled, as the reference's training step does, and XLA's CPU backend
then (a) multiplies by ``f32(1/127)`` where the source divides by 127 —
the port does the same — and (b) contracts ``b1*m + (1-b1)*g`` into one
fused multiply-add where the source rounds twice.  The port keeps the
source's two roundings (its kernel must match its plain version bit for
bit), so ``m'`` may differ by one f32 rounding, and with it:

* the codes: within one, on at most 0.1% of the elements (a code flips
  only where ``m'/s'`` sits within ~1e-5 of a rounding boundary);
* the scales: within 2.5e-7 relative (one f32 rounding of ``max|m'|``);
* the bf16 second moment and the bf16 parameter: within one bf16 unit in
  the last place; an f32 master within ``1e-6`` relative.

The codes and scales of a given f32 moment (``q8_encode``) are bitwise
the reference's; the optimizer's own CPU path (decode, ``_update``,
encode, as the reference off the TPU) is held to the reference's
``functional_update`` over two steps at the tolerances above.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.fused_adamw import _fused_adamw_q8
from paddle_tpu.optimizer import Adam as JAdam
from paddle_tpu.optimizer import AdamW as JAdamW
from paddle_tpu.optimizer.optimizers import _pow_t as _jpow_t
from paddle_tpu_torch.interop import tensor_from_numpy
from paddle_tpu_torch.ops import fused_adamw as k7
from paddle_tpu_torch.optimizer import Adam, AdamW

torch.set_num_threads(1)

B1, B2, EPS, LR, STEP, DECAY = 0.9, 0.999, 1e-8, 0.01, 3, 0.05


def _jax_scalars(lr=LR, step=STEP, decay=DECAY):
    """The 16 scalars exactly as ``Adam._update_param`` builds them."""
    lrf = jnp.asarray(lr, jnp.float32)
    z = jnp.float32(0.0)
    return jnp.stack([
        jnp.float32(B1), jnp.float32(B2), jnp.float32(EPS), lrf,
        1.0 - _jpow_t(B1, step), 1.0 - _jpow_t(B2, step),
        1.0 - lrf * jnp.float32(decay), z,
        jnp.float32(1.0 - B1), jnp.float32(1.0 - B2), z, z, z, z, z, z])


def _jit_update(jopt):
    """The reference's ``functional_update`` compiled, as its training
    step runs it (XLA then multiplies by ``f32(1/127)`` where the source
    divides by 127)."""
    return jax.jit(lambda p, g, s: jopt.functional_update(
        p, g, s, jnp.float32(LR)))


def _case(shape, seed=0):
    """A bf16 parameter with its f32 master, an f32 gradient and
    nontrivial moments (codes from an encoded f32 moment, |v| in bf16)."""
    rng = np.random.default_rng(seed)
    p32 = rng.standard_normal(shape).astype(np.float32)
    g = rng.standard_normal(shape).astype(np.float32)
    m0 = (0.1 * rng.standard_normal(shape)).astype(np.float32)
    v0 = np.abs(rng.standard_normal(shape)).astype(np.float32)
    codes, scales = k7.q8_encode(torch.from_numpy(m0))
    return dict(p32=p32, p=torch.from_numpy(p32).to(torch.bfloat16), g=g,
                codes=codes, scales=scales,
                v=torch.from_numpy(v0).to(torch.bfloat16))


def _codes_close(got, want, frac=1e-3):
    d = np.abs(got.astype(np.int32) - np.asarray(want).astype(np.int32))
    assert d.max() <= 1 and (d > 0).mean() <= frac, (d.max(), (d > 0).mean())


def _f32_of(a):
    return np.asarray(a).astype(np.float32)


def _np(t):
    return t.view(torch.int16).numpy() if t.dtype == torch.bfloat16 \
        else t.numpy()


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def test_host_scalars_equal_the_references():
    ours = k7.adamw_scalars(B1, B2, EPS, LR, STEP, DECAY)
    ref = np.asarray(_jax_scalars())
    want = [ref[i] for i in (0, 1, 2, 3, 4, 5, 6, 8, 9)]
    got = np.asarray([ours[k] for k in ("b1", "b2", "eps", "lr", "c1", "c2",
                                        "wd", "omb1", "omb2")], np.float32)
    np.testing.assert_array_equal(got, np.asarray(want, np.float32))


@pytest.mark.parametrize("master", [False, True], ids=["bf16", "master"])
@pytest.mark.parametrize("shape", [(8, 2048), (8, 512), (2048,), (12, 256)],
                         ids=str)
def test_plain_matches_pallas_interpret(shape, master):
    c = _case(shape)
    # without a master the gradient arrives in bf16 (the bench's case);
    # with one, in f32
    g = torch.from_numpy(c["g"])
    if not master:
        g = g.to(torch.bfloat16)
    n = int(np.prod(shape))
    p_in = jnp.asarray(c["p32"]) if master \
        else tensor_jax(c["p"])
    outs = _fused_adamw_q8(
        p_in.reshape(-1), tensor_jax(g).reshape(-1),
        jnp.asarray(c["codes"].numpy()).reshape(-1),
        jnp.asarray(c["scales"].numpy()), tensor_jax(c["v"]).reshape(-1),
        _jax_scalars(), out_dtype=jnp.bfloat16, has_master=master,
        interpret=True)
    if master:
        jm, jp, jc, js, jv = outs
    else:
        jp, jc, js, jv = outs
    p, codes, scales, v = (c["p"].clone(), c["codes"].clone(),
                           c["scales"].clone(), c["v"].clone())
    mw = torch.from_numpy(c["p32"].copy()) if master else None
    before = k7.plain_runs
    k7.fused_adamw_q8(p, g, codes, scales, v,
                      k7.adamw_scalars(B1, B2, EPS, LR, STEP, DECAY),
                      master=mw)
    assert k7.plain_runs == before + 1
    _codes_close(codes.numpy().reshape(-1), jc)
    np.testing.assert_allclose(scales.numpy(), np.asarray(js), rtol=2.5e-7,
                               atol=0)
    np.testing.assert_allclose(v.float().numpy().reshape(-1), _f32_of(jv),
                               rtol=2.0 ** -7, atol=0)
    np.testing.assert_allclose(p.float().numpy().reshape(-1), _f32_of(jp),
                               rtol=2.0 ** -7, atol=1e-7)
    if master:
        np.testing.assert_allclose(mw.numpy().reshape(-1), np.asarray(jm),
                                   rtol=1e-6, atol=1e-7)
    assert codes.shape == shape and n == codes.numel()


def tensor_jax(t):
    """A CPU tensor (bf16 through its bits) -> a JAX array."""
    if t.dtype == torch.bfloat16:
        return jnp.asarray(t.view(torch.int16).numpy()).view(jnp.bfloat16)
    return jnp.asarray(t.numpy())


@pytest.mark.parametrize("master", [False, True], ids=["bf16", "master"])
def test_ragged_block_matches_jnp_path(master):
    """100 values: one short block, zero-padded by the encode.  The
    reference sends it to its jnp path (decode, ``_update``, encode)."""
    c = _case((100,), seed=1)
    jopt = JAdamW(learning_rate=LR, weight_decay=DECAY, moment_dtype="int8",
                  multi_precision=master)
    jopt._global_step = STEP
    jparams = {"b": tensor_jax(c["p"])}
    jst = jopt.functional_init_states(jparams)
    jst["moment1"]["b"] = jnp.asarray(c["codes"].numpy())
    jst["moment1@scale"]["b"] = jnp.asarray(c["scales"].numpy())
    jst["moment2"]["b"] = tensor_jax(c["v"])
    if master:
        jst["master_weight"]["b"] = jnp.asarray(c["p32"])
    jp, jst = _jit_update(jopt)(jparams, {"b": jnp.asarray(c["g"])}, jst)
    p, codes, scales, v = (c["p"].clone(), c["codes"].clone(),
                           c["scales"].clone(), c["v"].clone())
    mw = torch.from_numpy(c["p32"].copy()) if master else None
    k7.fused_adamw_q8(p, torch.from_numpy(c["g"]), codes, scales, v,
                      k7.adamw_scalars(B1, B2, EPS, LR, STEP, DECAY),
                      master=mw)
    _codes_close(codes.numpy(), jst["moment1"]["b"], frac=0.02)
    np.testing.assert_allclose(scales.numpy(),
                               np.asarray(jst["moment1@scale"]["b"]),
                               rtol=2.5e-7, atol=0)
    np.testing.assert_allclose(v.float().numpy(),
                               _f32_of(jst["moment2"]["b"]),
                               rtol=2.0 ** -7, atol=0)
    if master:
        np.testing.assert_allclose(mw.numpy(),
                                   np.asarray(jst["master_weight"]["b"]),
                                   rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(p.float().numpy(), _f32_of(jp["b"]),
                               rtol=2.0 ** -7, atol=1e-7)


@pytest.mark.parametrize("shape", [(3, 256), (100,), (7, 300), (1,)],
                         ids=str)
def test_q8_encode_decode_match_reference(shape):
    rng = np.random.default_rng(2)
    x = (rng.standard_normal(shape) * 10.0 ** rng.integers(
        -6, 3, shape)).astype(np.float32)
    x.reshape(-1)[:3] = 0.0                     # a zero-led block
    codes, scales = k7.q8_encode(torch.from_numpy(x))
    jc, js = jax.jit(JAdamW._q8_encode)(jnp.asarray(x))
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(scales.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        k7.q8_decode(codes, scales).numpy(),
        np.asarray(jax.jit(JAdamW._q8_decode)(jc, js)))


@pytest.mark.parametrize("cls,jcls,kw", [
    (AdamW, JAdamW, dict(weight_decay=0.05)),
    (Adam, JAdam, dict(weight_decay=0.01)),           # the L2 term
    (AdamW, JAdamW, dict(weight_decay=0.05, multi_precision=True))],
    ids=["adamw", "adam-l2", "adamw-master"])
def test_optimizer_int8_states_match_reference(cls, jcls, kw):
    """Two ``functional_update`` steps from zero states: a bf16 matrix, a
    ragged bf16 vector and an f32 vector, at the module's tolerances (the
    codes on at most 2% of the elements: these tensors hold a few hundred
    values, so one flip is 0.3-1%)."""
    rng = np.random.default_rng(4)
    shapes = {"w": (16, 48), "b": (100,), "f": (40,)}
    p32 = {k: rng.standard_normal(s).astype(np.float32)
           for k, s in shapes.items()}
    jp = {k: jnp.asarray(v).astype(jnp.float32 if k == "f"
                                   else jnp.bfloat16)
          for k, v in p32.items()}
    jopt = jcls(learning_rate=LR, moment_dtype="int8", **kw)
    topt = cls(learning_rate=LR, moment_dtype="int8", **kw)
    jst = jopt.functional_init_states(jp)
    tp = {k: tensor_from_numpy(np.asarray(v)) for k, v in jp.items()}
    tst = topt.functional_init_states(tp)
    assert set(tst) == set(jst)
    for k, s in shapes.items():
        assert tst["moment1"][k].dtype == torch.int8
        assert tst["moment2"][k].dtype == torch.bfloat16
        assert tst["moment1@scale"][k].shape == (-(-int(np.prod(s))
                                                   // 256),)
    for t in (1, 2):
        g = {k: rng.standard_normal(s).astype(np.float32)
             for k, s in shapes.items()}
        jg = {k: jnp.asarray(v).astype(jp[k].dtype) for k, v in g.items()}
        jopt._global_step = topt._global_step = t
        jp, jst = _jit_update(jopt)(jp, jg, jst)
        tg = {k: tensor_from_numpy(np.asarray(v)) for k, v in jg.items()}
        tp, tst = topt.functional_update(tp, tg, tst, LR)
        for k in shapes:
            _codes_close(tst["moment1"][k].numpy(), jst["moment1"][k],
                         frac=0.02)
            np.testing.assert_allclose(
                tst["moment1@scale"][k].numpy(),
                np.asarray(jst["moment1@scale"][k]), rtol=2.5e-7, atol=0)
            np.testing.assert_allclose(
                tst["moment2"][k].float().numpy(),
                _f32_of(jst["moment2"][k]), rtol=2.0 ** -7, atol=0)
            np.testing.assert_allclose(
                tp[k].float().numpy(), _f32_of(jp[k]),
                rtol=2.0 ** -7 if tp[k].dtype == torch.bfloat16 else 1e-6,
                atol=1e-7)


def test_cpu_optimizer_takes_the_decode_path_not_the_kernel():
    """On the CPU the optimizer decodes, updates and re-encodes (the
    reference's behaviour off the TPU); only the card routes to K7."""
    opt = AdamW(learning_rate=LR, moment_dtype="int8")
    p = {"w": torch.zeros(300, dtype=torch.bfloat16)}
    st = opt.functional_init_states(p)
    opt._global_step = 1
    runs, launched = k7.plain_runs, k7.launches
    new, st2 = opt.functional_update(p, {"w": torch.ones(300)}, st, LR)
    assert (k7.plain_runs, k7.launches) == (runs, launched)
    assert new["w"] is not p["w"] and st2["moment1"]["w"].dtype == torch.int8
    assert float(st2["moment1@scale"]["w"][1]) > 0     # the ragged block


def test_wrapper_checks_its_operands():
    p = torch.zeros(300)
    ok = dict(g=torch.zeros(300), codes=torch.zeros(300, dtype=torch.int8),
              scales=torch.zeros(2), v=torch.zeros(300, dtype=torch.bfloat16))
    sc = k7.adamw_scalars(B1, B2, EPS, LR, 1, 0.0)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        k7.fused_adamw_q8(p, *ok.values(), sc, impl="cuda")
    with pytest.raises(ValueError, match="scales must be float32"):
        k7.fused_adamw_q8(p, ok["g"], ok["codes"], torch.zeros(1), ok["v"],
                          sc)
    with pytest.raises(ValueError, match="bfloat16"):
        k7.fused_adamw_q8(p, ok["g"], ok["codes"], ok["scales"],
                          torch.zeros(300), sc)


def test_wrapper_takes_only_the_dtypes_the_optimizer_passes():
    """K7 is built for bf16 and f32 parameters and gradients only (no
    path of the port trains in f16); the plain version refuses the same,
    so the CPU and the card accept the same calls."""
    ok = dict(codes=torch.zeros(300, dtype=torch.int8),
              scales=torch.zeros(2), v=torch.zeros(300, dtype=torch.bfloat16))
    sc = k7.adamw_scalars(B1, B2, EPS, LR, 1, 0.0)
    with pytest.raises(ValueError, match="parameter dtype torch.float16"):
        k7.fused_adamw_q8(torch.zeros(300, dtype=torch.float16),
                          torch.zeros(300), *ok.values(), sc)
    with pytest.raises(ValueError, match="gradient must be float32 or"):
        k7.fused_adamw_q8(torch.zeros(300),
                          torch.zeros(300, dtype=torch.float16),
                          *ok.values(), sc)
