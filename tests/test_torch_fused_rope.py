"""The port's fused RoPE against the JAX package's Pallas kernel.

The plain version (what the port's kernel K6 is held to, bitwise, on the
card) against ``_rope_pallas(..., interpret=True)`` on the same numpy
inputs: the rotation and its inverse (sin negated), tables taken at a
position offset, f32 and bf16; the gradients through the port's
``autograd.Function`` against ``jax.grad`` of ``fused_rope``.
Tolerances: f32 1e-6 (the reference may contract the product and sum
into one rounding); bf16 the rounding error of the reference's three
bf16 operations, ``2^-8 (|x cos| + |swap(x) sin| + |out|)`` per element
(it rounds each product and the sum to bf16, the port once at the end).
"""
import ml_dtypes
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.models.llama import _rope_cos_sin as j_tables
from paddle_tpu.ops.fused_rope import _rope_pallas
from paddle_tpu.ops.fused_rope import available as j_available
from paddle_tpu.ops.fused_rope import fused_rope as j_fused_rope
from paddle_tpu_torch.interop import tensor_from_numpy
from paddle_tpu_torch.models.llama import _rope_cos_sin
from paddle_tpu_torch.ops import fused_rope as trope

torch.set_num_threads(1)

B, L, NH, NKV, D, OFF = 2, 128, 4, 2, 128, 37


def _case(dtype, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, L, NH * D)).astype(np.float32)
    k = rng.standard_normal((B, L, NKV * D)).astype(np.float32)
    cos, sin = (np.asarray(x) for x in j_tables(OFF + L, D, 10000.0,
                                                jnp.float32))
    np_dt = ml_dtypes.bfloat16 if dtype == "bfloat16" else np.float32
    return [x.astype(np_dt) for x in (q, k, cos[OFF:], sin[OFF:])]


def _close(got, want, dtype, terms=None):
    got = got.float().numpy()
    want = np.asarray(want).astype(np.float32)
    if dtype == "bfloat16":
        a, b = terms if terms is not None else (want, 0.0)
        tol = 2.0 ** -8 * (np.abs(a) + np.abs(b) + np.abs(want))
        assert (np.abs(got - want) <= tol).all(), \
            float(np.abs(got - want).max())
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def _terms(x, cos, sin, h, neg):
    """The two products of the rotation, f32, ``[B, L, h*D]``."""
    x = x.astype(np.float32).reshape(B, L, h, D)
    c = cos.astype(np.float32)[None, :, None, :]
    s = sin.astype(np.float32)
    s = np.concatenate([-s[:, :D // 2], s[:, D // 2:]], -1)[None, :, None]
    sw = np.concatenate([x[..., D // 2:], x[..., :D // 2]], -1)
    return ((x * c).reshape(B, L, h * D),
            (sw * (-s if neg else s)).reshape(B, L, h * D))


@pytest.mark.parametrize("neg", [False, True], ids=["rotate", "inverse"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_pallas_interpret(dtype, neg):
    q, k, cos, sin = _case(dtype)
    jq, jk = _rope_pallas(jnp.asarray(q), jnp.asarray(k), jnp.asarray(cos),
                          jnp.asarray(sin), NH, NKV, neg=neg, interpret=True)
    tq, tk = trope.rope_reference(*map(tensor_from_numpy, (q, k, cos, sin)),
                                  NH, NKV, neg)
    assert tq.dtype == tk.dtype == tensor_from_numpy(q).dtype
    _close(tq, jq, dtype, _terms(q, cos, sin, NH, neg))
    _close(tk, jk, dtype, _terms(k, cos, sin, NKV, neg))


def test_inverse_undoes_the_rotation():
    q, k, cos, sin = map(tensor_from_numpy, _case("float32", seed=1))
    rq, rk = trope.rope_reference(q, k, cos, sin, NH, NKV)
    bq, bk = trope.rope_reference(rq, rk, cos, sin, NH, NKV, neg=True)
    torch.testing.assert_close(bq, q, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(bk, k, atol=1e-5, rtol=1e-5)


def test_grads_match_jax_grad():
    q, k, cos, sin = _case("float32", seed=2)
    rng = np.random.default_rng(3)
    wq = rng.standard_normal(q.shape).astype(np.float32)
    wk = rng.standard_normal(k.shape).astype(np.float32)

    def f(q_, k_):
        a, b = j_fused_rope(q_, k_, jnp.asarray(cos), jnp.asarray(sin), NH,
                            NKV, True)
        return jnp.vdot(a, wq) + jnp.vdot(b, wk)

    jgq, jgk = jax.grad(f, argnums=(0, 1))(jnp.asarray(q), jnp.asarray(k))
    tq, tk = (torch.from_numpy(x).requires_grad_(True) for x in (q, k))
    oq, ok = trope.fused_rope(tq, tk, torch.from_numpy(cos),
                              torch.from_numpy(sin), NH, NKV)
    ((oq * torch.from_numpy(wq)).sum()
     + (ok * torch.from_numpy(wk)).sum()).backward()
    np.testing.assert_allclose(tq.grad.numpy(), np.asarray(jgq), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(tk.grad.numpy(), np.asarray(jgk), rtol=1e-5,
                               atol=1e-5)


def test_tables_match_the_reference():
    for dt, tdt in (("float32", torch.float32),
                    ("bfloat16", torch.bfloat16)):
        jc, js = j_tables(300, D, 10000.0, jnp.dtype(dt))
        tc, ts = _rope_cos_sin(300, D, 10000.0, tdt, "cpu")
        _close(tc, jc, dt)
        _close(ts, js, dt)


@pytest.mark.parametrize("shape", [
    ((2, 128, 512), (2, 128, 256), 4, 2), ((2, 256, 256), (2, 256, 256), 4,
                                            4),
    ((2, 100, 512), (2, 100, 256), 4, 2), ((1, 64, 512), (1, 64, 256), 4, 2),
    ((2, 128, 512), (2, 128, 128), 4, 2)], ids=str)
def test_gate_is_the_reference_gate_without_the_tpu(shape, monkeypatch):
    import paddle_tpu.ops.fused_rope as jfr

    monkeypatch.setattr(jfr, "_on_tpu", lambda: True)
    assert trope.available(*shape) == j_available(*shape)
