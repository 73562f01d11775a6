"""The port's flash attention with in-kernel RoPE (K10) against the JAX
package's.

The same numpy inputs go through the JAX package's
``flash_attention_packed_rope(..., interpret=True)`` (its Pallas kernels
in interpret mode, as ``tests/test_fused_rope.py`` runs them) under
``jax.vjp``, and through the port's ``flash_attention_packed_rope`` on
CPU tensors (the plain versions the port's kernels are held to on the
card) under autograd.  Tolerances: f32 ``rtol=atol=2e-5`` on values,
``2e-4`` on gradients (the JAX package's own kernel tests); bf16 within 2
ulps, elements within ``2^-10`` of the tensor's largest magnitude held to
that bound instead (near zero the backward's rounding of ds, taken from
scores summed in another order, moves an element by more ulps than it
has) — ``2^-9`` for dK: XLA's CPU compiler keeps some bf16 intermediates
of the interpret-mode dK/dV kernel in f32 (``xla_allow_excess_precision``,
on by default), so its dK is not the reference's code evaluated op by op;
with that flag off the two agree exactly, and the port's dK with them on
all but a few elements.
"""
import ml_dtypes
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.models.llama import _rope_cos_sin as j_tables
from paddle_tpu.ops import flash_attention as jfa
from paddle_tpu_torch.ops import flash_attention as tfa

# small shapes: torch's intra-op threads would only contend with the
# other test processes sharing this machine
torch.set_num_threads(1)

FWD = dict(atol=2e-5, rtol=2e-5)
BWD = dict(atol=2e-4, rtol=2e-4)


def _inputs(b, lq, lk, h, hkv, d, dtype="float32", seed=0):
    """numpy q, k, v, dout in ``dtype`` and the f32 tables ``[Lk, D]``."""
    rng = np.random.default_rng(seed)
    np_dt = ml_dtypes.bfloat16 if dtype == "bfloat16" else np.float32

    def rnd(*shape):
        return rng.standard_normal(shape).astype(np.float32).astype(np_dt)
    cos, sin = (np.array(t) for t in j_tables(lk, d, 10000.0, jnp.float32))
    return (rnd(b, lq, h * d), rnd(b, lk, hkv * d), rnd(b, lk, hkv * d),
            rnd(b, lq, h * d), cos, sin)


def _jax(q, k, v, do, cos, sin, h, hkv, causal):
    """JAX: (out, dq, dk, dv, dcos, dsin) as f32 numpy arrays."""
    def f(q_, k_, v_, c_, s_):
        return jfa.flash_attention_packed_rope(q_, k_, v_, c_, s_, h, hkv,
                                               causal, None, True)
    out, vjp = jax.vjp(f, *map(jnp.asarray, (q, k, v, cos, sin)))
    grads = vjp(jnp.asarray(do))
    return [np.asarray(x).astype(np.float32) for x in (out, *grads)]


def _t(x, dtype):
    return torch.from_numpy(np.asarray(x).astype(np.float32)).to(dtype)


def _port(q, k, v, do, cos, sin, h, hkv, causal, dtype=torch.float32):
    """The port: (out, dq, dk, dv, dcos, dsin) as torch tensors."""
    xs = [_t(x, dtype).requires_grad_(True) for x in (q, k, v)]
    tables = [_t(x, torch.float32).requires_grad_(True) for x in (cos, sin)]
    out = tfa.flash_attention_packed_rope(*xs, *tables, h, hkv,
                                          causal=causal)
    out.backward(_t(do, dtype))
    return [out.detach()] + [x.grad for x in xs + tables]


GEOMS = {"causal": (2, 256, 256, 4, 2, 128, True),
         "full": (2, 256, 256, 4, 2, 128, False),
         "d64-g2": (1, 128, 128, 2, 1, 64, True)}


@pytest.fixture(scope="module")
def f32_runs():
    """JAX and port results at each f32 geometry, computed once."""
    runs = {}
    for name, (b, lq, lk, h, hkv, d, causal) in GEOMS.items():
        args = _inputs(b, lq, lk, h, hkv, d, seed=len(runs))
        runs[name] = (_jax(*args, h, hkv, causal),
                      _port(*args, h, hkv, causal))
    return runs


@pytest.mark.parametrize("geom", list(GEOMS))
def test_matches_pallas_interpret_f32(geom, f32_runs):
    """Values and gradients at B 2, L 256, H 4/2, D 128, causal and not;
    and at head_dim 64 with G 2, a shape the gate refuses (head_dim not a
    multiple of 128) where the reference still computes."""
    want, got = f32_runs[geom]
    np.testing.assert_allclose(got[0].numpy(), want[0], **FWD)
    for name, g, w in zip(("dq", "dk", "dv"), got[1:4], want[1:4]):
        np.testing.assert_allclose(g.numpy(), w, **BWD, err_msg=name)


def test_cos_and_sin_get_zero_gradients(f32_runs):
    """The tables are positional constants (the reference's :1411): zero
    cotangents on both sides; none where they do not require grad."""
    want, got = f32_runs["causal"]
    for g, w in zip(got[4:], want[4:]):
        assert not w.any() and not g.any() and g.shape == w.shape
    b, lq, lk, h, hkv, d, causal = GEOMS["d64-g2"]
    q, k, v, do, cos, sin = _inputs(b, lq, lk, h, hkv, d, seed=9)
    xs = [_t(x, torch.float32).requires_grad_(True) for x in (q, k, v)]
    c, s = _t(cos, torch.float32), _t(sin, torch.float32)
    tfa.flash_attention_packed_rope(*xs, c, s, h, hkv, causal=causal) \
        .backward(_t(do, torch.float32))
    assert c.grad is None and s.grad is None
    assert all(x.grad is not None for x in xs)


def _bf16_ulps(a, b):
    """Elementwise distance of two bf16 tensors in units in the last
    place (sign-magnitude bit patterns mapped to ordered integers)."""
    ia, ib = (x.contiguous().view(torch.int16).int() for x in (a, b))
    ia = torch.where(ia < 0, -32768 - ia, ia)
    ib = torch.where(ib < 0, -32768 - ib, ib)
    return (ia - ib).abs()


def test_bf16_within_two_ulps_of_pallas_interpret():
    """bf16 at B 1, L 128, H 4/2, D 128, causal: the rotation rounds each
    product and the sum to bf16, as the reference's ``_rot_tile`` does on
    bf16 tiles (one rounding, K6's, puts lse 4e-3 off at this shape)."""
    b, lq, lk, h, hkv, d, causal = 1, 128, 128, 4, 2, 128, True
    args = _inputs(b, lq, lk, h, hkv, d, "bfloat16", seed=0)
    want = _jax(*args, h, hkv, causal)
    got = _port(*args, h, hkv, causal, torch.bfloat16)
    for name, g, w, exp in zip(("out", "dq", "dk", "dv"), got, want,
                               (10, 10, 9, 10)):
        assert g.dtype == torch.bfloat16
        w = torch.from_numpy(w).bfloat16()
        slack = 2.0 ** -exp * float(w.float().abs().max())
        far = (g.float() - w.float()).abs() > slack
        worst = int((_bf16_ulps(g, w) * far).max())
        assert worst <= 2, f"{name}: {worst} bf16 ulps from the reference"


def test_cached_prefill_aligns_q_tables_bottom_right():
    """Lq 128 < Lk 256, causal: the queries are the last 128 positions
    (q tables ``cos[Lk - Lq:]``, the causal mask bottom-right)."""
    b, lq, lk, h, hkv, d, causal = 1, 128, 256, 4, 2, 128, True
    args = _inputs(b, lq, lk, h, hkv, d, seed=3)
    want = _jax(*args, h, hkv, causal)
    got = _port(*args, h, hkv, causal)
    np.testing.assert_allclose(got[0].numpy(), want[0], **FWD)
    for name, g, w in zip(("dq", "dk", "dv"), got[1:4], want[1:4]):
        np.testing.assert_allclose(g.numpy(), w, **BWD, err_msg=name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_tables_match_the_reference_bitwise(dtype):
    cos, sin = (np.array(t) for t in j_tables(256, 128, 10000.0,
                                              jnp.float32))
    jt = jfa._rope_kernel_tables(jnp.asarray(cos), jnp.asarray(sin), 2, 128,
                                 256, jnp.dtype(dtype))
    tt = tfa.rope_kernel_tables(torch.from_numpy(cos), torch.from_numpy(sin),
                                128, 256, getattr(torch, dtype))
    for j, t in zip(jt, tt):
        assert t.dtype == getattr(torch, dtype) and t.is_contiguous()
        assert torch.equal(t, _t(np.asarray(j)[0], t.dtype))


@pytest.mark.parametrize("shape", [
    ((2, 256, 512), (2, 256, 256), 4, 2), ((1, 128, 256), (1, 128, 128), 4,
                                           2),
    ((2, 256, 256), (2, 256, 256), 4, 4), ((2, 256, 128), (2, 256, 128), 2,
                                           1),
    ((1, 256, 192), (1, 256, 64), 3, 1), ((2, 200, 512), (2, 200, 256), 4,
                                          2),
    ((1, 128, 512), (1, 384, 256), 4, 2), ((1, 128, 512), (1, 8192, 256),
                                           4, 2),
    ((1, 128, 512), (1, 6144, 256), 4, 2), ((1, 256, 1024), (1, 256, 512),
                                            4, 2)], ids=str)
def test_gate_is_the_reference_gate_without_the_tpu(shape, monkeypatch):
    """head_dim 64 (G·D 128 and not), G·D % 128 != 0, L % 128 != 0, Lk
    8192 at head_dim 128 (past the budget the tables add) and 6144 (at
    it), head_dim 256."""
    monkeypatch.setattr(jfa, "_on_tpu", lambda: True)
    assert tfa.rope_fusable(*shape) == jfa.rope_fusable(*shape)


@pytest.mark.parametrize("case", [
    dict(lq=128, lk=16384, h=2, hkv=1, d=128, causal=True),
    dict(lq=128, lk=128, h=2, hkv=2, d=64, causal=False),
    dict(lq=256, lk=128, h=2, hkv=1, d=128, causal=True)],
    ids=["lk16384-streamed", "d64-mha", "causal-lq>lk"])
def test_raises_where_the_reference_raises(case):
    """Lk 16384 at head_dim 128 (the reference's streamed kernels have no
    rotation), G·D not a multiple of 128, causal Lq > Lk: ValueError on
    both sides."""
    h, hkv, d = case["h"], case["hkv"], case["d"]
    q, k, v, _, cos, sin = _inputs(1, case["lq"], case["lk"], h, hkv, d)
    with pytest.raises(ValueError):
        jfa.flash_attention_packed_rope(
            *map(jnp.asarray, (q, k, v, cos, sin)), h, hkv, case["causal"],
            None, True)
    with pytest.raises(ValueError):
        tfa.flash_attention_packed_rope(
            *(torch.from_numpy(x) for x in (q, k, v, cos, sin)), h, hkv,
            causal=case["causal"])
