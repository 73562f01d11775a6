"""The port's flash attention against the JAX package's Pallas kernels.

The same numpy inputs go through the JAX kernels in interpret mode
(``_flash_fwd_pallas``, ``_flash_bwd_pallas``, ``_delta_pallas``) and
through the port's plain versions on the CPU (what the port's kernels K1
to K5 are held to on the card), in f32.  JAX stores the row statistics
as ``[B, Hkv, 8, Lq*G]`` (sublane-replicated, row ``pos*G + g``); the
port as ``[B, H, Lq]``: the tests compare row 0 of JAX's layout after
that reshape.  Tolerances as the JAX package's own kernel tests
(``tests/test_models.py``): 2e-5 forward, 2e-4 backward; delta 1e-5.
One bf16 case holds the backward's rounding points (p and ds rounded to
bf16 before their products) to the reference's: within one bf16 ulp.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.nn.functional.attention import _sdpa_ref as j_sdpa_ref
from paddle_tpu.ops.flash_attention import (
    _delta_pallas, _flash_bwd_pallas, _flash_fwd_pallas,
)
from paddle_tpu.ops.flash_attention import available as j_available
from paddle_tpu_torch.models.llama import _rope_cos_sin
from paddle_tpu_torch.nn.functional import attention as tattn
from paddle_tpu_torch.ops import flash_attention as tfa
from paddle_tpu_torch.ops import fused_rope as trope

# small shapes: torch's intra-op threads would only contend with the
# other test processes sharing this machine
torch.set_num_threads(1)

FWD = dict(atol=2e-5, rtol=2e-5)
BWD = dict(atol=2e-4, rtol=2e-4)


def _inputs(lq, lk, h, hkv, d, seed=0, b=1):
    rng = np.random.default_rng(seed)

    def rnd(*shape):
        return rng.standard_normal(shape).astype(np.float32)
    return rnd(b, lq, h * d), rnd(b, lk, hkv * d), rnd(b, lk, hkv * d), \
        rnd(b, lq, h * d)


def _stats(x, h, hkv, lq):
    """JAX ``[B, Hkv, 8, Lq*G]`` -> the port's ``[B, H, Lq]``."""
    x = np.asarray(x)[:, :, 0]
    b, g = x.shape[0], h // hkv
    return x.reshape(b, hkv, lq, g).transpose(0, 1, 3, 2).reshape(b, h, lq)


def _t(x):
    return torch.from_numpy(x)


CASES = [(4, 128, True), (2, 128, True), (1, 128, True), (4, 128, False),
         (2, 128, False), (1, 128, False), (4, 64, True), (2, 64, False)]


@pytest.mark.parametrize("hkv,d,causal", CASES,
                         ids=[f"hkv{a}-d{b}-{'causal' if c else 'full'}"
                              for a, b, c in CASES])
def test_forward_matches_pallas_interpret(hkv, d, causal):
    h, l = 4, 256
    q, k, v, _ = _inputs(l, l, h, hkv, d, seed=hkv + d)
    jo, jl = _flash_fwd_pallas(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), h, hkv, causal=causal,
                               interpret=True)
    to, tl = tfa.flash_fwd_reference(_t(q), _t(k), _t(v), h, hkv, causal)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **FWD)
    np.testing.assert_allclose(tl.numpy(), _stats(jl, h, hkv, l), **FWD)


@pytest.mark.parametrize("hkv,causal", [(4, True), (2, True), (1, True),
                                        (2, False)],
                         ids=["mha", "gqa", "mqa", "gqa-full"])
def test_backward_and_delta_match_pallas_interpret(hkv, causal):
    """Gradients through the port's ``autograd.Function`` against
    ``_flash_bwd_pallas``; delta against ``_delta_pallas``."""
    h, l, d = 4, 256, 128
    q, k, v, do = _inputs(l, l, h, hkv, d, seed=10 + hkv)
    jq, jk, jv, jdo = map(jnp.asarray, (q, k, v, do))
    jo, jl = _flash_fwd_pallas(jq, jk, jv, h, hkv, causal=causal,
                               interpret=True)
    jg = _flash_bwd_pallas(jq, jk, jv, jo, jl, jdo, h, hkv, causal=causal,
                           interpret=True)
    jd = _delta_pallas(jdo, jo, hkv, h // hkv, d, interpret=True)
    xs = [_t(x).requires_grad_(True) for x in (q, k, v)]
    out = tfa.flash_attention_packed(*xs, h, hkv, causal=causal)
    out.backward(_t(do))
    for x, g in zip(xs, jg):
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(g), **BWD)
    td = tfa.flash_delta_reference(_t(do), out.detach(), h)
    np.testing.assert_allclose(td.numpy(), _stats(jd, h, hkv, l),
                               atol=1e-5, rtol=1e-5)


def _bf16_ulps(a, b):
    """Elementwise distance of two bf16 tensors in units in the last
    place (sign-magnitude bit patterns mapped to ordered integers)."""
    ia, ib = (x.contiguous().view(torch.int16).int() for x in (a, b))
    ia = torch.where(ia < 0, -32768 - ia, ia)
    ib = torch.where(ib < 0, -32768 - ib, ib)
    return (ia - ib).abs()


@pytest.mark.parametrize("hkv,causal", [(2, True), (1, True), (4, False)],
                         ids=["gqa", "mqa", "mha-full"])
def test_bf16_backward_rounds_where_the_reference_rounds(hkv, causal):
    """bf16 from the same forward residuals (JAX's out and lse): the
    port's plain backward rounds p before p^T·dO and ds before ds^T·q and
    ds·k, as ``_flash_bwd_pallas`` does, so dq/dk/dv land within 1 bf16
    ulp of it; elements within 2^-12 of the tensor's largest magnitude
    are held to that absolute bound instead (near zero, two f32 sums in
    another order may round to values many ulps apart).  Keeping p and
    ds in f32 puts thousands of elements beyond this bound."""
    h, l, d = 4, 256, 128
    q, k, v, do = _inputs(l, l, h, hkv, d, seed=21)
    jq, jk, jv, jdo = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v, do))
    jo, jl = _flash_fwd_pallas(jq, jk, jv, h, hkv, causal=causal,
                               interpret=True)
    jg = _flash_bwd_pallas(jq, jk, jv, jo, jl, jdo, h, hkv, causal=causal,
                           interpret=True)

    def bf16(x):
        return _t(np.asarray(x.astype(jnp.float32))).bfloat16()
    tq, tk, tv, tdo, to = map(bf16, (jq, jk, jv, jdo, jo))
    lse = _t(np.ascontiguousarray(_stats(jl, h, hkv, l)))
    delta = tfa.flash_delta_reference(tdo, to, h)
    got = tfa.flash_bwd_reference(tq, tk, tv, tdo, lse, delta, h, hkv,
                                  causal)
    for name, a, j in zip(("dq", "dk", "dv"), got, jg):
        want = bf16(j)
        assert a.dtype == torch.bfloat16
        slack = 2.0 ** -12 * float(want.float().abs().max())
        far = (a.float() - want.float()).abs() > slack
        worst = int((_bf16_ulps(a, want) * far).max())
        assert worst <= 1, f"{name}: {worst} bf16 ulps from the reference"


def test_cross_length_causal_is_bottom_right_aligned():
    """Lq 128 < Lk 256: the mask aligns bottom-right (the cached prefix
    stays visible), forward and backward."""
    h, hkv, d, lq, lk = 4, 2, 128, 128, 256
    q, k, v, do = _inputs(lq, lk, h, hkv, d, seed=3)
    jq, jk, jv, jdo = map(jnp.asarray, (q, k, v, do))
    jo, jl = _flash_fwd_pallas(jq, jk, jv, h, hkv, causal=True,
                               interpret=True)
    jg = _flash_bwd_pallas(jq, jk, jv, jo, jl, jdo, h, hkv, causal=True,
                           interpret=True)
    xs = [_t(x).requires_grad_(True) for x in (q, k, v)]
    out = tfa.flash_attention_packed(*xs, h, hkv, causal=True)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jo), **FWD)
    out.backward(_t(do))
    for x, g in zip(xs, jg):
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(g), **BWD)


def test_causal_lq_gt_lk_is_rejected():
    q, k, v, _ = _inputs(256, 128, 4, 2, 64)
    with pytest.raises(ValueError, match="Lq <= Lk"):
        tfa.flash_attention_packed(_t(q), _t(k), _t(v), 4, 2, causal=True)
    with pytest.raises(ValueError, match="integer multiple"):
        tfa.flash_attention_packed(_t(q), _t(k), _t(v), 4, 3)
    assert not tfa.available((1, 256, 4, 64), (1, 128, 2, 64), causal=True)


@pytest.mark.parametrize("shape", [
    ((1, 256, 4, 128), (1, 256, 2, 128)), ((1, 256, 4, 64), None),
    ((1, 100, 4, 128), None), ((1, 256, 4, 96), None),
    ((1, 256, 4, 128), (1, 256, 3, 128)), ((2, 64, 8, 128), None),
    ((1, 128, 4, 256), (1, 192, 4, 256))], ids=str)
def test_gate_is_the_reference_gate_without_the_tpu(shape, monkeypatch):
    import paddle_tpu.ops.flash_attention as jfa

    monkeypatch.setattr(jfa, "_on_tpu", lambda: True)
    for causal in (False, True):
        assert tfa.available(*shape, causal=causal) == \
            j_available(*shape, causal=causal)


def test_sdpa_routes_to_flash_and_matches_the_dense_path():
    """A flash-eligible shape takes the flash path (no dense run) and
    agrees with the dense composition; the dense composition agrees with
    the JAX package's, including zeroed dead rows at causal Lq > Lk."""
    q, k, v, _ = _inputs(128, 128, 4, 2, 64, seed=5)
    q4, k4, v4 = (_t(x).view(1, 128, -1, 64) for x in (q, k, v))
    before, runs = tattn.dense_runs, tfa.plain_runs["fwd"]
    out = tattn.scaled_dot_product_attention(q4, k4, v4, is_causal=True)
    assert tattn.dense_runs == before and tfa.plain_runs["fwd"] == runs + 1
    dense = tattn._sdpa_ref(q4, k4, v4, causal=True)
    np.testing.assert_allclose(out.numpy(), dense.numpy(), **FWD)
    jd = j_sdpa_ref(*(jnp.asarray(x.numpy()) for x in (q4, k4, v4)),
                    causal=True)
    np.testing.assert_allclose(dense.numpy(), np.asarray(jd), **FWD)
    # causal Lq > Lk: the dense path owns it, its first rows are zero
    qs = q4[:, :96]
    ks, vs = k4[:, :64], v4[:, :64]
    got = tattn.scaled_dot_product_attention(qs, ks, vs, is_causal=True)
    want = j_sdpa_ref(*(jnp.asarray(x.numpy()) for x in (qs, ks, vs)),
                      causal=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD)
    assert float(got[:, :32].abs().max()) == 0.0


@pytest.mark.parametrize("kind", ["bool", "additive"])
def test_sdpa_dense_path_takes_a_general_mask(kind):
    """A mask that is not a key-padding mask goes to the dense
    composition, as in the reference, with the same result."""
    q, k, v, _ = _inputs(64, 64, 4, 2, 32, seed=6)
    q4, k4, v4 = (_t(x).view(1, 64, -1, 32) for x in (q, k, v))
    keep = np.random.default_rng(7).random((1, 1, 64, 64)) > 0.3
    mask = keep if kind == "bool" else np.where(keep, 0.0, -3.0) \
        .astype(np.float32)
    before = tattn.dense_runs
    got = tattn.scaled_dot_product_attention(q4, k4, v4, _t(mask))
    assert tattn.dense_runs == before + 1
    want = j_sdpa_ref(*(jnp.asarray(x.numpy()) for x in (q4, k4, v4)),
                      mask=jnp.asarray(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD)


def test_sdpa_refuses_what_is_not_ported():
    """Float segment ids and a lone ``q_segments`` are refused.
    Key-padding masks, attention dropout, segment ids and in-kernel RoPE
    run: a key-padding mask on the segmented flash path (no dense run),
    dropout on the dense path, segment ids through
    ``flash_attention_blhd``, and ``flash_attention_packed_rope`` on CPU
    tensors equals rotate-then-attend (the full behaviour is held to the
    reference in ``test_torch_flash_segmented.py``,
    ``test_torch_bert.py`` and ``test_torch_flash_rope.py``)."""
    q = torch.randn((1, 128, 4, 64), generator=torch.Generator()
                    .manual_seed(0))
    mask = torch.ones((1, 128), dtype=torch.bool)
    dense, runs = tattn.dense_runs, tfa.plain_runs["fwd"]
    out = tattn.scaled_dot_product_attention(q, q, q, attn_mask=mask)
    assert tattn.dense_runs == dense and tfa.plain_runs["fwd"] == runs + 1
    torch.testing.assert_close(out, tattn.scaled_dot_product_attention(
        q, q, q), atol=0, rtol=0)
    dropped = tattn.scaled_dot_product_attention(q, q, q, dropout_p=0.1)
    assert tattn.dense_runs == dense + 1 and dropped.shape == q.shape
    seg = torch.zeros((1, 128), dtype=torch.int32)
    torch.testing.assert_close(
        tfa.flash_attention_blhd(q, q, q, q_segments=seg, k_segments=seg),
        out, atol=0, rtol=0)
    with pytest.raises(ValueError, match="integer"):
        tfa.flash_attention_blhd(q, q, q, q_segments=seg.float(),
                                 k_segments=seg.float())
    with pytest.raises(ValueError, match="both"):
        tfa.flash_attention_blhd(q, q, q, q_segments=seg)
    qp, (cos, sin) = q.reshape(1, 128, 256), _rope_cos_sin(
        128, 128, 10000.0, torch.float32, "cpu")
    rq, rk = trope.rope_reference(qp, qp, cos, sin, 2, 2)
    torch.testing.assert_close(
        tfa.flash_attention_packed_rope(qp, qp, qp, cos, sin, 2, 2, True),
        tfa.flash_attention_packed(rq, rk, qp, 2, 2, True), **FWD)
