"""The port's segment-masked flash attention against the JAX package.

The same numpy inputs go through the JAX package's segment-masked
Pallas kernels in interpret mode (``_flash_fwd_pallas`` /
``_flash_bwd_pallas`` with ``q_segments``/``k_segments``, the resident
and, patched as ``tests/test_models.py`` does, the streamed variants) and
through the port's plain versions on the CPU (what the port's segmented
kernels are held to on the card).  Tolerances as the JAX package's own
kernel tests: f32 values within 2e-5, gradients within 2e-4; bf16 within
2 ulps (or, near zero, the bf16 rounding of p against another running
maximum).

Each convention of the segment masks is pinned:

* key padding, right and left (a row whose leading key tiles are all out
  of segment self-corrects), MHA at head_dim 64 (BERT's shape) and GQA
  at 128;
* causal varlen: per-sequence causality from global positions plus
  segments, and a pad tail (q -1, k -2) whose rows come out zero with
  zero gradients;
* a dead row (a live q segment with no same-segment key, an all-padding
  ``attention_mask`` row) averages V over every key, as the reference's
  kernel does — possible only because the mask is the finite -1e30 and
  not -inf.  The reference's kernel then rebuilds ``p = 1`` per key in
  its backward (``log(Lk)`` does not survive in the f32 lse), which is
  not the gradient of that mean; the port's backward gives ``dO/Lk`` to
  each key's dV and nothing to dQ/dK, as the JAX package's dense path
  (``_sdpa_ref``) and ``blockwise_attention`` do, and is held to them.

Also here: ``flash_attn_unpadded`` and the key-padding route of
``scaled_dot_product_attention`` against the JAX package's.
"""
from unittest import mock

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.nn.functional import attention as jattn
from paddle_tpu.ops import flash_attention as jfa
from paddle_tpu_torch.nn.functional import attention as tattn
from paddle_tpu_torch.ops import flash_attention as tfa

torch.set_num_threads(1)

FWD = dict(atol=2e-5, rtol=2e-5)
BWD = dict(atol=2e-4, rtol=2e-4)


def _rnd(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _stats(x, h, hkv, lq):
    """JAX ``[B, Hkv, 8, Lq*G]`` -> the port's ``[B, H, Lq]``."""
    x = np.asarray(x)[:, :, 0]
    b, g = x.shape[0], h // hkv
    return x.reshape(b, hkv, lq, g).transpose(0, 1, 3, 2).reshape(b, h, lq)


def _key_padding(lengths, l, left=()):
    """k segments of a key-padding mask: 0 for live keys, -2 for padded
    ones (the reference's sdpa lowering); rows in ``left`` pad from the
    front."""
    kseg = np.full((len(lengths), l), -2, np.int32)
    for i, n in enumerate(lengths):
        if i in left:
            kseg[i, l - n:] = 0
        else:
            kseg[i, :n] = 0
    return np.zeros((len(lengths), l), np.int32), kseg


def _varlen(cu, total):
    """``flash_attn_unpadded``'s segments: the sequence index of each
    packed token, the pad tail past ``cu[-1]`` at q -1 and k -2."""
    pos = np.arange(total)
    seg = np.searchsorted(np.asarray(cu[1:]), pos, side="right")
    qseg = np.where(pos < cu[-1], seg, -1).astype(np.int32)[None]
    kseg = np.where(pos < cu[-1], seg, -2).astype(np.int32)[None]
    return qseg, kseg


def _jax(q, k, v, do, qseg, kseg, h, hkv, causal):
    """The reference's segmented kernels (interpret): out, lse, grads."""
    jq, jk, jv, jdo = map(jnp.asarray, (q, k, v, do))
    js, jks = jnp.asarray(qseg), jnp.asarray(kseg)
    out, lse = jfa._flash_fwd_pallas(jq, jk, jv, h, hkv, causal=causal,
                                     interpret=True, q_segments=js,
                                     k_segments=jks)
    grads = jfa._flash_bwd_pallas(jq, jk, jv, out, lse, jdo, h, hkv,
                                  causal=causal, interpret=True,
                                  q_segments=js, k_segments=jks)
    return out, lse, grads


def _port(q, k, v, do, qseg, kseg, h, hkv, causal):
    """The port's plain segmented path through its autograd.Function."""
    xs = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    out = tfa.flash_attention_packed_segmented(
        *xs, torch.from_numpy(qseg), torch.from_numpy(kseg), h, hkv,
        causal=causal)
    out.backward(torch.from_numpy(do))
    _, lse = tfa.flash_fwd_reference(*(x.detach() for x in xs), h, hkv,
                                     causal, None, torch.from_numpy(qseg),
                                     torch.from_numpy(kseg))
    return out.detach(), lse, [x.grad for x in xs]


def _compare(q, k, v, do, qseg, kseg, h, hkv, causal):
    jo, jl, jg = _jax(q, k, v, do, qseg, kseg, h, hkv, causal)
    to, tl, tg = _port(q, k, v, do, qseg, kseg, h, hkv, causal)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **FWD)
    live = qseg >= 0
    b, lq = qseg.shape
    # padding rows' lse is garbage in both (never read: their dout is 0)
    np.testing.assert_allclose(
        (tl.numpy() * live[:, None]), _stats(jl, h, hkv, lq) * live[:, None],
        **FWD)
    for got, want in zip(tg, jg):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **BWD)
    return to, tg


PAD = [(2, 128), (4, 64)]


@pytest.mark.parametrize("hkv,d", PAD, ids=["gqa-d128", "mha-d64"])
def test_key_padding_matches_pallas_interpret(hkv, d):
    """B 2, L 256, H 4: row 0 padded at the end to 200 keys, row 1 at the
    front to 156 (its first key tiles are all out of segment)."""
    h, l = 4, 256
    rng = np.random.default_rng(hkv + d)
    q, do = _rnd(rng, 2, l, h * d), _rnd(rng, 2, l, h * d)
    k, v = _rnd(rng, 2, l, hkv * d), _rnd(rng, 2, l, hkv * d)
    qseg, kseg = _key_padding([200, 156], l, left=(1,))
    _compare(q, k, v, do, qseg, kseg, h, hkv, causal=False)


@pytest.mark.parametrize("streamed", [False, True],
                         ids=["resident", "streamed"])
def test_causal_varlen_with_pad_tail(streamed):
    """Three packed sequences and a pad tail, causal, GQA at head_dim
    128: per-sequence causality; the tail's rows are zero and add nothing
    to any gradient.  ``streamed`` makes the reference take its streamed
    kernels (K2, the streamed dQ), as at long context, at a length of its
    own (the reference's entry points are jitted: a length traced before
    would not consult the patch)."""
    h, hkv, d = 4, 2, 128
    l, cu = (384, [0, 70, 190, 300]) if streamed else (256, [0, 50, 130,
                                                             200])
    rng = np.random.default_rng(11)
    q, do = _rnd(rng, 1, l, h * d), _rnd(rng, 1, l, h * d)
    k, v = _rnd(rng, 1, l, hkv * d), _rnd(rng, 1, l, hkv * d)
    qseg, kseg = _varlen(cu, l)
    with mock.patch.object(jfa, "_stream_kv",
                           return_value=streamed) as stream:
        to, (dq, dk, dv) = _compare(q, k, v, do, qseg, kseg, h, hkv,
                                    causal=True)
    assert stream.called
    n = cu[-1]
    assert float(to[0, n:].abs().max()) == 0.0
    assert float(dq[0, n:].abs().max()) == 0.0
    # pad-tail keys match no query: no gradient reaches them
    assert float(dk[0, n:].abs().max()) == 0.0
    assert float(dv[0, n:].abs().max()) == 0.0
    # per-sequence causality: the first token of sequence 1 sees only
    # itself, so its output is its own value row
    np.testing.assert_allclose(
        to[0, cu[1]].view(h, d).numpy(),
        np.repeat(v[0, cu[1]].reshape(hkv, d), h // hkv, axis=0), **FWD)


def test_dead_row_averages_v_and_its_gradient_is_the_mean_s():
    """Row 1 of the batch has no live key (an all-zero attention mask):
    every query row of it outputs the mean of V over all 256 keys, as the
    reference's kernel does; its backward spreads dO/Lk over dV and gives
    dQ/dK nothing, as the reference's dense path does (which the live
    row 0 also matches)."""
    h, hkv, d, l = 4, 4, 64, 256
    rng = np.random.default_rng(5)
    q, do = _rnd(rng, 2, l, h * d), _rnd(rng, 2, l, h * d)
    k, v = _rnd(rng, 2, l, hkv * d), _rnd(rng, 2, l, hkv * d)
    qseg, kseg = _key_padding([180, 0], l)
    jo, jl, _ = _jax(q, k, v, do, qseg, kseg, h, hkv, causal=False)
    to, tl, (dq, dk, dv) = _port(q, k, v, do, qseg, kseg, h, hkv, False)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **FWD)
    mean_v = v[1].reshape(l, hkv, d).mean(0).reshape(-1)
    np.testing.assert_allclose(to[1].numpy(), np.broadcast_to(
        mean_v, (l, h * d)), **FWD)
    assert float(tl[1].max()) <= tfa.DEAD_LSE
    np.testing.assert_allclose(tl[0].numpy(), _stats(jl, h, hkv, l)[0],
                               **FWD)
    # the dense reference's gradients, batch row by batch row
    mask = jnp.asarray(kseg == 0)[:, None, None, :]

    def dense(a, b_, c):
        return jattn._sdpa_ref(a.reshape(2, l, h, d), b_.reshape(2, l, hkv, d),
                               c.reshape(2, l, hkv, d), mask).reshape(2, l, -1)
    _, vjp = jax.vjp(dense, *map(jnp.asarray, (q, k, v)))
    for got, want in zip((dq, dk, dv), vjp(jnp.asarray(do))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **BWD)
    np.testing.assert_allclose(dv[1].numpy(), np.broadcast_to(
        do[1].reshape(l, hkv, d).sum(0).reshape(-1) / l, (l, hkv * d)),
        **BWD)
    assert float(dq[1].abs().max()) == 0.0 and float(dk[1].abs().max()) == 0


def _bf16_ulps(a, b):
    ia, ib = (x.contiguous().view(torch.int16).int() for x in (a, b))
    ia = torch.where(ia < 0, -32768 - ia, ia)
    ib = torch.where(ib < 0, -32768 - ib, ib)
    return (ia - ib).abs()


def test_bf16_key_padding_within_two_ulps():
    """bf16 at BERT's head_dim 64 with key padding: the forward within 2
    bf16 ulps of the reference kernel's, or near zero within the bf16
    rounding of p (2^-8·P|V|, both round p before p·V against other
    running maxima); dq/dk/dv from the same residuals within 2 ulps or
    2^-12 of the tensor's largest magnitude (ds rounds to bf16 in both)."""
    h, hkv, d, l = 4, 4, 64, 256
    rng = np.random.default_rng(21)
    q, do = _rnd(rng, 2, l, h * d), _rnd(rng, 2, l, h * d)
    k, v = _rnd(rng, 2, l, hkv * d), _rnd(rng, 2, l, hkv * d)
    qseg, kseg = _key_padding([256, 130], l)
    jq, jk, jv, jdo = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v, do))
    js, jks = jnp.asarray(qseg), jnp.asarray(kseg)
    jo, jl = jfa._flash_fwd_pallas(jq, jk, jv, h, hkv, interpret=True,
                                   q_segments=js, k_segments=jks)
    jg = jfa._flash_bwd_pallas(jq, jk, jv, jo, jl, jdo, h, hkv,
                               interpret=True, q_segments=js, k_segments=jks)

    def bf16(x):
        return torch.from_numpy(np.array(x.astype(jnp.float32))).bfloat16()
    tq, tk, tv, tdo, tjo = map(bf16, (jq, jk, jv, jdo, jo))
    ts, tks = torch.from_numpy(qseg), torch.from_numpy(kseg)
    to, _ = tfa.flash_fwd_reference(tq, tk, tv, h, hkv, False, None, ts, tks)
    pv = tfa.flash_fwd_reference(tq, tk, tv.abs(), h, hkv, False, None, ts,
                                 tks)[0].float()
    far = (to.float() - tjo.float()).abs() > 2.0 ** -8 * pv + 1e-6
    assert int((_bf16_ulps(to, tjo) * far).max()) <= 2
    lse = torch.from_numpy(np.ascontiguousarray(_stats(jl, h, hkv, l)))
    delta = tfa.flash_delta_reference(tdo, tjo, h)
    got = tfa.flash_bwd_reference(tq, tk, tv, tdo, lse, delta, h, hkv,
                                  False, None, ts, tks)
    for name, a, j in zip(("dq", "dk", "dv"), got, jg):
        want = bf16(j)
        slack = 2.0 ** -12 * float(want.float().abs().max())
        far = (a.float() - want.float()).abs() > slack
        worst = int((_bf16_ulps(a, want) * far).max())
        assert worst <= 2, f"{name}: {worst} bf16 ulps from the reference"


@pytest.mark.parametrize("total,causal", [(256, True), (256, False),
                                          (100, True)],
                         ids=["flash-causal", "flash-full", "blockwise"])
def test_flash_attn_unpadded_matches_jax(total, causal):
    """Packed ``[total, H, D]`` tokens with ``cu_seqlens`` and a pad tail:
    the port (flash route where the gate passes, ``blockwise_attention``
    otherwise) against the JAX package's ``flash_attn_unpadded`` (its
    blockwise route on the CPU), and gradients against ``jax.vjp`` of its
    ``blockwise_attention``."""
    h, hkv, d = 4, 2, 64
    rng = np.random.default_rng(total + causal)
    q, do = _rnd(rng, total, h, d), _rnd(rng, total, h, d)
    k, v = _rnd(rng, total, hkv, d), _rnd(rng, total, hkv, d)
    n = total - 20
    cu = np.array([0, n // 3, n // 2, n], np.int32)
    jout, _ = jattn.flash_attn_unpadded(
        paddle.to_tensor(q), paddle.to_tensor(k), paddle.to_tensor(v),
        paddle.to_tensor(cu), paddle.to_tensor(cu), causal=causal)
    xs = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    before = tfa.plain_runs["fwd"]
    out, sm = tattn.flash_attn_unpadded(*xs, torch.from_numpy(cu),
                                        torch.from_numpy(cu), causal=causal)
    assert sm is None
    assert (tfa.plain_runs["fwd"] > before) == (total % 128 == 0)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout.data),
                               **FWD)
    assert float(out.detach()[n:].abs().max()) == 0.0
    out.backward(torch.from_numpy(do))
    qseg, kseg = _varlen(cu, total)

    def blockwise(a, b_, c):
        return jfa.blockwise_attention(
            a[None], b_[None], c[None], causal=causal,
            q_segments=jnp.asarray(qseg), k_segments=jnp.asarray(kseg))[0]
    _, vjp = jax.vjp(blockwise, *map(jnp.asarray, (q, k, v)))
    for x, want in zip(xs, vjp(jnp.asarray(do))):
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(want), **BWD)


@pytest.mark.parametrize("mask_shape", ["b-l", "b-1-1-l"])
def test_sdpa_key_padding_takes_the_segmented_path(mask_shape):
    """A boolean key-padding mask at a flash-eligible shape goes to the
    segmented flash path (no dense run) and agrees with the reference's
    dense composition with the same mask, forward and gradients."""
    b, l, h, d = 2, 128, 4, 64
    rng = np.random.default_rng(8)
    q, k, v, do = (_rnd(rng, b, l, h, d) for _ in range(4))
    keep = np.ones((b, l), bool)
    keep[0, 90:] = False
    keep[1, :17] = False
    mask = keep if mask_shape == "b-l" else keep[:, None, None, :]
    xs = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    dense, runs = tattn.dense_runs, tfa.plain_runs["fwd"]
    out = tattn.scaled_dot_product_attention(*xs,
                                             attn_mask=torch.from_numpy(mask))
    assert tattn.dense_runs == dense and tfa.plain_runs["fwd"] == runs + 1
    out.backward(torch.from_numpy(do))
    want, vjp = jax.vjp(
        lambda a, b_, c: jattn._sdpa_ref(a, b_, c, jnp.asarray(
            keep)[:, None, None, :]), *map(jnp.asarray, (q, k, v)))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), **FWD)
    for x, g in zip(xs, vjp(jnp.asarray(do))):
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(g), **BWD)
