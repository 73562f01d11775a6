"""The port's decode / chunked-prefill attention against the JAX package.

Inputs are made with numpy from a seed and go through both packages: the
JAX functions run with ``attn_impl`` / ``prefill_impl`` ``None`` (the
reference while_loop read) and ``"pallas"`` (the fused kernels K8/K9, in
interpret mode on the CPU, as the JAX package's own tests run them); the
port runs its plain versions (CPU tensors).  Tolerances are f32:
``atol=rtol=1e-5`` on attention outputs; caches after an append must be
BITWISE equal.  Parked rows (offset ``lmax``) are finite garbage in both
packages and are compared only against the JAX reference path, which
computes them the same way (the fused kernel reads one chunk for them).

int8 caches (``(data, scale)`` pairs) run the same comparisons: the
quantize-on-append must give BITWISE the reference's codes and f16
scales — the reference compiled, as its serving programs run it, where
XLA multiplies by ``f32(1/127)`` for ``amax / 127`` — and the attention
outputs agree at the f32 tolerance (dequantization is exact in f32).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops import decode_attention as jda
from paddle_tpu_torch.core.device import resolve_impl
from paddle_tpu_torch.ops import decode_attention as tda
from paddle_tpu_torch.ops import paged_attention_cuda as k8
from paddle_tpu_torch.ops import prefill_attention_cuda as k9

# tiny shapes: torch's intra-op threads would only contend with the
# other test processes sharing this machine
torch.set_num_threads(1)

B, HKV, G, D, C = 4, 2, 2, 16, 16
LMAX = 64
W = LMAX // C
N_BLOCKS = 12
TOL = dict(atol=1e-5, rtol=1e-5)

_jdecode = jax.jit(jda.decode_attention,
                   static_argnames=("scale", "layout", "chunk_size",
                                    "attn_impl"))
_jprefill = jax.jit(jda.slot_prefill_attention,
                    static_argnames=("scale", "chunk_size", "attn_impl",
                                     "prefill_impl"))


def _t(a):
    return torch.from_numpy(np.array(a))


def _q8_cache(rng, shape):
    """A random int8 cache leaf pair: codes in [-127, 127] and positive
    f16 scales (numpy, for both packages)."""
    return (rng.integers(-127, 128, shape).astype(np.int8),
            rng.uniform(1e-3, 5e-2, shape[:-1]).astype(np.float16))


def _j(c):
    return tuple(jnp.asarray(x) for x in c) if isinstance(c, tuple) \
        else jnp.asarray(c)


def _tt(c):
    return tuple(_t(x) for x in c) if isinstance(c, tuple) else _t(c)


def _same(tc, jc):
    """Caches bitwise equal (both leaves of an int8 cache)."""
    if isinstance(tc, tuple):
        for a, b in zip(tc, jc):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    else:
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))


def _decode_case(rng, t, paged, q8=False):
    """Ragged lengths 0, C-1, C and a parked slot at lmax; a shuffled
    table whose unneeded entries (and the parked row) hold sentinels."""
    lengths = np.array([0, C - 1, C, LMAX], np.int32)
    q = rng.standard_normal((B, t, HKV * G, D)).astype(np.float32)
    kn = rng.standard_normal((B, t, HKV, D)).astype(np.float32)
    vn = rng.standard_normal((B, t, HKV, D)).astype(np.float32)

    def cache(shape):
        return _q8_cache(rng, shape) if q8 \
            else rng.standard_normal(shape).astype(np.float32)
    if not paged:
        shape = (B, LMAX, HKV, D)
        kc, vc = cache(shape), cache(shape)
        return q, kn, vn, kc, vc, lengths, None
    shape = (N_BLOCKS, C, HKV, D)
    kc, vc = cache(shape), cache(shape)
    ids = list(rng.permutation(N_BLOCKS))
    table = np.full((B, W), N_BLOCKS, np.int32)
    for b in range(B - 1):
        need = -(-(int(lengths[b]) + t) // C)
        for w in range(need):
            table[b, w] = ids.pop()
    return q, kn, vn, kc, vc, lengths, table


def _decode_vs_jax(paged, t, impl, q8):
    rng = np.random.default_rng(7 + t + 10 * paged + 100 * q8)
    q, kn, vn, kc, vc, lengths, table = _decode_case(rng, t, paged, q8)
    jt = None if table is None else jnp.asarray(table)
    jo, jk, jv, jl = _jdecode(jnp.asarray(q), jnp.asarray(kn),
                              jnp.asarray(vn), _j(kc), _j(vc),
                              jnp.asarray(lengths),
                              chunk_size=C, block_table=jt, attn_impl=impl)
    tk, tv = _tt(kc), _tt(vc)
    to, tk2, tv2, tl = tda.decode_attention(
        _t(q), _t(kn), _t(vn), tk, tv, _t(lengths), chunk_size=C,
        block_table=None if table is None else _t(table), impl="reference")
    assert tk2 is tk and tv2 is tv            # updated in place
    _same(tk, jk)
    _same(tv, jv)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    rows = slice(None) if impl is None else slice(0, B - 1)
    np.testing.assert_allclose(to.numpy()[rows], np.asarray(jo)[rows], **TOL)
    assert np.isfinite(to.numpy()).all()


@pytest.mark.parametrize("t", [1, 3])
@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("impl", [None, "pallas"], ids=["jref", "jpallas"])
def test_decode_attention_matches_jax(paged, t, impl):
    _decode_vs_jax(paged, t, impl, q8=False)


@pytest.mark.parametrize("t", [1, 3])
@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("impl", [None, "pallas"], ids=["jref", "jpallas"])
def test_int8_decode_attention_matches_jax(paged, t, impl):
    """int8 caches: the appended codes and scales bitwise, the read
    (dequantized in the loop; in the K8 kernel when ``jpallas``) within
    the f32 tolerance."""
    _decode_vs_jax(paged, t, impl, q8=True)


def test_q8_quantize_matches_jax_bitwise():
    """Codes and f16 scales bitwise equal to the reference's compiled
    ``_q8_quantize``, over magnitudes from 1e-6 to 1e3, an all-zero row
    and rows whose absmax sits at a code boundary."""
    rng = np.random.default_rng(5)
    x = (rng.standard_normal((64, 3, D))
         * 10.0 ** rng.integers(-6, 4, (64, 3, 1))).astype(np.float32)
    x[0, 0] = 0.0
    x[1, 1, :] = np.arange(D) - D / 2
    jq, js = jax.jit(jda._q8_quantize)(jnp.asarray(x))
    tq, ts = tda._q8_quantize(torch.from_numpy(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float16
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        tda._q8_dequant(tq, ts).numpy(),
        np.asarray(jax.jit(jda._q8_dequant)(jq, js)))
    # bf16 input (the serving model's dtype) quantizes from its f32 value
    xb = torch.from_numpy(x).to(torch.bfloat16)
    jq, js = jax.jit(jda._q8_quantize)(
        jnp.asarray(xb.view(torch.int16).numpy()).view(jnp.bfloat16))
    tq, ts = tda._q8_quantize(xb)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_decode_full_read_matches_jax():
    """chunk_size=None: the single masked full-length read."""
    rng = np.random.default_rng(3)
    q, kn, vn, kc, vc, lengths, _ = _decode_case(rng, 2, False)
    jo, jk, _, _ = _jdecode(jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn),
                            jnp.asarray(kc), jnp.asarray(vc),
                            jnp.asarray(lengths))
    tk = _t(kc)
    to, _, _, _ = tda.decode_attention(_t(q), _t(kn), _t(vn), tk, _t(vc),
                                       _t(lengths))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)


def _prefill_vs_jax(paged, c, t, impl, q8):
    rng = np.random.default_rng(11 + t + 100 * paged + 1000 * q8)
    h = HKV * G
    if paged:
        shape = (N_BLOCKS, c, HKV, D)
        table = np.full((B, LMAX // c), N_BLOCKS, np.int32)
        n_map = (2 * t) // c   # blocks for offsets 0 and P; 2P unmapped
        table[1, :n_map] = rng.permutation(N_BLOCKS)[:n_map]
        jt, tt = jnp.asarray(table), _t(table)
    else:
        shape = (B, LMAX, HKV, D)
        jt = tt = None
    if q8:
        kc, vc = _q8_cache(rng, shape), _q8_cache(rng, shape)
    else:
        kc = rng.standard_normal(shape).astype(np.float32)
        vc = rng.standard_normal(shape).astype(np.float32)
    jk, jv = _j(kc), _j(vc)
    tk, tv = _tt(kc), _tt(vc)
    for off in (0, t, 2 * t):
        q = rng.standard_normal((1, t, h, D)).astype(np.float32)
        kn = rng.standard_normal((1, t, HKV, D)).astype(np.float32)
        vn = rng.standard_normal((1, t, HKV, D)).astype(np.float32)
        jo, jk, jv = _jprefill(jnp.asarray(q), jnp.asarray(kn),
                               jnp.asarray(vn), jk, jv, jnp.int32(1),
                               jnp.int32(off), chunk_size=c, block_table=jt,
                               prefill_impl=impl)
        to, tk, tv = tda.slot_prefill_attention(
            _t(q), _t(kn), _t(vn), tk, tv, 1, off, chunk_size=c,
            block_table=tt, impl="reference")
        _same(tk, jk)
        _same(tv, jv)
        if impl is None or not paged or off < 2 * t:
            np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("c,t", [(16, 8), (16, 16)], ids=["C>T", "C=T"])
@pytest.mark.parametrize("impl", [None, "pallas"], ids=["jref", "jpallas"])
def test_slot_prefill_matches_jax(paged, c, t, impl):
    """Chained chunks at offsets 0, P, 2P of slot 1 — the cache carried
    from step to step as the engine does — with the last destination
    block a sentinel on the paged pool (its writes must drop).  At that
    step the JAX reference attends to the rows it reads back (the
    dropped write leaves the clamped block's bytes) while the fused
    kernel attends to the staged new rows, so the output is held to the
    reference only; the engine never reaches it for a real row."""
    _prefill_vs_jax(paged, c, t, impl, q8=False)


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("c,t", [(16, 8), (16, 16)], ids=["C>T", "C=T"])
@pytest.mark.parametrize("impl", [None, "pallas"], ids=["jref", "jpallas"])
def test_int8_slot_prefill_matches_jax(paged, c, t, impl):
    """The same chained chunks on int8 caches: quantize-on-append bitwise
    the reference's (its scatter + chunked read, and the K9 kernel's
    int8 branch in interpret mode, whose chunk rows fold from the
    quantized-then-dequantized copy); outputs where the destination is
    mapped."""
    _prefill_vs_jax(paged, c, t, impl, q8=True)


def test_append_drops_out_of_span_writes():
    """The masked write reproduces JAX's mode='drop': a row straddling
    the end of the span writes only its in-span positions, a parked row
    writes nothing, and no write is clamped onto the last row."""
    kc = torch.zeros((2, 8, 1, 2))
    new = torch.arange(1, 13, dtype=torch.float32).reshape(2, 3, 1, 2)
    tda._append(kc, new, torch.tensor([6, 8], dtype=torch.int32))
    assert kc[0, 6:, 0].tolist() == [[1.0, 2.0], [3.0, 4.0]]
    assert kc[0, :6].abs().sum() == 0 and kc[1].abs().sum() == 0


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_append_never_reads_back_to_the_host(paged):
    """The append runs inside every decode step on the card; a host read
    there (PyTorch turns indexing by a 0-d tensor into ``.item()``) would
    serialise the pipelined engine.  Counted with the profiler on CPU."""
    from torch.profiler import ProfilerActivity, profile

    kc = torch.zeros((4, 16, 2, 4))
    new = torch.ones((3, 1, 2, 4))
    table = torch.tensor([[0, 1], [2, 4], [3, 4]], dtype=torch.int32) \
        if paged else None
    lengths = torch.tensor([3, 20, 40], dtype=torch.int32)
    if not paged:
        kc = torch.zeros((3, 16, 2, 4))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        tda._append(kc, new, lengths, table)
    names = {e.key for e in prof.key_averages()}
    assert not names & {"aten::_local_scalar_dense", "aten::item"}, names
    assert kc.sum() == 8            # only row 0's write landed


def test_masked_lengths_parks_dead_slots():
    out = tda.masked_lengths(torch.tensor([3, 5, 7]),
                             torch.tensor([True, False, True]), 64)
    assert out.dtype == torch.int32 and out.tolist() == [3, 64, 7]


def test_gates_name_offending_values():
    assert k8.fused_decode_supported(32, 64, 128) is None
    assert "chunk_size=None" in k8.fused_decode_supported(None, 64, 16)
    assert "divide" in k8.fused_decode_supported(24, 64, 16)
    assert "multiple of 32" in k8.fused_decode_supported(16, 64, 16)
    assert "head_dim" in k8.fused_decode_supported(32, 64, 512)
    assert k9.fused_prefill_supported(32, 64, 32, True, 128) is None
    assert "divide one another" in k9.fused_prefill_supported(
        32, 64, 24, True, 16)
    assert "stay in bounds" in k9.fused_prefill_supported(
        32, 96, 64, False, 16)
    assert "multiple of 32" in k9.fused_prefill_supported(16, 64, 16, True,
                                                          16)


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_int8_append_drops_both_leaves(paged):
    """Parked and out-of-span rows of an int8 cache write neither codes
    nor scales; a row straddling the span's end writes its in-span
    positions only."""
    if paged:
        k = tda.init_kv_pool(4, 8, 1, 4, dtype="int8", device="cpu")[0]
        table = torch.tensor([[0, 1], [2, 4]], dtype=torch.int32)
    else:
        k = tda.init_kv_cache(2, 16, 1, 4, dtype="int8", device="cpu")[0]
        table = None
    assert k[0].dtype == torch.int8 and k[1].dtype == torch.float16
    assert k[1].shape == k[0].shape[:-1]
    new = torch.arange(1, 2 * 3 * 4 + 1, dtype=torch.float32) \
        .reshape(2, 3, 1, 4)
    tda._append(k, new, torch.tensor([14, 16], dtype=torch.int32), table)
    data, scale = k
    written = (data != 0).any(-1) | (scale != 0)
    if paged:                       # row 0: block 1, rows 6-7 only
        assert written[1, 6:].all() and int(written.sum()) == 2
    else:
        assert written[0, 14:].all() and int(written.sum()) == 2
    q, s = tda._q8_quantize(new[0, :2])
    # row 0's first write lands at flat row 14 in both geometries
    assert torch.equal(data.reshape(-1, 1, 4)[14], q[0])
    assert torch.equal(scale.reshape(-1, 1)[14], s[0])


def test_kernel_wrappers_refuse_cpu_tensors():
    q = torch.zeros((1, 1, 1, 1, 16))
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        k8.paged_decode_attention(q, torch.zeros((1, 32, 1, 16)),
                                  torch.zeros((1, 32, 1, 16)),
                                  torch.zeros((1,), dtype=torch.int32),
                                  0.25, 32, impl="cuda")
    assert resolve_impl(None, "cpu", "x") == "reference"
