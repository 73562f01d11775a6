"""The port's hand-written kernels against their plain versions, on the card.

Every test here needs CUDA: it carries the ``cuda`` marker and skips
where ``torch.cuda.is_available()`` is false.  The module imports
neither jax nor the JAX package, so it also runs where only PyTorch is
installed::

    python -m pytest --noconftest -q tests/test_torch_kernels_cuda.py

(``--noconftest``: the suite's conftest configures jax).  Shapes are
small and cover what ``chip_smoke.py`` (serving shapes, bf16) does not:
every cache dtype the kernels take, T > 1 decode rows, C > T prefill,
head_dim 64.  Tolerances: f32 outputs ``atol=rtol=1e-4`` (summation
order only); K9 outputs in the cache dtype within ``2e-2`` (a few bf16
ulps); caches after a K9 append BITWISE equal to the plain append.  The
training kernels (K1-K5 flash attention, K6 RoPE) run at every dtype,
head_dim 64/128/256, G 1/2/3/4/8, Lq < Lk and non-causal, against their
plain versions (tolerances at ``FLASH_TOL``; RoPE bitwise) and against
themselves (bitwise, run to run); the segmented flash kernels likewise,
with key padding (a dead row among them) and causal varlen; the rope
ones (K10) at every dtype, head_dim 128/256, G 1-3, Lq < Lk and
non-causal, and end to end card vs CPU.  The loss
chunk's bf16 GEMM with an
f32 result (the card's branch of ``ops/chunked_ce.py``) runs against the
widened f32 branch.  The int8 kernels: K8's and K9's int8 branches
against their plain versions (K9's appended codes and scales bitwise,
and equal to ``_q8_quantize``), and K7, the fused int8 AdamW, bitwise
against its plain version for the dtypes the optimizer passes (bf16 and
f32 parameters, bf16 and f32 gradients, with and without an f32
master), whole and ragged blocks, aligned and not.  The split-K K8 at
head_dim 128 with lengths on every pool-block and span edge (every cache
dtype, dense and paged, T 1 and 4): one launch a call and bitwise equal
run to run; K9's tensor-core instance (bf16 q over bf16 and int8 KV) at
T 16-256 over chained offsets, its output within 2 bf16 ulps or 1e-6 of
the plain version.  The wgmma instances of the forward, dK/dV and dQ at
the edges of their tiles (G 1-8, Lq and Lk not multiples of 128, causal
with q_offset > 0, segments with a dead row, rope), through their
``*_wgmma`` counters and bitwise run to run; K6's vector and scalar
instances bitwise equal to the plain version in every dtype.  The
speculative serving engine (prompt lookup and a draft model, dense and
paged) on the card: K8 at the verify width, streams equal to greedy and
pipeline on == off.  K8 with hidden key ranges (the top-2 tree verify's
branch row, and ranges over whole 64-key spans) in every cache dtype and
int8, dense and paged, against its plain version and bitwise run to
run; the tree engine on the card (K8's range launches counted, streams
equal to greedy) and the reliability layer's retries and poison there.
K8 and K9 at a TP-2 rank's heads (the serving model split two ways: Hkv
2, G 4, D 128), bf16 and int8, against their plain versions; the engine
over a one-rank NCCL mesh, bit for bit the single-device one.
"""
import pytest
import torch

from paddle_tpu_torch.ops import decode_attention as tda
from paddle_tpu_torch.ops import paged_attention_cuda as k8
from paddle_tpu_torch.ops import prefill_attention_cuda as k9

DTYPES = [torch.float32, torch.bfloat16, torch.float16]
B, HKV, G, D, C, N = 4, 2, 2, 64, 32, 16
LMAX = 4 * C


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU build")
    return torch.device("cuda")


def _caches(dev, gen, dtype, paged):
    shape = (N, C, HKV, D) if paged else (B, LMAX, HKV, D)
    k = torch.randn(shape, generator=gen).to(dev, dtype)
    v = torch.randn(shape, generator=gen).to(dev, dtype)
    return k, v


def _table(dev, gen):
    t = torch.full((B, LMAX // C), N, dtype=torch.int32)
    t[:B - 1] = torch.randperm(N, generator=gen)[:12].view(3, 4) \
        .to(torch.int32)
    t[1, 3] = N                          # a sentinel past row 1's length
    return t.to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("t", [1, 3, 9])     # 9: two groups of 16 rows
def test_decode_kernel_matches_plain(dtype, paged, t):
    dev = _card()
    gen = torch.Generator().manual_seed(3)
    kc, vc = _caches(dev, gen, dtype, paged)
    table = _table(dev, gen) if paged else None
    lengths = torch.tensor([0, C - 1, 2 * C + 5, LMAX], dtype=torch.int32,
                           device=dev)             # the last row parked
    qg = torch.randn(B, HKV, G, t, D, generator=gen).to(dev)
    before = k8.launches
    out = k8.paged_decode_attention(qg, kc, vc, lengths, D ** -0.5, C,
                                    table, impl="cuda")
    ref = k8.paged_decode_attention_reference(qg, kc, vc, lengths,
                                              D ** -0.5, C, table)
    torch.cuda.synchronize()
    assert k8.launches == before + 1
    torch.testing.assert_close(out[:B - 1], ref[:B - 1], atol=1e-4,
                               rtol=1e-4)
    assert torch.isfinite(out).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("t", [16, 32], ids=["C>T", "C=T"])
def test_prefill_kernel_matches_plain(dtype, paged, t):
    """Chained chunks at offsets 0, T, 2T, ... over slot 1's whole span,
    the cache carried from chunk to chunk; the paged row's last block is
    unmapped, so the final chunks' writes drop (outputs compared only
    where mapped: there the plain version reads back dropped rows)."""
    dev = _card()
    gen = torch.Generator().manual_seed(5)
    kc, vc = _caches(dev, gen, dtype, paged)
    trow = None
    if paged:
        trow = torch.tensor([[3, 9, 0, N]], dtype=torch.int32, device=dev)
    k2, v2 = kc.clone(), vc.clone()
    for off in range(0, LMAX, t):
        q = torch.randn(1, t, HKV * G, D, generator=gen).to(dev, dtype)
        kn = torch.randn(1, t, HKV, D, generator=gen).to(dev, dtype)
        vn = torch.randn(1, t, HKV, D, generator=gen).to(dev, dtype)
        o1, _, _ = k9.prefill_attention(q, kn, vn, kc, vc, 1, off,
                                        D ** -0.5, C, trow, impl="cuda")
        o2, _, _ = k9.prefill_attention_reference(q, kn, vn, k2, v2, 1, off,
                                                  D ** -0.5, C, trow)
        torch.cuda.synchronize()
        assert torch.equal(kc, k2) and torch.equal(vc, v2)
        if trow is None or int(trow[0, off // C]) < N:
            torch.testing.assert_close(o1.float(), o2.float(), atol=2e-2,
                                       rtol=2e-2)


@pytest.mark.cuda
def test_wrappers_refuse_what_the_kernels_do_not_take():
    dev = _card()
    qg = torch.zeros((1, 1, 1, 1, D), device=dev)
    kc = torch.zeros((1, 2 * C, 1, D), device=dev)
    lengths = torch.zeros((1,), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="multiple of 32"):
        k8.paged_decode_attention(qg, kc, kc, lengths, 1.0, 16, impl="cuda")
    with pytest.raises(ValueError, match="int32"):
        k8.paged_decode_attention(qg, kc, kc, lengths.long(), 1.0, C,
                                  impl="cuda")
    q = torch.zeros((1, 16, 1, D), device=dev)
    kn = torch.zeros((1, 16, 1, D), device=dev)
    with pytest.raises(ValueError, match="alignment contract"):
        k9.prefill_attention(q, kn, kn, kc, kc.clone(), 0, 8, 1.0, C,
                             impl="cuda")
    with pytest.raises(ValueError, match="no CPU build|CUDA tensors"):
        tda.decode_attention(q.cpu(), kn.cpu(), kn.cpu(), kc.cpu(),
                             kc.cpu(), lengths.cpu(), chunk_size=C,
                             impl="cuda")


# ------------------------------------------------- training kernels (K1-K6)
from paddle_tpu_torch.ops import flash_attention as tfa  # noqa: E402
from paddle_tpu_torch.ops import flash_attention_cuda as kfa  # noqa: E402
from paddle_tpu_torch.ops import fused_rope as trope  # noqa: E402
from paddle_tpu_torch.ops import fused_rope_cuda as k6  # noqa: E402

# f32: summation order only; bf16/f16: a few units in the last place of
# the output dtype (the forward rounds p to the input dtype before p·V in
# both, against the running max in the kernel and the final max in the
# plain version; the backward rounds p and ds to the input dtype before
# their products in both, from scores summed in another order)
FLASH_TOL = {torch.float32: dict(atol=2e-5, rtol=2e-5),
             torch.bfloat16: dict(atol=2e-2, rtol=2e-2),
             torch.float16: dict(atol=4e-3, rtol=4e-3)}


def _flash_inputs(dev, dtype, b, lq, lk, h, hkv, d, seed):
    gen = torch.Generator().manual_seed(seed)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen).to(dev, dtype)
    return (rnd(b, lq, h * d), rnd(b, lk, hkv * d), rnd(b, lk, hkv * d),
            rnd(b, lq, h * d))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("geom", [
    (2, 128, 128, 4, 4, 64, True), (1, 128, 256, 4, 2, 128, True),
    (2, 128, 128, 8, 1, 128, False), (1, 64, 128, 2, 1, 256, True),
    (1, 192, 192, 6, 2, 64, True)],
    ids=["mha-d64", "gqa-lq<lk", "mqa-noncausal", "d256", "g3"])
def test_flash_kernels_match_plain(dtype, geom):
    """K1/K2 forward (out, lse), K3 delta, K4 dK/dV and K5 dQ against
    the plain versions on the same inputs; the kernels run twice and
    must agree bitwise with themselves (deterministic)."""
    dev = _card()
    b, lq, lk, h, hkv, d, causal = geom
    q, k, v, do = _flash_inputs(dev, dtype, b, lq, lk, h, hkv, d, 11)
    scale = d ** -0.5
    out, lse = kfa.flash_fwd(q, k, v, h, hkv, causal, scale)
    ref, rlse = tfa.flash_fwd_reference(q, k, v, h, hkv, causal, scale)
    delta = kfa.flash_delta(do, out, h)
    rdelta = tfa.flash_delta_reference(do, out, h)
    dk, dv = kfa.flash_bwd_dkv(q, k, v, do, lse, delta, h, hkv, causal,
                               scale)
    dq = kfa.flash_bwd_dq(q, k, v, do, lse, delta, h, hkv, causal, scale)
    rdq, rdk, rdv = tfa.flash_bwd_reference(q, k, v, do, lse, delta, h,
                                            hkv, causal, scale)
    torch.cuda.synchronize()
    tol = FLASH_TOL[dtype]
    torch.testing.assert_close(out.float(), ref.float(), **tol)
    torch.testing.assert_close(lse, rlse, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(delta, rdelta, atol=1e-4, rtol=1e-5)
    for a, r in ((dq, rdq), (dk, rdk), (dv, rdv)):
        torch.testing.assert_close(a.float(), r.float(), **tol)
    dk2, dv2 = kfa.flash_bwd_dkv(q, k, v, do, lse, delta, h, hkv, causal,
                                 scale)
    dq2 = kfa.flash_bwd_dq(q, k, v, do, lse, delta, h, hkv, causal, scale)
    out2, lse2 = kfa.flash_fwd(q, k, v, h, hkv, causal, scale)
    for a, a2 in ((dq, dq2), (dk, dk2), (dv, dv2), (out, out2),
                  (lse, lse2)):
        assert torch.equal(a, a2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_flash_autograd_on_the_card_matches_cpu(dtype):
    dev = _card()
    q, k, v, do = _flash_inputs("cpu", dtype, 1, 128, 128, 4, 2, 128, 12)
    grads = []
    for device in ("cpu", dev):
        xs = [x.detach().to(device).requires_grad_(True) for x in (q, k, v)]
        out = tfa.flash_attention_packed(*xs, 4, 2, causal=True)
        out.backward(do.to(device))
        grads.append([out.detach().cpu()] + [x.grad.cpu() for x in xs])
    for a, c in zip(grads[1], grads[0]):
        torch.testing.assert_close(a.float(), c.float(), **FLASH_TOL[dtype])


def _segments(dev, kind, b, l):
    """(q_segments, k_segments) int32: key padding (one row left-padded,
    one all padding: a dead row) or three packed sequences with a pad
    tail (q -1, k -2)."""
    if kind == "padding":
        kseg = torch.full((b, l), -2, dtype=torch.int32)
        for i, (n, left) in enumerate([(l, False), (l - 58, True),
                                       (70, False), (0, False)][:b]):
            if left:
                kseg[i, l - n:] = 0
            else:
                kseg[i, :n] = 0
        return torch.zeros((b, l), dtype=torch.int32).to(dev), kseg.to(dev)
    pos = torch.arange(l)
    cu = torch.tensor([l // 5, l // 2, l - 40])
    seg = torch.searchsorted(cu, pos, right=True).int()
    qseg = torch.where(pos < cu[-1], seg, -1).int().repeat(b, 1)
    kseg = torch.where(pos < cu[-1], seg, -2).int().repeat(b, 1)
    return qseg.to(dev), kseg.to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("geom", [
    (4, 128, 4, 4, 64, False, "padding"), (2, 256, 4, 2, 128, True, "varlen"),
    (1, 192, 6, 2, 64, True, "varlen"), (2, 128, 2, 1, 256, False, "padding")],
    ids=["mha-d64-padding", "gqa-varlen", "g3-varlen", "d256-padding"])
def test_segmented_flash_kernels_match_plain(dtype, geom):
    """The segmented K1/K2, K4 and K5 (and K3 on the zeroed dout) against
    the plain versions with the same segment ids: key padding with a
    left-padded and a dead row (the mean of V, dO/Lk to dV), causal varlen
    with a pad tail (zero rows); bitwise repeatable."""
    dev = _card()
    b, l, h, hkv, d, causal, kind = geom
    q, k, v, do = _flash_inputs(dev, dtype, b, l, l, h, hkv, d, 17)
    qseg, kseg = _segments(dev, kind, b, l)
    do = do.masked_fill((qseg < 0)[:, :, None], 0)
    scale = d ** -0.5
    before = dict(kfa.launches)
    out, lse = kfa.flash_fwd(q, k, v, h, hkv, causal, scale, qseg, kseg)
    ref, rlse = tfa.flash_fwd_reference(q, k, v, h, hkv, causal, scale,
                                        qseg, kseg)
    delta = kfa.flash_delta(do, out, h)
    dk, dv = kfa.flash_bwd_dkv(q, k, v, do, lse, delta, h, hkv, causal,
                               scale, qseg, kseg)
    dq = kfa.flash_bwd_dq(q, k, v, do, lse, delta, h, hkv, causal, scale,
                          qseg, kseg)
    rdq, rdk, rdv = tfa.flash_bwd_reference(q, k, v, do, lse, delta, h,
                                            hkv, causal, scale, qseg, kseg)
    torch.cuda.synchronize()
    for key in ("fwd_seg", "dkv_seg", "dq_seg"):
        assert kfa.launches[key] == before[key] + 1
    for key in ("fwd", "dkv", "dq"):
        assert kfa.launches[key] == before[key]
    tol = FLASH_TOL[dtype]
    torch.testing.assert_close(out.float(), ref.float(), **tol)
    live = (qseg >= 0)[:, None, :]
    torch.testing.assert_close(lse * live, rlse * live, atol=1e-5,
                               rtol=1e-5)
    assert float(out.float().masked_fill((qseg >= 0)[:, :, None], 0)
                 .abs().max()) == 0.0
    for a, r in ((dq, rdq), (dk, rdk), (dv, rdv)):
        torch.testing.assert_close(a.float(), r.float(), **tol)
    dk2, dv2 = kfa.flash_bwd_dkv(q, k, v, do, lse, delta, h, hkv, causal,
                                 scale, qseg, kseg)
    dq2 = kfa.flash_bwd_dq(q, k, v, do, lse, delta, h, hkv, causal, scale,
                           qseg, kseg)
    out2, lse2 = kfa.flash_fwd(q, k, v, h, hkv, causal, scale, qseg, kseg)
    for a, a2 in ((dq, dq2), (dk, dk2), (dv, dv2), (out, out2),
                  (lse, lse2)):
        assert torch.equal(a, a2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_segmented_autograd_on_the_card_matches_cpu(dtype):
    """``flash_attention_packed_segmented`` end to end (the padding rows'
    dout zeroed before K3-K5) on the card and on the CPU."""
    dev = _card()
    q, k, v, do = _flash_inputs("cpu", dtype, 2, 256, 256, 4, 2, 128, 19)
    qseg, kseg = _segments("cpu", "varlen", 2, 256)
    grads = []
    for device in ("cpu", dev):
        xs = [x.detach().to(device).requires_grad_(True) for x in (q, k, v)]
        out = tfa.flash_attention_packed_segmented(
            *xs, qseg.to(device), kseg.to(device), 4, 2, causal=True)
        out.backward(do.to(device))
        grads.append([out.detach().cpu()] + [x.grad.cpu() for x in xs])
    for a, c in zip(grads[1], grads[0]):
        torch.testing.assert_close(a.float(), c.float(), **FLASH_TOL[dtype])


def _rope_tables(dev, dtype, lq, lk, d, seed):
    """K10's kernel tables from random angles (cos/sin ``[Lk, D]``)."""
    gen = torch.Generator().manual_seed(seed)
    ang = torch.rand(lk, d, generator=gen) * 6.0
    return tfa.rope_kernel_tables(ang.cos().to(dev), ang.sin().to(dev), lq,
                                  lk, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("geom", [
    (2, 128, 128, 4, 2, 128, True), (1, 128, 256, 4, 2, 128, True),
    (2, 128, 128, 8, 1, 128, False), (1, 64, 128, 2, 1, 256, True),
    (1, 192, 192, 6, 2, 128, True)],
    ids=["gqa", "gqa-lq<lk", "mqa-noncausal", "d256", "g3"])
def test_rope_flash_kernels_match_plain(dtype, geom):
    """K10: the ROPE instances of the forward (out, lse), K4 dK/dV and K5
    dQ (K3 on their output) against the plain versions with the same
    tables, q tables bottom-right at Lq < Lk; only the ``*_rope`` counters
    move; bitwise repeatable."""
    dev = _card()
    b, lq, lk, h, hkv, d, causal = geom
    q, k, v, do = _flash_inputs(dev, dtype, b, lq, lk, h, hkv, d, 23)
    rope = _rope_tables(dev, dtype, lq, lk, d, 5)
    scale = d ** -0.5
    before = dict(kfa.launches)
    out, lse = kfa.flash_fwd(q, k, v, h, hkv, causal, scale, rope=rope)
    ref, rlse = tfa.flash_fwd_reference(q, k, v, h, hkv, causal, scale,
                                        rope=rope)
    delta = kfa.flash_delta(do, out, h)
    dk, dv = kfa.flash_bwd_dkv(q, k, v, do, lse, delta, h, hkv, causal,
                               scale, rope=rope)
    dq = kfa.flash_bwd_dq(q, k, v, do, lse, delta, h, hkv, causal, scale,
                          rope=rope)
    rdq, rdk, rdv = tfa.flash_bwd_reference(q, k, v, do, lse, delta, h,
                                            hkv, causal, scale, rope=rope)
    torch.cuda.synchronize()
    for key in ("fwd_rope", "dkv_rope", "dq_rope"):
        assert kfa.launches[key] == before[key] + 1
    for key in ("fwd", "dkv", "dq", "fwd_seg", "dkv_seg", "dq_seg"):
        assert kfa.launches[key] == before[key]
    tol = FLASH_TOL[dtype]
    torch.testing.assert_close(out.float(), ref.float(), **tol)
    torch.testing.assert_close(lse, rlse, atol=1e-5, rtol=1e-5)
    for a, r in ((dq, rdq), (dk, rdk), (dv, rdv)):
        torch.testing.assert_close(a.float(), r.float(), **tol)
    dk2, dv2 = kfa.flash_bwd_dkv(q, k, v, do, lse, delta, h, hkv, causal,
                                 scale, rope=rope)
    dq2 = kfa.flash_bwd_dq(q, k, v, do, lse, delta, h, hkv, causal, scale,
                           rope=rope)
    out2, lse2 = kfa.flash_fwd(q, k, v, h, hkv, causal, scale, rope=rope)
    for a, a2 in ((dq, dq2), (dk, dk2), (dv, dv2), (out, out2),
                  (lse, lse2)):
        assert torch.equal(a, a2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_rope_autograd_on_the_card_matches_cpu(dtype):
    """``flash_attention_packed_rope`` end to end on the card (K10-fwd,
    K3, K10-dkv, K10-dq) and on the CPU (plain versions), cached-prefill
    shape (Lq 128 < Lk 256, causal)."""
    dev = _card()
    q, k, v, _ = _flash_inputs("cpu", dtype, 2, 256, 256, 4, 2, 128, 29)
    q, do = q[:, 128:].contiguous(), torch.randn(
        2, 128, 4 * 128, generator=torch.Generator().manual_seed(3)) \
        .to(dtype)
    ang = torch.rand(256, 128, generator=torch.Generator().manual_seed(4))
    grads = []
    for device in ("cpu", dev):
        xs = [x.detach().to(device).requires_grad_(True) for x in (q, k, v)]
        out = tfa.flash_attention_packed_rope(
            *xs, ang.cos().to(device), ang.sin().to(device), 4, 2,
            causal=True)
        out.backward(do.to(device))
        grads.append([out.detach().cpu()] + [x.grad.cpu() for x in xs])
    for a, c in zip(grads[1], grads[0]):
        torch.testing.assert_close(a.float(), c.float(), **FLASH_TOL[dtype])


@pytest.mark.cuda
def test_rope_wrappers_refuse_what_the_kernels_do_not_take():
    dev = _card()
    q = torch.zeros((1, 128, 4 * 64), device=dev)
    k = torch.zeros((1, 128, 2 * 64), device=dev)
    with pytest.raises(ValueError, match="head_dim 64"):
        kfa.flash_fwd(q, k, k, 4, 2, True, 1.0,
                      rope=_rope_tables(dev, q.dtype, 128, 128, 64, 0))
    q = torch.zeros((1, 128, 2 * 128), device=dev)
    k = torch.zeros((1, 128, 128), device=dev)
    rope = _rope_tables(dev, q.dtype, 128, 128, 128, 0)
    seg = torch.zeros((1, 128), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="no segment ids"):
        kfa.flash_fwd(q, k, k, 2, 1, True, 1.0, seg, seg, rope=rope)
    with pytest.raises(ValueError, match="qcos"):
        kfa.flash_fwd(q, k, k, 2, 1, True, 1.0,
                      rope=(rope[0].bfloat16(),) + rope[1:])
    with pytest.raises(ValueError, match="kcos"):
        kfa.flash_fwd(q, k, k, 2, 1, True, 1.0,
                      rope=rope[:2] + (rope[2][:64],) + rope[3:])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("neg", [False, True], ids=["fwd", "inverse"])
def test_rope_kernel_matches_plain_bitwise(dtype, neg):
    dev = _card()
    gen = torch.Generator().manual_seed(13)
    b, l, nh, nkv, d = 2, 256, 4, 2, 128
    q = torch.randn(b, l, nh * d, generator=gen).to(dev, dtype)
    k = torch.randn(b, l, nkv * d, generator=gen).to(dev, dtype)
    ang = torch.rand(l, d, generator=gen).to(dev) * 6.0
    cos, sin = ang.cos().to(dtype), ang.sin().to(dtype)
    oq, ok = k6.rope(q, k, cos, sin, nh, nkv, neg)
    rq, rk = trope.rope_reference(q, k, cos, sin, nh, nkv, neg)
    torch.cuda.synchronize()
    assert torch.equal(oq, rq) and torch.equal(ok, rk)


@pytest.mark.cuda
def test_training_wrappers_refuse_what_the_kernels_do_not_take():
    dev = _card()
    q = torch.zeros((1, 128, 4 * 96), device=dev)
    k = torch.zeros((1, 128, 2 * 96), device=dev)
    with pytest.raises(ValueError, match="head_dim 96"):
        kfa.flash_fwd(q, k, k, 4, 2, True, 1.0)
    q = torch.zeros((1, 256, 4 * 64), device=dev)
    k = torch.zeros((1, 128, 2 * 64), device=dev)
    with pytest.raises(ValueError, match="Lq <= Lk"):
        kfa.flash_fwd(q, k, k, 4, 2, True, 1.0)
    q1 = torch.zeros((1, 100, 4 * 64), device=dev)
    k1 = torch.zeros((1, 128, 4 * 64), device=dev)
    with pytest.raises(ValueError, match="multiple of 64"):
        kfa.flash_fwd(q1, k1, k1, 4, 4, False, 1.0)
    with pytest.raises(ValueError, match="share one of"):
        kfa.flash_fwd(q, k.half(), k, 4, 2, False, 1.0)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        k6.rope(q.cpu(), k.cpu(), q.cpu(), q.cpu(), 4, 2)
    seg = torch.zeros((1, 128), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="int32"):
        kfa.flash_fwd(k1, k1, k1, 4, 4, False, 1.0, seg.long(), seg)
    with pytest.raises(ValueError, match="k_segments"):
        kfa.flash_fwd(k1, k1, k1, 4, 4, False, 1.0, seg, None)


@pytest.mark.cuda
def test_chunked_loss_bf16_gemm_matches_the_widened_branch():
    """The card's bf16 loss chunk (one GEMM with an f32 result) against
    the same chunk widened to f32 first: loss within 1e-6 relative, the
    bf16 gradients within one bf16 ulp (2^-7) of the f32 ones.  One chunk
    (with ignored tokens): over several, a bf16 w's gradient sums the
    chunks' parts in bf16, as the reference's scan does, and the f32
    branch's in f32."""
    from paddle_tpu_torch.ops.chunked_ce import chunked_token_ce

    dev = _card()
    gen = torch.Generator().manual_seed(14)
    n, hid, vocab = 512, 256, 1000
    h = torch.randn(1, n, hid, generator=gen).to(dev, torch.bfloat16)
    w = (0.05 * torch.randn(hid, vocab, generator=gen)).to(dev,
                                                           torch.bfloat16)
    labels = torch.randint(0, vocab, (1, n), generator=gen).to(dev)
    labels[0, -7:] = -1
    res = []
    for dt in (torch.bfloat16, torch.float32):
        hx, wx = h.to(dt).requires_grad_(True), w.to(dt).requires_grad_(True)
        loss = chunked_token_ce(hx, labels, wx, n)
        res.append((loss, *torch.autograd.grad(loss, (hx, wx))))
    (lb, dhb, dwb), (lf, dhf, dwf) = res
    torch.testing.assert_close(lb, lf, atol=0, rtol=1e-6)
    for got, ref in ((dhb, dhf), (dwb, dwf)):
        assert got.dtype == torch.bfloat16
        lim = 2.0 ** -7 * ref.abs() + 2.0 ** -16 * ref.abs().max()
        assert bool(((got.float() - ref).abs() <= lim).all())


# --------------------------------------- int8 kernels (K7, K8-int8, K9-int8)
from paddle_tpu_torch.ops import fused_adamw as k7  # noqa: E402


def _q8_caches(dev, gen, paged):
    shape = (N, C, HKV, D) if paged else (B, LMAX, HKV, D)

    def leaf():
        return (torch.randint(-127, 128, shape, generator=gen,
                              dtype=torch.int8).to(dev),
                (0.001 + 0.05 * torch.rand(shape[:-1], generator=gen))
                .to(dev, torch.float16))
    return leaf(), leaf()


def _clone(c):
    return tuple(x.clone() for x in c)


def _equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.cuda
@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("t", [1, 3])
def test_decode_kernel_int8_matches_plain(paged, t):
    """K8's int8 branch: codes times f16 scales dequantized in the
    kernel; f32 output within atol=rtol=1e-4 (summation order only)."""
    dev = _card()
    gen = torch.Generator().manual_seed(13)
    kc, vc = _q8_caches(dev, gen, paged)
    table = _table(dev, gen) if paged else None
    lengths = torch.tensor([0, C - 1, 2 * C + 5, LMAX], dtype=torch.int32,
                           device=dev)
    qg = torch.randn(B, HKV, G, t, D, generator=gen).to(dev)
    before = k8.launches
    out = k8.paged_decode_attention(qg, kc, vc, lengths, D ** -0.5, C,
                                    table, impl="cuda")
    ref = k8.paged_decode_attention_reference(qg, kc, vc, lengths,
                                              D ** -0.5, C, table)
    torch.cuda.synchronize()
    assert k8.launches == before + 1
    torch.testing.assert_close(out[:B - 1], ref[:B - 1], atol=1e-4,
                               rtol=1e-4)
    assert torch.isfinite(out).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("t", [16, 32], ids=["C>T", "C=T"])
def test_prefill_kernel_int8_matches_plain(dtype, paged, t):
    """K9's int8 branch over chained chunks: the appended codes and f16
    scales BITWISE the plain quantize-on-append (dropped rows write
    neither), the output where the destination is mapped within
    atol=rtol=1e-4 in f32 (summation order only) or, for bf16 queries
    (the output rounds to bf16), within 2e-2 as the float rows."""
    dev = _card()
    gen = torch.Generator().manual_seed(17)
    kc, vc = _q8_caches(dev, gen, paged)
    trow = None
    if paged:
        trow = torch.tensor([[3, 9, 0, N]], dtype=torch.int32, device=dev)
    k2, v2 = _clone(kc), _clone(vc)
    for off in range(0, LMAX, t):
        q = torch.randn(1, t, HKV * G, D, generator=gen).to(dev, dtype)
        kn = torch.randn(1, t, HKV, D, generator=gen).to(dev, dtype)
        vn = (3.0 * torch.randn(1, t, HKV, D, generator=gen)).to(dev, dtype)
        o1, _, _ = k9.prefill_attention(q, kn, vn, kc, vc, 1, off,
                                        D ** -0.5, C, trow, impl="cuda")
        o2, _, _ = k9.prefill_attention_reference(q, kn, vn, k2, v2, 1, off,
                                                  D ** -0.5, C, trow)
        torch.cuda.synchronize()
        assert _equal(kc, k2) and _equal(vc, v2), off
        tol = 1e-4 if dtype == torch.float32 else 2e-2
        if trow is None or int(trow[0, off // C]) < N:
            torch.testing.assert_close(o1.float(), o2.float(), atol=tol,
                                       rtol=tol)


@pytest.mark.cuda
def test_prefill_kernel_int8_codes_are_q8_quantize():
    """The codes and scales the kernel writes are ``_q8_quantize`` of the
    new rows, bit for bit, including an all-zero row and rows of very
    small and very large magnitude."""
    dev = _card()
    gen = torch.Generator().manual_seed(19)
    kc, vc = _q8_caches(dev, gen, False)
    t = 32
    kn = torch.randn(1, t, HKV, D, generator=gen)
    kn[0, 0] = 0.0
    kn[0, 1] *= 1e-5
    kn[0, 2] *= 1e3
    kn = kn.to(dev)
    vn = torch.randn(1, t, HKV, D, generator=gen).to(dev)
    q = torch.randn(1, t, HKV * G, D, generator=gen).to(dev)
    k9.prefill_attention(q, kn, vn, kc, vc, 2, C, D ** -0.5, C,
                         impl="cuda")
    torch.cuda.synchronize()
    want_q, want_s = tda._q8_quantize(kn[0])
    assert torch.equal(kc[0][2, C:C + t], want_q)
    assert torch.equal(kc[1][2, C:C + t], want_s)


def _adam_case(dev, shape, p_dtype, g_dtype, master, seed):
    gen = torch.Generator().manual_seed(seed)
    p32 = torch.randn(shape, generator=gen)
    codes, scales = k7.q8_encode(0.1 * torch.randn(shape, generator=gen))
    return dict(
        p=p32.to(dev, p_dtype),
        g=torch.randn(shape, generator=gen).to(dev, g_dtype),
        codes=codes.to(dev), scales=scales.to(dev),
        v=torch.randn(shape, generator=gen).abs().to(dev, torch.bfloat16),
        master=p32.to(dev) if master else None)


@pytest.mark.cuda
@pytest.mark.parametrize("p_dtype,g_dtype,master", [
    (torch.bfloat16, torch.bfloat16, False),
    (torch.bfloat16, torch.float32, True),
    (torch.float32, torch.float32, False),
    (torch.bfloat16, torch.float32, False),
    (torch.bfloat16, torch.bfloat16, True)],
    ids=["bf16", "bf16-master", "f32", "bf16-f32grad", "bf16-master-bf16grad"])
@pytest.mark.parametrize("shape", [(8, 2048), (12, 256), (100,), (3, 1000)],
                         ids=str)
def test_fused_adamw_kernel_matches_plain_bitwise(shape, p_dtype, g_dtype,
                                                  master):
    """K7 in place against its plain version: parameter, master, codes,
    scales and second moment BITWISE equal (both round every operation
    once, in the same order), whole and ragged blocks alike."""
    dev = _card()
    a = _adam_case(dev, shape, p_dtype, g_dtype, master, 23)
    b = {k: (v.clone() if v is not None else None) for k, v in a.items()}
    sc = k7.adamw_scalars(0.9, 0.999, 1e-8, 1e-3, 5, 0.01)
    before = k7.launches
    k7.fused_adamw_q8(a["p"], a["g"], a["codes"], a["scales"], a["v"], sc,
                      master=a["master"], impl="cuda")
    k7.fused_adamw_q8(b["p"], b["g"], b["codes"], b["scales"], b["v"], sc,
                      master=b["master"], impl="reference")
    torch.cuda.synchronize()
    assert k7.launches == before + 1
    for k in ("p", "codes", "scales", "v", "master"):
        if a[k] is not None:
            assert torch.equal(a[k], b[k]), k


@pytest.mark.cuda
def test_fused_adamw_kernel_refuses_dtypes_it_is_not_built_for():
    """K7 is built for the dtypes the optimizer passes: an f16 parameter,
    or a bf16 gradient on an f32 parameter without a master, raises
    before any launch."""
    dev = _card()
    a = _adam_case(dev, (4, 256), torch.bfloat16, torch.bfloat16, False, 31)
    sc = k7.adamw_scalars(0.9, 0.999, 1e-8, 1e-3, 1, 0.0)
    before = k7.launches
    with pytest.raises(ValueError, match="parameter dtype torch.float16"):
        k7.fused_adamw_q8(a["p"].half(), a["g"], a["codes"], a["scales"],
                          a["v"], sc, impl="cuda")
    with pytest.raises(ValueError, match="not built"):
        k7.fused_adamw_q8(a["p"].float(), a["g"], a["codes"], a["scales"],
                          a["v"], sc, impl="cuda")
    assert k7.launches == before


@pytest.mark.cuda
def test_fused_adamw_kernel_unaligned_view():
    """Operands at an odd element offset take the element-by-element
    path: still bitwise the plain version."""
    dev = _card()
    a = _adam_case(dev, (1, 2049), torch.bfloat16, torch.bfloat16, False, 29)
    views = {k: (v.reshape(-1)[1:] if v is not None and k != "scales"
                 else v) for k, v in a.items()}
    n = views["p"].numel()
    views["scales"] = a["scales"].new_zeros((-(-n // 256),))
    b = {k: (v.clone() if v is not None else None) for k, v in views.items()}
    sc = k7.adamw_scalars(0.9, 0.999, 1e-8, 1e-3, 2, 0.0)
    k7.fused_adamw_q8(views["p"], views["g"], views["codes"],
                      views["scales"], views["v"], sc, impl="cuda")
    k7.fused_adamw_q8(b["p"], b["g"], b["codes"], b["scales"], b["v"], sc,
                      impl="reference")
    torch.cuda.synchronize()
    for k in ("p", "codes", "scales", "v"):
        assert torch.equal(views[k], b[k]), k


# ------------------------------- the redesigned serving kernels (K8, K9)
def _bf16_ulps(a, b):
    """Elementwise distance of two bf16 tensors in units in the last
    place (sign-magnitude bits mapped to ordered integers)."""
    ia = a.contiguous().view(torch.int16).int()
    ib = b.contiguous().view(torch.int16).int()
    ia = torch.where(ia < 0, -32768 - ia, ia)
    ib = torch.where(ib < 0, -32768 - ib, ib)
    return (ia - ib).abs()


def _edge_lengths(c, lmax):
    """Lengths on every edge of K8's pool blocks and of its 256-key spans,
    then a slot parked at lmax and one past it."""
    s = k8._SPLIT
    live = sorted({0, 1, c - 1, c, c + 1, 2 * c - 1, s - 1, s, s + 1,
                   lmax - 1})
    return live + [lmax, lmax + 5]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES + [torch.int8], ids=str)
@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("c", [64, 256])
@pytest.mark.parametrize("t", [1, 4])
def test_decode_split_edges_match_plain_bitwise_run_to_run(dtype, paged, c,
                                                           t):
    """The split-K K8 at head_dim 128 with lengths on every block and
    span edge, a parked slot at lmax and past it, sentinel entries past
    each row's blocks: live rows within atol=rtol=1e-4 of the plain
    version (summation order only), one launch a call, and two launches
    bitwise equal (the merge runs in span order)."""
    dev = _card()
    gen = torch.Generator().manual_seed(23)
    d, hkv, g, lmax = 128, 2, 2, 1024
    lens = _edge_lengths(c, lmax)
    b, w = len(lens), lmax // c
    n = b * w
    shape = (n, c, hkv, d) if paged else (b, lmax, hkv, d)
    if dtype == torch.int8:
        def leaf():
            return (torch.randint(-127, 128, shape, generator=gen,
                                  dtype=torch.int8).to(dev),
                    (0.001 + 0.05 * torch.rand(shape[:-1], generator=gen))
                    .to(dev, torch.float16))
        kc, vc = leaf(), leaf()
    else:
        kc = torch.randn(shape, generator=gen).to(dev, dtype)
        vc = torch.randn(shape, generator=gen).to(dev, dtype)
    table = None
    if paged:
        tbl = torch.full((b, w), n, dtype=torch.int32)
        perm = torch.randperm(n, generator=gen).to(torch.int32)
        for i, length in enumerate(lens):
            if length < lmax:
                used = min(-(-(length + t) // c), w)
                tbl[i, :used] = perm[i * w:i * w + used]
        table = tbl.to(dev)
    lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
    qg = torch.randn(b, hkv, g, t, d, generator=gen).to(dev)
    before = k8.launches
    out = k8.paged_decode_attention(qg, kc, vc, lengths, d ** -0.5, c,
                                    table, impl="cuda")
    out2 = k8.paged_decode_attention(qg, kc, vc, lengths, d ** -0.5, c,
                                     table, impl="cuda")
    ref = k8.paged_decode_attention_reference(qg, kc, vc, lengths,
                                              d ** -0.5, c, table)
    torch.cuda.synchronize()
    assert k8.launches == before + 2
    live = torch.tensor([x < lmax for x in lens], device=dev)
    torch.testing.assert_close(out[live], ref[live], atol=1e-4, rtol=1e-4)
    assert torch.isfinite(out).all()
    assert torch.equal(out, out2)


@pytest.mark.cuda
@pytest.mark.parametrize("kv", ["bfloat16", "int8"])
@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("t", [16, 32, 64, 256])
def test_prefill_mma_instance_matches_plain(kv, paged, t):
    """K9's tensor-core instance (bf16 q, bf16 or int8 cache, head_dim
    128) over chunks chained at offsets 0, T, 2T, ... (up to 8 chunks),
    the caches carried along: each call launches the mma instance once;
    the caches stay BITWISE the plain append's (int8 codes and f16 scales
    included); the bf16 output within 2 bf16 ulps or 1e-6 of the plain
    version (p = hi + lo keeps the reference's f32 p·v).  The paged
    row's last block is unmapped, so the last chunks' writes drop."""
    dev = _card()
    gen = torch.Generator().manual_seed(31)
    d, hkv, g, c, lmax = 128, 2, 4, 64, 1024
    w = lmax // c
    shape = (w + 2, c, hkv, d) if paged else (3, lmax, hkv, d)
    kc, vc = tda.init_kv_pool(*shape, dtype=kv, device=dev) if paged \
        else tda.init_kv_cache(*shape, dtype=kv, device=dev)
    trow = None
    if paged:
        trow = torch.randperm(w + 2, generator=gen)[:w].to(torch.int32)
        trow[-1] = w + 2                     # a sentinel: the append drops
        trow = trow.view(1, w).to(dev)

    def clone(x):
        return tuple(y.clone() for y in x) if isinstance(x, tuple) \
            else x.clone()

    def equal(a, b):
        if isinstance(a, tuple):
            return all(torch.equal(x, y) for x, y in zip(a, b))
        return torch.equal(a, b)

    k2, v2 = clone(kc), clone(vc)
    for off in range(0, min(lmax, 8 * t), t):
        q = torch.randn(1, t, hkv * g, d, generator=gen).to(dev,
                                                            torch.bfloat16)
        kn = torch.randn(1, t, hkv, d, generator=gen).to(dev, torch.bfloat16)
        vn = (3 * torch.randn(1, t, hkv, d, generator=gen)).to(
            dev, torch.bfloat16)
        before = (k9.launches, k9.launches_mma)
        o1, _, _ = k9.prefill_attention(q, kn, vn, kc, vc, 1, off,
                                        d ** -0.5, c, trow, impl="cuda")
        o2, _, _ = k9.prefill_attention_reference(q, kn, vn, k2, v2, 1, off,
                                                  d ** -0.5, c, trow)
        torch.cuda.synchronize()
        assert (k9.launches, k9.launches_mma) == (before[0] + 1,
                                                  before[1] + 1)
        assert equal(kc, k2) and equal(vc, v2), off
        assert o1.dtype == torch.bfloat16 and o1.shape == q.shape
        # where a block of the chunk is unmapped the plain version reads
        # back rows the append dropped: compare the caches only
        if trow is None or bool((trow[0, off // c:(off + t - 1) // c + 1]
                                 < w + 2).all()):
            near = (o1.float() - o2.float()).abs() <= 1e-6
            assert ((_bf16_ulps(o1, o2) <= 2) | near).all(), off


@pytest.mark.cuda
def test_prefill_f32_queries_take_the_cuda_core_instance():
    dev = _card()
    gen = torch.Generator().manual_seed(37)
    kc, vc = tda.init_kv_cache(2, 128, 1, 128, "bfloat16", device=dev)
    q = torch.randn(1, 32, 2, 128, generator=gen).to(dev)
    kn = torch.randn(1, 32, 1, 128, generator=gen).to(dev)
    before = (k9.launches, k9.launches_mma)
    out, _, _ = k9.prefill_attention(q, kn, kn, kc, vc, 0, 32, 128 ** -0.5,
                                     32, impl="cuda")
    torch.cuda.synchronize()
    assert (k9.launches, k9.launches_mma) == (before[0] + 1, before[1])
    assert out.dtype == torch.float32


# The forward's and dK/dV's wgmma instances (bf16, head_dim 64/128) at the
# edges of their tiles: blocks of 128 positions of one head (Lq 64: a
# half-empty block; G 3), key tiles of 128 (Lk 64: one half tile; Lk 192
# and 320: a ragged last tile), causal with q_offset > 0, segments with a
# dead row and a pad tail, and the rope instance.
# (id, B, Lq, Lk, H, Hkv, D, causal, kind)
WGMMA_EDGES = [
    ("lqg64", 2, 64, 64, 1, 1, 64, True, None),
    ("g3-lqg192", 1, 64, 64, 3, 1, 128, True, None),
    ("lq<lk-ragged-keys", 1, 64, 192, 4, 2, 128, True, None),
    ("lk64-noncausal", 2, 128, 64, 4, 2, 64, False, None),
    ("lk64-causal", 1, 64, 64, 2, 2, 128, True, None),
    ("g3-d64-lq<lk", 2, 128, 320, 6, 2, 64, True, None),
    ("padding-d128", 4, 192, 192, 4, 2, 128, False, "padding"),
    ("varlen-d64-g3", 1, 320, 320, 3, 1, 64, True, "varlen"),
    ("rope-g3-lq<lk", 1, 64, 192, 6, 2, 128, True, "rope"),
    ("rope-noncausal-lk64", 2, 64, 64, 4, 4, 128, False, "rope"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("geom", WGMMA_EDGES, ids=[g[0] for g in WGMMA_EDGES])
def test_wgmma_flash_edges_match_plain(geom):
    """Forward (out, lse) and dK/dV of the wgmma instances against the
    plain versions at ``FLASH_TOL`` (lse on live rows; padding rows zero),
    launched through the wgmma instances (their ``*_wgmma`` counters move
    with the kernel's), and bitwise equal run to run."""
    dev = _card()
    _, b, lq, lk, h, hkv, d, causal, kind = geom
    dtype = torch.bfloat16
    q, k, v, do = _flash_inputs(dev, dtype, b, lq, lk, h, hkv, d, 31)
    seg, extra, tag = (), {}, ""
    if kind in ("padding", "varlen"):
        seg = _segments(dev, kind, b, lq)
        do = do.masked_fill((seg[0] < 0)[:, :, None], 0)
        tag = "_seg"
    elif kind == "rope":
        extra["rope"] = _rope_tables(dev, dtype, lq, lk, d, 7)
        tag = "_rope"
    scale = d ** -0.5

    def run():
        out, lse = kfa.flash_fwd(q, k, v, h, hkv, causal, scale, *seg,
                                 **extra)
        delta = kfa.flash_delta(do, out, h)
        dk, dv = kfa.flash_bwd_dkv(q, k, v, do, lse, delta, h, hkv, causal,
                                   scale, *seg, **extra)
        return out, lse, delta, dk, dv

    before = dict(kfa.launches)
    out, lse, delta, dk, dv = run()
    ref, rlse = tfa.flash_fwd_reference(q, k, v, h, hkv, causal, scale,
                                        *seg, **extra)
    _, rdk, rdv = tfa.flash_bwd_reference(q, k, v, do, lse, delta, h, hkv,
                                          causal, scale, *seg, **extra)
    torch.cuda.synchronize()
    for key in ("fwd", "dkv"):
        assert kfa.launches[key + tag] == before[key + tag] + 1
        assert kfa.launches[key + tag + "_wgmma"] == \
            before[key + tag + "_wgmma"] + 1
    tol = FLASH_TOL[dtype]
    torch.testing.assert_close(out.float(), ref.float(), **tol)
    live = (seg[0] >= 0)[:, None, :] if seg else 1
    torch.testing.assert_close(lse * live, rlse * live, atol=1e-5,
                               rtol=1e-5)
    if seg:
        assert float(out.float().masked_fill((seg[0] >= 0)[:, :, None], 0)
                     .abs().max()) == 0.0
    for a, r in ((dk, rdk), (dv, rdv)):
        torch.testing.assert_close(a.float(), r.float(), **tol)
    for a, a2 in zip((out, lse, delta, dk, dv), run()):
        assert torch.equal(a, a2)


# The dQ kernel's wgmma instance (bf16, head_dim 64/128): blocks of 128
# positions of one head (Lq 64 and 192: half-empty blocks), 64-key ring
# stages (Lk 192, 320, 448), G 1/2/4/8, causal with q_offset > 0,
# non-causal, key padding with a dead row, causal varlen with a pad tail,
# and the rope instance.  (id, B, Lq, Lk, H, Hkv, D, causal, kind)
DQ_EDGES = [
    ("g1-d64-lq192", 2, 192, 192, 2, 2, 64, True, None),
    ("g2-lq<lk-320", 1, 192, 320, 4, 2, 128, True, None),
    ("g4-lq64-lk448", 1, 64, 448, 8, 2, 128, True, None),
    ("g8-noncausal-lk192", 2, 128, 192, 8, 1, 64, False, None),
    ("g8-causal-d128", 1, 320, 320, 8, 1, 128, True, None),
    ("padding-g2-d64", 4, 192, 192, 4, 2, 64, False, "padding"),
    ("varlen-g4-d128", 1, 320, 320, 8, 2, 128, True, "varlen"),
    ("rope-g4-lq<lk", 1, 192, 320, 8, 2, 128, True, "rope"),
    ("rope-g1-noncausal", 2, 64, 192, 2, 2, 128, False, "rope"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("geom", DQ_EDGES, ids=[g[0] for g in DQ_EDGES])
def test_wgmma_dq_edges_match_plain(geom):
    """dQ of the wgmma instance against ``flash_bwd_reference`` at
    ``FLASH_TOL`` (on the forward's lse and K3's delta), launched through
    the wgmma instance (its ``*_wgmma`` counter moves with the kernel's),
    and bitwise equal over two launches (a fixed order of key tiles)."""
    dev = _card()
    _, b, lq, lk, h, hkv, d, causal, kind = geom
    dtype = torch.bfloat16
    q, k, v, do = _flash_inputs(dev, dtype, b, lq, lk, h, hkv, d, 37)
    seg, extra, tag = (), {}, ""
    if kind in ("padding", "varlen"):
        seg = _segments(dev, kind, b, lq)
        do = do.masked_fill((seg[0] < 0)[:, :, None], 0)
        tag = "_seg"
    elif kind == "rope":
        extra["rope"] = _rope_tables(dev, dtype, lq, lk, d, 9)
        tag = "_rope"
    scale = d ** -0.5
    out, lse = kfa.flash_fwd(q, k, v, h, hkv, causal, scale, *seg, **extra)
    delta = kfa.flash_delta(do, out, h)
    before = dict(kfa.launches)
    dq = kfa.flash_bwd_dq(q, k, v, do, lse, delta, h, hkv, causal, scale,
                          *seg, **extra)
    dq2 = kfa.flash_bwd_dq(q, k, v, do, lse, delta, h, hkv, causal, scale,
                           *seg, **extra)
    rdq, _, _ = tfa.flash_bwd_reference(q, k, v, do, lse, delta, h, hkv,
                                        causal, scale, *seg, **extra)
    torch.cuda.synchronize()
    assert kfa.launches["dq" + tag] == before["dq" + tag] + 2
    assert kfa.launches["dq" + tag + "_wgmma"] == \
        before["dq" + tag + "_wgmma"] + 2
    torch.testing.assert_close(dq.float(), rdq.float(), **FLASH_TOL[dtype])
    assert torch.isfinite(dq.float()).all()
    assert torch.equal(dq, dq2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("neg", [False, True], ids=["fwd", "inverse"])
@pytest.mark.parametrize("case", ["vector", "scalar-d20", "scalar-unaligned"])
def test_rope_instances_match_plain_bitwise(dtype, neg, case):
    """K6's vector instance (16-byte chunks) and its scalar instance (D/2
    not a whole number of chunks, or an unaligned pointer) bitwise equal
    to the plain version; only the vector launch moves ``launches_vec``."""
    dev = _card()
    gen = torch.Generator().manual_seed(41)
    b, l, nh, nkv = 2, 96, 4, 2
    d = 20 if case == "scalar-d20" else 128
    off = 1 if case == "scalar-unaligned" else 0

    def packed(width):
        flat = torch.randn(b * l * width + off, generator=gen)
        return flat.to(dev, dtype)[off:].view(b, l, width)
    q, k = packed(nh * d), packed(nkv * d)
    ang = torch.rand(l, d, generator=gen).to(dev) * 6.0
    cos, sin = ang.cos().to(dtype), ang.sin().to(dtype)
    before = (k6.launches, k6.launches_vec)
    oq, ok = k6.rope(q, k, cos, sin, nh, nkv, neg)
    rq, rk = trope.rope_reference(q, k, cos, sin, nh, nkv, neg)
    torch.cuda.synchronize()
    vec = int(case == "vector")
    assert (k6.launches, k6.launches_vec) == (before[0] + 1, before[1] + vec)
    assert torch.equal(oq, rq) and torch.equal(ok, rk)


from paddle_tpu_torch.models.llama import (  # noqa: E402
    LlamaConfig, LlamaForCausalLM,
)
from paddle_tpu_torch.serving import (  # noqa: E402
    FaultPlan, Request, ServingEngine, SpecConfig,
)
from paddle_tpu_torch.ops.decode_attention import (  # noqa: E402
    _q8_quantize,
)


@pytest.mark.cuda
@pytest.mark.parametrize("source", ["prompt_lookup", "draft_model"])
@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_spec_serving_on_the_card_equals_greedy(source, paged):
    """Speculative serving on the card (the tiny f32 Llama, 32-key
    chunks, spec_k 4): the verify forward runs K8 at T = 5 (counted by
    width), no plain version runs, the streams equal the greedy engine's
    on the card and pipelined == synchronous; a paged draft leaves no
    block behind."""
    dev = _card()
    model = LlamaForCausalLM(LlamaConfig.tiny(dtype="float32"), device=dev,
                             seed=0)
    draft = LlamaForCausalLM(LlamaConfig.tiny(dtype="float32",
                                              num_hidden_layers=1),
                             device=dev, seed=1)
    gen = torch.Generator().manual_seed(5)
    prompts = [torch.randint(1, 200, (6,), generator=gen).repeat(4),
               torch.randint(1, 200, (19,), generator=gen),
               torch.randint(1, 200, (40,), generator=gen)]
    geom = dict(batch_size=2, max_len=128, decode_chunk=32,
                prefill_chunk=32, instrument=False)
    if paged:
        geom["kv_block"] = 32
    spec = SpecConfig(source=source, spec_k=4,
                      draft_model=draft if source == "draft_model" else None)

    def serve(**kw):
        eng = ServingEngine(model, **geom, **kw)
        reqs = [eng.submit(Request(p.numpy(), 16)) for p in prompts]
        eng.run()
        if paged:
            assert eng.kv_manager.draft_blocks_used() == 0
        return [r.output_ids for r in reqs]
    greedy = serve()
    before = (k8.launches_t.get(5, 0), k8.plain_runs, k9.plain_runs)
    out = serve(mode="spec", spec=spec)
    torch.cuda.synchronize()
    assert k8.launches_t.get(5, 0) > before[0]
    assert (k8.plain_runs, k9.plain_runs) == before[1:]
    assert out == greedy
    assert serve(mode="spec", spec=spec, pipeline=False) == out


def _ranges(lengths, t, kind):
    """``tree``: the last of ``t`` rows hides keys [L+1, L+t-1); ``spans``:
    every row hides [64, 192) — two whole 64-key spans of the split."""
    h = torch.zeros((lengths.shape[0], t, 2), dtype=torch.int32,
                    device=lengths.device)
    if kind == "tree":
        h[:, t - 1, 0] = lengths + 1
        h[:, t - 1, 1] = lengths + (t - 1)
    else:
        h[..., 0], h[..., 1] = 64, 192
    return h


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES + ["int8"], ids=str)
@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("t,kind", [(3, "tree"), (10, "tree"),
                                    (4, "spans")])
def test_decode_kernel_hidden_range_matches_plain(dtype, paged, t, kind):
    dev = _card()
    gen = torch.Generator().manual_seed(11)
    Dh, Ch, W = 128, 256, 4                   # the split's 64-key spans
    lmax = Ch * W
    n = 12
    shape = (n, Ch, HKV, Dh) if paged else (B, lmax, HKV, Dh)

    def leaf():
        x = torch.randn(shape, generator=gen).to(dev)
        return _q8_quantize(x) if dtype == "int8" else x.to(dtype)
    kc, vc = leaf(), leaf()
    table = None
    if paged:
        table = torch.full((B, W), n, dtype=torch.int32)
        table[:B - 1, :3] = torch.randperm(n, generator=gen)[:9].view(3, 3) \
            .to(torch.int32)
        table = table.to(dev)
    lengths = torch.tensor([5, 200, 700, lmax], dtype=torch.int32,
                           device=dev)             # the last row parked
    hid = _ranges(lengths, t, kind)
    qg = torch.randn(B, HKV, G, t, Dh, generator=gen).to(dev)
    before = (k8.launches, k8.launches_hidden, k8.launches_t.get(t, 0))
    out = k8.paged_decode_attention(qg, kc, vc, lengths, Dh ** -0.5, Ch,
                                    table, impl="cuda", hidden=hid)
    again = k8.paged_decode_attention(qg, kc, vc, lengths, Dh ** -0.5, Ch,
                                      table, impl="cuda", hidden=hid)
    ref = k8.paged_decode_attention_reference(qg, kc, vc, lengths,
                                              Dh ** -0.5, Ch, table,
                                              hidden=hid)
    plain = k8.paged_decode_attention(qg, kc, vc, lengths, Dh ** -0.5, Ch,
                                      table, impl="cuda")
    torch.cuda.synchronize()
    assert (k8.launches, k8.launches_hidden, k8.launches_t[t]) == (
        before[0] + 3, before[1] + 2, before[2] + 3)
    assert torch.equal(out, again)
    torch.testing.assert_close(out[:B - 1], ref[:B - 1], atol=1e-4,
                               rtol=1e-4)
    assert not torch.equal(out[1:B - 1], plain[1:B - 1])


@pytest.mark.cuda
@pytest.mark.parametrize("pipeline", [False, True])
def test_tree_serving_on_the_card_equals_greedy(pipeline):
    """Top-2 tree verification on the card (the tiny f32 Llama, 32-key
    chunks, spec_k 4): every verify launches K8 at T = 6 with the branch
    row's range, no plain version runs, and the streams equal the greedy
    engine's."""
    dev = _card()
    model = LlamaForCausalLM(LlamaConfig.tiny(dtype="float32"), device=dev,
                             seed=0)
    draft = LlamaForCausalLM(LlamaConfig.tiny(dtype="float32",
                                              num_hidden_layers=1),
                             device=dev, seed=1)
    gen = torch.Generator().manual_seed(5)
    prompts = [torch.randint(1, 200, (n,), generator=gen) for n in (7, 19, 40)]
    geom = dict(batch_size=2, max_len=128, decode_chunk=32,
                prefill_chunk=32, instrument=False, pipeline=pipeline)

    def serve(**kw):
        eng = ServingEngine(model, **geom, **kw)
        reqs = [eng.submit(Request(p.numpy(), 16)) for p in prompts]
        eng.run()
        return [r.output_ids for r in reqs]
    greedy = serve()
    before = (k8.launches_t.get(6, 0), k8.launches_hidden, k8.plain_runs)
    out = serve(mode="spec", spec=SpecConfig(
        source="draft_model", draft_model=draft, spec_k=4, tree="top2"))
    torch.cuda.synchronize()
    grew = (k8.launches_t.get(6, 0) - before[0],
            k8.launches_hidden - before[1])
    assert grew[0] > 0 and grew[0] == grew[1]
    assert k8.plain_runs == before[2]
    assert out == greedy


@pytest.mark.cuda
def test_reliability_on_the_card():
    """Injected dispatch errors are retried with the kernels (the streams
    equal a clean run bit for bit) and a poisoned request retires alone."""
    dev = _card()
    model = LlamaForCausalLM(LlamaConfig.tiny(dtype="float32"), device=dev,
                             seed=0)
    gen = torch.Generator().manual_seed(9)
    prompts = [torch.randint(1, 200, (n,), generator=gen) for n in (7, 19, 40)]
    geom = dict(batch_size=2, max_len=128, decode_chunk=32,
                prefill_chunk=32, instrument=False, retry_backoff=1e-4)

    def serve(plan=None):
        eng = ServingEngine(model, **geom, faults=plan)
        reqs = [eng.submit(Request(p.numpy(), 16)) for p in prompts]
        st = eng.drain()
        return st, [r.output_ids for r in reqs]
    _, clean = serve()
    plan = FaultPlan(dispatch_error_steps={1, 3, 6})
    st, out = serve(plan)
    assert out == clean and plan.stats["dispatch_errors"] == 3
    st, out = serve(FaultPlan(poison={1: 3}))
    assert st == {0: "done", 1: "poisoned", 2: "done"}
    assert out[0] == clean[0] and out[2] == clean[2]


# ------------------------- tensor parallelism: the TP-2 shard's head count
#: the serving model (16/4 heads, head_dim 128) split two ways: a rank's
#: K8 and K9 see 8/2 heads, G 4 unchanged; its cache geometry (256-key
#: blocks, max_len 2048) is the serving cell's
TP2 = dict(hkv=2, g=4, d=128, c=256, lmax=2048)


def _tp2_caches(dev, gen, kv, shape):
    if kv == "int8":
        def leaf():
            return (torch.randint(-127, 128, shape, generator=gen,
                                  dtype=torch.int8).to(dev),
                    (0.001 + 0.05 * torch.rand(shape[:-1], generator=gen))
                    .to(dev, torch.float16))
        return leaf(), leaf()
    return (torch.randn(shape, generator=gen).to(dev, torch.bfloat16),
            torch.randn(shape, generator=gen).to(dev, torch.bfloat16))


@pytest.mark.cuda
@pytest.mark.parametrize("kv", ["bfloat16", "int8"])
@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("t", [1, 9])
def test_decode_kernel_at_the_tp2_shard_matches_plain(kv, paged, t):
    """K8 at a TP-2 rank's heads (Hkv 2, G 4, D 128, C 256, lmax 2048),
    bf16 and int8 caches, a decode step (T 1) and the spec_k 8 verify
    width (T 9), mixed lengths and a parked slot: within atol=rtol=1e-4
    of the plain version, one launch a call, bitwise run to run."""
    dev = _card()
    gen = torch.Generator().manual_seed(41)
    hkv, g, d, c, lmax = (TP2[k] for k in ("hkv", "g", "d", "c", "lmax"))
    lens = [0, 255, 256, 700, 1500, lmax - 9, lmax]
    b, w = len(lens), lmax // c
    n = b * w
    kc, vc = _tp2_caches(dev, gen, kv, (n, c, hkv, d) if paged
                         else (b, lmax, hkv, d))
    table = None
    if paged:
        tbl = torch.full((b, w), n, dtype=torch.int32)
        perm = torch.randperm(n, generator=gen).to(torch.int32)
        for i, length in enumerate(lens[:-1]):
            used = min(-(-(length + t) // c), w)
            tbl[i, :used] = perm[i * w:i * w + used]
        table = tbl.to(dev)
    lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
    qg = torch.randn(b, hkv, g, t, d, generator=gen).to(dev)
    before = k8.launches
    out = k8.paged_decode_attention(qg, kc, vc, lengths, d ** -0.5, c,
                                    table, impl="cuda")
    out2 = k8.paged_decode_attention(qg, kc, vc, lengths, d ** -0.5, c,
                                     table, impl="cuda")
    ref = k8.paged_decode_attention_reference(qg, kc, vc, lengths,
                                              d ** -0.5, c, table)
    torch.cuda.synchronize()
    assert k8.launches == before + 2
    torch.testing.assert_close(out[:-1], ref[:-1], atol=1e-4, rtol=1e-4)
    assert torch.isfinite(out).all() and torch.equal(out, out2)


@pytest.mark.cuda
@pytest.mark.parametrize("kv", ["bfloat16", "int8"])
@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_prefill_kernel_at_the_tp2_shard_matches_plain(kv, paged):
    """K9's tensor-core instance at a TP-2 rank's heads (8 query heads,
    Hkv 2, D 128, 256-row chunks chained at offsets 0-1792, 256-key
    blocks): the caches bitwise the plain append's, the bf16 output within
    2 bf16 ulps or 1e-6 of the plain version."""
    dev = _card()
    gen = torch.Generator().manual_seed(43)
    hkv, g, d, c, lmax = (TP2[k] for k in ("hkv", "g", "d", "c", "lmax"))
    t, w = 256, lmax // c
    shape = (w + 2, c, hkv, d) if paged else (3, lmax, hkv, d)
    kc, vc = tda.init_kv_pool(*shape, dtype=kv, device=dev) if paged \
        else tda.init_kv_cache(*shape, dtype=kv, device=dev)
    trow = None
    if paged:
        trow = torch.randperm(w + 2, generator=gen)[:w].to(torch.int32) \
            .view(1, w).to(dev)

    def clone(x):
        return tuple(y.clone() for y in x) if isinstance(x, tuple) \
            else x.clone()

    def equal(a, b):
        if isinstance(a, tuple):
            return all(torch.equal(x, y) for x, y in zip(a, b))
        return torch.equal(a, b)

    k2, v2 = clone(kc), clone(vc)
    for off in range(0, lmax, t):
        q = torch.randn(1, t, hkv * g, d, generator=gen).to(dev,
                                                            torch.bfloat16)
        kn = torch.randn(1, t, hkv, d, generator=gen).to(dev, torch.bfloat16)
        vn = torch.randn(1, t, hkv, d, generator=gen).to(dev, torch.bfloat16)
        before = k9.launches_mma
        o1, _, _ = k9.prefill_attention(q, kn, vn, kc, vc, 2, off,
                                        d ** -0.5, c, trow, impl="cuda")
        o2, _, _ = k9.prefill_attention_reference(q, kn, vn, k2, v2, 2, off,
                                                  d ** -0.5, c, trow)
        torch.cuda.synchronize()
        assert k9.launches_mma == before + 1
        assert equal(kc, k2) and equal(vc, v2), off
        near = (o1.float() - o2.float()).abs() <= 1e-6
        assert ((_bf16_ulps(o1, o2) <= 2) | near).all(), off


@pytest.mark.cuda
def test_tp1_nccl_engine_on_the_card_equals_single_device(tmp_path):
    """``ServingEngine(mesh=)`` over a one-rank NCCL group on the card:
    its all-reduce is the identity, so greedy and prompt-lookup spec
    (int8 KV, paged) stream bit for bit as the single-device engine, with
    the kernels; ``tp_overlap=2`` keeps the tokens."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    dev = _card()
    model = LlamaForCausalLM(LlamaConfig.tiny(dtype="float32"), device=dev,
                             seed=0)
    gen = torch.Generator().manual_seed(13)
    prompts = [torch.randint(1, 200, (n,), generator=gen) for n in (7, 19, 40)]
    geom = dict(batch_size=2, max_len=128, decode_chunk=32,
                prefill_chunk=32, instrument=False)

    def serve(**kw):
        eng = ServingEngine(model, **geom, **kw)
        reqs = [eng.submit(Request(p.numpy(), 16)) for p in prompts]
        eng.run()
        return [r.output_ids for r in reqs]
    spec = dict(mode="spec", spec_k=4, kv_dtype="int8", kv_block=32)
    single = serve(), serve(**spec)
    dist.init_process_group("nccl", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        mesh = init_device_mesh("cuda", (1,), mesh_dim_names=("mp",))
        before = (k8.plain_runs, k9.plain_runs, k8.launches)
        assert (serve(mesh=mesh), serve(mesh=mesh, **spec)) == single
        assert serve(mesh=mesh, tp_overlap=2) == single[0]
        torch.cuda.synchronize()
        assert (k8.plain_runs, k9.plain_runs) == before[:2]
        assert k8.launches > before[2]
    finally:
        dist.destroy_process_group()


# ------------------------------ monolithic prefill: K8 at T = the bucket
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES + [torch.int8], ids=str)
@pytest.mark.parametrize("t", [16, 48, 64, 256, 512])
def test_decode_kernel_at_the_prompt_bucket(dtype, t):
    """K8 with ``t`` query rows over a fresh dense ``[1, t]`` cache at
    length 0 — a monolithic prefill's mini cache — read with a chunk of
    256: wider than the span for t < 256 (one chunk of the span rounded
    up to 32 keys, keys past it masked), 256-key chunks at 512.  Within
    atol=rtol=1e-4 of the plain version and bitwise run to run."""
    dev = _card()
    gen = torch.Generator().manual_seed(31)
    hkv, g, d = 2, 4, 128
    shape = (1, t, hkv, d)
    if dtype == torch.int8:
        def leaf():
            return (torch.randint(-127, 128, shape, generator=gen,
                                  dtype=torch.int8).to(dev),
                    (0.001 + 0.05 * torch.rand(shape[:-1], generator=gen))
                    .to(dev, torch.float16))
        kc, vc = leaf(), leaf()
    else:
        kc = torch.randn(shape, generator=gen).to(dev, dtype)
        vc = torch.randn(shape, generator=gen).to(dev, dtype)
    qg = torch.randn(1, hkv, g, t, d, generator=gen).to(dev)
    lengths = torch.zeros((1,), dtype=torch.int32, device=dev)
    before = k8.launches_t.get(t, 0)
    out = k8.paged_decode_attention(qg, kc, vc, lengths, d ** -0.5, 256,
                                    impl="cuda")
    out2 = k8.paged_decode_attention(qg, kc, vc, lengths, d ** -0.5, 256,
                                     impl="cuda")
    ref = k8.paged_decode_attention_reference(qg, kc, vc, lengths,
                                              d ** -0.5, 256)
    torch.cuda.synchronize()
    assert k8.launches_t[t] == before + 2
    torch.testing.assert_close(out, ref, atol=1e-4, rtol=1e-4)
    assert torch.equal(out, out2)


@pytest.mark.cuda
def test_monolithic_engine_on_the_card():
    """``prefill_chunk=None`` on the card: every admission launches K8 at
    T = its bucket once a layer, no plain version runs, and the f32
    streams equal chunked prefill's."""
    dev = _card()
    model = LlamaForCausalLM(LlamaConfig.tiny(dtype="float32"), device=dev,
                             seed=0)
    gen = torch.Generator().manual_seed(13)
    prompts = [torch.randint(1, 200, (n,), generator=gen) for n in (7, 19,
                                                                    40)]
    geom = dict(batch_size=2, max_len=128, decode_chunk=32,
                instrument=False)

    def serve(pchunk):
        eng = ServingEngine(model, **geom, prefill_chunk=pchunk)
        reqs = [eng.submit(Request(p.numpy(), 12)) for p in prompts]
        eng.run()
        return [r.output_ids for r in reqs]
    k8.launches_t.clear()
    k8.plain_runs = k9.plain_runs = 0
    mono = serve(None)
    n_layers = len(model.llama.layers)
    assert k8.launches_t.get(16) == n_layers
    assert k8.launches_t.get(32) == n_layers
    assert k8.launches_t.get(64) == n_layers
    assert k8.plain_runs == 0 and k9.plain_runs == 0
    assert mono == serve(32)
