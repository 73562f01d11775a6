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
themselves (bitwise, run to run).  The loss chunk's bf16 GEMM with an
f32 result (the card's branch of ``ops/chunked_ce.py``) runs against the
widened f32 branch.
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
@pytest.mark.parametrize("t", [1, 3])
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
