"""The port's top-2 tree verification against the JAX package.

Three levels, each with inputs made from numpy seeds and the JAX side
run as its own tests run it on the CPU:

* the plain version of the hidden key range (``decode_attention(...,
  hidden=)``) against the reference's ``decode_attention(...,
  attn_bias=)`` with the bias built from the same ranges (-1e30 over the
  hidden keys): dense full read, dense chunked read and the paged pool,
  f32 and int8 caches, 3 or 6 query rows, ranges that are empty, that
  cover a whole 16-key chunk, and that start past a row's length;
  outputs of live rows within ``atol=rtol=1e-5``;
* one ``serving_spec_draft_step`` round with ``spec_tree="top2"`` in
  which the BRANCH IS TAKEN for one slot (the reference's own tests
  never take it): the draft is the target with its LM-head columns for
  the target's top-2 next tokens swapped, so it drafts the target's
  second choice and its ``alt1`` is the target's pick.  Two rounds,
  f32 and int8 dense caches: emitted block, ``j``, ``cur'``,
  ``new_len`` and the finite flag equal the reference's exactly; the
  caches (the repaired branch row included) agree with it to the f32
  tolerance (int8: within one quantization step);
* the engine, on the reference test's geometry
  (``tests/test_serving_spec_draft.py:232-241``): tree == linear ==
  greedy streams within the port, pipelined == not, and the port's tree
  engine == the JAX engine's (``pipeline=False`` on the JAX side, its
  pipelined loop races on this container).  Each engine configuration
  runs once per module (memoised).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import llama_decode as jld
from paddle_tpu.models.llama import LlamaConfig as JConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JModel
from paddle_tpu.ops import decode_attention as jda
from paddle_tpu.serving import Request as JRequest
from paddle_tpu.serving import ServingEngine as JEngine
from paddle_tpu.serving.engine import SpecConfig as JSpec
from paddle_tpu.serving.program_key import ProgramKey as JKey
from paddle_tpu_torch.models import llama_decode as tld
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.ops import decode_attention as tda
from paddle_tpu_torch.serving import Request, ServingEngine, SpecConfig
from paddle_tpu_torch.serving.program_key import ProgramKey

# tiny shapes: torch's intra-op threads would only contend with the
# other test processes sharing this machine
torch.set_num_threads(1)

TOL = dict(atol=1e-5, rtol=1e-5)


def _pair(layers, seed):
    paddle.seed(seed)
    jm = JModel(JConfig.tiny(dtype="float32", num_hidden_layers=layers))
    jm.eval()
    tm = LlamaForCausalLM(LlamaConfig.tiny(dtype="float32",
                                           num_hidden_layers=layers),
                          device="cpu")
    state, _ = jm.functional_state()
    tm.load_numpy_state({k: np.asarray(v) for k, v in state.items()})
    return jm, tm


@pytest.fixture(scope="module")
def models():
    """{"jax": (target, draft), "port": (target, draft)}: 2-layer target
    (seed 0), 1-layer draft (seed 1)."""
    (jm, tm), (jd, td) = _pair(2, 0), _pair(1, 1)
    return {"jax": (jm, jd), "port": (tm, td)}


# ------------------------------------------------- the plain hidden range
B, HKV, G, D, C = 4, 2, 2, 16, 16
LMAX = 64
N_BLOCKS = 12

_jdecode = jax.jit(jda.decode_attention,
                   static_argnames=("scale", "layout", "chunk_size",
                                    "attn_impl"))


def _ranges(rng, lengths, t):
    """Per (row, query) hidden ranges: row 2 hides its whole first chunk
    from query 0 and its whole second chunk from query 1 (the spans a
    split-K kernel folds with no visible key); elsewhere empty, a random
    span inside the window, or one starting past the row's length."""
    hidden = np.zeros((B, t, 2), np.int32)
    for b in range(B):
        n = int(lengths[b])
        for i in range(t):
            kind = (b + i) % 3
            if b == 2 and i < 2:
                hidden[b, i] = (i * C, (i + 1) * C)
            elif kind == 1 and n + i >= 2:
                lo = int(rng.integers(1, n + i))
                hidden[b, i] = (lo, int(rng.integers(lo, n + i + 1)))
            elif kind == 2:
                hidden[b, i] = (n + i + 1, n + i + 5)
    return hidden


@pytest.mark.parametrize("read,q8,t", [
    ("full", False, 6), ("full", True, 3), ("chunked", False, 3),
    ("chunked", True, 6), ("paged", False, 6), ("paged", True, 3)],
    ids=lambda v: {False: "f32", True: "int8"}.get(v, str(v)))
def test_hidden_range_matches_jax_bias(read, q8, t):
    rng = np.random.default_rng(t + 10 * q8 + 100 * len(read))
    lengths = np.array([3, C + 5, 2 * C + 1, LMAX], np.int32)  # last parked
    q = rng.standard_normal((B, t, HKV * G, D)).astype(np.float32)
    kn = rng.standard_normal((B, t, HKV, D)).astype(np.float32)
    vn = rng.standard_normal((B, t, HKV, D)).astype(np.float32)
    hidden = _ranges(rng, lengths, t)

    def cache(shape):
        if q8:
            return (rng.integers(-127, 128, shape).astype(np.int8),
                    rng.uniform(1e-3, 5e-2, shape[:-1]).astype(np.float16))
        return rng.standard_normal(shape).astype(np.float32)
    table = None
    if read == "paged":
        shape = (N_BLOCKS, C, HKV, D)
        table = np.full((B, LMAX // C), N_BLOCKS, np.int32)
        ids = list(rng.permutation(N_BLOCKS))
        for b in range(B - 1):
            for w in range(-(-(int(lengths[b]) + t) // C)):
                table[b, w] = ids.pop()
    else:
        shape = (B, LMAX, HKV, D)
    kc, vc = cache(shape), cache(shape)
    chunk = None if read == "full" else C
    k = np.arange(LMAX)[None, None, :]
    bias = np.where((k >= hidden[..., :1]) & (k < hidden[..., 1:]),
                    np.float32(-1e30), np.float32(0))[:, None]
    jt = None if table is None else jnp.asarray(table)

    def j(c):
        return tuple(jnp.asarray(x) for x in c) if q8 else jnp.asarray(c)

    def tt(c):
        return tuple(torch.from_numpy(x.copy()) for x in c) if q8 \
            else torch.from_numpy(c.copy())
    jo = _jdecode(jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn), j(kc),
                  j(vc), jnp.asarray(lengths), attn_bias=jnp.asarray(bias),
                  chunk_size=chunk, block_table=jt)[0]
    to = tda.decode_attention(
        torch.from_numpy(q), torch.from_numpy(kn), torch.from_numpy(vn),
        tt(kc), tt(vc), torch.from_numpy(lengths), chunk_size=chunk,
        block_table=None if table is None else torch.from_numpy(table),
        impl="reference", hidden=torch.from_numpy(hidden))[0]
    live = slice(0, B - 1)
    np.testing.assert_allclose(to.numpy()[live], np.asarray(jo)[live], **TOL)
    # the range changes what a row sees (else the check proves nothing)
    plain = tda.decode_attention(
        torch.from_numpy(q), torch.from_numpy(kn), torch.from_numpy(vn),
        tt(kc), tt(vc), torch.from_numpy(lengths), chunk_size=chunk,
        block_table=None if table is None else torch.from_numpy(table),
        impl="reference")[0]
    assert not np.allclose(plain.numpy()[live], to.numpy()[live])


def test_empty_range_is_the_linear_read():
    """A range that hides nothing gives bitwise the read without one."""
    rng = np.random.default_rng(3)
    lengths = torch.tensor([5, 20, 33, 40], dtype=torch.int32)
    q = torch.from_numpy(rng.standard_normal(
        (B, 4, HKV * G, D)).astype(np.float32))
    kn = torch.from_numpy(rng.standard_normal(
        (B, 4, HKV, D)).astype(np.float32))
    kc = torch.from_numpy(rng.standard_normal(
        (B, LMAX, HKV, D)).astype(np.float32))
    empty = torch.full((B, 4, 2), 7, dtype=torch.int32)
    outs = [tda.decode_attention(q, kn, kn, kc.clone(), kc.clone(), lengths,
                                 chunk_size=C, impl="reference",
                                 hidden=h)[0] for h in (None, empty)]
    assert torch.equal(outs[0], outs[1])


# ------------------------------------------------- one tree round vs JAX
TL, TC, TP, K = 64, 16, 16, 4


def _prefill_both(jp, tp, cfg, jc, tc, prompt, slot):
    padded = np.zeros((-(-prompt.size // TP) * TP,), np.int32)
    padded[:prompt.size] = prompt
    jplen = jnp.asarray(np.array([prompt.size], np.int32))
    for off in range(0, prompt.size, TP):
        chunk = padded[off:off + TP][None, :]
        jf, _, jc, _, _ = jld.serving_prefill_chunk(
            jp, cfg, jnp.asarray(chunk), jnp.int32(off), jplen, jc,
            jnp.int32(slot), with_hist=False, chunk_size=TC)
        tf, _, tc = tld.serving_prefill_chunk(
            tp, cfg, torch.from_numpy(chunk), off, prompt.size, tc, slot,
            chunk_size=TC)
        assert int(tf[0]) == int(np.asarray(jf)[0])
    return int(tf[0]), jc, tc


def _leaves(c):
    return list(c) if isinstance(c, tuple) else [c]


def _close_caches(tcs, jcs, lens, q8):
    """Port caches against the reference's over each slot's valid rows:
    f32 within the tolerance; int8 dequantized within one step of the
    reference's scale (a code may round the other way across
    frameworks)."""
    for tl_, jl_ in zip(tcs, jcs):
        for tc, jc in zip(tl_, jl_):
            for b, n in enumerate(lens):
                if q8:
                    tq, ts = (x[b, :n].float().numpy() for x in tc)
                    jq, js = (np.asarray(x[b, :n], np.float32) for x in jc)
                    got, want = tq * ts[..., None], jq * js[..., None]
                    assert (np.abs(got - want)
                            <= 1.01 * js[..., None] + 1e-6).all()
                else:
                    np.testing.assert_allclose(
                        tc[b, :n].numpy(), np.asarray(jc[b, :n]), **TOL)


@pytest.mark.parametrize("q8", [False, True], ids=["f32", "int8"])
def test_tree_round_takes_the_branch_like_jax(models, q8):
    """Slot 1 takes the branch (the draft picks the target's second
    choice first, its ``alt1`` is the target's pick); slot 0 runs the
    linear chain.  Two rounds, each held to the reference's round."""
    jm, tm = models["jax"][0], models["port"][0]
    jp, cfg = jld._decode_params_of(jm, TL)
    tp, tcfg = tld._decode_params_of(tm, TL)
    assert tcfg == cfg and "lm_head" in tp
    _, nkv, hd, _ = cfg
    dt = "int8" if q8 else "float32"
    n_layers = len(tp["layers"])

    def caches():
        return ([jda.init_kv_cache(2, TL, nkv, hd, dt)
                 for _ in range(n_layers)],
                [tda.init_kv_cache(2, TL, nkv, hd, dt, "cpu")
                 for _ in range(n_layers)])
    (jc, tc), (jdc, tdc) = caches(), caches()
    rng = np.random.default_rng(21)
    prompts = [rng.integers(1, 250, size=n) for n in (11, 19)]
    cur = np.zeros((2,), np.int32)
    for slot, p in enumerate(prompts):
        cur[slot], jc, tc = _prefill_both(jp, tp, cfg, jc, tc, p, slot)
        _, jdc, tdc = _prefill_both(jp, tp, cfg, jdc, tdc, p, slot)
    lengths = np.array([p.size for p in prompts], np.int32)

    # the target's top-2 after slot 1's first token, on copies of the
    # caches: the draft swaps those two columns of its LM head
    probe = [tuple(tuple(x.clone() for x in c) if isinstance(c, tuple)
                   else c.clone() for c in kv) for kv in tc]
    lg, _, _ = tld._forward_step(tp, cfg, torch.from_numpy(cur)[:, None],
                                 probe, torch.from_numpy(lengths),
                                 chunk_size=TC)
    top = torch.argsort(lg[1], descending=True)[:3]
    a, b = int(top[0]), int(top[1])
    assert float(lg[1, a] - lg[1, b]) > 1e-4 and float(
        lg[1, b] - lg[1, top[2]]) > 1e-4
    head = tp["lm_head"].numpy().copy()
    head[:, [a, b]] = head[:, [b, a]]
    tdp = dict(tp, lm_head=torch.from_numpy(head))
    jdp = dict(jp, lm_head=jnp.asarray(head))

    active = np.array([True, True])
    jkey = JKey(draft_source="draft_model", spec_depth=K, spec_tree="top2")
    tkey = ProgramKey(draft_source="draft_model", spec_depth=K,
                      spec_tree="top2")
    jcur, jlen = jnp.asarray(cur), jnp.asarray(lengths)
    tcur, tlen = torch.from_numpy(cur), torch.from_numpy(lengths)
    taken = torch.zeros((1,), dtype=torch.int64)
    for rnd in range(2):
        jout = jld.serving_spec_draft_step(
            jp, jdp, cfg, cfg, jcur, jc, jdc, jlen, jnp.asarray(active),
            spec_k=K, chunk_size=TC, program_key=jkey)
        before = int(tlen[1])
        tout = tld.serving_spec_draft_step(
            tp, tdp, cfg, cfg, tcur, tc, tdc, tlen,
            torch.from_numpy(active), spec_k=K, chunk_size=TC,
            program_key=tkey, branch_count=taken)
        for w, g in zip(jout[:5], tout):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        if rnd == 0:
            # slot 1: the chain rejects at once, the branch is taken
            assert int(tout[1][1]) == 1 and int(tout[0][1, 0]) == a
            assert int(taken[0]) == 1
            # the branch row's K/V moved to row L+1, every layer
            for kv in tc:
                for c in kv:
                    for x in _leaves(c):
                        assert torch.equal(x[1, before + 1],
                                           x[1, before + K + 1])
        jc, jdc = jout[5], jout[6]
        jcur, jlen = jout[2], jout[3]
        tcur, tlen = tout[2], tout[3]
        _close_caches(tc, jc, [int(x) for x in tlen], q8)


def test_tree_refuses_paged_caches(models):
    tm, td = models["port"]
    tp, cfg = tld._decode_params_of(tm, TL)
    with pytest.raises(ValueError, match="dense"):
        tld.serving_spec_draft_step(
            tp, tp, cfg, cfg, torch.zeros(2, dtype=torch.int32), [], None,
            torch.zeros(2, dtype=torch.int32),
            torch.ones(2, dtype=torch.bool), spec_k=2,
            block_tables=torch.zeros((2, 4), dtype=torch.int32),
            program_key=ProgramKey(draft_source="draft_model",
                                   spec_depth=2, spec_tree="top2"))


@pytest.mark.parametrize("ties", [[5, 9], [9, 5], [2, 5, 9]], ids=str)
def test_second_choice_breaks_ties_like_top_k(ties):
    """The second choice is ``jax.lax.top_k``'s second index: among tied
    maxima the lower index is first, the next one second."""
    rng = np.random.default_rng(len(ties))
    logits = rng.standard_normal((3, 16)).astype(np.float32)
    logits[:, ties] = 10.0
    logits[1, 12] = 11.0                      # row 1: one max, then ties
    first = torch.argmax(torch.from_numpy(logits), dim=-1).to(torch.int32)
    got = tld._second_choice(torch.from_numpy(logits), first)
    want = np.asarray(jax.lax.top_k(jnp.asarray(logits), 2)[1][:, 1])
    np.testing.assert_array_equal(got.numpy(), want)


# ------------------------------------------------------------- the engine
GEOM = dict(batch_size=2, max_len=96, decode_chunk=16, prefill_chunk=8,
            instrument=False)
_rng = np.random.default_rng(5)
PROMPTS = [_rng.integers(1, 200, size=int(s)).astype(np.int32)
           for s in (7, 12, 9)]
NEW = [20, 14, 18]

_MEMO = {}


def _run(pkg, models, key, **kw):
    if (pkg,) + key not in _MEMO:
        E, R = (JEngine, JRequest) if pkg == "jax" else \
            (ServingEngine, Request)
        eng = E(models[pkg][0], **GEOM, **kw)
        for p, n in zip(PROMPTS, NEW):
            eng.submit(R(p, n))
        done = eng.run()
        assert not eng.has_work
        _MEMO[(pkg,) + key] = ({r.rid: list(r.output_ids) for r in done},
                               eng)
    return _MEMO[(pkg,) + key]


def _spec_run(pkg, models, tree, adaptive_window=None, **extra):
    spec = (JSpec if pkg == "jax" else SpecConfig)(
        source="draft_model", draft_model=models[pkg][1], spec_k=4,
        tree="top2" if tree else None, adaptive_window=adaptive_window)
    kw = dict(mode="spec", spec=spec, **extra)
    if pkg == "jax":
        kw.update(recorder=False, pipeline=False)
    key = ("tree" if tree else "linear", adaptive_window) \
        + tuple(sorted(extra.items()))
    return _run(pkg, models, key, **kw)


def test_tree_equals_linear_and_greedy(models):
    tree, eng = _spec_run("port", models, True)
    assert eng._pk.spec_tree == "top2"
    assert tree == _spec_run("port", models, False)[0]
    assert tree == _run("port", models, ("greedy",))[0]
    assert all(len(tree[i]) == n for i, n in enumerate(NEW))


def test_tree_matches_jax_engine(models):
    assert _spec_run("port", models, True)[0] \
        == _spec_run("jax", models, True)[0]


def test_tree_pipeline_on_equals_off(models):
    assert _spec_run("port", models, True, pipeline=False)[0] \
        == _spec_run("port", models, True)[0]


def test_tree_headroom_counts_the_branch_row(models):
    """The verify writes k+2 rows (the branch at L+k+1); a pipelined
    engine reserves two rounds of them."""
    _, eng = _spec_run("port", models, True)
    assert eng._headroom() == 2 * (4 + 2)
    _, sync = _spec_run("port", models, True, pipeline=False)
    assert sync._headroom() == 4 + 2
    _, lin = _spec_run("port", models, False)
    assert lin._headroom() == 2 * (4 + 1)
    assert eng.tree_branches_taken() >= 0 and lin.tree_branches_taken() == 0


@pytest.mark.slow  # the reference marks its counterpart slow as well
def test_tree_pipelined_adaptive_equals_greedy(models):
    out, eng = _spec_run("port", models, True, adaptive_window=3)
    assert len(eng._spec_pks) > 1
    assert all(pk.spec_tree == "top2" for pk in eng._spec_pks.values())
    assert out == _run("port", models, ("greedy",))[0]
