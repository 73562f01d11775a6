"""The port's speculative-decoding functions against the JAX package.

The tiny f32 Llama target (2 layers) and a 1-layer draft are built by
the JAX package and their weights carried across by name.  The same
inputs, made with numpy seeds, go through both packages:

* ``_ngram_draft`` and ``_verify_and_emit`` exactly (integer outputs);
* ``serving_spec_step`` (prompt lookup) and ``serving_spec_draft_step``
  (draft model, linear chain), dense and paged, after a chunked prefill
  of one slot with the other parked at ``lmax``: three rounds, each
  round's emitted block, ``j``, ``cur'``, ``new_len``, the finite flag
  and the history exactly; the JAX side runs its reference read, the
  port its plain version;
* ``decode_speculative`` with n-gram drafting, a bad draft model and the
  target drafting for itself: equal to the JAX package's output and to
  the port's own ``decode_greedy``.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.models import llama_decode as jld
from paddle_tpu.models.llama import LlamaConfig as JConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JModel
from paddle_tpu.ops.decode_attention import init_kv_cache as j_cache
from paddle_tpu.ops.decode_attention import init_kv_pool as j_pool
from paddle_tpu_torch.models import llama_decode as tld
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.ops.decode_attention import init_kv_cache, init_kv_pool
from paddle_tpu_torch.serving.program_key import ProgramKey

# tiny shapes: torch's intra-op threads would only contend with the
# other test processes sharing this machine
torch.set_num_threads(1)

LMAX, P, C, K = 64, 16, 16, 4
N_BLOCKS = 12


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
    """(JAX target, port target, JAX draft, port draft)."""
    return _pair(2, 0) + _pair(1, 1)


def _np(x):
    return np.asarray(x) if not isinstance(x, torch.Tensor) else x.numpy()


# ------------------------------------------------------------ host helpers
@pytest.mark.parametrize("spec_k", [1, 3, 8])
def test_ngram_draft_matches_jax(spec_k):
    rng = np.random.default_rng(spec_k)
    b = 6
    hist = rng.integers(0, 5, (b, 24)).astype(np.int32)  # many repeats
    hist_len = np.array([0, 1, 2, 9, 24, 17], np.int32)
    cur = rng.integers(0, 6, b).astype(np.int32)          # 5 never occurs
    want = jld._ngram_draft(jnp.asarray(hist), jnp.asarray(hist_len),
                            jnp.asarray(cur), spec_k)
    got = tld._ngram_draft(torch.from_numpy(hist),
                           torch.from_numpy(hist_len),
                           torch.from_numpy(cur), spec_k)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("spec_k", [1, 3, 8])
def test_verify_and_emit_matches_jax(spec_k):
    rng = np.random.default_rng(10 + spec_k)
    b, v, max_new = 6, 11, 12
    logits = rng.standard_normal((b, spec_k + 1, v)).astype(np.float32)
    picks = logits.argmax(-1)
    drafts = picks[:, :spec_k].copy()
    # row r mismatches first at position r (row 0 at once; the later rows
    # accept everything when r >= spec_k)
    for r in range(b):
        if r < spec_k:
            drafts[r, r] = (drafts[r, r] + 1) % v
    drafts = drafts.astype(np.int32)
    n_out = np.array([0, 1, 5, max_new - 2, max_new - 1, 3], np.int32)
    out = rng.integers(0, v, (b, max_new)).astype(np.int32)
    want = jld._verify_and_emit(jnp.asarray(logits), jnp.asarray(drafts),
                                jnp.asarray(n_out), jnp.asarray(out),
                                max_new, spec_k)
    got = tld._verify_and_emit(torch.from_numpy(logits),
                               torch.from_numpy(drafts),
                               torch.from_numpy(n_out),
                               torch.from_numpy(out.copy()), max_new,
                               spec_k)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# --------------------------------------------------------- serving rounds
def _geometry(paged, n_layers, nkv, hd, slot, tables):
    """Both packages' caches (and table operands) for one model."""
    if paged:
        jc = [j_pool(N_BLOCKS, C, nkv, hd, "float32")
              for _ in range(n_layers)]
        tc = [init_kv_pool(N_BLOCKS, C, nkv, hd, "float32", "cpu")
              for _ in range(n_layers)]
        return jc, tc, jnp.asarray(tables), torch.from_numpy(tables)
    jc = [j_cache(2, LMAX, nkv, hd, "float32") for _ in range(n_layers)]
    tc = [init_kv_cache(2, LMAX, nkv, hd, "float32", "cpu")
          for _ in range(n_layers)]
    return jc, tc, None, None


def _table(slot, blocks):
    t = np.full((2, LMAX // C), N_BLOCKS, np.int32)
    t[slot] = blocks
    return t


def _prefill(jp, tp, cfg, jc, tc, jt, tt, prompt, slot, hist=None):
    """Chunked prefill of ``prompt`` into ``slot`` in both packages;
    returns the first token (asserted equal) and, with ``hist``, both
    history pairs."""
    padded = np.zeros((-(-prompt.size // P) * P,), np.int32)
    padded[:prompt.size] = prompt
    jplen = jnp.asarray(np.array([prompt.size], np.int32))
    jh = jhl = th = thl = None
    if hist:
        jh, jhl = jnp.zeros((2, LMAX), jnp.int32), jnp.zeros((2,), jnp.int32)
        th = torch.zeros((2, LMAX), dtype=torch.int32)
        thl = torch.zeros((2,), dtype=torch.int32)
    for off in range(0, prompt.size, P):
        chunk = padded[off:off + P][None, :]
        jf, _, jc, jh, jhl = jld.serving_prefill_chunk(
            jp, cfg, jnp.asarray(chunk), jnp.int32(off), jplen, jc,
            jnp.int32(slot), hist=jh, hist_len=jhl, with_hist=bool(hist),
            chunk_size=C, block_tables=jt)
        tf, _, tc = tld.serving_prefill_chunk(
            tp, cfg, torch.from_numpy(chunk), off, prompt.size, tc, slot,
            chunk_size=C, block_tables=tt, hist=th, hist_len=thl)
        assert int(tf[0]) == int(np.asarray(jf)[0])
    if hist:
        np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
        np.testing.assert_array_equal(thl.numpy(), np.asarray(jhl))
    return int(tf[0]), jc, tc, (jh, jhl, th, thl)


def _params(models, lmax=LMAX):
    jm, tm, jd, td = models
    jp, cfg = jld._decode_params_of(jm, lmax)
    tp, tcfg = tld._decode_params_of(tm, lmax)
    jdp, dcfg = jld._decode_params_of(jd, lmax)
    tdp, _ = tld._decode_params_of(td, lmax)
    assert tcfg == cfg
    return jp, tp, cfg, jdp, tdp, dcfg


def _check_round(jout, tout):
    for w, g in zip(jout[:5], tout):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_serving_spec_step_matches_jax(models, paged):
    jp, tp, cfg, _, _, _ = _params(models)
    nh, nkv, hd, _ = cfg
    slot = 1
    seg = np.random.default_rng(3).integers(1, 250, size=9)
    prompt = np.tile(seg, 4)[:33]          # repeats: lookups hit
    tables = _table(slot, [5, 2, 7, 0])
    jc, tc, jt, tt = _geometry(paged, len(jp["layers"]), nkv, hd, slot,
                               tables)
    first, jc, tc, (jh, jhl, th, thl) = _prefill(
        jp, tp, cfg, jc, tc, jt, tt, prompt, slot, hist=True)
    cur = np.array([0, first], np.int32)
    lengths = np.array([LMAX, prompt.size], np.int32)   # slot 0 parked
    active = np.array([False, True])
    jcur, jlen = jnp.asarray(cur), jnp.asarray(lengths)
    tcur, tlen = torch.from_numpy(cur), torch.from_numpy(lengths)
    accepted = 0
    for _ in range(3):
        jout = jld.serving_spec_step(
            jp, cfg, jcur, jc, jlen, jh, jhl, jnp.asarray(active),
            spec_k=K, chunk_size=C, block_tables=jt)
        tout = tld.serving_spec_step(
            tp, cfg, tcur, tc, tlen, th, thl, torch.from_numpy(active),
            spec_k=K, chunk_size=C, block_tables=tt,
            program_key=ProgramKey(draft_source="prompt_lookup",
                                   spec_depth=K))
        _check_round(jout, tout)
        jc, jh, jhl = jout[5], jout[6], jout[7]
        np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
        np.testing.assert_array_equal(thl.numpy(), np.asarray(jhl))
        jcur, jlen = jout[2], jout[3]
        tcur, tlen = tout[2], tout[3]
        accepted += int(tout[1][slot])
        assert int(tlen[0]) == LMAX                       # parked stays
    assert accepted > 0          # the repeated prompt drafts real tokens


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_serving_spec_draft_step_matches_jax(models, paged):
    jp, tp, cfg, jdp, tdp, dcfg = _params(models)
    nh, nkv, hd, _ = cfg
    slot = 1
    prompt = np.random.default_rng(4).integers(1, 250, size=29)
    tables = _table(slot, [5, 2, 7, 0])
    dtables = _table(slot, [1, 9, 3, 11])
    jc, tc, jt, tt = _geometry(paged, len(jp["layers"]), nkv, hd, slot,
                               tables)
    first, jc, tc, _ = _prefill(jp, tp, cfg, jc, tc, jt, tt, prompt, slot)
    if paged:
        # the draft's layer 0 rides the target's layer-0 pool through its
        # own table
        jdt, tdt = jnp.asarray(dtables), torch.from_numpy(dtables)
        _, jdc_l, tdc_l, _ = _prefill(jdp, tdp, dcfg, jc[:1], tc, jdt, tdt,
                                      prompt, slot)
        jc = list(jdc_l) + list(jc[1:])
        jdc = tdc = None
    else:
        jdt = tdt = None
        jdc, tdc, _, _ = _geometry(False, len(jdp["layers"]), nkv, hd, slot,
                                   None)
        _, jdc, tdc, _ = _prefill(jdp, tdp, dcfg, jdc, tdc, None, None,
                                  prompt, slot)
    cur = np.array([0, first], np.int32)
    lengths = np.array([LMAX, prompt.size], np.int32)
    active = np.array([False, True])
    jcur, jlen = jnp.asarray(cur), jnp.asarray(lengths)
    tcur, tlen = torch.from_numpy(cur), torch.from_numpy(lengths)
    for _ in range(3):
        jout = jld.serving_spec_draft_step(
            jp, jdp, cfg, dcfg, jcur, jc, jdc, jlen, jnp.asarray(active),
            spec_k=K, chunk_size=C, block_tables=jt, draft_tables=jdt)
        tout = tld.serving_spec_draft_step(
            tp, tdp, cfg, dcfg, tcur, tc, tdc, tlen,
            torch.from_numpy(active), spec_k=K, chunk_size=C,
            block_tables=tt, draft_tables=tdt)
        _check_round(jout, tout)
        jc, jdc = jout[5], jout[6]
        jcur, jlen = jout[2], jout[3]
        tcur, tlen = tout[2], tout[3]


def test_serving_spec_draft_step_refuses_the_tree(models):
    """The top-2 tree runs on dense caches only (its branch-row repair
    copies dense rows): a paged draft layout is refused, as in the
    reference."""
    jp, tp, cfg, jdp, tdp, dcfg = _params(models)
    with pytest.raises(ValueError, match="dense caches"):
        tld.serving_spec_draft_step(
            tp, tdp, cfg, dcfg, torch.zeros(2, dtype=torch.int32), [],
            None, torch.zeros(2, dtype=torch.int32),
            torch.ones(2, dtype=torch.bool), spec_k=2,
            program_key=ProgramKey(draft_source="draft_model",
                                   spec_depth=2, spec_tree="top2"))


# ------------------------------------------------------ decode_speculative
@pytest.fixture(scope="module")
def bad_draft():
    """A narrower random draft (near-zero acceptance: every round takes
    the rejection path), in both packages."""
    paddle.seed(7)
    kw = dict(vocab_size=256, hidden_size=32, intermediate_size=64,
              num_hidden_layers=1, num_attention_heads=2,
              num_key_value_heads=1, dtype="float32")
    jd = JModel(JConfig(**kw))
    jd.eval()
    td = LlamaForCausalLM(LlamaConfig(**kw), device="cpu")
    state, _ = jd.functional_state()
    td.load_numpy_state({k: np.asarray(v) for k, v in state.items()})
    return jd, td


@pytest.mark.parametrize("drafter", ["ngram", "bad_draft", "self"])
def test_decode_speculative_matches_jax_and_greedy(models, bad_draft,
                                                   drafter):
    jm, tm = models[0], models[1]
    jd, td = {"ngram": (None, None), "bad_draft": bad_draft,
              "self": (jm, tm)}[drafter]
    rng = np.random.default_rng(0)
    ids = np.concatenate([np.tile(rng.integers(1, 250, (2, 5)), (1, 2)),
                          rng.integers(1, 250, (2, 3))], 1).astype(np.int32)
    new, k = 24, 3
    want = np.asarray(jld.decode_speculative(jm, jd, jnp.asarray(ids),
                                             max_new_tokens=new, spec_k=k))
    got = tld.decode_speculative(tm, td, ids, max_new_tokens=new, spec_k=k)
    greedy = tld.decode_greedy(tm, ids, max_new_tokens=new)
    assert got.dtype == torch.int32 and got.shape == (2, new)
    assert got.numpy().tolist() == want.tolist()
    assert got.numpy().tolist() == greedy.numpy().tolist()


def test_decode_speculative_guards(models, bad_draft):
    tm = models[1]
    ids = np.ones((1, 4), np.int32)
    with pytest.raises(TypeError, match="draft_model must be"):
        tld.decode_speculative(tm, ids)
    with pytest.raises(ValueError, match="input_ids is required"):
        tld.decode_speculative(tm, None)
    small = LlamaForCausalLM(LlamaConfig.tiny(dtype="float32",
                                              vocab_size=128), device="cpu")
    with pytest.raises(ValueError, match="shared vocabulary"):
        tld.decode_speculative(tm, small, ids)
    with pytest.raises(ValueError, match="headroom"):
        tld.decode_speculative(tm, None, ids, max_new_tokens=8,
                               max_len=12, spec_k=4)
