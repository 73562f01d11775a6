"""The port's speculative ServingEngine against the JAX package's.

The tiny f32 Llama target (2 layers) and a 1-layer draft are built by
the JAX package and their weights carried across by name; five requests
(two with repeated prompts, so prompt lookup drafts real tokens, two
sharing a prefix) run through batch 2, max_len 96, 8-token prefill
chunks.  The JAX engine runs ``pipeline=False`` (its pipelined loop
races on this container, ROADMAP §C) with its reference reads; the port
runs its plain versions.  For prompt-lookup and draft-model drafting,
dense and paged, adaptive depth and int8 KV, the port's streams equal
the JAX engine's token for token; within the port spec == greedy, paged
== dense and pipeline on == off bit for bit (the JAX comparison covers
one configuration of each kind; within the port every configuration of
``CONFIGS`` is held to greedy).  Then the reference's own
host-side contracts: ``SpecConfig`` / ``AcceptWindow`` validation, the
adaptive ladder, the draft tenant's pool accounting (back to 0 after
drain, draft radix reuse while a chain is live), the spec metrics, and
one ``ProgramKey`` per ladder rung, made once (the port's counterpart of
the reference's zero-retrace check).  Each engine configuration runs
once per module (memoised).
"""
import warnings

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models.llama import LlamaConfig as JConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JModel
from paddle_tpu.serving import Request as JRequest
from paddle_tpu.serving import ServingEngine as JEngine
from paddle_tpu.serving.engine import SpecConfig as JSpec
import paddle_tpu_torch.serving.engine as engine_mod
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.observability import MetricsRegistry
from paddle_tpu_torch.ops import paged_attention_cuda as k8
from paddle_tpu_torch.ops import prefill_attention_cuda as k9
from paddle_tpu_torch.serving import (
    AcceptWindow, Request, ServingEngine, SpecConfig,
)

# tiny shapes: torch's intra-op threads would only contend with the
# other test processes sharing this machine
torch.set_num_threads(1)

GEOM = dict(batch_size=2, max_len=96, decode_chunk=16, prefill_chunk=8,
            instrument=False)
PAGED = dict(kv_block=8)

_rng = np.random.default_rng(5)
_HEAD = _rng.integers(1, 200, size=16).tolist()
PROMPTS = [np.tile(_rng.integers(1, 200, size=6), 3)[:17].tolist(),
           _HEAD + _rng.integers(1, 200, size=5).tolist(),
           _rng.integers(1, 200, size=9).tolist(),
           np.tile(_rng.integers(1, 200, size=4), 4).tolist(),
           _HEAD + _rng.integers(1, 200, size=3).tolist()]
NEW = [20, 14, 18, 10, 12]

#: the spec configurations: (drafting, engine knobs); "dm" drafts with
#: the 1-layer model
CONFIGS = {
    "pl-dense": ("pl", dict(spec_k=4)),
    "pl-paged": ("pl", dict(spec_k=4, **PAGED)),
    "dm-dense": ("dm", dict(spec_k=4)),
    "dm-paged": ("dm", dict(spec_k=4, **PAGED)),
    "adaptive-paged": ("pl", dict(spec_k=8, adaptive_window=2, k_min=1,
                                  **PAGED)),
    "pl-kv8-paged": ("pl", dict(spec_k=4, kv_dtype="int8", **PAGED)),
    "dm-kv8-paged": ("dm", dict(spec_k=4, kv_dtype="int8", **PAGED)),
}
_SPEC_KEYS = ("spec_k", "adaptive_window", "k_min")

_MEMO = {}


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
    """{"jax": (target, draft), "port": (target, draft)}."""
    (jm, tm), (jd, td) = _pair(2, 0), _pair(1, 1)
    return {"jax": (jm, jd), "port": (tm, td)}


def _run(pkg, models, key, **kw):
    memo_key = (pkg,) + key
    if memo_key not in _MEMO:
        E, R = (JEngine, JRequest) if pkg == "jax" else \
            (ServingEngine, Request)
        eng = E(models[pkg][0], **kw)
        for p, n in zip(PROMPTS, NEW):
            eng.submit(R(p, n))
        done = eng.run()
        assert not eng.has_work
        _MEMO[memo_key] = ({r.rid: list(r.output_ids) for r in done}, eng)
    return _MEMO[memo_key]


def _spec(pkg, models, name, **extra):
    """The spec engine of configuration ``name`` in package ``pkg``."""
    source, knobs = CONFIGS[name]
    skw = {k: v for k, v in knobs.items() if k in _SPEC_KEYS}
    ekw = {k: v for k, v in knobs.items() if k not in _SPEC_KEYS}
    if source == "dm":
        skw.update(source="draft_model", draft_model=models[pkg][1])
    spec = (JSpec if pkg == "jax" else SpecConfig)(**skw)
    kw = dict(GEOM, mode="spec", spec=spec, **ekw, **extra)
    if pkg == "jax":
        kw.update(recorder=False, pipeline=False)
    return _run(pkg, models, (name,) + tuple(sorted(extra.items())), **kw)


def _greedy(models, **extra):
    return _run("port", models, ("greedy",) + tuple(sorted(extra.items())),
                **GEOM, **extra)


@pytest.mark.parametrize("name", ["pl-dense", "dm-paged", "adaptive-paged",
                                  "pl-kv8-paged"])
def test_streams_match_jax_engine(models, name):
    jout, _ = _spec("jax", models, name)
    tout, teng = _spec("port", models, name)
    assert tout == jout
    assert all(len(tout[i]) == n for i, n in enumerate(NEW))
    assert teng._pk.draft_source == (
        "draft_model" if CONFIGS[name][0] == "dm" else "prompt_lookup")


@pytest.mark.parametrize("name", list(CONFIGS))
def test_spec_equals_greedy(models, name):
    ekw = {k: v for k, v in CONFIGS[name][1].items()
           if k in ("kv_dtype", "kv_block")}
    assert _spec("port", models, name)[0] == _greedy(models, **ekw)[0]


@pytest.mark.parametrize("source", ["pl", "dm"])
def test_paged_equals_dense(models, source):
    assert _spec("port", models, f"{source}-paged")[0] \
        == _spec("port", models, f"{source}-dense")[0]


@pytest.mark.parametrize("name", ["pl-dense", "dm-paged", "adaptive-paged",
                                  "pl-kv8-paged"])
def test_pipeline_on_equals_off(models, name):
    assert _spec("port", models, name, pipeline=False)[0] \
        == _spec("port", models, name)[0]


def test_prompt_lookup_accepts_on_repeated_prompts(models):
    """The metric plumbing counts real acceptance: an instrumented
    prompt-lookup run accepts drafts, and the counters agree with the
    accept-rate gauge of its source."""
    reg = MetricsRegistry()
    eng = ServingEngine(models["port"][0], **{**GEOM, "instrument": True},
                        mode="spec", spec_k=4, registry=reg)
    for p, n in zip(PROMPTS, NEW):
        eng.submit(Request(p, n))
    eng.run()
    lbl = dict(policy="continuous")
    drafted = reg.get("serving_spec_drafted_total").labels(**lbl).value
    accepted = reg.get("serving_spec_accepted_total").labels(**lbl).value
    assert 0 < accepted <= drafted and drafted % 4 == 0
    rate = reg.get("serving_spec_accept_rate")
    assert rate.labels(source="prompt_lookup", **lbl).value \
        == pytest.approx(accepted / drafted)
    info = reg.get("serving_spec_draft_source")
    assert info.labels(source="prompt_lookup", **lbl).value == 1
    assert info.labels(source="draft_model", **lbl).value == 0
    assert reg.get("serving_spec_draft_k").labels(**lbl).value == 4


def test_plain_versions_only_on_the_cpu(models):
    """A CPU spec engine runs the plain versions: the kernels' launch
    counters stay put while the plain-run counters move."""
    before = (k8.launches, k9.launches, k8.plain_runs, k9.plain_runs)
    eng = ServingEngine(models["port"][0], **GEOM, mode="spec", spec_k=2)
    eng.submit(Request(PROMPTS[0], 4))
    eng.run()
    assert (k8.launches, k9.launches) == before[:2]
    assert k8.plain_runs > before[2] and k9.plain_runs > before[3]


# ------------------------------------------------------------- SpecConfig
class TestSpecConfig:
    def test_source_enum(self):
        with pytest.raises(ValueError, match="source"):
            SpecConfig(source="oracle")

    @pytest.mark.parametrize("bad", [0, -1, True, 2.0, "4"])
    def test_spec_k_validated(self, bad):
        with pytest.raises(ValueError, match="spec_k"):
            SpecConfig(spec_k=bad)

    def test_k_min_le_spec_k(self):
        with pytest.raises(ValueError, match="k_min"):
            SpecConfig(spec_k=2, k_min=3)

    @pytest.mark.parametrize("bad", [0, True, "8"])
    def test_adaptive_window_validated(self, bad):
        with pytest.raises(ValueError, match="adaptive_window"):
            SpecConfig(adaptive_window=bad)

    def test_tree_requires_draft_model_source(self):
        with pytest.raises(ValueError, match="tree"):
            SpecConfig(source="prompt_lookup", tree="top2")
        with pytest.raises(ValueError, match="tree"):
            SpecConfig(source="draft_model", tree="top3")

    def test_spec_kwarg_requires_spec_mode(self, models):
        with pytest.raises(ValueError, match="mode"):
            ServingEngine(models["port"][0], mode="greedy",
                          spec=SpecConfig(), **GEOM)

    def test_tree_requires_dense_caches(self, models):
        tm, td = models["port"]
        with pytest.raises(ValueError, match="dense"):
            ServingEngine(tm, mode="spec", **GEOM, **PAGED, spec=SpecConfig(
                source="draft_model", draft_model=td, tree="top2"))

    def test_tree_is_not_ported(self, models):
        tm, td = models["port"]
        with pytest.raises(NotImplementedError, match="top-2 tree"):
            ServingEngine(tm, mode="spec", **GEOM, spec=SpecConfig(
                source="draft_model", draft_model=td, tree="top2"))

    def test_paged_geometry_mismatch_is_loud(self, models):
        tm = models["port"][0]
        bad = LlamaForCausalLM(LlamaConfig.tiny(
            dtype="float32", num_hidden_layers=1, num_key_value_heads=4),
            device="cpu")
        with pytest.raises(ValueError, match="geometry"):
            ServingEngine(tm, mode="spec", **GEOM, **PAGED, spec=SpecConfig(
                source="draft_model", draft_model=bad))
        # the same drafter is fine on dense caches (separate arrays)
        ServingEngine(tm, mode="spec", **GEOM, spec=SpecConfig(
            source="draft_model", draft_model=bad))

    def test_draft_layer_count_capped_by_target(self, models):
        deep = LlamaForCausalLM(LlamaConfig.tiny(
            dtype="float32", num_hidden_layers=3), device="cpu")
        with pytest.raises(ValueError, match="layer count"):
            ServingEngine(models["port"][0], mode="spec", **GEOM, **PAGED,
                          spec=SpecConfig(source="draft_model",
                                          draft_model=deep))

    def test_draft_vocab_must_match(self, models):
        other = LlamaForCausalLM(LlamaConfig.tiny(
            dtype="float32", num_hidden_layers=1, vocab_size=128),
            device="cpu")
        with pytest.raises(ValueError, match="vocab"):
            ServingEngine(models["port"][0], mode="spec", **GEOM,
                          spec=SpecConfig(source="draft_model",
                                          draft_model=other))

    def test_dict_spec_accepted(self, models):
        eng = ServingEngine(
            models["port"][0], mode="spec",
            spec={"source": "prompt_lookup", "spec_k": 3}, **GEOM)
        assert eng._spec.spec_k == 3
        assert eng._pk.spec_depth == 3
        assert eng._pk.draft_source == "prompt_lookup"

    def test_missing_draft_model_falls_back_with_one_warning(
            self, models, monkeypatch):
        monkeypatch.setattr(engine_mod, "_SPEC_FALLBACK_WARNED", False)
        with pytest.warns(RuntimeWarning, match="prompt-lookup"):
            eng = ServingEngine(models["port"][0], mode="spec",
                                spec=SpecConfig(source="draft_model"),
                                **GEOM)
        assert eng._spec.source == "prompt_lookup"
        assert not eng._dspec
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            ServingEngine(models["port"][0], mode="spec",
                          spec=SpecConfig(source="draft_model"), **GEOM)


class TestAcceptWindow:
    def test_validation(self):
        with pytest.raises(ValueError):
            AcceptWindow(0)
        w = AcceptWindow(4)
        with pytest.raises(ValueError):
            w.push(4, 5)
        with pytest.raises(ValueError):
            w.push(4, -1)

    def test_empty_rate_is_none(self):
        assert AcceptWindow(3).rate() is None

    def test_rate_and_sliding(self):
        w = AcceptWindow(2)
        w.push(4, 4)
        assert w.rate() == pytest.approx(1.0)
        w.push(4, 0)
        assert w.rate() == pytest.approx(0.5)
        w.push(4, 0)  # slides the all-accepted round out
        assert w.rate() == pytest.approx(0.0)
        assert len(w) == 2

    def test_reset(self):
        w = AcceptWindow(3)
        w.push(2, 1)
        w.reset()
        assert w.rate() is None and len(w) == 0


class TestAdaptiveDepth:
    def _eng(self, models, **kw):
        return ServingEngine(models["port"][0], mode="spec",
                             spec=SpecConfig(**kw), **GEOM)

    def test_rung_ladder_shape(self, models):
        eng = self._eng(models, spec_k=8, adaptive_window=4, k_min=1)
        assert eng._k_rungs == [1, 2, 4, 8] and eng._k_cur == 8
        assert [eng._spec_pks[k].spec_depth for k in eng._k_rungs] \
            == [1, 2, 4, 8]

    def test_depth_descends_on_rejection(self, models):
        eng = self._eng(models, spec_k=4, adaptive_window=2, k_min=1)
        for _ in range(2):
            eng._adapt_k([(0, 0)], 4)
        assert eng._k_want[0] == len(eng._k_rungs) - 2
        k1 = eng._next_k([0])
        assert k1 == eng._k_rungs[-2]       # one rung per round
        for _ in range(3):
            eng._adapt_k([(0, k1)], k1)
        assert eng._next_k([0]) == eng._k_rungs[-1]

    def test_batch_depth_is_min_over_live(self, models):
        eng = self._eng(models, spec_k=4, adaptive_window=1, k_min=1)
        eng._adapt_k([(0, 4), (1, 0)], 4)   # slot 1 rejects everything
        assert eng._next_k([0, 1]) < 4
        eng._reset_spec_slot(1)
        for _ in range(len(eng._k_rungs)):
            k = eng._next_k([0])
            eng._adapt_k([(0, k)], k)
        assert eng._k_cur == 4

    def test_spec_draft_k_gauge_tracks_depth(self, models):
        reg = MetricsRegistry()
        eng = ServingEngine(
            models["port"][0], mode="spec", registry=reg,
            spec=SpecConfig(spec_k=4, adaptive_window=1, k_min=1),
            **{**GEOM, "instrument": True})
        g = reg.get("serving_spec_draft_k").labels(policy="continuous")
        assert g.value == 4
        eng._adapt_k([(0, 0)], 4)
        eng._next_k([0])
        assert g.value == 2

    def test_one_program_key_per_rung(self, models, monkeypatch):
        """The ladder's program keys are made once, one per rung: over two
        staggered waves (chains grow, rewind, release and re-admit while
        the depth moves) every dispatch carries one of them, and the
        second wave adds no key."""
        seen = []
        inner = engine_mod.serving_spec_draft_step

        def spy(*a, **kw):
            seen.append(kw["program_key"])
            return inner(*a, **kw)
        monkeypatch.setattr(engine_mod, "serving_spec_draft_step", spy)
        tm, td = models["port"]
        eng = ServingEngine(tm, mode="spec", pipeline=True, **GEOM, **PAGED,
                            spec=SpecConfig(source="draft_model",
                                            draft_model=td, spec_k=4,
                                            adaptive_window=2, k_min=1))

        def wave():
            it = iter(zip(PROMPTS, NEW))
            for p, n in [next(it), next(it)]:
                eng.submit(Request(p, n))
            for p, n in it:
                eng.step()
                eng.submit(Request(p, n))
            eng.run()
        wave()
        first = {id(k) for k in seen}
        n_first = len(seen)
        wave()
        assert len(seen) > n_first
        assert {id(k) for k in seen} == first
        assert first <= {id(k) for k in eng._spec_pks.values()}
        assert len({k.spec_depth for k in seen}) > 1      # the depth moved
        assert eng.kv_manager.draft_blocks_used() == 0


class TestDraftTenancy:
    def test_accounting_returns_to_zero_after_drain(self, models):
        tm, td = models["port"]
        reg = MetricsRegistry()
        eng = ServingEngine(tm, mode="spec", registry=reg,
                            spec=SpecConfig(source="draft_model",
                                            draft_model=td, spec_k=4),
                            **{**GEOM, **PAGED, "instrument": True})
        for p, n in zip(PROMPTS, NEW):
            eng.submit(Request(p, n))
        eng.run()
        kv = eng.kv_manager
        assert kv.live_tokens() == 0 and kv.outstanding() == 0
        # target prefixes may park evictable; draft chains free outright
        assert kv.blocks_used() == kv.evictable_count()
        assert kv.draft_blocks_used() == 0
        assert (kv.draft_tables == kv.num_blocks).all()
        assert int(kv.refcnt.sum()) == 0
        used = reg.get("serving_kv_blocks_used")
        assert used.labels(policy="continuous", model="draft").value == 0
        assert used.labels(policy="continuous", model="target").value \
            == kv.blocks_used()
        # the default pool doubles for the second tenant
        assert kv.num_blocks == 2 * GEOM["batch_size"] * GEOM["max_len"] \
            // PAGED["kv_block"]

    def test_draft_radix_reuse_while_chain_live(self, models):
        tm, td = models["port"]
        p = np.random.default_rng(3).integers(1, 200, size=24)
        eng = ServingEngine(tm, mode="spec", **GEOM, **PAGED,
                            spec=SpecConfig(source="draft_model",
                                            draft_model=td, spec_k=4))
        eng.submit(Request(p, 16))
        for _ in range(64):
            eng.step()
            if eng.kv_manager.match_draft_prefix(p)[0] > 0:
                break
        off, blocks = eng.kv_manager.match_draft_prefix(p)
        assert off > 0 and len(blocks) > 0
        # the draft namespace is salted: a draft chunk never matches as a
        # target chunk, and vice versa
        assert not set(blocks) & set(eng.kv_manager.match_prefix(p)[1])
        r2 = eng.submit(Request(p, 8))  # adopts the live draft chain
        eng.run()
        assert r2.status == "done" and len(r2.output_ids) == 8
        assert eng.kv_manager.match_draft_prefix(p)[0] == 0
        assert eng.kv_manager.draft_blocks_used() == 0
        assert eng.kv_manager.outstanding() == 0

    def test_accept_rate_real_and_high_with_self_draft(self, models):
        tm = models["port"][0]
        reg = MetricsRegistry()
        eng = ServingEngine(tm, mode="spec", registry=reg,
                            spec=SpecConfig(source="draft_model",
                                            draft_model=tm, spec_k=4),
                            **{**GEOM, **PAGED, "instrument": True})
        for p, n in zip(PROMPTS[:2], NEW[:2]):
            eng.submit(Request(p, n))
        eng.run()
        rate = reg.get("serving_spec_accept_rate").labels(
            policy="continuous", source="draft_model").value
        assert rate > 0.9
        info = reg.get("serving_spec_draft_source")
        assert info.labels(policy="continuous",
                           source="draft_model").value == 1
        assert info.labels(policy="continuous",
                           source="prompt_lookup").value == 0
