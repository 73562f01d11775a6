"""The host KV tier in the port against the JAX package, on the CPU.

``BlockStore`` makes the same decisions as the reference's on the same
puts and fetches — what it stores, rejects and evicts (LRU, whole
subtrees), its byte accounting, and the CRC / shape checks that reject a
garbled or truncated entry.  A paged manager demotes an evicted chain
into the store (a gather on the device at eviction, one copy to the host
a pump) and restores it into fresh pool blocks bit for bit, float, bf16
and int8 alike.  Under churn on a pool too small to keep the families
(the reference's ``tests/test_serving_tiered.py`` workload: shared
48-token heads revisited, a 16-block pool), the tiered engine's streams
equal the untiered run and the JAX tiered engine's (``pipeline=False``,
ROADMAP queue C), with host hits and restores above zero; int8 KV, prompt
lookup and the pipelined loop keep tiered == untiered; a
``FaultPlan(host_tier_corrupt=)`` garble and truncate fall back to
prefill with the same streams.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models.llama import LlamaConfig as JConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JModel
from paddle_tpu.serving import BlockStore as JBlockStore
from paddle_tpu.serving import FaultPlan as JFaultPlan
from paddle_tpu.serving import Request as JRequest
from paddle_tpu.serving import ServingEngine as JEngine
from paddle_tpu.serving.kv_cache import chunk_keys as j_chunk_keys
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.observability import MetricsRegistry
from paddle_tpu_torch.serving import FaultPlan, Request, ServingEngine
from paddle_tpu_torch.serving.kv_cache import (
    BlockStore, PagedKVCacheManager, chunk_keys,
)

torch.set_num_threads(1)


def _leaves(n, seed, n_layers=1, scales=False):
    rng = np.random.default_rng(seed)

    def leaf():
        d = rng.random(n).astype(np.float32)
        return (d, rng.random(n // 4).astype(np.float16)) if scales else d
    return [(leaf(), leaf()) for _ in range(n_layers)]


def _store_script(mod):
    """One sequence of puts, probes and fetches (with damage) against a
    store of 5 entries' budget; returns everything observable."""
    st = mod(max_bytes=5 * 128, block=4)
    a = (None, (1, 2, 3, 4))
    a2 = (a, (5, 6, 7, 8))
    a3 = (a2, (9, 9, 9, 9))
    b = (None, (4, 4, 4, 4))
    c = (None, (7, 7, 7, 7))
    d = (None, (8, 8, 8, 8))
    spec = [((16,), "float32"), ((16,), "float32")]
    log = []
    for i, key in enumerate((a, a2, a3, b, c)):
        log.append(st.put(key, _leaves(16, i)))
    log.append((st.n_blocks, st.total_bytes, st.has(a3), a in st))
    log.append(st.fetch(b, [spec]) is not None)       # b is hot now
    log.append(st.put(d, _leaves(16, 9)))             # evicts a's subtree
    log.append([st.has(k) for k in (a, a2, a3, b, c, d)])
    log.append(st.put((None, (0,) * 4), _leaves(256, 3)))   # oversize
    log.append(st.corrupt(c, mode="garble"))
    log.append(st.fetch(c, [spec]))                   # CRC mismatch
    log.append(st.corrupt(None, mode="truncate"))
    log.append(st.fetch(b, [spec]))                   # shape mismatch
    log.append(st.fetch(d, None) is None)             # CRC of cut bytes
    log.append((st.n_blocks, st.total_bytes, dict(st.stats),
                st.snapshot(), mod.key_digest(a2)))
    return log


def test_block_store_matches_jax():
    got, ref = _store_script(BlockStore), _store_script(JBlockStore)
    assert got == ref
    assert got[-1][2]["errors"] == 3 and got[-1][2]["rejected"] == 1
    tokens = list(range(1, 14))
    assert chunk_keys(tokens, 4) == j_chunk_keys(tokens, 4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_demote_then_restore_bit_for_bit(dtype):
    """A registered chain parked evictable, reclaimed by allocations:
    demoted (gathered at eviction, copied to the host by the pump), then
    restored into other blocks with the same bytes and re-matched."""
    events = []
    mgr = PagedKVCacheManager(
        2, 2, 32, 2, 8, dtype, block=8, max_live_tokens=48, device="cpu",
        on_event=lambda kind, **kw: events.append(kind),
        host_store=BlockStore(1 << 20, block=8))
    gen = torch.Generator().manual_seed(0)
    for k, v in mgr.caches:
        for leaf in (k, v):
            for x in (leaf if isinstance(leaf, tuple) else (leaf,)):
                if x.dtype == torch.int8:
                    x.copy_(torch.randint(-127, 128, x.shape, generator=gen))
                else:
                    x.copy_(torch.rand(x.shape, generator=gen))
    tokens = list(range(100, 124))
    mgr.assign(0, "a")
    mgr.ensure_rows(0, 24)
    chain = [int(b) for b in mgr.block_tables[0, :3]]

    def rows(blocks):
        idx = torch.tensor(blocks)
        return [[x[idx].clone() for leaf in kv
                 for x in (leaf if isinstance(leaf, tuple) else (leaf,))]
                for kv in mgr.caches]
    before = rows(chain)
    mgr.register_prefix(0, tokens)
    mgr.release(0)
    assert mgr.evictable_count() == 3
    mgr.assign(1, "b")
    mgr.ensure_rows(1, 32)                 # 4 of 6 blocks: evicts the chain
    mgr.assign(0, "c")
    mgr.ensure_rows(0, 16)
    assert mgr.match_prefix(tokens + [1])[0] == 0
    assert mgr.pump_host_tier() == 3 and mgr.host_tier.n_blocks == 3
    mgr.release(0)
    mgr.release(1)
    assert mgr.host_match(tokens + [1], 0) == 24
    assert mgr.restore_from_host(tokens + [1], rid=7) == 3
    matched, blocks = mgr.match_prefix(tokens + [1])
    assert matched == 24
    after = rows(blocks)
    for lb, la in zip(before, after):
        for x, y in zip(lb, la):
            assert torch.equal(x, y)
    assert {"demote", "restore", "block_free"} <= set(events)


CHURN = dict(batch_size=2, max_len=128, decode_chunk=16, prefill_chunk=16,
             kv_block=16, max_live_tokens=2 * 128, instrument=False)


def _churn_prompts(seed, n_heads=6, head=48, tail=8, waves=2):
    rng = np.random.default_rng(seed)
    heads = [rng.integers(1, 200, size=head).tolist() for _ in range(n_heads)]
    return [h + rng.integers(1, 200, size=tail).tolist()
            for _ in range(waves) for h in heads]


@pytest.fixture(scope="module")
def models():
    paddle.seed(0)
    jm = JModel(JConfig.tiny(dtype="float32"))
    jm.eval()
    tm = LlamaForCausalLM(LlamaConfig.tiny(dtype="float32"), device="cpu")
    state, _ = jm.functional_state()
    tm.load_numpy_state({k: np.asarray(v) for k, v in state.items()})
    return jm, tm


def _run(E, R, model, prompts, **kw):
    eng = E(model, **kw)
    reqs = [eng.submit(R(np.asarray(p), 8)) for p in prompts]
    eng.run()
    assert not eng.has_work
    return [list(r.output_ids) for r in reqs], eng


def test_tiered_streams_match_untiered_and_jax(models):
    jm, tm = models
    prompts = _churn_prompts(7)
    base, e0 = _run(ServingEngine, Request, tm, prompts, **CHURN)
    reg = MetricsRegistry()
    tier, e1 = _run(ServingEngine, Request, tm, prompts,
                    host_tier_bytes=1 << 30,
                    **dict(CHURN, instrument=True), registry=reg)
    jtier, je = _run(JEngine, JRequest, jm, prompts,
                     host_tier_bytes=1 << 30, pipeline=False, recorder=False,
                     **CHURN)
    assert tier == base == jtier
    s0, s1 = e0.stats(), e1.stats()
    assert s1["host_reuse_tokens"] > 0
    assert s1["prefix_reuse_tokens"] > s0["prefix_reuse_tokens"]
    assert s1["host_reuse_tokens"] == je.stats()["host_reuse_tokens"]
    host = e1.kv_manager.host_tier
    assert host.stats == je.kv_manager.host_tier.stats
    assert host.stats["demoted"] > 0 and host.stats["restored"] > 0
    lbl = dict(policy="continuous")
    assert reg.get("serving_tier_restores_total").labels(**lbl).value > 0
    assert reg.get("serving_tier_demotions_total").labels(**lbl).value > 0
    assert reg.get("serving_prefix_hits_total").labels(
        policy="continuous", tier="host").value > 0
    assert reg.get("serving_kv_host_blocks").labels(**lbl).value \
        == host.n_blocks


@pytest.mark.parametrize("arm", ["kv8", "lookup", "pipelined"])
def test_tiered_equals_untiered(models, arm):
    tm = models[1]
    extra = {"kv8": dict(kv_dtype="int8"),
             "lookup": dict(mode="spec", spec_k=4),
             "pipelined": dict(pipeline=True)}[arm]
    prompts = _churn_prompts(11, n_heads=5)
    base, _ = _run(ServingEngine, Request, tm, prompts, **CHURN, **extra)
    tier, eng = _run(ServingEngine, Request, tm, prompts,
                     host_tier_bytes=1 << 30, **CHURN, **extra)
    assert tier == base
    assert eng.stats()["host_reuse_tokens"] > 0


def test_corrupt_host_tier_falls_back_to_prefill(models):
    jm, tm = models
    prompts = _churn_prompts(19)
    base, _ = _run(ServingEngine, Request, tm, prompts, **CHURN)
    reg = MetricsRegistry()
    plan = FaultPlan(host_tier_corrupt={26: ("*", "garble"),
                                        36: ("*", "truncate")})
    tier, eng = _run(ServingEngine, Request, tm, prompts,
                     host_tier_bytes=1 << 30, faults=plan, registry=reg,
                     pipeline=False, **dict(CHURN, instrument=True))
    jplan = JFaultPlan(host_tier_corrupt={26: ("*", "garble"),
                                          36: ("*", "truncate")})
    jtier, je = _run(JEngine, JRequest, jm, prompts,
                     host_tier_bytes=1 << 30, faults=jplan,
                     pipeline=False, **CHURN)
    assert tier == base == jtier
    assert plan.stats["host_corrupts"] == 2
    errs = reg.get("serving_host_tier_errors_total").labels(
        policy="continuous").value
    assert errs > 0
    assert eng.kv_manager.host_tier.stats \
        == je.kv_manager.host_tier.stats
    kinds = [e["kind"] for e in eng.recorder.events()]
    assert "host_corrupt" in kinds and "host_error" in kinds
    assert kinds == [e["kind"] for e in je.recorder.events()]


def test_knob_validation_and_preregistered_series(models):
    tm = models[1]
    with pytest.raises(ValueError, match="not both"):
        ServingEngine(tm, host_tier_bytes=1 << 20,
                      host_tier=BlockStore(1 << 20, 16), **CHURN)
    with pytest.raises(ValueError, match="requires paged"):
        ServingEngine(tm, batch_size=2, max_len=128,
                      host_tier_bytes=1 << 20)
    with pytest.raises(ValueError, match="block size"):
        ServingEngine(tm, host_tier=BlockStore(1 << 20, 8), **CHURN)
    reg = MetricsRegistry()
    ServingEngine(tm, registry=reg, **dict(CHURN, instrument=True))
    lbl = dict(policy="continuous")
    for name in ("serving_kv_host_blocks", "serving_kv_host_bytes",
                 "serving_tier_demotions_total",
                 "serving_tier_restores_total",
                 "serving_host_tier_errors_total"):
        assert reg.get(name).labels(**lbl).value == 0, name
    for tier in ("device", "host", "fleet"):
        assert reg.get("serving_prefix_hits_total").labels(
            policy="continuous", tier=tier).value == 0
    assert reg.get("serving_tier_restore_seconds") is not None
