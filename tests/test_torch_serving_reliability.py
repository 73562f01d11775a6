"""The port's serving reliability layer against the JAX engine's.

Deadlines, cancellation, load shedding, poison quarantine, dispatch
retries, the fault-injection plan and priority preemption, on the
reference tests' geometries (``tests/test_serving_reliability.py``: the
tiny f32 Llama, batch 2, max_len 64; ``tests/test_serving_router.py``
for preemption: a paged pool of 16-row blocks at max_len 128).  The
model is built by the JAX package and its weights carried across by
name.  Where the outcome is deterministic the port's statuses, partial
outputs and cohabitant streams equal the JAX engine's (run with
``pipeline=False``: its pipelined loop races on this container); within
the port, faulted runs equal clean ones bit for bit, pipelined or not.
Deadlines are forced with ``FaultPlan(slow_steps=...)``, never by
editing a request's clock.  Each clean configuration runs once per
module (memoised).
"""
import logging

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models.llama import LlamaConfig as JConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JModel
from paddle_tpu.serving import FaultPlan as JFaultPlan
from paddle_tpu.serving import Request as JRequest
from paddle_tpu.serving import ServingEngine as JEngine
import paddle_tpu_torch.serving.engine as engine_mod
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.observability import MetricsRegistry
from paddle_tpu_torch.serving import (
    EngineOverloaded, FaultPlan, InjectedDispatchError, Request,
    ServingEngine, SpecConfig,
)

# tiny shapes: torch's intra-op threads would only contend with the
# other test processes sharing this machine
torch.set_num_threads(1)

GEOM = dict(batch_size=2, max_len=64)
PROMPTS = [np.arange(1, 7), np.arange(2, 11), np.arange(3, 9)]
NEW = [8, 6, 4]
LBL = dict(policy="continuous")
SERIES = ("serving_requests_shed_total", "serving_requests_timed_out_total",
          "serving_requests_cancelled_total",
          "serving_requests_poisoned_total", "serving_dispatch_retries_total",
          "serving_preempted_total", "serving_preempt_resume_tokens_total")


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


def _engine(pkg, models, **kw):
    if pkg == "jax":
        kw = dict(kw, recorder=False, pipeline=False)
        if "faults" in kw:
            kw["faults"] = JFaultPlan(**kw["faults"])
        return JEngine(models["jax"][0], **kw)
    if "faults" in kw:
        kw["faults"] = FaultPlan(**kw["faults"])
    return ServingEngine(models["port"][0], **kw)


def _submit(pkg, eng, n=3, **kw):
    R = JRequest if pkg == "jax" else Request
    return [eng.submit(R(p, m, **kw)) for p, m in
            zip(PROMPTS[:n], NEW[:n])]


def _outs(reqs):
    return [list(r.output_ids) for r in reqs]


_MEMO = {}


def _clean(pkg, models, n=3, **kw):
    """Output streams of an unfaulted run of the first ``n`` requests."""
    key = (pkg, n) + tuple(sorted(kw.items()))
    if key not in _MEMO:
        eng = _engine(pkg, models, **GEOM, **kw)
        reqs = _submit(pkg, eng, n)
        eng.run()
        _MEMO[key] = _outs(reqs)
    return _MEMO[key]


# ------------------------------------------------------------ clean path
class TestCleanPath:
    def test_defaults_match_the_reference_and_stay_a_no_op(self, models):
        reg = MetricsRegistry()
        eng = _engine("port", models, **GEOM, registry=reg)
        assert (eng._retry_attempts, eng._retry_backoff,
                eng._max_pending, eng._faults) == (3, 0.05, None, None)
        reqs = _submit("port", eng)
        assert eng.drain() == {0: "done", 1: "done", 2: "done"}
        assert _outs(reqs) == _clean("jax", models)
        for series in SERIES:
            assert reg.get(series).labels(**LBL).value == 0

    def test_counters_registered_at_construction(self, models):
        reg = MetricsRegistry()
        _engine("port", models, **GEOM, registry=reg)
        for series in SERIES:
            assert reg.get(series).labels(**LBL).value == 0
        assert reg.get("serving_stream_cb_errors_total").labels(
            error="Exception", **LBL).value == 0


# --------------------------------------------------------------- retries
class TestDispatchRetry:
    @pytest.mark.parametrize("pipeline", [False, True])
    def test_retries_equal_the_clean_run_bitwise(self, models, pipeline,
                                                 caplog):
        """Errors at the dispatch seam (steps 2, 4) and at the drain seam
        (synchronous: step 0, the first tokens' fetch; pipelined: the last
        step, which only drains) are retried; the streams equal an
        unfaulted run bit for bit."""
        probe = _engine("port", models, **GEOM, pipeline=pipeline)
        _submit("port", probe)
        probe.run()
        drain_step = probe._step_idx if pipeline else 0
        reg = MetricsRegistry()
        eng = _engine("port", models, **GEOM, registry=reg,
                      pipeline=pipeline, retry_backoff=1e-4,
                      faults=dict(dispatch_error_steps={drain_step, 2, 4}))
        reqs = _submit("port", eng)
        with caplog.at_level(logging.WARNING, logger=engine_mod.__name__):
            assert set(eng.drain().values()) == {"done"}
        assert _outs(reqs) == _clean("port", models, pipeline=pipeline)
        assert eng._faults.stats["dispatch_errors"] == 3
        assert reg.get("serving_dispatch_retries_total").labels(
            **LBL).value == 3
        seams = {m.split()[1] for m in caplog.messages}
        assert {"drain", "decode"} <= seams

    def test_retry_exhaustion_reraises(self, models):
        eng = _engine("port", models, **GEOM, retry_attempts=2,
                      retry_backoff=1e-4,
                      faults=dict(dispatch_error_steps={1},
                                  dispatch_error_attempts=10))
        eng.submit(Request(PROMPTS[0], 6))
        with pytest.raises(InjectedDispatchError):
            eng.run()
        assert eng._faults.stats["dispatch_errors"] == 2

    def test_rate_draws_are_seed_deterministic(self, models):
        stats, outs = [], []
        for _ in range(2):
            eng = _engine("port", models, **GEOM, retry_backoff=1e-4,
                          faults=dict(seed=3, dispatch_error_rate=0.5))
            reqs = _submit("port", eng)
            eng.run()
            stats.append(dict(eng._faults.stats))
            outs.append(_outs(reqs))
        assert stats[0] == stats[1] and stats[0]["dispatch_errors"] > 0
        assert outs[0] == outs[1] == _clean("port", models)

    def test_out_of_memory_is_retried_sticky_errors_are_not(
            self, models, monkeypatch):
        """``torch.cuda.OutOfMemoryError`` (raised by the allocator before
        its operation is enqueued) is retried and the streams stay
        exact; any other error — a sticky CUDA error such as an illegal
        address — re-raises at once, with no second attempt."""
        monkeypatch.setattr(engine_mod, "_backoff_sleep", lambda s: None)
        for err, retried in (
                (torch.cuda.OutOfMemoryError("CUDA out of memory."), True),
                (RuntimeError("CUDA error: an illegal memory access was "
                              "encountered"), False)):
            eng = _engine("port", models, **GEOM)
            calls = []
            real = eng._call_decode

            def flaky(cur, dev_len, real=real, calls=calls, err=err):
                calls.append(1)
                if len(calls) == 2:
                    raise err
                return real(cur, dev_len)
            eng._call_decode = flaky
            reqs = _submit("port", eng)
            if retried:
                eng.run()
                assert _outs(reqs) == _clean("port", models)
            else:
                with pytest.raises(RuntimeError, match="illegal memory"):
                    eng.run()
                assert len(calls) == 2


# ---------------------------------------------------------------- poison
class TestPoisonQuarantine:
    @pytest.mark.parametrize("mode", ["greedy", "spec"])
    def test_poisoned_request_matches_jax(self, models, mode):
        """A NaN payload retires request 0 as "poisoned" with a clean-run
        prefix as its partial output; request 1 stays exact and request 2
        takes the freed slot — the JAX engine's statuses and streams."""
        kw = dict(mode=mode, spec_k=4) if mode == "spec" else {}
        got = {}
        for pkg in ("jax", "port"):
            eng = _engine(pkg, models, **GEOM, pipeline=False,
                          faults=dict(poison={0: 2}), **kw)
            reqs = _submit(pkg, eng)
            got[pkg] = (eng.drain(), _outs(reqs), eng._faults.stats)
        assert got["port"] == got["jax"]
        statuses, outs, stats = got["port"]
        assert statuses == {0: "poisoned", 1: "done", 2: "done"}
        assert stats["poisoned"] == 1
        clean = _clean("port", models, **kw)
        assert outs[1:] == clean[1:]
        assert outs[0] == clean[0][:len(outs[0])] and len(outs[0]) < NEW[0]

    @pytest.mark.parametrize("kw", [
        dict(pipeline=True), dict(pipeline=True, mode="spec", spec_k=4),
        dict(kv_dtype="int8"), dict(kv_block=16, prefill_chunk=16)],
        ids=["greedy-pipelined", "spec-pipelined", "int8", "paged"])
    def test_quarantine_keeps_cohabitants_exact(self, models, kw):
        """Pipelined, int8 (the poison lands in the scale leaf) and paged
        (the slot's first block): the poisoned request alone retires."""
        reg = MetricsRegistry()
        eng = _engine("port", models, **GEOM, registry=reg,
                      faults=dict(poison={0: 2}), **kw)
        reqs = _submit("port", eng)
        assert eng.drain() == {0: "poisoned", 1: "done", 2: "done"}
        clean = _clean("port", models, **kw)
        assert _outs(reqs)[1:] == clean[1:]
        assert _outs(reqs)[0] == clean[0][:len(reqs[0].output_ids)]
        assert reg.get("serving_requests_poisoned_total").labels(
            **LBL).value == 1


# ------------------------------------------------------------- deadlines
class TestDeadlines:
    def test_slow_step_expires_in_flight_and_queued_like_jax(self, models):
        """Request 0 (in flight) and request 2 (queued behind the full
        batch) carry a 0.6 s deadline; step 3 stalls 0.7 s, so both expire
        there — 0 with the tokens of steps 0-2, 2 with none — while
        request 1 finishes exactly."""
        got = {}
        for pkg in ("jax", "port"):
            _clean(pkg, models, pipeline=False)   # warm: no compile
            R = JRequest if pkg == "jax" else Request
            eng = _engine(pkg, models, **GEOM, pipeline=False,
                          faults=dict(slow_steps={3: 0.7}))
            reqs = [eng.submit(R(PROMPTS[0], NEW[0], deadline_ms=600)),
                    eng.submit(R(PROMPTS[1], NEW[1])),
                    eng.submit(R(PROMPTS[2], NEW[2], deadline_ms=600))]
            got[pkg] = (eng.drain(), _outs(reqs))
        assert got["port"] == got["jax"]
        statuses, outs = got["port"]
        assert statuses == {0: "timed_out", 1: "done", 2: "timed_out"}
        assert outs[0] == _clean("port", models)[0][:4] and outs[2] == []
        assert outs[1] == _clean("port", models)[1]

    def test_zero_deadline_expires_in_the_queue(self, models):
        reg = MetricsRegistry()
        eng = _engine("port", models, batch_size=1, max_len=64,
                      registry=reg)
        r0 = eng.submit(Request(PROMPTS[0], 6))
        r1 = eng.submit(Request(PROMPTS[1], 6, deadline_ms=0))
        assert eng.drain() == {r0.rid: "done", r1.rid: "timed_out"}
        assert r1.output_ids == [] and r1.done
        assert reg.get("serving_requests_timed_out_total").labels(
            **LBL).value == 1


# ---------------------------------------------------------- cancellation
class TestCancellation:
    def test_cancel_queued_and_unknown(self, models):
        eng = _engine("port", models, batch_size=1, max_len=64)
        eng.submit(Request(PROMPTS[0], 4, rid="res"))
        q = eng.submit(Request(PROMPTS[1], 4, rid="waiting"))
        assert eng.cancel("waiting") is True
        assert q.done and q.status == "cancelled" and q.output_ids == []
        assert eng.cancel("nope") is False
        assert eng.drain() == {"res": "done", "waiting": "cancelled"}
        assert eng.cancel("res") is False

    def test_cancel_mid_prefill(self, models):
        eng = _engine("port", models, batch_size=1, max_len=64,
                      prefill_chunk=4, prefill_budget=1)
        long = eng.submit(Request(np.arange(1, 30), 5, rid="long"))
        nxt = eng.submit(Request(PROMPTS[0], 4, rid="next"))
        eng.step()
        assert eng._pf
        assert eng.cancel("long") is True
        assert eng.drain() == {"long": "cancelled", "next": "done"}
        assert long.output_ids == [] and len(nxt.output_ids) == 4

    def test_cancel_in_flight_matches_jax(self, models):
        got = {}
        for pkg in ("jax", "port"):
            eng = _engine(pkg, models, **GEOM, pipeline=False)
            reqs = _submit(pkg, eng)
            for _ in range(3):
                eng.step()
            assert eng.cancel(0) is True
            got[pkg] = (eng.drain(), _outs(reqs))
        assert got["port"] == got["jax"]
        assert got["port"][0] == {0: "cancelled", 1: "done", 2: "done"}
        assert got["port"][1][1] == _clean("port", models)[1]

    def test_cancel_in_flight_pipelined_keeps_the_bystander(self, models):
        reg = MetricsRegistry()
        eng = _engine("port", models, **GEOM, pipeline=True, registry=reg)
        reqs = _submit("port", eng)
        for _ in range(3):
            eng.step()
        assert eng._inflight is not None      # a dispatch rides the cancel
        assert eng.cancel(0) is True
        assert eng.drain() == {0: "cancelled", 1: "done", 2: "done"}
        clean = _clean("port", models, pipeline=True)
        assert _outs(reqs)[1] == clean[1]
        assert _outs(reqs)[0] == clean[0][:len(reqs[0].output_ids)]
        assert len(reqs[2].output_ids) == NEW[2]
        assert reg.get("serving_requests_cancelled_total").labels(
            **LBL).value == 1


# --------------------------------------------------------- load shedding
class TestLoadShedding:
    def test_bounded_queue_sheds_and_recovers(self, models):
        reg = MetricsRegistry()
        eng = _engine("port", models, batch_size=1, max_len=64,
                      max_pending=1, registry=reg)
        eng.submit(Request(PROMPTS[0], 4))
        shed = Request(PROMPTS[1], 4)
        with pytest.raises(EngineOverloaded):
            eng.submit(shed)
        assert shed.status == "shed" and shed.rid is None
        assert not shed.done
        assert reg.get("serving_requests_shed_total").labels(
            **LBL).value == 1
        eng.step()
        ok = eng.submit(Request(PROMPTS[1], 4))
        assert eng.drain() == {0: "done", ok.rid: "done"}

    def test_shedding_leaves_no_engine_state(self, models):
        eng = _engine("port", models, batch_size=1, max_len=64,
                      max_pending=0)
        with pytest.raises(EngineOverloaded):
            eng.submit(Request(PROMPTS[0], 4, rid="x"))
        assert not eng.has_work and eng._finished == [] and not eng._rids
        assert eng.stats()["queue_depth"] == 0 and eng._next_rid == 0
        with pytest.raises(ValueError, match="max_pending"):
            _engine("port", models, batch_size=1, max_len=64,
                    max_pending=-1)

    def test_shedding_keeps_the_streams_exact(self, models):
        eng = _engine("port", models, **GEOM, max_pending=2)
        reqs = _submit("port", eng, n=2)
        with pytest.raises(EngineOverloaded):
            eng.submit(Request(PROMPTS[2], NEW[2]))
        eng.step()
        reqs.append(eng.submit(Request(PROMPTS[2], NEW[2])))
        eng.run()
        assert _outs(reqs) == _clean("port", models)


# ---------------------------------------------------------- drain / close
class TestDrainClose:
    def test_close_matches_jax(self, models):
        """After 2 steps, ``close()`` cancels the resident and the queued
        request alike, keeping the partial outputs; a second call returns
        the same map."""
        got = {}
        for pkg in ("jax", "port"):
            eng = _engine(pkg, models, **GEOM, pipeline=False)
            reqs = _submit(pkg, eng)
            for _ in range(2):
                eng.step()
            st = eng.close()
            assert not eng.has_work and st == eng.close()
            got[pkg] = (st, _outs(reqs))
        assert got["port"] == got["jax"]
        assert set(got["port"][0].values()) == {"cancelled"}

    def test_close_drains_the_inflight_dispatch(self, models):
        eng = _engine("port", models, **GEOM, pipeline=True)
        reqs = _submit("port", eng)
        for _ in range(3):
            eng.step()
        assert eng._inflight is not None
        n_before = len(reqs[0].output_ids)
        st = eng.close()
        assert st == {0: "cancelled", 1: "cancelled", 2: "cancelled"}
        assert len(reqs[0].output_ids) == n_before + 1
        assert _outs(reqs)[0] == _clean("port", models,
                                        pipeline=True)[0][:n_before + 1]
        assert st == eng.close() and not eng.has_work

    def test_drain_returns_the_status_map(self, models):
        eng = _engine("port", models, **GEOM)
        eng.submit(Request(PROMPTS[0], 4, rid="a"))
        eng.submit(Request(PROMPTS[1], 3, rid="b"))
        assert eng.drain() == {"a": "done", "b": "done"}
        assert not eng.has_work


# ------------------------------------------------------------ preemption
PAGED = dict(batch_size=2, max_len=128, decode_chunk=16, prefill_chunk=16,
             kv_block=16, max_live_tokens=2 * 128)


def _preempt_wave(pkg, models, **kw):
    """Two low-priority requests decode for 6 steps, then a priority-5
    request arrives that only a preemption can admit."""
    R = JRequest if pkg == "jax" else Request
    rng = np.random.default_rng(11)
    prompts = [rng.integers(1, 200, size=24).astype(np.int32)
               for _ in range(3)]
    eng = _engine(pkg, models, **{**PAGED, **kw})
    lows = [eng.submit(R(p, 40)) for p in prompts[:2]]
    for _ in range(6):
        eng.step()
    hi = eng.submit(R(prompts[2], 8, priority=5))
    eng.run()
    return eng, lows, hi


class TestPreemption:
    def test_victim_and_resumed_streams_match_jax(self, models):
        got = {}
        for pkg in ("jax", "port"):
            eng, lows, hi = _preempt_wave(pkg, models, pipeline=False)
            s = eng.stats()
            got[pkg] = ([q.preempts for q in lows], _outs(lows + [hi]),
                        [q.status for q in lows + [hi]],
                        {k: s[k] for k in ("preempted",
                                           "preempt_resume_suffix_tokens",
                                           "preempt_resume_total_tokens")})
        assert got["port"] == got["jax"]
        preempts, outs, statuses, s = got["port"]
        assert preempts == [0, 1] and set(statuses) == {"done"}
        assert s["preempted"] == 1
        assert 0 < s["preempt_resume_suffix_tokens"] \
            < s["preempt_resume_total_tokens"]

    @pytest.mark.parametrize("pipeline", [False, True])
    def test_resumed_streams_equal_an_unpreempted_run(self, models,
                                                      pipeline):
        reg = MetricsRegistry()
        eng, lows, hi = _preempt_wave("port", models, pipeline=pipeline,
                                      registry=reg)
        assert [q.preempts for q in lows] == [0, 1]
        assert hi.status == "done" and len(hi.output_ids) == 8
        ref = _engine("port", models, **PAGED, pipeline=pipeline)
        refs = [ref.submit(Request(q.prompt_ids.copy(), 40)) for q in lows]
        ref.run()
        assert _outs(lows) == _outs(refs)
        assert reg.get("serving_preempted_total").labels(**LBL).value == 1
        assert reg.get("serving_preempt_resume_tokens_total").labels(
            **LBL).value == eng.stats()["preempt_resume_suffix_tokens"]
        kv = eng.kv_manager
        assert kv.live_tokens() == 0 and kv.outstanding() == 0

    def test_preempting_a_draft_model_slot_frees_its_draft_chain(
            self, models):
        draft = models["port"][1]
        spec = SpecConfig(source="draft_model", draft_model=draft, spec_k=2)
        eng, lows, hi = _preempt_wave(
            "port", models, mode="spec", spec=spec,
            max_live_tokens=4 * 128)
        assert sum(q.preempts for q in lows) >= 1 and hi.status == "done"
        assert eng.kv_manager.draft_blocks_used() == 0
        ref = _engine("port", models, **PAGED)
        refs = [ref.submit(Request(q.prompt_ids.copy(), 40)) for q in lows]
        ref.run()
        assert _outs(lows) == _outs(refs)

    def test_default_priority_never_preempts(self, models):
        eng = _engine("port", models, **PAGED)
        rng = np.random.default_rng(23)
        reqs = [eng.submit(Request(rng.integers(1, 200, size=24), 8))
                for _ in range(4)]
        eng.run()
        assert all(q.preempts == 0 for q in reqs)
        assert eng.stats()["preempted"] == 0


# ----------------------------------------------------------- fault plan
class TestFaultHarness:
    def test_slow_steps_fire_and_are_counted(self, models):
        eng = _engine("port", models, batch_size=1, max_len=64,
                      faults=dict(slow_steps={1: 1e-4, 2: 1e-4}))
        eng.submit(Request(PROMPTS[0], 6))
        eng.drain()
        assert eng._faults.stats["slow_steps"] == 2

    def test_cb_crashes_counted_by_type_decode_unharmed(self, models):
        reg = MetricsRegistry()
        eng = _engine("port", models, **GEOM, registry=reg,
                      faults=dict(cb_crash_steps={1, 2}))
        got = []
        reqs = [eng.submit(Request(PROMPTS[0], NEW[0],
                                   stream_cb=lambda r, ids: got.extend(ids))),
                eng.submit(Request(PROMPTS[1], NEW[1]))]
        assert eng.drain() == {0: "done", 1: "done"}
        assert _outs(reqs) == _clean("port", models, n=2)
        crashes = eng._faults.stats["cb_crashes"]
        assert crashes > 0
        assert reg.get("serving_stream_cb_errors_total").labels(
            error="InjectedStreamCbError", **LBL).value == crashes
        assert 0 < len(got) < len(reqs[0].output_ids)

    def test_fleet_and_host_tier_faults_are_a_no_op(self, models):
        """The port has no fleet and no host tier: a plan that kills a
        worker or corrupts the host tier injects nothing."""
        eng = _engine("port", models, **GEOM, faults=dict(
            worker_kill={1: "decode0"}, host_tier_corrupt={1: None}))
        reqs = _submit("port", eng)
        eng.run()
        assert _outs(reqs) == _clean("port", models)
        st = eng._faults.stats
        assert st["worker_kills"] == 0 and st["host_corrupts"] == 0


def test_reliability_paths_stay_on_the_clean_program_keys(models,
                                                         monkeypatch):
    """Cancel, deadline expiry, poison quarantine, shedding and retries
    dispatch through the program keys a clean run uses — the port's
    counterpart of the reference's zero-retrace check."""
    seen = []
    for name in ("serving_decode_steps", "serving_prefill_chunk"):
        real = getattr(engine_mod, name)

        def spy(*a, real=real, **kw):
            seen.append(kw["program_key"])
            return real(*a, **kw)
        monkeypatch.setattr(engine_mod, name, spy)
    eng = _engine("port", models, **GEOM, pipeline=True)
    _submit("port", eng)
    eng.run()
    clean = set(seen)
    seen.clear()
    eng = _engine("port", models, **GEOM, pipeline=True, max_pending=3,
                  retry_backoff=1e-4, faults=dict(
                      poison={"p": 2}, dispatch_error_steps={3},
                      slow_steps={4: 0.3}))
    eng.submit(Request(PROMPTS[0], NEW[0], rid="a"))
    eng.submit(Request(PROMPTS[1], NEW[1], rid="p"))
    eng.submit(Request(PROMPTS[2], 20, rid="late", deadline_ms=250))
    with pytest.raises(EngineOverloaded):
        eng.submit(Request(PROMPTS[2], 4))
    for _ in range(3):
        eng.step()
    eng.cancel("a")
    st = eng.drain()
    assert st["a"] == "cancelled" and st["p"] == "poisoned", st
    assert st["late"] in ("timed_out", "done")
    assert seen and set(seen) <= clean
