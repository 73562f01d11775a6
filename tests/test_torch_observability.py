"""The port's request observability layer against the JAX package's.

Module level: the port's own copies of ``observability/`` (flight
recorder, request traces, spans, SLO tracker, watchdog, exporter,
compile-cache monitor) make the same calls give the same output as the
reference's — JSONL and chrome-trace dumps, ``chrome_event`` dicts,
Prometheus text, SLO attainment and burn rate — with the clock patched
in both.  Engine level, on the tiny f32 Llama (weights carried from the
JAX model): the flight recorder's ``(kind, rid, slot, step)`` sequence
and every request's timeline phases equal the JAX engine's
(``pipeline=False``, the synchronous loop, ROADMAP queue C) for the same
requests, dense and paged; the compile-cache monitor's program counts
for chunked and monolithic prefill equal ``jax.jit``'s traces; the
token streams are bitwise the same with the recorder on and off; the
anomaly auto-dumps fire once on poison, timeout and retry exhaustion
and never on done or cancel; the watchdog dumps one stall and stops on
``close()``; a live exporter serves ``/metrics``, ``/healthz`` and the
engine's ``/debug/*``; a ``torch.profiler`` session shows the
``serving.*`` spans.  Threads are joined with a timeout and sockets bind
``127.0.0.1:0``.
"""
import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.observability as jobs
from paddle_tpu.models.llama import LlamaConfig as JConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JModel
from paddle_tpu.observability import exporter as jexporter
from paddle_tpu.observability import flightrecorder as jfr
from paddle_tpu.observability import slo as jslo
from paddle_tpu.observability import trace as jtrace
from paddle_tpu.observability import watchdog as jwatchdog
from paddle_tpu.observability.metrics import MetricsRegistry as JRegistry
from paddle_tpu.serving import Request as JRequest
from paddle_tpu.serving import ServingEngine as JEngine
import paddle_tpu_torch.observability as tobs
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.observability import exporter as texporter
from paddle_tpu_torch.observability import flightrecorder as tfr
from paddle_tpu_torch.observability import slo as tslo
from paddle_tpu_torch.observability import trace as ttrace
from paddle_tpu_torch.observability import watchdog as twatchdog
from paddle_tpu_torch.observability.compilecache import CompileCacheMonitor
from paddle_tpu_torch.observability.metrics import MetricsRegistry
from paddle_tpu_torch.serving import FaultPlan, Request, ServingEngine
from paddle_tpu_torch.serving.faults import InjectedDispatchError

torch.set_num_threads(1)


class _Clock:
    """A deterministic stand-in for ``time.perf_counter_ns`` /
    ``perf_counter``: every read advances by a fixed step."""

    def __init__(self, step_ns=1000):
        self.t = 10 ** 12
        self.step = step_ns

    def ns(self):
        self.t += self.step
        return self.t

    def s(self):
        return self.ns() / 1e9


@pytest.fixture
def clock(monkeypatch):
    c = _Clock()
    monkeypatch.setattr(time, "perf_counter_ns", c.ns)
    monkeypatch.setattr(time, "perf_counter", c.s)
    return c


def _record_script(fr):
    fr.record("submit", step=-1, rid=0, prompt_len=5, slo_class=None)
    fr.record("admit", step=0, rid=0, slot=1, bucket=16)
    fr.record("dispatch", step=0, mode="greedy", n_live=1)
    fr.record("stall", step=0, seconds=0.25)
    fr.record("submit", step=0, rid="b", prompt_len=9, slo_class="batch")
    fr.record("retire", step=1, rid=0, slot=1, status="poisoned", n_out=2)


def test_lazy_exports_match_jax():
    assert sorted(tobs.__all__) == sorted(jobs.__all__)
    for name in tobs.__all__:
        assert getattr(tobs, name) is not None


def test_flight_recorder_dumps_match_jax(clock, tmp_path):
    """The ring, its overflow count, JSONL, the chrome trace, the snapshot
    and an auto-dump (record and file) are the reference's, byte for
    byte."""
    outs = []
    for mod, tag in ((jfr, "jax"), (tfr, "port")):
        clock.t = 10 ** 12
        got = []
        fr = mod.FlightRecorder(capacity=5, policy="continuous",
                                dump_dir=str(tmp_path / tag), dump_last=3,
                                on_dump=got.append)
        _record_script(fr)
        rec = fr.auto_dump("poisoned")
        with open(rec["path"], encoding="utf-8") as f:
            dumped = f.read()
        rec["path"] = rec["path"].replace(str(tmp_path / tag), "")
        outs.append((fr.to_jsonl(), fr.chrome_trace(), fr.snapshot(),
                     rec, dumped, got, fr.dropped, len(fr)))
    assert outs[0] == outs[1]
    assert outs[1][6] == 1 and outs[1][5] == ["poisoned"]


def test_request_trace_matches_jax(clock):
    outs = []
    for mod in (jfr, tfr):
        clock.t = 10 ** 12
        tr = mod.RequestTrace(7)
        tr.mark("queued")
        tr.mark("prefilling", slot=0)
        tr.mark("prefilling", chunk=1, slot=0)
        tr.mark("decoding", slot=0)
        tr.mark("done", slot=0)
        outs.append((tr.as_dicts(), tr.durations(), tr.phase,
                     tr.first_at("prefilling")))
    assert outs[0] == outs[1]
    assert tfr.TERMINAL_PHASES == jfr.TERMINAL_PHASES
    assert tfr.EVENT_KINDS == jfr.EVENT_KINDS


def test_chrome_event_matches_jax():
    args = {"rid": 3, "slot": 1}
    a = jtrace.chrome_event("admit", 2000, 5000, tid=4,
                            event_type="FlightRecorder", args=args)
    b = ttrace.chrome_event("admit", 2000, 5000, tid=4,
                            event_type="FlightRecorder", args=args)
    assert a == b and list(a) == list(b)
    assert jtrace.chrome_event("x", 0, 10, tid=0) \
        == ttrace.chrome_event("x", 0, 10, tid=0)


def test_span_observes_like_jax(clock):
    """A span (reused, nested, and as a decorator) feeds
    ``span_seconds{name, mesh}`` as the reference's does."""
    texts = []
    for mod, reg in ((jtrace, JRegistry()), (ttrace, MetricsRegistry())):
        outer = mod.span("serving.step", registry=reg)
        inner = mod.span("serving.decode", registry=reg, mesh="2")
        with outer:
            with inner:
                with inner:
                    pass

        @mod.span("serving.prefill", registry=reg)
        def work(x):
            return x + 1

        assert work(1) == 2
        texts.append(reg.to_prometheus())
    assert texts[0] == texts[1]
    assert 'span_seconds_count{name="serving.decode",mesh="2"} 2' \
        in texts[1]


def test_span_shows_in_torch_profiler():
    reg = MetricsRegistry()
    sp = ttrace.span("serving.unit", registry=reg)
    assert ttrace._profiler_record("x") is None   # no session recording
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with sp:
            torch.ones(4).sum()
    keys = {e.key for e in prof.key_averages()}
    assert "serving.unit" in keys
    hist = reg.get("span_seconds").labels(name="serving.unit", mesh="")
    assert hist.count == 1


class _FakeReq:
    def __init__(self, ttft=None, tpot=None, latency=None, n_out=0,
                 slo_class=None):
        self.ttft = ttft
        self.tpot = tpot
        self.latency = latency
        self.output_ids = [0] * n_out
        self.slo_class = slo_class


_SLO_REQS = [
    _FakeReq(ttft=0.1, tpot=0.05, latency=1.0, n_out=10),
    _FakeReq(ttft=0.9, tpot=0.05, latency=2.0, n_out=10),
    _FakeReq(ttft=None, latency=0.5, n_out=0),
    _FakeReq(latency=4.0, n_out=8, slo_class="batch"),
    _FakeReq(latency=40.0, n_out=8, slo_class="batch"),
    _FakeReq(ttft=0.2, latency=1.0, n_out=3, slo_class="unknown"),
    _FakeReq(ttft=0.3, tpot=0.2, latency=3.0, n_out=12),
]


def test_slo_attainment_and_burn_match_jax():
    outs = []
    for mod, reg in ((jslo, JRegistry()), (tslo, MetricsRegistry())):
        objs = (mod.SLObjective("interactive", ttft=0.5, tpot=0.1,
                                target=0.9),
                mod.SLObjective("batch", min_tok_per_s=1.0, e2e=10.0))
        tr = mod.SLOTracker(objectives=objs, window=4, registry=reg,
                            policy="continuous")
        goods = [tr.observe(r) for r in _SLO_REQS]
        outs.append((goods, tr.snapshot(), reg.to_prometheus(),
                     [tr.attainment(c) for c in
                      ("interactive", "batch", "unknown", "none")],
                     [tr.burn_rate(c) for c in
                      ("interactive", "batch", "unknown")]))
    assert outs[0] == outs[1]
    assert [o.name for o in tslo.DEFAULT_OBJECTIVES] \
        == [o.name for o in jslo.DEFAULT_OBJECTIVES]
    assert [o.as_dict() for o in tslo.DEFAULT_OBJECTIVES] \
        == [o.as_dict() for o in jslo.DEFAULT_OBJECTIVES]


def test_metrics_text_and_json_match_jax():
    outs = []
    for reg in (JRegistry(), MetricsRegistry()):
        c = reg.counter("requests_total", "reqs", ("policy",))
        c.labels(policy="continuous").inc(3)
        g = reg.gauge("depth", "depth")
        g.set(2.5)
        h = reg.histogram("lat_seconds", "lat", ("policy",))
        for v in (1e-4, 0.02, 0.3, 7.0):
            h.labels(policy="gang").observe(v)
        outs.append((reg.to_prometheus(), reg.to_json()))
    assert outs[0] == outs[1]


def test_watchdog_trips_latches_and_rearms_like_jax():
    """``check_now(now=)`` drives both watchdogs (no poll thread): one
    dump a stall episode, re-armed by fresh progress."""
    outs = []
    for wmod, fmod, reg in ((jwatchdog, jfr, JRegistry()),
                            (twatchdog, tfr, MetricsRegistry())):
        probe = {"t": 100.0}
        fr = fmod.FlightRecorder(policy="continuous")
        wd = wmod.DeadlockWatchdog(lambda: probe["t"], stall_after=5.0,
                                   recorder=fr, registry=reg,
                                   component="engine")
        trips = [wd.check_now(now=101.0), wd.check_now(now=106.0),
                 wd.check_now(now=200.0)]
        probe["t"] = 300.0
        trips.append(wd.check_now(now=302.0))
        trips.append(wd.check_now(now=310.0))
        probe["t"] = None
        trips.append(wd.check_now(now=1e9))
        stalls = [e for e in fr.events() if e["kind"] == "stall"]
        outs.append((trips, wd.stalls, [d["reason"] for d in fr.dumps],
                     reg.get("serving_watchdog_stalls_total").labels(
                         component="engine").value,
                     sorted({k for e in stalls for k in e})))
    assert outs[0] == outs[1]
    assert outs[1][0] == [False, True, False, False, True, False]


def test_watchdog_thread_starts_and_stops():
    before = threading.active_count()
    wd = twatchdog.DeadlockWatchdog(lambda: None, stall_after=0.05,
                                    registry=MetricsRegistry())
    wd.start()
    assert wd.is_alive
    wd.stop(timeout=5.0)
    assert not wd.is_alive
    assert threading.active_count() == before


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=10) as r:
            return r.status, r.headers.get("Content-Type"), r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Content-Type"), e.read()


def _fill(reg):
    reg.counter("serving_steps_total", "steps", ("policy",)).labels(
        policy="continuous").inc(4)
    reg.gauge("serving_queue_depth", "q", ("policy",)).labels(
        policy="continuous").set(2)
    reg.gauge("serving_inflight_steps", "i", ("policy",)).labels(
        policy="continuous").set(1)


def test_exporter_serves_like_jax_and_stops():
    before = threading.active_count()
    pages = []
    for mod, reg in ((jexporter, JRegistry()),
                     (texporter, MetricsRegistry())):
        _fill(reg)
        exp = mod.MetricsExporter(registry=reg, port=0,
                                  debug_sources={"x": lambda: {"a": 1}})
        exp.start()
        try:
            metrics = _get(exp.url + "/metrics")
            health = _get(exp.url + "/healthz")
            dbg = _get(exp.url + "/debug/x")
            missing = _get(exp.url + "/debug/nope")
        finally:
            exp.stop()
        assert not exp.running and exp.port is None
        h = json.loads(health[2])
        pages.append((metrics, sorted(h), h["queue_depth"],
                      h["inflight_steps"], json.loads(dbg[2]),
                      missing[0]))
    assert pages[0] == pages[1]
    assert pages[1][0][0] == 200 and pages[1][5] == 404
    assert threading.active_count() == before


def test_default_exporter_is_opt_in(monkeypatch):
    monkeypatch.delenv("PADDLE_TPU_METRICS_PORT", raising=False)
    assert texporter.start_default_exporter() is None
    assert jexporter.start_default_exporter() is None
    monkeypatch.setenv("PADDLE_TPU_METRICS_PORT", "0")
    exp = texporter.start_default_exporter()
    try:
        assert exp.running and exp.port > 0
        assert texporter.start_default_exporter() is exp
    finally:
        texporter.stop_default_exporter()
    assert not exp.running


def test_compile_cache_monitor_counts_first_dispatches():
    reg = MetricsRegistry()
    mon = CompileCacheMonitor("unit", registry=reg)
    assert mon.dispatch("prog", (1, "a")) is True
    assert mon.dispatch("prog", (1, "a")) is False
    assert mon.dispatch("prog", (2, "a")) is True
    assert mon.trace_counts() == {"prog": 2}
    lbl = dict(cache="unit", program="prog")
    assert reg.get("compile_cache_misses_total").labels(**lbl).value == 2
    assert reg.get("compile_cache_hits_total").labels(**lbl).value == 1
    assert mon in tobs.compilecache.all_monitors()


# ------------------------------------------------------------ engine level
_PROMPTS = [[3, 9, 4, 1, 7], [2, 5, 8, 11, 6, 4, 9, 13, 1, 3, 5, 7, 8, 2, 6,
                              10, 12, 14, 3, 4, 5],
            list(range(1, 18)), [7, 7, 1, 2, 3, 4, 5, 6, 7, 8, 9]]
_NEW = [6, 4, 7, 5]
# paged: the last request repeats the first's 16-token head
_PAGED_PROMPTS = [list(range(20, 52)), list(range(60, 69)),
                  list(range(20, 36)) + [9, 9, 9]]
_PAGED_NEW = [5, 6, 4]
GEOM = dict(batch_size=2, max_len=64, decode_chunk=16, prefill_chunk=16)
PAGED = dict(kv_block=16, max_live_tokens=2 * 64)


@pytest.fixture(scope="module")
def models():
    paddle.seed(0)
    jm = JModel(JConfig.tiny(dtype="float32"))
    jm.eval()
    tm = LlamaForCausalLM(LlamaConfig.tiny(dtype="float32"), device="cpu")
    state, _ = jm.functional_state()
    tm.load_numpy_state({k: np.asarray(v) for k, v in state.items()})
    return jm, tm


def _serve(E, R, model, prompts, news, **kw):
    eng = E(model, **kw)
    reqs = [eng.submit(R(np.asarray(p), n)) for p, n in zip(prompts, news)]
    eng.run()
    return eng, reqs


def _events(eng):
    return [(e["kind"], e["rid"], e["slot"], e["step"])
            for e in eng.recorder.events()]


def _phases(reqs):
    return [[(d["phase"], d.get("chunk"), d.get("slot"))
             for d in r.timeline()] for r in reqs]


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_engine_events_and_timelines_match_jax(models, paged):
    jm, tm = models
    prompts, news = (_PAGED_PROMPTS, _PAGED_NEW) if paged \
        else (_PROMPTS, _NEW)
    kw = dict(GEOM, pipeline=False, **(PAGED if paged else {}))
    jeng, jreqs = _serve(JEngine, JRequest, jm, prompts, news,
                         registry=JRegistry(), **kw)
    teng, treqs = _serve(ServingEngine, Request, tm, prompts, news,
                         registry=MetricsRegistry(), **kw)
    assert [list(r.output_ids) for r in treqs] \
        == [list(r.output_ids) for r in jreqs]
    assert _events(teng) == _events(jeng)
    assert _phases(treqs) == _phases(jreqs)
    # the detail keys ride too (values of the kernel labels differ by
    # name: the port's "cuda"/"reference" against "fused"/"reference")
    for te, je in zip(teng.recorder.events(), jeng.recorder.events()):
        assert sorted(te) == sorted(je), (te, je)
    kinds = {e[0] for e in _events(teng)}
    assert {"submit", "admit", "prefill_chunk", "dispatch", "drain",
            "retire"} <= kinds
    if paged:
        assert {"prefix_hit", "block_alloc", "block_free"} <= kinds


def test_compile_cache_counts_match_jax(models):
    """Eight prompt lengths over three buckets: one chunked-prefill
    program, and one monolithic program per touched bucket — the counts
    ``jax.jit`` traced for the same run (a geometry no other test uses,
    so both sides start cold)."""
    from paddle_tpu.models.llama_decode import _mon as jmon
    from paddle_tpu_torch.models.llama_decode import _mon as tmon

    jm, tm = models
    rng = np.random.default_rng(22)
    prompts = [rng.integers(0, 256, (p,)) for p in (3, 5, 7, 9, 11, 14,
                                                     17, 21)]
    kw = dict(batch_size=2, max_len=88, prompt_buckets=(8, 16, 24),
              decode_chunk=8, pipeline=False, recorder=False,
              instrument=False)
    deltas = []
    for E, R, model, mon in ((JEngine, JRequest, jm, jmon),
                             (ServingEngine, Request, tm, tmon)):
        got = []
        for pchunk in (8, None):
            before = mon.trace_counts()
            _serve(E, R, model, prompts, [3] * 8, prefill_chunk=pchunk,
                   **kw)
            after = mon.trace_counts()
            got.append({p: after.get(p, 0) - before.get(p, 0)
                        for p in ("serving_prefill_chunk",
                                  "serving_prefill_slot")})
        deltas.append(got)
    assert deltas[0] == deltas[1]
    assert deltas[1] == [{"serving_prefill_chunk": 1,
                          "serving_prefill_slot": 0},
                         {"serving_prefill_chunk": 0,
                          "serving_prefill_slot": 3}]


@pytest.mark.parametrize("pipeline", [False, True], ids=["sync", "pipe"])
@pytest.mark.parametrize("mode", ["greedy", "spec"])
def test_recorder_on_off_streams_bitwise(models, mode, pipeline):
    tm = models[1]
    kw = dict(GEOM, mode=mode, pipeline=pipeline, spec_k=3,
              registry=MetricsRegistry())
    on, ron = _serve(ServingEngine, Request, tm, _PROMPTS, _NEW, **kw)
    kw["registry"] = MetricsRegistry()
    off, roff = _serve(ServingEngine, Request, tm, _PROMPTS, _NEW,
                       recorder=False, **kw)
    assert [r.output_ids for r in ron] == [r.output_ids for r in roff]
    assert off.recorder is None and all(r.timeline() == [] for r in roff)
    kinds = [e["kind"] for e in on.recorder.events()]
    assert kinds.count("submit") == len(_PROMPTS)
    assert kinds.count("retire") == len(_PROMPTS)
    if mode == "spec":
        assert {"draft", "verify", "rewind"} <= set(kinds)


def _dumps(eng):
    return [d["reason"] for d in eng.recorder.dumps]


def test_poison_dumps_once_with_the_lifecycle(models, tmp_path):
    tm = models[1]
    reg = MetricsRegistry()
    fr = tobs.FlightRecorder(dump_dir=str(tmp_path), policy="continuous")
    eng = ServingEngine(tm, registry=reg, recorder=fr,
                        faults=FaultPlan(poison={0: 2}), **GEOM)
    for p, n in zip(_PROMPTS[:2], _NEW[:2]):
        eng.submit(Request(p, n))
    statuses = eng.drain()
    assert statuses[0] == "poisoned" and statuses[1] == "done"
    assert _dumps(eng) == ["poisoned"]
    assert reg.get("flight_recorder_dumps_total").labels(
        policy="continuous", reason="poisoned").value == 1
    mine = [e["kind"] for e in fr.dumps[0]["events"] if e["rid"] == 0]
    for k in ("submit", "admit", "poison", "retire"):
        assert k in mine
    with open(fr.dumps[0]["path"], encoding="utf-8") as f:
        assert [json.loads(ln) for ln in f] == fr.dumps[0]["events"]


def test_timeout_dumps_once(models):
    tm = models[1]
    eng = ServingEngine(tm, registry=MetricsRegistry(),
                        **dict(GEOM, batch_size=1))
    eng.submit(Request(_PROMPTS[0], 4))
    late = eng.submit(Request(_PROMPTS[1], 4, deadline_ms=0))
    assert eng.drain()[late.rid] == "timed_out"
    assert _dumps(eng) == ["timed_out"]
    assert late.timeline()[-1]["phase"] == "timed_out"


def test_done_and_cancel_do_not_dump(models):
    tm = models[1]
    eng = ServingEngine(tm, registry=MetricsRegistry(),
                        **dict(GEOM, batch_size=1))
    eng.submit(Request(_PROMPTS[0], 4, rid="a"))
    q = eng.submit(Request(_PROMPTS[1], 4, rid="b"))
    eng.cancel("b")
    eng.drain()
    assert q.status == "cancelled" and eng.recorder.dumps == []
    assert [e["kind"] for e in eng.recorder.events()
            if e["rid"] == "b"] == ["submit", "cancel", "retire"]


def test_retry_exhaustion_dumps(models):
    tm = models[1]
    reg = MetricsRegistry()
    eng = ServingEngine(tm, registry=reg, retry_attempts=2,
                        retry_backoff=1e-4,
                        faults=FaultPlan(dispatch_error_steps={1},
                                         dispatch_error_attempts=10),
                        **GEOM)
    eng.submit(Request(_PROMPTS[0], 6))
    with pytest.raises(InjectedDispatchError):
        eng.run()
    assert _dumps(eng) == ["retry_exhausted"]
    retries = [e for e in eng.recorder.events() if e["kind"] == "retry"]
    assert retries[-1]["exhausted"] is True
    assert retries[-1]["error"] == "InjectedDispatchError"
    assert reg.get("flight_recorder_dumps_total").labels(
        policy="continuous", reason="retry_exhausted").value == 1


def test_engine_watchdog_dumps_one_stall_and_stops(models):
    tm = models[1]
    reg = MetricsRegistry()
    eng = ServingEngine(tm, registry=reg, watchdog=3600.0, **GEOM)
    wd = eng._watchdog
    assert wd.is_alive
    assert wd.check_now(now=time.time() + 7200) is False   # idle
    eng.submit(Request(_PROMPTS[2], 5))
    eng.step()
    assert wd.check_now(now=time.time() + 7200) is True
    assert wd.check_now(now=time.time() + 9000) is False   # latched
    assert _dumps(eng) == ["stall"]
    assert reg.get("serving_watchdog_stalls_total").labels(
        component="continuous").value == 1
    eng.close()
    assert not wd.is_alive


def test_exporter_scrapes_a_live_engine(models):
    tm = models[1]
    reg = MetricsRegistry()
    eng = ServingEngine(tm, registry=reg, **GEOM)
    exp = tobs.MetricsExporter(registry=reg, port=0,
                               debug_sources=eng.debug_sources()).start()
    try:
        for p, n in zip(_PROMPTS, _NEW):
            eng.submit(Request(p, n, slo_class="batch"))
        eng.step()
        mid = json.loads(_get(exp.url + "/debug/requests")[2])
        eng.run()
        status, ctype, body = _get(exp.url + "/metrics")
        health = json.loads(_get(exp.url + "/healthz")[2])
        rec = json.loads(_get(exp.url + "/debug/flightrecorder")[2])
        slo = json.loads(_get(exp.url + "/debug/slo")[2])
    finally:
        exp.stop()
    text = body.decode()
    assert status == 200 and ctype.startswith("text/plain")
    for fam in ("span_seconds", "serving_queue_seconds",
                "flight_recorder_dumps_total", "serving_slo_attainment",
                "serving_last_step_unixtime", "serving_prefix_hits_total",
                "serving_kv_host_blocks"):
        assert fam in text, fam
    assert 'serving_slo_attainment{policy="continuous",slo_class="batch"}' \
        in text
    assert health["last_step_age_seconds"] is not None
    assert mid["n_tracked"] == len(_PROMPTS)
    assert rec["enabled"] and rec["recorded"] > 0
    assert slo["classes"]["batch"]["window_requests"] == len(_PROMPTS)


def test_profiler_shows_the_serving_spans(models):
    tm = models[1]
    eng = ServingEngine(tm, registry=MetricsRegistry(), **GEOM)
    for p, n in zip(_PROMPTS, _NEW):
        eng.submit(Request(p, n))
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            eng.step()
    eng.run()
    keys = {e.key for e in prof.key_averages()}
    assert {"serving.step", "serving.prefill", "serving.decode"} <= keys


def test_train_step_span_and_program_count():
    """``TrainStep`` runs under the ``train.step`` span and books its
    dispatches in ``CompileCacheMonitor("functionalize")``: a new input
    shape counts one trace, a repeated one none."""
    from paddle_tpu_torch.observability import get_registry
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.static import functionalize as tfn

    net = torch.nn.Linear(4, 2)
    step = tfn.build_train_step(
        net, lambda out, y: ((out - y) ** 2).mean(),
        AdamW(learning_rate=1e-2, parameters=net.parameters()))
    hist = get_registry().histogram(
        "span_seconds", labelnames=("name", "mesh")).labels(
            name="train.step", mesh="")
    n0, t0 = hist.count, tfn._mon.trace_counts().get("train_step", 0)
    for b in (3, 3, 5):
        loss = step(torch.ones(b, 4), torch.zeros(b, 2))
        assert torch.isfinite(loss)
    assert hist.count == n0 + 3
    assert tfn._mon.trace_counts()["train_step"] == t0 + 2
