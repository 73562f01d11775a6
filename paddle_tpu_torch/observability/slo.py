"""Sliding-window SLO attainment and burn-rate tracking for serving.

The port's own copy of ``paddle_tpu/observability/slo.py`` (stdlib-only;
the port imports nothing of the JAX package).

The production-telemetry formulation (vLLM/SGLang-style): an objective like
"interactive TTFT p95 < 500 ms" means "at least 95% of interactive requests
see TTFT <= 500 ms", so each retired request is scored good/bad against its
class's per-request thresholds and **attainment** is the good fraction over
a sliding window of the most recent retirements.  **Burn rate** is the
SRE error-budget view of the same number::

    burn_rate = (1 - attainment) / (1 - target)

1.0 = failing requests at exactly the budgeted rate (5% for a 0.95
target); 0 = every request in the window met its objectives; 20 = the
entire window failed a 0.95-target objective.  A router alerts on
burn_rate > 1 sustained, long before attainment visibly craters.

Request classes are threaded through ``Request(slo_class=...)`` (default
``"interactive"``) and must stay LOW-CARDINALITY — they label the
``serving_slo_attainment`` / ``serving_slo_burn_rate`` gauges, and
per-request identifiers in metric labels would grow the series without
bound.  A class with no configured objectives is tracked (window
counts) but trivially attains 1.0.

Fed from engine retirement (every terminal status; a request that never
produced a token fails any latency objective), host-side only — zero
device syncs.  stdlib-only, like every observability module.
"""
from __future__ import annotations

import threading
from collections import deque

__all__ = ["SLObjective", "SLOTracker", "DEFAULT_OBJECTIVES",
           "DEFAULT_SLO_CLASS"]

DEFAULT_SLO_CLASS = "interactive"


class SLObjective:
    """One request class's objective set.

    Thresholds are per-request: ``ttft`` / ``tpot`` / ``e2e`` in seconds
    (met when the request's value is <= the bound), ``min_tok_per_s`` as a
    per-request output-throughput floor (the batch-class objective).
    ``target`` is the attainment the class promises (0.95 = "p95"); it
    feeds the burn-rate denominator.  A request with no first token fails
    every latency objective — timeouts and sheds burn budget, as they
    should."""

    def __init__(self, name, ttft=None, tpot=None, e2e=None,
                 min_tok_per_s=None, target=0.95):
        self.name = str(name)
        self.ttft = None if ttft is None else float(ttft)
        self.tpot = None if tpot is None else float(tpot)
        self.e2e = None if e2e is None else float(e2e)
        self.min_tok_per_s = (None if min_tok_per_s is None
                              else float(min_tok_per_s))
        self.target = float(target)
        if not 0.0 < self.target < 1.0:
            raise ValueError("SLObjective target must be in (0, 1)")

    def met_by(self, request):
        """True when ``request`` meets every configured threshold."""
        if self.ttft is not None:
            v = request.ttft
            if v is None or v > self.ttft:
                return False
        if self.tpot is not None:
            v = request.tpot
            if v is None or v > self.tpot:
                return False
        if self.e2e is not None:
            v = request.latency
            if v is None or v > self.e2e:
                return False
        if self.min_tok_per_s is not None:
            lat = request.latency
            n = len(request.output_ids)
            if lat is None or lat <= 0.0 or n == 0 \
                    or n / lat < self.min_tok_per_s:
                return False
        return True

    def as_dict(self):
        d = {"target": self.target}
        for k in ("ttft", "tpot", "e2e", "min_tok_per_s"):
            v = getattr(self, k)
            if v is not None:
                d[k] = v
        return d


# sane defaults for the two canonical traffic classes; deployments pass
# their own tuple through ``ServingEngine(slo=...)``
DEFAULT_OBJECTIVES = (
    SLObjective("interactive", ttft=0.5, tpot=0.1),
    SLObjective("batch", min_tok_per_s=1.0, target=0.9),
)


class SLOTracker:
    """Sliding-window attainment/burn-rate over per-class objectives.

    ``objectives``: iterable of :class:`SLObjective` (default
    :data:`DEFAULT_OBJECTIVES`).  ``window``: retirements kept per class.
    ``registry``: a MetricsRegistry to export gauges into (None = pure
    in-memory tracking — the ``instrument=False`` engine path); children
    for every configured class are PRE-REGISTERED at construction
    (attainment 1.0, burn 0.0), so a first scrape before any traffic
    shows the full series set.  ``policy`` labels the gauges alongside
    ``slo_class`` so two engines sharing a registry stay separable.

    Thread-safe: ``observe`` comes from the engine thread, ``snapshot``
    / ``attainment`` / ``burn_rate`` from the scrape thread.
    """

    def __init__(self, objectives=None, window=256, registry=None,
                 policy=""):
        objs = (DEFAULT_OBJECTIVES if objectives is None
                else tuple(objectives))
        self._objectives = {o.name: o for o in objs}
        self._window = max(1, int(window))
        self._policy = policy
        self._lock = threading.Lock()
        self._wins = {name: deque(maxlen=self._window)
                      for name in self._objectives}
        self._att = self._burn = self._count = None
        if registry is not None:
            L = ("policy", "slo_class")
            self._att = registry.gauge(
                "serving_slo_attainment",
                "fraction of windowed requests meeting their class's SLO "
                "objectives (1.0 = all)", L)
            self._burn = registry.gauge(
                "serving_slo_burn_rate",
                "(1 - attainment) / (1 - target): error-budget burn; "
                "1.0 = failing at exactly the budgeted rate", L)
            self._count = registry.gauge(
                "serving_slo_window_requests",
                "retired requests currently in the class's sliding window",
                L)
            for name in self._objectives:
                self._att.labels(policy=policy, slo_class=name).set(1.0)
                self._burn.labels(policy=policy, slo_class=name).set(0.0)
                self._count.labels(policy=policy, slo_class=name).set(0)

    @property
    def window(self):
        return self._window

    def objectives(self):
        return dict(self._objectives)

    def _class_of(self, request):
        cls = getattr(request, "slo_class", None)
        return DEFAULT_SLO_CLASS if cls is None else str(cls)

    def observe(self, request):
        """Score one retired request against its class and refresh the
        class's gauges.  Classes outside the configured objective set are
        tracked with no thresholds (always good) — submission is not the
        place to crash on a typo'd class name."""
        cls = self._class_of(request)
        obj = self._objectives.get(cls)
        good = True if obj is None else obj.met_by(request)
        with self._lock:
            win = self._wins.get(cls)
            if win is None:
                win = self._wins[cls] = deque(maxlen=self._window)
            win.append(bool(good))
            n = len(win)
            att = sum(win) / n
        if self._att is not None:
            target = obj.target if obj is not None else 0.95
            self._att.labels(policy=self._policy, slo_class=cls).set(att)
            self._burn.labels(policy=self._policy, slo_class=cls).set(
                (1.0 - att) / (1.0 - target))
            self._count.labels(policy=self._policy, slo_class=cls).set(n)
        return good

    def attainment(self, cls):
        """Windowed attainment for ``cls`` (1.0 when the window is
        empty — no evidence of failure)."""
        with self._lock:
            win = self._wins.get(cls)
            if not win:
                return 1.0
            return sum(win) / len(win)

    def burn_rate(self, cls):
        obj = self._objectives.get(cls)
        target = obj.target if obj is not None else 0.95
        return (1.0 - self.attainment(cls)) / (1.0 - target)

    def snapshot(self):
        """JSON-ready state for the ``/debug/slo`` endpoint."""
        with self._lock:
            counts = {name: (len(win), sum(win))
                      for name, win in self._wins.items()}
        classes = {}
        for name, (n, good) in sorted(counts.items()):
            obj = self._objectives.get(name)
            att = (good / n) if n else 1.0
            target = obj.target if obj is not None else 0.95
            classes[name] = {
                "objectives": obj.as_dict() if obj is not None else {},
                "window_requests": n,
                "good": good,
                "attainment": att,
                "burn_rate": (1.0 - att) / (1.0 - target),
            }
        return {"window": self._window, "policy": self._policy,
                "classes": classes}
