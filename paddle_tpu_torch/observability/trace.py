"""Span tracing: one primitive feeding both telemetry sinks.

Counterpart of ``paddle_tpu/observability/trace.py``.
``span("serving.step")`` is a context manager *and* a decorator.  On exit
it observes the wall duration into the registry histogram
``span_seconds{name, mesh}`` (always — metrics are the production sink).
Where the reference forwarded the interval to its profiler's host
tracer, the port's span enters ``torch.profiler.record_function(name)``
for its duration while a ``torch.profiler.profile`` session is
recording, so framework spans appear in that session's trace and
``key_averages()`` beside the operators they enclose.  With no profiler
recording a span is two clock reads and one histogram observe: it makes
no CUDA call and no device sync either way.

``chrome_event`` builds the reference profiler's chrome-trace event dict
key for key (``name``, ``ts``, ``dur``, ``ph``, ``pid``, ``tid``, ``cat``
and an optional ``args``); the flight recorder's one-track-per-rid dump
is made of them.  ``torch`` is imported lazily (on the first span exit
that finds a profiler), so this module stays stdlib-only at import.
"""
from __future__ import annotations

import functools
import os
import sys
import threading
import time

from paddle_tpu_torch.observability.metrics import get_registry

__all__ = ["span", "span_histogram", "chrome_event"]

SPAN_EVENT_TYPE = "Span"


def chrome_event(name, start_ns, end_ns, *, tid, event_type=SPAN_EVENT_TYPE,
                 args=None):
    """One chrome-trace complete event (``ph`` "X") in the reference
    profiler's shape: microsecond ``ts`` / ``dur`` from the
    ``perf_counter_ns`` interval, this process's ``pid``, the given
    ``tid``, ``cat`` = ``event_type``, and ``args`` when given."""
    ev = {"name": name, "ts": start_ns / 1000.0,
          "dur": (end_ns - start_ns) / 1000.0, "ph": "X",
          "pid": os.getpid(), "tid": tid, "cat": event_type}
    if args:
        ev["args"] = args
    return ev


def span_histogram(registry=None):
    """The ``span_seconds`` histogram family in ``registry``, labeled
    ``{name, mesh}``: ``mesh`` is "" for ordinary host spans and the
    device count for spans around a tensor-parallel engine's dispatches,
    so a single-device engine and its TP twin stay separable."""
    reg = registry if registry is not None else get_registry()
    return reg.histogram(
        "span_seconds", "wall seconds spent inside observability spans",
        labelnames=("name", "mesh"))


def _profiler_record(name):
    """An entered ``torch.profiler.record_function(name)`` when a torch
    profiler session is recording, else None.  Without ``torch`` loaded
    there is no session to record into."""
    torch = sys.modules.get("torch")
    if torch is None or not torch._C._autograd._profiler_enabled():
        return None
    rf = torch.profiler.record_function(name)
    rf.__enter__()
    return rf


class span:
    """``with span("name"): ...`` or ``@span("name")``.

    One instance is reusable and re-entrant: the start stamps live on a
    thread-local stack, so a cached ``span`` (the instrumentation sites
    hold them to skip the registry lookup per iteration) nests with
    itself and across threads."""

    def __init__(self, name, registry=None, event_type=SPAN_EVENT_TYPE,
                 mesh=""):
        self.name = name
        self.event_type = event_type
        self._hist = span_histogram(registry).labels(name=name, mesh=mesh)
        self._local = threading.local()

    def __enter__(self):
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        stack.append((time.perf_counter_ns(), _profiler_record(self.name)))
        return self

    def __exit__(self, *exc):
        end_ns = time.perf_counter_ns()
        stack = getattr(self._local, "stack", None)
        if not stack:
            return False
        start_ns, rf = stack.pop()
        if rf is not None:
            rf.__exit__(None, None, None)
        self._hist.observe((end_ns - start_ns) / 1e9)
        return False

    def __call__(self, fn):
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            with self:
                return fn(*args, **kwargs)
        return wrapped
