"""paddle_tpu_torch.observability — the port's telemetry, stdlib-only.

Counterpart of ``paddle_tpu/observability`` with the same names (the port
keeps its own copy of each module: the JAX package's ``__init__`` imports
jax):

* :mod:`~paddle_tpu_torch.observability.metrics` — the thread-safe
  ``MetricsRegistry`` of labeled Counter / Gauge / Histogram series, with
  Prometheus-text and JSON export.
* :mod:`~paddle_tpu_torch.observability.exporter` — the opt-in background
  ``http.server`` thread serving ``/metrics``, ``/healthz`` and
  ``/debug/*`` (``PADDLE_TPU_METRICS_PORT`` or
  ``MetricsExporter(port=...)``).
* :mod:`~paddle_tpu_torch.observability.trace` — ``span()``, recording into
  the registry and, while a ``torch.profiler`` session records, into its
  trace.
* :mod:`~paddle_tpu_torch.observability.compilecache` —
  ``CompileCacheMonitor``: first dispatches of a program signature.

Lazy exports (loaded on first attribute access): ``FlightRecorder`` and
``RequestTrace`` (the engine-event ring and per-request timelines),
``SLObjective`` / ``SLOTracker`` / ``DEFAULT_OBJECTIVES`` (windowed SLO
attainment and burn rate) and ``DeadlockWatchdog``.
"""
import importlib

from paddle_tpu_torch.observability.compilecache import CompileCacheMonitor
from paddle_tpu_torch.observability.exporter import (
    MetricsExporter, start_default_exporter, stop_default_exporter,
)
from paddle_tpu_torch.observability.metrics import (
    Counter, DEFAULT_LATENCY_BUCKETS, Gauge, Histogram, MetricsRegistry,
    get_registry,
)
from paddle_tpu_torch.observability.trace import span

# name -> defining module, resolved on first access (PEP 562)
_LAZY = {
    "DeadlockWatchdog": "paddle_tpu_torch.observability.watchdog",
    "FlightRecorder": "paddle_tpu_torch.observability.flightrecorder",
    "RequestTrace": "paddle_tpu_torch.observability.flightrecorder",
    "SLObjective": "paddle_tpu_torch.observability.slo",
    "SLOTracker": "paddle_tpu_torch.observability.slo",
    "DEFAULT_OBJECTIVES": "paddle_tpu_torch.observability.slo",
}

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "get_registry",
    "DEFAULT_LATENCY_BUCKETS", "MetricsExporter", "start_default_exporter",
    "stop_default_exporter", "span", "CompileCacheMonitor",
] + sorted(_LAZY)


def __getattr__(name):
    mod = _LAZY.get(name)
    if mod is None:
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r}")
    value = getattr(importlib.import_module(mod), name)
    globals()[name] = value   # cache: next access skips __getattr__
    return value


def __dir__():
    return sorted(set(globals()) | set(__all__))
