"""Program-cache visibility: hit/miss counters per program.

Counterpart of ``paddle_tpu/observability/compilecache.py``, with the same
series (``compile_cache_hits_total``, ``compile_cache_misses_total``,
``compile_seconds``, labeled ``cache`` / ``program``) and the same
``trace_counts()``.  The reference counted a trace each time ``jax.jit``
missed its cache: a new static-argument / shape signature cost a trace
and a compile on the dispatch path.  Eager PyTorch never traces, so here
a "trace" is the first dispatch of a signature that ``jax.jit`` would
have keyed on — the program name's static arguments (the ``ProgramKey``,
``cfg``, the chunk width) and its operands' shapes, such as the prompt
bucket of ``serving_prefill_slot`` — and every later dispatch of it is a
hit.  ``dispatch(program, signature)`` books one dispatch; host-side
memo caches use ``hit()`` / ``miss()``.
"""
from __future__ import annotations

import weakref

from paddle_tpu_torch.observability.metrics import get_registry

__all__ = ["CompileCacheMonitor", "all_monitors"]

_LABELS = ("cache", "program")

# every live monitor, weakly held
_MONITORS = weakref.WeakSet()


def all_monitors():
    """Snapshot list of every live CompileCacheMonitor in the process."""
    return list(_MONITORS)


class CompileCacheMonitor:
    def __init__(self, cache, registry=None):
        reg = registry if registry is not None else get_registry()
        self.cache = cache
        _MONITORS.add(self)
        self._hits = reg.counter(
            "compile_cache_hits_total",
            "dispatches served by an already-compiled program",
            labelnames=_LABELS)
        self._misses = reg.counter(
            "compile_cache_misses_total",
            "dispatches that traced + compiled a new program "
            "(or rebuilt a host-side cache entry)", labelnames=_LABELS)
        self._seconds = reg.histogram(
            "compile_seconds", "wall seconds of dispatches that compiled",
            labelnames=_LABELS)
        self._trace_counts = {}
        self._seen = set()

    def dispatch(self, program, signature):
        """Book one dispatch of ``program`` at ``signature`` (a hashable
        tuple of what ``jax.jit`` keys on): the first sight of the pair
        counts a trace and a miss, every later one a hit.  Returns True
        on a miss."""
        key = (program, signature)
        if key in self._seen:
            self.hit(program)
            return False
        self._seen.add(key)
        self.mark_trace(program)
        self.miss(program)
        return True

    def mark_trace(self, program):
        """Count one trace (one new signature) of ``program``."""
        self._trace_counts[program] = self._trace_counts.get(program, 0) + 1

    def trace_counts(self):
        """Copy of the per-program trace counts."""
        return dict(self._trace_counts)

    # -------------------------------------------- host-side memo caches
    def hit(self, program):
        self._hits.labels(cache=self.cache, program=program).inc()

    def miss(self, program, seconds=None):
        self._misses.labels(cache=self.cache, program=program).inc()
        if seconds is not None:
            self._seconds.labels(cache=self.cache,
                                 program=program).observe(seconds)
