"""Runtime deadlock watchdog (stdlib only).

The port's own copy of ``paddle_tpu/observability/watchdog.py`` (the port
imports nothing of the JAX package).  It watches for what no review can
see — a wedged C extension or CUDA call, a peer that stopped reading its
socket, a lock inversion smuggled in through dynamic dispatch.  A
:class:`DeadlockWatchdog` is a daemon thread that polls a *progress
probe* (a callable returning the unixtime of the last step-loop
progress, or ``None`` while the component is legitimately idle).  When
the probe goes stale past ``stall_after`` seconds it:

1. samples **every thread's stack** via ``sys._current_frames()`` and
   records one ``stall`` event per thread into the flight recorder
   (thread name + formatted stack ride in the event detail),
2. triggers ``recorder.auto_dump("stall")`` — the standard anomaly
   snapshot path, so stall dumps land next to timeout/poison dumps with
   the same JSONL shape and ``on_dump`` metrics hook, and
3. bumps ``serving_watchdog_stalls_total`` (labeled by component).

One dump per stall episode: the watchdog latches after tripping and
re-arms only when the probe reports fresh progress (or goes idle), so a
30-minute wedge produces one snapshot, not one per poll.

Wired into the serving engine (``watchdog=<seconds>``), which hands the
watchdog its notion of progress (``serving_last_step_unixtime``).
"""
from __future__ import annotations

import sys
import threading
import time
import traceback

__all__ = ["DeadlockWatchdog"]

# cap formatted stack depth per thread so a dump of a deeply recursed
# thread stays a bounded event detail, not a megabyte string
_MAX_FRAMES = 40


class DeadlockWatchdog:
    """Daemon thread dumping all thread stacks when progress stalls.

    Parameters
    ----------
    probe:
        ``() -> float | None`` — unixtime of the most recent progress of
        the watched loop, ``None`` (or ``<= 0``) while idle/healthy with
        nothing outstanding.  Must be cheap and thread-safe.
    stall_after:
        seconds of probe staleness that count as a stall.
    poll:
        seconds between checks (default ``stall_after / 4``, floored at
        10 ms).
    recorder:
        optional ``FlightRecorder`` receiving the per-thread ``stall``
        events and the ``auto_dump("stall")`` snapshot.
    registry:
        ``MetricsRegistry`` for ``serving_watchdog_stalls_total``
        (default: the process-wide registry).
    component:
        label value naming the watched loop (``engine`` / ``fleet`` /
        worker id).
    """

    def __init__(self, probe, stall_after=30.0, poll=None, recorder=None,
                 registry=None, component="engine"):
        if stall_after <= 0:
            raise ValueError(f"stall_after must be > 0, got {stall_after}")
        self._probe = probe
        self._stall_after = float(stall_after)
        self._poll = max(0.01, float(poll) if poll is not None
                         else stall_after / 4.0)
        self._recorder = recorder
        self.component = component
        if registry is None:
            from paddle_tpu_torch.observability.metrics import get_registry
            registry = get_registry()
        # pre-bound so a scrape sees the zero-valued series before any
        # stall — the registry convention every serving series follows
        self._stalls_metric = registry.counter(
            "serving_watchdog_stalls_total",
            "progress stalls detected by the deadlock watchdog (each "
            "bump has a matching flight-recorder `stall` dump)",
            ("component",)).labels(component=component)
        self.stalls = 0           # local count, mirrors the counter
        self._tripped_at = None   # probe value at the last trip (latch)
        self._stop = threading.Event()
        self._thread = None

    # ------------------------------------------------------------- control
    def start(self):
        """Start the daemon poll thread (idempotent)."""
        if self._thread is not None and self._thread.is_alive():
            return self
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name=f"{self.component}-watchdog",
            daemon=True)
        self._thread.start()
        return self

    def stop(self, timeout=2.0):
        """Stop and join the poll thread (idempotent)."""
        self._stop.set()
        t = self._thread
        if t is not None and t.is_alive() and \
                t is not threading.current_thread():
            t.join(timeout=timeout)
        self._thread = None

    @property
    def is_alive(self):
        return self._thread is not None and self._thread.is_alive()

    def _run(self):
        while not self._stop.wait(self._poll):
            try:
                self.check_now()
            except Exception:  # pragma: no cover - must never kill poll
                pass

    # -------------------------------------------------------------- checks
    def check_now(self, now=None):
        """One synchronous staleness check; returns True when this call
        tripped a new stall dump.  Public so thread-less loops can run
        the watchdog inline at their own cadence."""
        t = self._probe()
        if t is None or t <= 0:
            self._tripped_at = None  # idle: healthy, re-arm
            return False
        if self._tripped_at is not None:
            if t > self._tripped_at:
                self._tripped_at = None  # progress resumed: re-arm
            else:
                return False             # same stall episode: latched
        now = time.time() if now is None else now
        age = now - t
        if age < self._stall_after:
            return False
        self._tripped_at = t
        self._dump(age)
        return True

    def _dump(self, age):
        t = self._thread
        stacks = self.sample_stacks(
            skip_ident=t.ident if t is not None else None)
        if self._recorder is not None:
            for name, ident, stack in stacks:
                self._recorder.record(
                    "stall", seconds=round(age, 3), thread=name,
                    ident=ident, stack=stack, component=self.component)
            self._recorder.auto_dump("stall")
        self.stalls += 1
        self._stalls_metric.inc()

    @staticmethod
    def sample_stacks(skip_ident=None):
        """``[(thread_name, ident, formatted_stack)]`` for every live
        python thread; ``skip_ident`` drops one thread (the watchdog's
        own poll thread — its stack is just the poll loop)."""
        names = {t.ident: t.name for t in threading.enumerate()}
        out = []
        for ident, frame in sorted(sys._current_frames().items()):
            if ident == skip_ident:
                continue
            stack = "".join(traceback.format_stack(frame, _MAX_FRAMES))
            out.append((names.get(ident, f"thread-{ident}"), ident, stack))
        return out
