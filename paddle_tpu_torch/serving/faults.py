"""Deterministic fault injection for the serving engine.

The port's own copy of ``paddle_tpu/serving/faults.py`` (a stdlib-only
module; the port imports nothing of the JAX package).  A ``FaultPlan``
is a seeded, declarative schedule of failures threaded through the
engine's test-only seams (``ServingEngine(faults=...)``):

* **dispatch errors** — ``maybe_dispatch_error`` raises
  ``InjectedDispatchError`` at the engine's dispatch/drain fault points
  (``dispatch_error_steps``: exact scheduler-step indices;
  ``dispatch_error_rate``: a seeded per-step Bernoulli draw).  Each
  chosen step fails ``dispatch_error_attempts`` consecutive attempts
  (default 1) and then succeeds, so the bounded retry runs end to end;
  an attempt count past the engine's ``retry_attempts`` proves retry
  exhaustion.  The error fires BEFORE the dispatch launches anything, so
  a retried attempt re-issues the same kernels on unchanged caches.
* **poison payloads** — ``poison`` maps ``rid -> step``: from that
  scheduler step on, the engine overwrites one KV row of the request's
  slot with NaN (between steps).  Per-row attention isolation confines
  the damage to that slot; the finite-logits flag then quarantines it
  with terminal status ``poisoned``.
* **slow steps** — ``slow_steps`` maps ``step -> seconds``:
  ``maybe_slow_step`` blocks the host that long at the top of the step
  (deadline pressure without touching device work).
* **stream_cb crashes** — ``cb_crash_steps``: ``maybe_crash_stream_cb``
  raises ``InjectedStreamCbError`` inside the engine's emission callback
  guard, proving a crashing user callback is counted and survived.
* **host-tier corruption** — ``host_tier_corrupt`` maps ``step ->
  chain``: at that scheduler step the host KV tier's entries along the
  chain's token ids are damaged (``None`` or ``"*"``: every stored
  entry; a ``(tokens, mode)`` pair picks ``"truncate"`` or
  ``"garble"``).  The next restore must reject the damage and fall back
  to suffix prefill.  Without a host tier the plan injects nothing.
* **worker deaths** (``worker_kill``) keep the reference's fields and
  draws; their consumer, the fleet, is not in the port.

``stats`` counts every fault actually fired, so a test can assert the
plan executed.  Determinism: the only randomness is
``random.Random(seed)`` consumed in engine-step order — two runs of the
same workload against the same plan inject identically.
"""
from __future__ import annotations

import random
import time

__all__ = ["FaultPlan", "InjectedDispatchError", "InjectedStreamCbError"]


class InjectedDispatchError(RuntimeError):
    """Stands in for a transient device error at a dispatch/drain fault
    point — retryable by design."""


class InjectedStreamCbError(RuntimeError):
    """Raised inside ``stream_cb`` delivery to simulate a crashing user
    callback."""


class FaultPlan:
    """Seeded schedule of injected failures (module docstring)."""

    def __init__(self, seed=0, dispatch_error_steps=(),
                 dispatch_error_rate=0.0, dispatch_error_attempts=1,
                 poison=None, slow_steps=None, cb_crash_steps=(),
                 worker_kill=None, host_tier_corrupt=None):
        self.seed = int(seed)
        self._rng = random.Random(self.seed)
        self.dispatch_error_steps = set(dispatch_error_steps)
        self.dispatch_error_rate = float(dispatch_error_rate)
        self.dispatch_error_attempts = max(1, int(dispatch_error_attempts))
        self.poison = dict(poison or {})            # rid -> step index
        self.slow_steps = dict(slow_steps or {})    # step index -> seconds
        self.cb_crash_steps = set(cb_crash_steps)
        self.worker_kill = dict(worker_kill or {})  # step -> name(s)
        # step -> chain: token ids, None/"*" (= every entry), or a
        # (tokens, mode) pair naming "truncate" / "garble"
        self.host_tier_corrupt = dict(host_tier_corrupt or {})
        self._killed_steps = set()
        self._corrupted_steps = set()
        self._poisoned = set()
        self._rate_drawn = {}                       # step -> bool (memoized)
        self._fired = {}                            # step -> errors raised
        self.stats = {"dispatch_errors": 0, "poisoned": 0,
                      "slow_steps": 0, "cb_crashes": 0,
                      "worker_kills": 0, "host_corrupts": 0}

    # ------------------------------------------------------- dispatch faults
    def _step_faulty(self, step):
        if step in self.dispatch_error_steps:
            return True
        if self.dispatch_error_rate <= 0.0:
            return False
        # memoize the draw per step: the engine probes the same step from
        # both its dispatch and drain fault points, and a retry must see
        # the same verdict for its attempt accounting to mean anything
        drawn = self._rate_drawn.get(step)
        if drawn is None:
            drawn = self._rng.random() < self.dispatch_error_rate
            self._rate_drawn[step] = drawn
        return drawn

    def maybe_dispatch_error(self, kind, step, attempt):
        """Raise ``InjectedDispatchError`` when ``step`` is scheduled to
        fail and fewer than ``dispatch_error_attempts`` errors have been
        raised for it so far.  The budget is per STEP, not per fault
        point: the engine probes several seams per step (flush / dispatch
        / drain), and a step scheduled for one transient fault should
        fail exactly once, at the first seam that asks.  ``kind`` labels
        the seam ("dispatch" / "drain") in the error message."""
        if not self._step_faulty(step):
            return
        n = self._fired.get(step, 0)
        if n >= self.dispatch_error_attempts:
            return
        self._fired[step] = n + 1
        self.stats["dispatch_errors"] += 1
        raise InjectedDispatchError(
            f"injected {kind} fault at step {step} (attempt {attempt})")

    # --------------------------------------------------------- poison faults
    def poison_due(self, rid, step):
        """True when ``rid`` is scheduled for poisoning at or before
        ``step`` and has not been injected yet (the engine defers
        injection until the slot has cache rows to corrupt)."""
        due = self.poison.get(rid)
        return (due is not None and step >= due
                and rid not in self._poisoned)

    def mark_poisoned(self, rid):
        self._poisoned.add(rid)
        self.stats["poisoned"] += 1

    # ----------------------------------------------------------- slow steps
    def maybe_slow_step(self, step):
        """Block the host for the step's scheduled stall, if any.  Returns
        the seconds actually slept (0.0 when the step is clean) so the
        engine can attribute the injected stall in its flight recorder."""
        s = self.slow_steps.get(step)
        if not s:
            return 0.0
        self.stats["slow_steps"] += 1
        time.sleep(float(s))
        return float(s)

    # --------------------------------------------------------- worker deaths
    def worker_kills_due(self, step):
        """Worker names scheduled to die at or before ``step`` that have
        not fired yet (fires once per scheduled step).  The at-or-before
        semantics mean a kill scheduled for a step the driver skipped
        (e.g. the coordinator quiesced early) still lands on the next
        probe instead of silently never firing."""
        names = []
        for due in sorted(self.worker_kill):
            if due > step or due in self._killed_steps:
                continue
            self._killed_steps.add(due)
            victim = self.worker_kill[due]
            if isinstance(victim, (list, tuple, set)):
                names.extend(victim)
            else:
                names.append(victim)
        self.stats["worker_kills"] += len(names)
        return names

    # ------------------------------------------------- host-tier corruption
    def host_corrupts_due(self, step):
        """Damage payloads scheduled at or before ``step`` that have not
        fired yet, as ``(tokens, mode)`` pairs (``tokens`` None = every
        stored entry; mode defaults to "truncate").  Same at-or-before,
        fire-once semantics as ``worker_kills_due`` — a payload scheduled
        for a skipped step lands on the next probe."""
        out = []
        for due in sorted(self.host_tier_corrupt):
            if due > step or due in self._corrupted_steps:
                continue
            self._corrupted_steps.add(due)
            chain, mode = self.host_tier_corrupt[due], "truncate"
            if (isinstance(chain, tuple) and len(chain) == 2
                    and isinstance(chain[1], str)
                    and chain[1] in ("truncate", "garble")):
                chain, mode = chain
            if isinstance(chain, str) and chain == "*":
                chain = None
            out.append((chain, mode))
        self.stats["host_corrupts"] += len(out)
        return out

    # -------------------------------------------------------- introspection
    def snapshot(self):
        """JSON-ready plan summary for the engine's ``/debug/*`` views:
        the configured schedule plus the fire counts — a postmortem reader
        sees WHAT was injected next to the events it caused."""
        return {
            "seed": self.seed,
            "dispatch_error_steps": sorted(self.dispatch_error_steps),
            "dispatch_error_rate": self.dispatch_error_rate,
            "dispatch_error_attempts": self.dispatch_error_attempts,
            "poison": dict(self.poison),
            "slow_steps": dict(self.slow_steps),
            "cb_crash_steps": sorted(self.cb_crash_steps),
            "worker_kill": {
                int(k): (sorted(v) if isinstance(v, (list, tuple, set))
                         else v)
                for k, v in self.worker_kill.items()},
            "host_tier_corrupt": {
                int(k): ("*" if v is None or (isinstance(v, str)
                                              and v == "*") else "chain")
                for k, v in self.host_tier_corrupt.items()},
            "stats": dict(self.stats),
        }

    # ------------------------------------------------------ stream_cb faults
    def maybe_crash_stream_cb(self, step):
        if step in self.cb_crash_steps:
            self.stats["cb_crashes"] += 1
            raise InjectedStreamCbError(
                f"injected stream_cb crash at step {step}")
