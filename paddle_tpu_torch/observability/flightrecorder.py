"""Engine flight recorder: an always-on bounded ring of lifecycle events.

The port's own copy of ``paddle_tpu/observability/flightrecorder.py``
(stdlib-only; the port imports nothing of the JAX package), with the
same event vocabulary, dump formats and auto-dump reasons.

The aggregate metrics (observability/metrics.py) answer "how fast is the
engine"; the five terminal statuses of the reliability layer
created questions they cannot answer — *why* did request 17 time out, what
was in flight when slot 3 got poisoned, how many retries preceded the
exhaustion?  This module is the postmortem half of the request-scoped
observability layer:

* :class:`FlightRecorder` — a thread-safe bounded ring buffer of structured
  engine events (``submit``, ``admit``, ``prefill_chunk``, ``dispatch``,
  ``retry``, ``drain``, ``stall``, ``cancel``, ``shed``, ``poison``,
  ``retire``), each carrying a monotonic ``perf_counter_ns`` timestamp, the
  scheduler step index, rid, slot and the engine's scheduling policy.
  Recording is host-side bookkeeping only (one lock + one deque append per
  event): zero device syncs, zero retraces, and token outputs are
  byte-identical recorder-on vs recorder-off (tested).  When the ring is
  full the OLDEST event is evicted (``dropped`` counts them) — memory stays
  bounded no matter how long the engine runs.
* **Dumps** — the ring serializes as JSONL (one event object per line,
  log-shipping friendly) and as a chrome trace with ONE TRACK PER RID
  (``tid`` = rid, built by trace.py's ``chrome_event`` in the reference
  profiler's event shape), so a
  request's lifecycle reads as a horizontal lane in ``chrome://tracing``.
* **Anomaly auto-dump** — the engine calls :meth:`auto_dump` when a request
  retires ``timed_out``/``poisoned`` or a bounded dispatch retry exhausts:
  the last ``dump_last`` events are snapshotted into ``.dumps`` (bounded)
  and written as a JSONL file when ``dump_dir`` is set, and the engine's
  ``flight_recorder_dumps_total{reason}`` counter is bumped through the
  ``on_dump`` hook.

:class:`RequestTrace` is the per-request sibling: the rid-keyed record of
lifecycle transitions (``queued`` → ``prefilling`` (chunk k) → ``decoding``
→ terminal status) the engine maintains for every submitted request and
exposes as ``Request.timeline()``; its :meth:`~RequestTrace.durations`
feed the ``serving_queue_seconds`` / ``serving_prefill_seconds`` /
``serving_decode_seconds`` phase histograms at retirement.

stdlib-only, like every observability module.
"""
from __future__ import annotations

import collections
import json
import os
import threading
import time

__all__ = ["EVENT_KINDS", "DUMP_REASONS", "FlightRecorder", "RequestTrace",
           "TERMINAL_PHASES"]

# the structured event vocabulary — every engine lifecycle edge has a kind
EVENT_KINDS = ("submit", "admit", "prefill_chunk", "dispatch", "retry",
               "drain", "stall", "cancel", "shed", "poison", "retire",
               # tiered KV cache: eviction-time demotion into the host
               # store, admission-time restore out of it, the store's own
               # budget evictions, validation failures, injected damage
               "demote", "restore", "host_evict", "host_error",
               "host_corrupt")

# anomaly-dump triggers (the `reason` label of flight_recorder_dumps_total)
DUMP_REASONS = ("timed_out", "poisoned", "retry_exhausted", "stall")

# terminal request phases, mirroring Request.status
TERMINAL_PHASES = ("done", "timed_out", "cancelled", "poisoned", "shed")

_CHROME_CAT = "FlightRecorder"


class FlightRecorder:
    """Bounded ring of engine lifecycle events (module docstring).

    ``capacity``: ring size in events (oldest evicted beyond it).
    ``policy``: the owning engine's scheduling policy, stamped on every
    serialized event.  ``dump_dir``: when set, :meth:`auto_dump` also
    writes the snapshot as a JSONL file there (``None`` keeps dumps
    in-memory only).  ``dump_last``: events per anomaly snapshot.
    ``on_dump``: optional ``fn(reason)`` hook fired after every auto-dump
    — the engine wires it to the ``flight_recorder_dumps_total{reason}``
    counter.
    """

    def __init__(self, capacity=4096, policy="", dump_dir=None,
                 dump_last=256, on_dump=None):
        if int(capacity) < 1:
            raise ValueError("FlightRecorder capacity must be >= 1")
        self._ring = collections.deque(maxlen=int(capacity))
        self._lock = threading.Lock()
        self.policy = policy
        self.dump_dir = dump_dir
        self.dump_last = max(1, int(dump_last))
        self.on_dump = on_dump
        self.dropped = 0          # events evicted by ring overflow
        self.dumps = []           # bounded list of auto-dump records
        self._dump_seq = 0

    @property
    def capacity(self):
        return self._ring.maxlen

    def __len__(self):
        with self._lock:
            return len(self._ring)

    # ------------------------------------------------------------ recording
    def record(self, kind, step=-1, rid=None, slot=None, **detail):
        """Append one event.  ``detail`` keyword pairs ride along verbatim
        (``status=`` for retire, ``chunk=`` for prefill_chunk, ``seconds=``
        for stall, ...).  Host bookkeeping only — never touches a device
        value."""
        ev = (time.perf_counter_ns(), int(step), kind, rid, slot,
              detail or None)
        with self._lock:
            if len(self._ring) == self._ring.maxlen:
                self.dropped += 1
            self._ring.append(ev)

    def _as_dict(self, ev):
        t_ns, step, kind, rid, slot, detail = ev
        d = {"t_ns": t_ns, "step": step, "kind": kind, "rid": rid,
             "slot": slot, "policy": self.policy}
        if detail:
            d.update(detail)
        return d

    def events(self, last=None):
        """The recorded events (oldest first) as dicts; ``last`` keeps only
        the newest N.  Thread-safe snapshot — safe to call from the scrape
        thread while the engine records."""
        with self._lock:
            evs = list(self._ring)
        if last is not None:
            evs = evs[-int(last):]
        return [self._as_dict(e) for e in evs]

    # -------------------------------------------------------------- dumping
    def to_jsonl(self, last=None):
        """One JSON object per line, oldest first."""
        return "".join(
            json.dumps(d, sort_keys=True, default=str) + "\n"
            for d in self.events(last))

    def dump_jsonl(self, path, last=None):
        with open(path, "w", encoding="utf-8") as f:
            f.write(self.to_jsonl(last))
        return path

    def chrome_trace(self, last=None):
        """The ring as a chrome-trace dict: ``{"traceEvents": [...],
        "displayTimeUnit": "ms"}``, ONE TRACK PER RID (``tid`` = the rid's
        discovery order; batch-scoped events — dispatch/drain/stall with no
        rid — share track 0).  Events are instants unless they carry a
        ``seconds`` detail (stalls), which becomes the slice duration.
        Event dicts come from trace.py's ``chrome_event`` (the reference
        profiler's event shape), so the dump loads like the reference's."""
        from paddle_tpu_torch.observability.trace import chrome_event
        tids = {}
        out = []
        for d in self.events(last):
            rid = d.get("rid")
            tid = 0 if rid is None else tids.setdefault(rid, len(tids) + 1)
            dur_ns = int(float(d.get("seconds", 0.0)) * 1e9)
            args = {k: v for k, v in d.items() if k not in ("t_ns", "kind")}
            out.append(chrome_event(
                d["kind"], d["t_ns"], d["t_ns"] + dur_ns, tid=tid,
                event_type=_CHROME_CAT, args=args))
        return {"traceEvents": out, "displayTimeUnit": "ms"}

    def dump_chrome_trace(self, path, last=None):
        with open(path, "w", encoding="utf-8") as f:
            json.dump(self.chrome_trace(last), f, default=str)
        return path

    def auto_dump(self, reason):
        """Anomaly snapshot: capture the last ``dump_last`` events, keep
        the record on ``.dumps`` (bounded to the 16 most recent), write it
        as JSONL under ``dump_dir`` when configured, and fire the
        ``on_dump`` hook.  Returns the dump record ``{"reason", "path",
        "events"}``."""
        evs = self.events(self.dump_last)
        path = None
        if self.dump_dir is not None:
            with self._lock:
                self._dump_seq += 1
                seq = self._dump_seq
            os.makedirs(self.dump_dir, exist_ok=True)
            path = os.path.join(
                self.dump_dir,
                f"flightrec_{os.getpid()}_{seq:04d}_{reason}.jsonl")
            with open(path, "w", encoding="utf-8") as f:
                for d in evs:
                    f.write(json.dumps(d, sort_keys=True, default=str)
                            + "\n")
        rec = {"reason": reason, "path": path, "events": evs}
        with self._lock:
            self.dumps.append(rec)
            del self.dumps[:-16]
        if self.on_dump is not None:
            self.on_dump(reason)
        return rec

    # ------------------------------------------------------------- snapshot
    def snapshot(self, last=256):
        """JSON-ready state for the ``/debug/flightrecorder`` endpoint:
        ring stats, dump records (events elided to a count), and the newest
        ``last`` events."""
        with self._lock:
            recorded = len(self._ring)
            dropped = self.dropped
            dumps = [{"reason": d["reason"], "path": d["path"],
                      "n_events": len(d["events"])} for d in self.dumps]
        return {"capacity": self.capacity, "recorded": recorded,
                "dropped": dropped, "policy": self.policy,
                "dumps": dumps, "events": self.events(last)}


class RequestTrace:
    """Rid-keyed lifecycle record: ordered ``(t, phase, detail)``
    transitions through ``queued`` → ``prefilling`` (one mark per chunk,
    carrying ``chunk=k``) → ``decoding`` → one of
    :data:`TERMINAL_PHASES`.  ``t`` is ``time.perf_counter()`` — the same
    clock as ``Request.t_submit/t_first/t_done``, so the two records
    cross-reference directly.  Appends come from the single engine thread;
    reads (``/debug/requests``, ``Request.timeline()``) snapshot the list
    first, so concurrent scrapes are safe."""

    __slots__ = ("rid", "transitions")

    def __init__(self, rid):
        self.rid = rid
        self.transitions = []

    def mark(self, phase, **detail):
        self.transitions.append((time.perf_counter(), phase, detail or None))

    @property
    def phase(self):
        """The current (latest) phase, or None before submit."""
        ts = list(self.transitions)
        return ts[-1][1] if ts else None

    def first_at(self, phase):
        """Timestamp of the FIRST transition into ``phase`` (None if the
        request never reached it)."""
        for t, p, _ in list(self.transitions):
            if p == phase:
                return t
        return None

    def as_dicts(self):
        """``[{"t": ..., "phase": ..., **detail}, ...]`` — the
        ``Request.timeline()`` payload."""
        return [{"t": t, "phase": p, **(d or {})}
                for t, p, d in list(self.transitions)]

    def durations(self):
        """Phase durations in seconds, keyed ``queue`` / ``prefill`` /
        ``decode`` — each present only when both its endpoints were
        reached.  ``queue`` ends at admission (first ``prefilling`` mark),
        ``prefill`` at the first token (``decoding``), ``decode`` at the
        terminal transition.  A request retired while still queued
        reports only ``queue`` (submit → terminal)."""
        ts = list(self.transitions)
        t_q = next((t for t, p, _ in ts if p == "queued"), None)
        t_p = next((t for t, p, _ in ts if p == "prefilling"), None)
        t_d = next((t for t, p, _ in ts if p == "decoding"), None)
        t_end = next((t for t, p, _ in ts if p in TERMINAL_PHASES), None)
        out = {}
        if t_q is not None:
            if t_p is not None:
                out["queue"] = t_p - t_q
            elif t_end is not None:
                out["queue"] = t_end - t_q
        if t_p is not None:
            if t_d is not None:
                out["prefill"] = t_d - t_p
            elif t_end is not None:
                out["prefill"] = t_end - t_p
        if t_d is not None and t_end is not None:
            out["decode"] = t_end - t_d
        return out
