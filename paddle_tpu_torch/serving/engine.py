"""Continuous-batching serving engine on the ragged decode path.

Counterpart of ``paddle_tpu/serving/engine.py`` (greedy mode).  A
fixed-batch-B decode step runs on the device while a host-side
scheduler retires finished slots (EOS / max_new_tokens) and admits
queued requests into them between steps:

* **Chunked prefill with a budget** (``prefill_chunk``,
  ``prefill_budget``): an admitted prompt is processed in ``[1, P]``
  chunks written straight into the slot's rows of the batch cache, at
  most ``prefill_budget`` chunks per scheduler step, so a long prompt
  never stalls resident decode for its whole prefill.  The final
  chunk's first token stays on the device and feeds the slot's first
  decode dispatch.
* **Dense or paged KV** (``kv_block``): the paged geometry budgets
  admission in tokens (``max_live_tokens``), adopts identical prompt
  prefixes from a radix cache instead of re-prefilling them, and evicts
  refcount-0 cached blocks LRU-first (``serving/kv_cache.py``).
* ``policy="gang"`` admits only when every slot is free (the
  run-to-completion baseline, same device steps).
* **Pipelined dispatch** (``pipeline=True``): step N+1 depends only on
  device-resident state (the carried ``cur`` tokens and the caches), so
  it is issued BEFORE step N's tokens are read.  Each dispatch enqueues
  a non-blocking copy of its outputs into pinned host memory and records
  an event right behind it; ``_host_fetch`` — the one place the engine
  waits for the device — waits on that event only, so the drain of step
  N overlaps step N+1 on the card.  All device work stays on one stream,
  which keeps the reference's one-step-late retirement invariant: a
  retired slot is parked at ``lmax`` from the NEXT dispatch on (its
  writes drop), re-admission prefills run after the stale step in
  stream order, and the drain discards tokens whose slot no longer holds
  the same Request.  ``pipeline=False`` is the synchronous baseline with
  byte-identical token streams.

The caches are updated in place by every dispatch; the engine never
keeps an older copy of them.  On the card the engine always runs the
hand-written kernels (K8 decode, K9 prefill); ``attn_impl`` /
``prefill_impl`` default to them on ``cuda`` and to the plain versions on
``cpu``, a geometry the kernels do not cover fails at construction, and
nothing falls back.

* **int8 KV and weights**: ``kv_dtype="int8"`` stores every cache as
  ``(data, scale)`` pairs, quantized on append and dequantized in the
  kernels' reads (K8, K9); ``weight_dtype="int8"`` quantizes the seven
  decode projections once, at construction, into a fresh params dict
  (``quantize_decode_weights``), dequantized in the matmul.  Both are
  axes of the ``ProgramKey``.

Not ported yet (each raises ``NotImplementedError`` naming its slice):
speculative decoding, tensor parallelism, the
reliability layer (deadlines, load shedding, retries, fault injection,
preemption), the request-scoped observability layer (flight recorder,
SLO tracker, watchdog), the host KV tier, prefill/decode disaggregation
and the monolithic (``prefill_chunk=None``) prefill.
"""
from __future__ import annotations

import bisect
import logging
import time
from collections import deque

import numpy as np
import torch

from paddle_tpu_torch.core.device import h2d, resolve_impl
from paddle_tpu_torch.models.llama_decode import (
    QUANT_WEIGHTS, _decode_params_of, canon_weight_dtype,
    quantize_decode_weights, serving_decode_steps, serving_prefill_chunk,
)
from paddle_tpu_torch.ops.decode_attention import kv_dtype as _kv_dtype
from paddle_tpu_torch.ops.paged_attention_cuda import fused_decode_supported
from paddle_tpu_torch.ops.prefill_attention_cuda import (
    fused_prefill_supported,
)
from paddle_tpu_torch.serving.kv_cache import (
    KVCacheManager, KVPoolExhausted, PagedKVCacheManager,
)
from paddle_tpu_torch.serving.metrics import EngineMetrics
from paddle_tpu_torch.serving.program_key import ProgramKey

__all__ = ["KVPoolExhausted", "Request", "ServingEngine"]

_LOG = logging.getLogger(__name__)


def _not_ported(where, knob, slice_name):
    raise NotImplementedError(
        f"{where}: {knob} is not ported to the PyTorch/CUDA engine yet — it "
        f"arrives with the {slice_name} slice")


class _Fetch:
    """Outputs of one dispatch on their way to the host: a non-blocking
    copy into pinned memory, enqueued right after the dispatch, plus an
    event recorded behind it."""

    def __init__(self, tensors):
        self._event = None
        if tensors and tensors[0].device.type == "cuda":
            self._host = [torch.empty(t.shape, dtype=t.dtype,
                                      pin_memory=True) for t in tensors]
            for h, t in zip(self._host, tensors):
                h.copy_(t, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()
        else:
            self._host = [t.clone() for t in tensors]


def _host_fetch(fetch):
    """The engine's one device -> host sync point: wait for the event
    behind a dispatch's copies (not for later work on the stream) and
    return the outputs as numpy arrays."""
    if fetch._event is not None:
        fetch._event.synchronize()
    return [h.numpy() for h in fetch._host]


def _resolve_engine_impl(knob, value, device):
    """``resolve_impl``, plus the engine's rule that the card always runs
    the kernels."""
    impl = resolve_impl(value, device, f"ServingEngine {knob}")
    if impl == "reference" and device.type == "cuda":
        raise ValueError(
            f"ServingEngine: {knob}='reference' on the card — the engine "
            "always runs the kernels there; the plain versions are for "
            "CPU models (op-level functions take impl='reference')")
    return impl


class Request:
    """One generation request.

    ``prompt_ids``: 1-D int token ids.  ``eos_token_id`` retires the slot
    when emitted (the EOS is kept in ``output_ids``).  ``stream_cb``
    (optional ``cb(request, new_ids)``) fires per emission batch; a
    raising callback is logged once per request and never kills the
    scheduler.  Timing (perf_counter): ``t_submit`` / ``t_first`` /
    ``t_done`` and the derived ``ttft`` / ``tpot`` / ``latency``.
    ``status``: ``None`` while in flight, then ``"done"`` or
    ``"poisoned"`` (non-finite logits quarantine)."""

    def __init__(self, prompt_ids, max_new_tokens, eos_token_id=None,
                 stream_cb=None, rid=None, deadline_ms=None, slo_class=None,
                 priority=0):
        if deadline_ms is not None:
            _not_ported("Request", "deadline_ms", "reliability")
        if slo_class is not None:
            _not_ported("Request", "slo_class", "observability")
        if priority != 0:
            _not_ported("Request", "priority (preemption)", "reliability")
        self.prompt_ids = np.asarray(prompt_ids, np.int32).reshape(-1)
        if self.prompt_ids.size == 0:
            raise ValueError("Request: empty prompt")
        self.max_new_tokens = int(max_new_tokens)
        if self.max_new_tokens < 1:
            raise ValueError("Request: max_new_tokens must be >= 1")
        self.eos_token_id = eos_token_id
        self.stream_cb = stream_cb
        self.rid = rid
        self.output_ids = []
        self.text = ""
        self.done = False
        self.status = None
        self.t_submit = None
        self.t_first = None
        self.t_done = None
        self._bucket = None
        self._cb_err_logged = False

    @property
    def latency(self):
        if self.t_done is None or self.t_submit is None:
            return None
        return self.t_done - self.t_submit

    @property
    def ttft(self):
        if self.t_first is None or self.t_submit is None:
            return None
        return self.t_first - self.t_submit

    @property
    def tpot(self):
        if self.t_done is None or self.t_first is None:
            return None
        return (self.t_done - self.t_first) / max(1, len(self.output_ids) - 1)


class ServingEngine:
    """Fixed-batch continuous-batching engine over one causal LM, on the
    model's device.

    ``sync_every``: greedy tokens per dispatch.  ``policy``:
    ``"continuous"`` or ``"gang"``.  ``prompt_buckets``: admissible prompt
    widths (default: powers of two from 16 while ``< max_len``).
    ``pipeline``: double-buffered dispatch (module docstring).
    ``decode_chunk``: KV chunk of the cache read.  ``prefill_chunk`` /
    ``prefill_budget``: prompt tokens per prefill dispatch and dispatches
    per step.  ``kv_block`` / ``max_live_tokens``: the paged KV pool
    (forces ``decode_chunk = kv_block``).  ``kv_dtype``: cache storage
    dtype override (a float dtype, or ``"int8"``).  ``weight_dtype``:
    ``"int8"`` quantizes the decode projections.  ``attn_impl`` /
    ``prefill_impl``:
    ``None`` (by device), ``"cuda"`` (kernels; the only choice on the
    card) or ``"reference"`` (plain versions; CPU only).  ``registry`` /
    ``instrument``: metrics.  ``recorder`` defaults to ``False`` here —
    the flight recorder is not ported yet."""

    def __init__(self, model, batch_size=8, max_len=2048, mode="greedy",
                 sync_every=1, policy="continuous", prompt_buckets=None,
                 detokenizer=None, registry=None, instrument=True,
                 pipeline=True, decode_chunk=256, prefill_chunk=256,
                 prefill_budget=2, kv_block=None, max_live_tokens=None,
                 kv_dtype=None, attn_impl=None, prefill_impl=None,
                 spec_k=None, spec=None, weight_dtype=None, mesh=None,
                 tp_axis=None, tp_overlap=None, max_pending=None,
                 retry_attempts=None, retry_backoff=None, faults=None,
                 recorder=False, slo=None, watchdog=None,
                 host_tier_bytes=None, host_tier=None,
                 host_tier_min_blocks=None, prefill_only=False,
                 on_prefilled=None):
        where = "ServingEngine"
        if mode == "spec" or spec is not None or spec_k is not None:
            _not_ported(where, "speculative decoding (mode='spec', spec=, "
                        "spec_k=)", "speculative decoding")
        if mode != "greedy":
            raise ValueError(f"unknown mode {mode!r}")
        if policy not in ("continuous", "gang"):
            raise ValueError(f"unknown policy {policy!r}")
        if mesh is not None or tp_axis is not None or tp_overlap is not None:
            _not_ported(where, "tensor parallelism (mesh=, tp_axis=, "
                        "tp_overlap=)", "tensor-parallel serving")
        if (max_pending is not None or retry_attempts is not None
                or retry_backoff is not None or faults is not None):
            _not_ported(where, "the reliability knobs (max_pending, "
                        "retry_attempts, retry_backoff, faults)",
                        "reliability")
        if recorder not in (False, None) or slo is not None \
                or watchdog is not None:
            _not_ported(where, "recorder / slo / watchdog",
                        "observability")
        if (host_tier_bytes is not None or host_tier is not None
                or host_tier_min_blocks is not None):
            _not_ported(where, "the host KV tier (host_tier*)",
                        "tiered KV cache")
        if prefill_only or on_prefilled is not None:
            _not_ported(where, "prefill_only / on_prefilled",
                        "prefill/decode disaggregation")
        if prefill_chunk is None:
            _not_ported(where, "prefill_chunk=None (monolithic prefill)",
                        "monolithic prefill")
        self._device = model.llama.embed_tokens.weight.device
        self._m = (EngineMetrics(registry, policy, int(batch_size))
                   if instrument else None)
        self._B = int(batch_size)
        self._lmax = int(max_len)
        self._sync = max(1, int(sync_every))
        self._policy = policy
        self._detok = detokenizer
        self._pipeline = bool(pipeline)
        self._chunk = int(decode_chunk) if decode_chunk else None
        self._pchunk = min(int(prefill_chunk), self._lmax)
        if self._pchunk < 1:
            raise ValueError("prefill_chunk must be >= 1")
        self._pbudget = max(1, int(prefill_budget))
        self._paged = kv_block is not None
        if self._paged:
            kv_block = int(kv_block)
            if self._pchunk % kv_block and kv_block % self._pchunk:
                raise ValueError(
                    f"prefill_chunk ({self._pchunk}) and kv_block "
                    f"({kv_block}) must divide one another (prefix hits "
                    "must land on prefill-chunk boundaries)")
            self._chunk = kv_block
        elif max_live_tokens is not None:
            raise ValueError("max_live_tokens requires kv_block (paged KV)")
        self._params, self._cfg = _decode_params_of(model, self._lmax)
        nh, nkv, hd, _ = self._cfg
        dtype = (_kv_dtype(kv_dtype, where) if kv_dtype is not None
                 else self._params["embed"].dtype)
        self._q8 = dtype == torch.int8
        self._w8 = canon_weight_dtype(weight_dtype, where) == "int8"
        if self._w8:
            # a fresh dict: the model's cached params (views of its
            # parameters) are never replaced or mutated
            self._params = quantize_decode_weights(self._params, "int8")
        self._attn_impl = _resolve_engine_impl("attn_impl", attn_impl,
                                               self._device)
        self._prefill_impl = _resolve_engine_impl(
            "prefill_impl", prefill_impl, self._device)
        if self._attn_impl == "cuda":
            reason = fused_decode_supported(self._chunk, self._lmax, hd)
            if reason is not None:
                raise ValueError(f"{where}: the decode kernel (K8) does not "
                                 f"cover this geometry — {reason}")
        if self._prefill_impl == "cuda":
            reason = fused_prefill_supported(self._chunk, self._lmax,
                                             self._pchunk, self._paged, hd)
            if reason is not None:
                raise ValueError(f"{where}: the prefill kernel (K9) does "
                                 f"not cover this geometry — {reason}")
        self._pk = ProgramKey(attn_impl=self._attn_impl,
                              prefill_impl=self._prefill_impl,
                              kv_dtype="int8" if self._q8 else None,
                              weight_dtype="int8" if self._w8 else None)
        if self._paged:
            self._kv = PagedKVCacheManager(
                len(self._params["layers"]), self._B, self._lmax, nkv, hd,
                dtype, block=kv_block,
                max_live_tokens=(int(max_live_tokens) if max_live_tokens
                                 else self._B * self._lmax),
                device=self._device, on_event=self._kv_event)
        else:
            self._kv = KVCacheManager(len(self._params["layers"]), self._B,
                                      self._lmax, nkv, hd, dtype,
                                      device=self._device)
        if self._m is not None:
            self._m.set_kernels(self._attn_impl, self._prefill_impl)
            self._m.set_kv_quant("int8" if self._q8 else "off")
            self._m.set_weight_quant("int8" if self._w8 else "off")
            n_layers = len(self._params["layers"])
            if self._q8:
                # per context token: 1 byte per (head, dim) element plus a
                # 2-byte f16 scale per (position, head), k and v, every
                # layer
                self._m.hbm_gb_per_tok_q8.set(
                    n_layers * 2 * nkv * (hd + 2) / 1e9)
            if self._w8:
                # per generated token: every projection element once (1
                # byte) plus 2 bytes of scale per output channel
                self._m.hbm_gb_per_tok_w8.set(sum(
                    lp[n].numel() + 2 * lp[n + "_scale"].numel()
                    for lp in self._params["layers"]
                    for n in QUANT_WEIGHTS) / 1e9)
        # paged decode-time row growth is capped per slot by the token
        # budget reserved at admission (prompt + max_new + headroom)
        self._need_rows = np.zeros((self._B,), np.int64)
        if prompt_buckets is None:
            prompt_buckets = []
            b = 16
            while b < self._lmax:
                prompt_buckets.append(b)
                b *= 2
        self._buckets = [int(b) for b in prompt_buckets]
        if not self._buckets or self._buckets[-1] > self._lmax:
            raise ValueError("prompt_buckets must be non-empty and <= max_len")
        if any(b2 <= b1 for b1, b2 in zip(self._buckets, self._buckets[1:])):
            raise ValueError(
                "prompt_buckets must be sorted strictly ascending (submit "
                f"bisects over them), got {self._buckets}")
        self._cur = np.zeros((self._B,), np.int32)   # host next-token mirror
        self._queue = deque()
        self._finished = []
        self._next_rid = 0
        self._rids = set()
        # pipelined-dispatch state: the outstanding (dispatched, not yet
        # drained) step and the device-resident carried tokens
        self._inflight = None
        self._dev_cur = None
        # chunked-prefill state: per-slot progress (insertion order =
        # admission order), the device-resident first tokens of slots whose
        # final chunk went out, and the (slot, request, first, ok) records
        # awaiting host emission
        self._pf = {}
        self._dev_first = {}
        self._pending_firsts = []
        self._t_lastdrain = None
        self._step_idx = -1
        self._n_prompt_tokens = 0
        self._n_reuse_tokens = 0

    # ------------------------------------------------------------- scheduling
    @property
    def has_work(self):
        return (bool(self._queue) or self._kv.any_live()
                or self._inflight is not None)

    @property
    def kv_manager(self):
        return self._kv

    def _headroom(self):
        # greedy may overshoot a retiring slot by < sync_every cache rows;
        # a pipelined engine discovers retirement one drain late
        return 2 * self._sync if self._pipeline else self._sync

    def submit(self, request):
        p = int(request.prompt_ids.size)
        i = bisect.bisect_left(self._buckets, p)
        if i == len(self._buckets):
            raise ValueError(
                f"prompt length {p} exceeds the largest prompt bucket "
                f"{self._buckets[-1]}")
        need = p + request.max_new_tokens + self._headroom()
        if need > self._lmax:
            raise ValueError(
                f"request needs {need} cache rows (prompt {p} + "
                f"max_new {request.max_new_tokens} + headroom "
                f"{self._headroom()}) > max_len {self._lmax}")
        request._bucket = self._buckets[i]
        if request.rid is None:
            request.rid = self._next_rid
            self._next_rid += 1
        else:
            if request.rid in self._rids:
                raise ValueError(
                    f"rid {request.rid!r} is already in use by another "
                    "request on this engine")
            if isinstance(request.rid, int):
                self._next_rid = max(self._next_rid, request.rid + 1)
        self._rids.add(request.rid)
        request.t_submit = time.perf_counter()
        self._queue.append(request)
        if self._m is not None:
            self._m.queue_depth.set(len(self._queue))
        return request

    def _decodable(self, i):
        """Slot ``i`` holds a live request that finished prefilling."""
        return self._kv.reqs[i] is not None and i not in self._pf

    def _forget_slot(self, slot):
        self._pf.pop(slot, None)
        self._dev_first.pop(slot, None)
        self._pending_firsts = [t for t in self._pending_firsts
                                if t[0] != slot]

    def _retire(self, slot, status):
        """Retire ``slot``'s request with a non-``done`` status, keeping
        the tokens it already emitted."""
        r = self._kv.reqs[slot]
        r.status = status
        r.done = True
        r.t_done = time.perf_counter()
        self._kv.release(slot)
        self._forget_slot(slot)
        self._finished.append(r)
        if self._m is not None:
            self._m.poisoned.inc()
            self._m.slots_occupied.set(self._kv.occupied())

    # --------------------------------------------------- program dispatch
    def _kv_event(self, kind, **info):
        if self._m is not None:
            self._m.set_kv_blocks(self._kv.blocks_used(),
                                  self._kv.free_count())

    def _tables(self):
        return self._kv.device_tables() if self._paged else None

    def _call_decode(self, cur, dev_len):
        toks, ok, _ = serving_decode_steps(
            self._params, self._cfg, cur, self._kv.caches, dev_len,
            n_steps=self._sync, chunk_size=self._chunk,
            block_tables=self._tables(), program_key=self._pk)
        return toks, ok

    def _call_prefill_chunk(self, chunk, offset, prompt_len, slot):
        first, ok, _ = serving_prefill_chunk(
            self._params, self._cfg, h2d(chunk, self._device), offset,
            prompt_len, self._kv.caches, slot, chunk_size=self._chunk,
            block_tables=self._tables(), program_key=self._pk)
        return first, ok

    def _admit(self):
        free = self._kv.free_slots()
        if not free or not self._queue:
            return
        if self._policy == "gang" and len(free) < self._B:
            return  # run-to-completion: wait for the whole batch to drain
        m = self._m
        P = self._pchunk
        while free and self._queue:
            r = self._queue[0]
            tok = r.prompt_ids
            p = int(tok.size)
            off0, shared, budget, need = 0, [], 0, 0
            if self._paged:
                # token-budget admission: reserve the request's worst-case
                # block count minus its radix-matched prefix; the match is
                # aligned DOWN to a prefill-chunk boundary so the suffix
                # runs the same chunks a miss would (byte-identity across
                # hit and miss).  FIFO: a head the pool can't cover defers
                C = self._kv.block
                need = min(self._lmax,
                           p + r.max_new_tokens + self._headroom())
                off0, shared = self._kv.match_prefix(tok)
                if P > C:
                    off0 = (off0 // P) * P
                    shared = shared[:off0 // C]
                budget = -(-need // C) - len(shared)
                if not self._kv.can_reserve(budget):
                    break
            self._queue.popleft()
            slot = free.pop(0)
            self._kv.assign(slot, r)
            if self._paged:
                self._kv.adopt_prefix(slot, shared)
                self._kv.reserve(slot, budget)
                self._need_rows[slot] = need
                self._n_prompt_tokens += p
                self._n_reuse_tokens += off0
            padded = np.zeros((-(-p // P) * P,), np.int32)
            padded[:p] = tok
            self._pf[slot] = {"req": r, "tok": padded, "p": p, "off": off0,
                              "first": None, "okf": None}
            if m is not None:
                m.admitted.inc()
                m.prefill(r._bucket)
                if self._paged:
                    m.prompt_tokens.inc(p)
                if off0:
                    m.prefix_reuse_tokens.inc(off0)
                    m.prefix_hits.inc()
                m.queue_wait.observe(time.perf_counter() - r.t_submit)
        if m is not None:
            m.queue_depth.set(len(self._queue))
            m.slots_occupied.set(self._kv.occupied())
            m.live_tokens.set(self._kv.live_tokens())

    def _spend_prefill(self):
        """Dispatch up to ``prefill_budget`` prompt chunks across the
        slots mid-prefill, admission order first.  Never waits on the
        device.  A slot whose FINAL chunk went out joins the next decode
        dispatch with its device-resident first token.  Returns the
        number of chunks dispatched."""
        if not self._pf:
            return 0
        m = self._m
        P = self._pchunk
        budget = self._pbudget
        spent = 0
        for slot in list(self._pf):
            if not budget:
                break
            st = self._pf[slot]
            while budget:
                if st["off"] < st["p"]:
                    if self._paged:
                        # map the chunk's real rows before its writes go
                        # out (pad rows past the prompt drop on the
                        # sentinel)
                        self._kv.ensure_rows(
                            slot, min(st["off"] + P, st["p"]))
                    chunk = st["tok"][st["off"]:st["off"] + P][None, :]
                    first, okf = self._call_prefill_chunk(
                        chunk, st["off"], st["p"], slot)
                    st["off"] += P
                    if m is not None:
                        m.prefill_chunks.inc()
                    if st["off"] >= st["p"]:
                        st["first"], st["okf"] = first, okf
                budget -= 1
                spent += 1
                if st["off"] >= st["p"]:
                    del self._pf[slot]
                    self._kv.lengths[slot] = st["p"]
                    self._dev_first[slot] = st["first"]
                    self._pending_firsts.append(
                        (slot, st["req"], st["first"], st["okf"]))
                    break
        if m is not None:
            m.prefill_backlog.set(sum(
                -(-max(0, st["p"] - st["off"]) // P)
                for st in self._pf.values()))
        return spent

    def _emit_first(self, slot, r, fv, ov):
        """Emit a drained first token (after its finite check).  The
        prefix is registered only now — registering at dispatch could
        publish poisoned blocks a later hit would adopt — and before
        ``_emit``, which may release the slot."""
        if not bool(ov[0]):
            self._retire(slot, "poisoned")
            return 0
        if self._paged:
            self._kv.register_prefix(slot, r.prompt_ids)
        self._cur[slot] = int(fv[0])
        return self._emit(slot, [int(fv[0])])

    def _flush_firsts(self):
        """Synchronous-mode first-token drain: wait once for the wave of
        pending final chunks and emit."""
        if not self._pending_firsts:
            return 0
        pend, self._pending_firsts = self._pending_firsts, []
        vals = _host_fetch(_Fetch([x for _, _, f, o in pend
                                   for x in (f, o)]))
        emitted = 0
        for n, (slot, r, _, _) in enumerate(pend):
            self._dev_first.pop(slot, None)
            if self._kv.reqs[slot] is not r:
                continue
            emitted += self._emit_first(slot, r, vals[2 * n],
                                        vals[2 * n + 1])
        return emitted

    def _emit(self, slot, toks):
        """Append tokens to the slot's request, truncating at EOS /
        max_new_tokens; retires the slot when the request completes.
        Returns the number of tokens consumed."""
        r = self._kv.reqs[slot]
        m = self._m
        took = 0
        for t in toks:
            if r.done:
                break
            r.output_ids.append(int(t))
            took += 1
            if r.t_first is None:
                r.t_first = time.perf_counter()
                if m is not None:
                    m.ttft.observe(r.t_first - r.t_submit)
            if len(r.output_ids) >= r.max_new_tokens or (
                    r.eos_token_id is not None
                    and int(t) == int(r.eos_token_id)):
                r.done = True
        if took:
            if m is not None:
                m.emitted.inc(took)
            if self._detok is not None:
                r.text = self._detok(list(r.output_ids))
            if r.stream_cb is not None:
                try:
                    r.stream_cb(r, r.output_ids[-took:])
                except Exception as e:  # a user callback must not kill
                    if not r._cb_err_logged:  # the scheduler mid-batch
                        r._cb_err_logged = True
                        _LOG.warning(
                            "stream_cb for request %r raised %s: %s — "
                            "further errors from this request are not "
                            "logged", r.rid, type(e).__name__, e)
        if r.done:
            r.status = "done"
            r.t_done = time.perf_counter()
            self._kv.release(slot)
            self._finished.append(r)
            if m is not None:
                m.retired.inc()
                m.e2e.observe(r.t_done - r.t_submit)
                m.tpot.observe(r.tpot)
                m.slots_occupied.set(self._kv.occupied())
        return took

    # ------------------------------------------------------------ step / run
    @torch.no_grad()
    def step(self):
        """One scheduler iteration: admit, spend the prefill budget, then
        one decode dispatch over every live slot.  Returns tokens
        emitted."""
        if self._m is not None:
            self._m.steps.inc()
        self._step_idx += 1
        self._admit()
        spent = self._spend_prefill()
        adm_active = spent > 0 or bool(self._pf)
        if not self._pipeline:
            return self._step_sync(adm_active)
        # the double buffer: issue the next dispatch, then drain the
        # previous one while the new one runs on the card
        prev, self._inflight = self._inflight, None
        self._dispatch(adm_active)
        return self._drain(prev)

    def _observe_interference(self, adm_active, per_slot_tokens):
        now = time.perf_counter()
        if self._m is not None:
            self._m.live_tokens.set(self._kv.live_tokens())
            if adm_active and self._t_lastdrain is not None:
                self._m.tpot_admission.observe(
                    (now - self._t_lastdrain) / max(1.0, per_slot_tokens))
        self._t_lastdrain = now

    def _ensure_decode_rows(self, live):
        """Paged: grow every live slot's chain to cover the rows this
        dispatch may write (length mirror + headroom, capped by the
        admission-time budget) before the table is shipped."""
        if not self._paged:
            return
        for i in live:
            upto = min(int(self._need_rows[i]),
                       int(self._kv.lengths[i]) + self._headroom())
            self._kv.ensure_rows(i, upto)

    def _step_sync(self, adm_active=False):
        """``pipeline=False``: dispatch one step and wait for its tokens
        in the same iteration."""
        emitted = self._flush_firsts()
        live = [i for i in range(self._B) if self._decodable(i)]
        if not live:
            return emitted
        self._ensure_decode_rows(live)
        active = np.array([self._decodable(i) for i in range(self._B)])
        toks, okd = self._call_decode(h2d(self._cur, self._device),
                                      self._kv.device_lengths(active))
        toks, okd = _host_fetch(_Fetch([toks, okd]))
        self._observe_interference(adm_active, self._sync)
        for i in live:
            if not bool(okd[i]):
                self._retire(i, "poisoned")
                continue
            emitted += self._emit(i, toks[i].tolist())
            self._kv.lengths[i] += self._sync
            self._cur[i] = toks[i, -1]
        return emitted

    def _dispatch(self, adm_active=False):
        """Issue the next decode step without waiting for the previous
        one.  Its inputs are device-resident: the previous dispatch's
        carried tokens (host values only for slots the host knows better —
        dead ones), plus the first tokens of slots whose final prefill
        chunk was just dispatched (still on the device).  Those first
        tokens ride this step's fetch and are emitted at its drain."""
        live = [i for i in range(self._B) if self._decodable(i)]
        if not live:
            return
        self._ensure_decode_rows(live)
        active = np.array([self._decodable(i) for i in range(self._B)])
        host_len = self._kv.device_lengths(active)
        host_cur = h2d(self._cur, self._device)
        if self._dev_cur is None:
            cur = host_cur
        else:
            cur = torch.where(h2d(~active, self._device), host_cur,
                              self._dev_cur)
        for s, f in self._dev_first.items():
            cur[s] = f[0]
        self._dev_first.clear()
        firsts, self._pending_firsts = self._pending_firsts, []
        toks, okd = self._call_decode(cur, host_len)
        self._dev_cur = toks[:, -1]
        # greedy lengths are host-derivable: every live slot advances
        # exactly sync_every per dispatch
        for i in live:
            self._kv.lengths[i] += self._sync
        fetch = _Fetch([toks, okd] + [x for _, _, f, o in firsts
                                      for x in (f, o)])
        self._inflight = {"fetch": fetch, "reqs": list(self._kv.reqs),
                          "live": live, "firsts": firsts, "adm": adm_active}
        if self._m is not None:
            self._m.inflight.set(1)

    def _drain(self, rec):
        """Wait for the PREVIOUS dispatch's outputs (the next one is
        already issued) and emit them.  A slot whose Request changed since
        that dispatch gets its stale tokens discarded."""
        if rec is None:
            return 0
        m = self._m
        still_inflight = 1 if self._inflight is not None else 0
        t0 = time.perf_counter()
        vals = _host_fetch(rec["fetch"])
        toks, okd, fvals = vals[0], vals[1], vals[2:]
        if m is not None:
            m.pipeline_stall.observe(time.perf_counter() - t0)
            m.inflight.set(still_inflight)
        self._observe_interference(rec["adm"], self._sync)
        emitted = 0
        # first tokens were dispatched before this decode step (stream
        # order): emit them ahead of the slot's decode block
        for n, (slot, r, _, _) in enumerate(rec["firsts"]):
            if self._kv.reqs[slot] is not r:
                continue
            emitted += self._emit_first(slot, r, fvals[2 * n],
                                        fvals[2 * n + 1])
        for i in rec["live"]:
            if self._kv.reqs[i] is not rec["reqs"][i]:
                continue
            if not bool(okd[i]):
                self._retire(i, "poisoned")
                continue
            emitted += self._emit(i, toks[i].tolist())
            self._cur[i] = toks[i, -1]
        return emitted

    def run(self):
        """Drive ``step()`` until the queue and every slot drain; returns
        the finished requests in completion order."""
        while self.has_work:
            self.step()
        return self._finished

    def drain(self):
        """Run to quiescence; ``{rid: terminal status}`` over every
        request the engine finished."""
        self.run()
        return {r.rid: r.status for r in self._finished}

    def stats(self):
        """Scheduling snapshot: backlog, occupancy and the cumulative
        paged prompt / prefix-reuse token tallies."""
        return {
            "queue_depth": len(self._queue),
            "slots_occupied": self._kv.occupied(),
            "slots_total": self._B,
            "prefill_slots": len(self._pf),
            "inflight": 1 if self._inflight is not None else 0,
            "live_tokens": int(self._kv.live_tokens()),
            "prompt_tokens": self._n_prompt_tokens,
            "prefix_reuse_tokens": self._n_reuse_tokens,
        }
