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
  decode dispatch.  ``prefill_chunk=None`` is the monolithic prefill of
  a dense engine: each admission runs its whole prompt, padded to its
  bucket, against fresh ``[1, bucket]`` mini caches
  (``serving_prefill_slot``; on the card K8 with ``T = bucket`` query
  rows) and copies the rows into the slot; the wave's first tokens are
  read once, at admission.
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

* **Speculative decoding** (``mode="spec"``, ``spec=SpecConfig(...)``):
  each round drafts ``k`` tokens a slot — by prompt lookup in the slot's
  token history (``serving_spec_step``) or with a resident draft model
  (``serving_spec_draft_step``) — and verifies them in one ``[B, k+1]``
  target forward (K8 with ``T = k+1`` query rows a slot on the card),
  emitting the longest matched prefix plus the target's own next pick:
  exactly the verify forward's greedy picks.  ``SpecConfig(tree=
  "top2")`` (draft model, dense caches) adds the draft's second choice at
  the first position as a branch row, verified in the same ``[B, k+2]``
  forward (K8 with a hidden key range for that row).  The accepted
  length is known only on the device, so a pipelined engine feeds the
  previous round's device lengths straight into the next dispatch and
  its host mirror catches up at the drain.  The adaptive policy
  (``adaptive_window``) moves the batch depth along a ladder of rungs
  ``k_min .. spec_k`` (powers of two), one ``ProgramKey`` per rung.  A
  draft model's KV lives in separate dense caches or, paged, as a second
  tenant of the same block pool (``serving/kv_cache.py``).

* **Reliability** (a strict no-op on the clean path: with no deadlines,
  no faults and ``max_pending=None`` the token streams and the dispatch
  structure are unchanged).  ``max_pending`` bounds the admission queue
  (``submit`` raises ``EngineOverloaded``, status ``"shed"``); every
  dispatch and every host fetch runs behind a bounded retry with
  exponential backoff (``retry_attempts``, ``retry_backoff``) against
  ``_RETRYABLE``; ``cancel(rid)`` and ``Request(deadline_ms=)`` retire
  work anywhere in its life through the same write-drop parking as
  retirement; non-finite logits quarantine one slot (``"poisoned"``);
  ``Request(priority=)`` parks the lowest-priority resident slot of a
  paged continuous engine when a higher-priority request is blocked,
  and its resume re-adopts its own cached chain (one suffix prefill).
  ``faults`` takes a ``serving/faults.FaultPlan`` (dispatch errors, NaN
  payloads, slow steps, ``stream_cb`` crashes) through test-only seams.

* **Tensor parallelism** (``mesh=`` a ``torch.distributed.device_mesh.
  DeviceMesh``, ``tp_axis`` its dimension): SPMD, one process per rank,
  as ``torchrun`` launches it — every rank builds the engine with the
  same arguments and submits the same requests in the same order.  Each
  rank holds its Megatron shard of the weights (column-parallel
  q/k/v/gate/up and their int8 scales, row-parallel wo/down, the rest
  replicated; ``serving/sharding.py``), sliced where the model lives
  (the CPU, for a model no single card holds) and then moved to its
  card, and its ``Hkv / N`` heads of every cache and pool.  The decode
  step all-reduces each row-parallel product over the axis's process
  group (``tp_overlap`` segments it), and K8/K9 run on the local tensors
  at the shard's heads.  The replicated ``lm_head`` gives every rank the
  same tokens, so the host schedulers decide alike; the one host input
  that is not a function of the tokens — the clock behind
  ``deadline_ms`` — is read on rank 0 and broadcast, only while some
  request carries a deadline.  An out-of-memory error is not retried
  under TP (ranks re-issuing alone would put the group's collectives out
  of step); an injected fault, raised on every rank alike before any
  launch, still is.

* **Request observability** (host bookkeeping only: no device value is
  read for it, and the token streams are bitwise the same with the
  recorder on or off).  ``recorder`` (default on) keeps a
  ``FlightRecorder`` of engine events — the reference's kinds and
  detail keys, from ``submit`` to ``retire`` — that auto-dumps on a
  ``timed_out`` or ``poisoned`` retirement and on retry exhaustion, and
  a ``RequestTrace`` a request (``Request.timeline()``) that feeds the
  queue / prefill / decode phase histograms at retirement.  ``slo``
  scores every retirement against its class's objectives
  (``Request(slo_class=)``; windowed attainment and burn-rate gauges).
  ``watchdog=<seconds>`` arms a ``DeadlockWatchdog`` thread that dumps
  every thread's stack through the recorder when the step loop stalls
  with work outstanding; ``close()`` stops it.  The steps, prefills and
  dispatches run under the ``serving.*`` spans, which show in a
  ``torch.profiler`` session.  ``debug_sources()`` plugs ``/debug/
  requests``, ``/debug/flightrecorder`` and ``/debug/slo`` into a
  ``MetricsExporter``.  Under TP each rank keeps its own recorder, with
  the same events as rank 0's.

* **Host KV tier** (``host_tier_bytes`` or a shared ``host_tier``
  ``BlockStore``; paged engines): LRU eviction demotes registered prefix
  chains into host RAM instead of destroying them (gathered on the
  device at eviction, copied to the host between steps by the pump), and
  admission restores the host continuation of a prompt into the pool
  (``host_tier_min_blocks`` blocks at least) before the radix match, so
  a restored prefix is adopted, not prefilled.  A damaged entry
  (``FaultPlan(host_tier_corrupt=)``) fails its CRC or shape check and
  falls back to prefill.

Not ported yet (raises ``NotImplementedError`` naming its slice):
prefill/decode disaggregation (``prefill_only`` / ``on_prefilled``).
"""
from __future__ import annotations

import bisect
import contextlib
import dataclasses
import logging
import threading
import time
import warnings
from collections import OrderedDict, deque

import numpy as np
import torch
import torch.distributed as dist

from paddle_tpu_torch.core.device import h2d, resolve_impl
from paddle_tpu_torch.models.llama_decode import (
    QUANT_WEIGHTS, _decode_params_of, _rope_tables, canon_weight_dtype,
    quantize_decode_weights, serving_decode_steps, serving_prefill_chunk,
    serving_prefill_slot, serving_spec_draft_step, serving_spec_step,
)
from paddle_tpu_torch.observability.flightrecorder import (
    FlightRecorder, RequestTrace,
)
from paddle_tpu_torch.observability.slo import SLOTracker
from paddle_tpu_torch.observability.watchdog import DeadlockWatchdog
from paddle_tpu_torch.ops.decode_attention import init_kv_cache
from paddle_tpu_torch.ops.decode_attention import kv_dtype as _kv_dtype
from paddle_tpu_torch.ops.paged_attention_cuda import fused_decode_supported
from paddle_tpu_torch.ops.prefill_attention_cuda import (
    fused_prefill_supported,
)
from paddle_tpu_torch.serving.faults import InjectedDispatchError
from paddle_tpu_torch.serving.kv_cache import (
    BlockStore, KVCacheManager, KVPoolExhausted, PagedKVCacheManager,
)
from paddle_tpu_torch.serving.metrics import EngineMetrics
from paddle_tpu_torch.serving.program_key import ProgramKey
from paddle_tpu_torch.serving.sharding import shard_decode_params, tp_coords

__all__ = ["AcceptWindow", "EngineOverloaded", "KVPoolExhausted", "Request",
           "ServingEngine", "SpecConfig"]

_LOG = logging.getLogger(__name__)

_NULL_CTX = contextlib.nullcontext()

#: the errors a dispatch or fetch retries.  ``torch.cuda.OutOfMemoryError``
#: is the one CUDA error PyTorch raises on the host, from the caching
#: allocator, before the operation that needed the memory is enqueued:
#: the context stays usable, and a dispatch re-issued from the top
#: rewrites the same cache rows with the same values (appends at the
#: slot's unchanged offsets; the one in-place counter, the prompt-lookup
#: ``hist_len``, is the last operation of its round and allocates
#: nothing).  Every other CUDA error (an illegal address, a launch
#: failure) leaves the context lost or is deterministic, and re-raises
#: at once.  The injected twin rides the same path.  Under tensor
#: parallelism only the injected error retries (``_retry``).
_RETRYABLE = (InjectedDispatchError, torch.cuda.OutOfMemoryError)


class EngineOverloaded(RuntimeError):
    """``submit()`` rejected the request: the bounded admission queue
    (``max_pending``) is full.  The caller owns the backoff or reroute;
    resident work is never displaced."""


def _backoff_sleep(seconds):
    """The engine's one deliberate blocking wait: the backoff between
    retry attempts."""
    if seconds > 0:
        time.sleep(seconds)


def _not_ported(where, knob, slice_name):
    raise NotImplementedError(
        f"{where}: {knob} is not ported to the PyTorch/CUDA engine yet — it "
        f"arrives with the {slice_name} slice")


#: warn-once latch for SpecConfig's draft-model fallback (a fleet of
#: engines constructed in a loop must not spam the log)
_SPEC_FALLBACK_WARNED = False


def _warn_spec_fallback():
    global _SPEC_FALLBACK_WARNED
    if _SPEC_FALLBACK_WARNED:
        return
    _SPEC_FALLBACK_WARNED = True
    warnings.warn(
        "SpecConfig(source='draft_model') with no draft_model supplied — "
        "falling back to prompt-lookup drafting (this warning fires once "
        "per process)", RuntimeWarning, stacklevel=3)


@dataclasses.dataclass(frozen=True)
class SpecConfig:
    """The validated speculative-decoding config, checked at
    construction.

    ``source``: ``"prompt_lookup"`` (drafts mined from the slot's token
    history) or ``"draft_model"`` (a resident draft ``LlamaForCausalLM``
    decoding ``spec_k`` candidates).  ``draft_model``: that model —
    ``source="draft_model"`` without one falls back to prompt lookup
    with a once-per-process RuntimeWarning (the reference's rule: an
    engine keeps serving when a deployment forgets the draft weights).
    ``spec_k``: draft tokens a round (``None`` inherits the engine's
    ``spec_k``); under the adaptive policy, the depth ceiling.
    ``adaptive_window``: ``None`` = fixed depth; an int >= 1 sizes each
    slot's sliding window of rounds whose accept rate moves the depth
    ladder.  ``k_min``: the ladder's floor.  ``tree``: ``None`` (the
    linear chain) or ``"top2"`` (the draft's second choice verified as a
    branch row in the same forward; ``source="draft_model"`` and dense
    caches)."""

    source: str = "prompt_lookup"
    draft_model: object = None
    spec_k: object = None
    adaptive_window: object = None
    k_min: int = 1
    tree: object = None

    def __post_init__(self):
        if self.source not in ("prompt_lookup", "draft_model"):
            raise ValueError(
                f"SpecConfig: unknown source {self.source!r} — expected "
                "'prompt_lookup' or 'draft_model'")
        if self.spec_k is not None and (
                isinstance(self.spec_k, bool)
                or not isinstance(self.spec_k, int) or self.spec_k < 1):
            raise ValueError(
                f"SpecConfig: spec_k must be None (inherit the engine "
                f"knob) or an int >= 1, got {self.spec_k!r}")
        if self.adaptive_window is not None and (
                isinstance(self.adaptive_window, bool)
                or not isinstance(self.adaptive_window, int)
                or self.adaptive_window < 1):
            raise ValueError(
                f"SpecConfig: adaptive_window must be None (fixed k) or "
                f"an int >= 1 (verify rounds in the accept-rate window), "
                f"got {self.adaptive_window!r}")
        if isinstance(self.k_min, bool) or not isinstance(self.k_min, int) \
                or self.k_min < 1:
            raise ValueError(
                f"SpecConfig: k_min must be an int >= 1, got "
                f"{self.k_min!r}")
        if self.spec_k is not None and self.k_min > self.spec_k:
            raise ValueError(
                f"SpecConfig: k_min ({self.k_min}) exceeds spec_k "
                f"({self.spec_k})")
        if self.tree not in (None, "top2"):
            raise ValueError(
                f"SpecConfig: unknown tree {self.tree!r} — expected None "
                "(linear chain) or 'top2'")
        if self.tree is not None and self.source != "draft_model":
            raise ValueError(
                "SpecConfig: tree='top2' branches on the draft model's "
                "top-2 — it requires source='draft_model'")

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


class AcceptWindow:
    """Sliding window of (drafted, accepted) verify rounds — the accept
    rate that moves one slot's adaptive depth.  ``rate()`` is
    ``sum(accepted) / sum(drafted)`` over the last ``window`` rounds, or
    ``None`` while empty.  Host arithmetic; one instance a slot."""

    def __init__(self, window):
        self.window = int(window)
        if self.window < 1:
            raise ValueError(
                f"AcceptWindow: window must be >= 1, got {window!r}")
        self._q = deque(maxlen=self.window)

    def push(self, drafted, accepted):
        if drafted < 0 or accepted < 0 or accepted > drafted:
            raise ValueError(
                f"AcceptWindow: need 0 <= accepted <= drafted, got "
                f"accepted={accepted} drafted={drafted}")
        self._q.append((int(drafted), int(accepted)))

    def rate(self):
        drafted = sum(d for d, _ in self._q)
        if not drafted:
            return None
        return sum(a for _, a in self._q) / drafted

    def reset(self):
        self._q.clear()

    def __len__(self):
        return len(self._q)


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
    raising callback is counted (``serving_stream_cb_errors_total``, by
    exception type), logged once per request, and never kills the
    scheduler.  ``deadline_ms`` bounds submit -> completion: past it the
    request retires wherever it is (queued, mid-prefill, decoding) with
    the tokens it has.  ``priority`` (int, higher wins) orders admission
    and, on paged continuous engines, arms preemption (``preempts``
    counts the parks).  Timing (perf_counter): ``t_submit`` /
    ``t_first`` / ``t_done`` and the derived ``ttft`` / ``tpot`` /
    ``latency``.  ``status``: ``None`` while in flight, then one of
    ``"done"``, ``"timed_out"``, ``"cancelled"``, ``"poisoned"``
    (non-finite logits quarantine) or ``"shed"`` (rejected at submit; the
    only terminal status that leaves ``done`` False).  ``slo_class``
    names the request's traffic class for the engine's SLO tracker
    (``None``: ``"interactive"``; keep classes few — they label gauges).
    ``timeline()``: the lifecycle transitions the engine recorded
    (``queued`` -> ``prefilling`` a chunk -> ``decoding`` -> the terminal
    status) as ``{"t", "phase", ...}`` dicts on the ``perf_counter``
    clock; empty before ``submit()`` or with the recorder off."""

    def __init__(self, prompt_ids, max_new_tokens, eos_token_id=None,
                 stream_cb=None, rid=None, deadline_ms=None, slo_class=None,
                 priority=0):
        self.slo_class = None if slo_class is None else str(slo_class)
        self.deadline_ms = (float(deadline_ms)
                            if deadline_ms is not None else None)
        if self.deadline_ms is not None and self.deadline_ms < 0:
            raise ValueError("Request: deadline_ms must be >= 0")
        self.priority = int(priority)
        self.preempts = 0
        self._adm_ids = None      # the tokens its last admission prefilled
        self._t_deadline = None   # stamped at submit()
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
        self._trace = None        # RequestTrace, attached at submit()
        self._cb_err_logged = False

    def timeline(self):
        """The lifecycle transitions recorded for this request (class
        docstring); ``[]`` before ``submit()``."""
        tr = self._trace
        return [] if tr is None else tr.as_dicts()

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
    card) or ``"reference"`` (plain versions; CPU only).  ``mode``:
    ``"greedy"`` or ``"spec"`` (speculative decoding; ``spec`` a
    ``SpecConfig`` or its kwargs dict, ``spec_k`` the default depth).
    ``prefill_chunk=None``: monolithic prefill, one ``[1, bucket]``
    forward an admission (dense engines, no draft model; module
    docstring).
    ``max_pending`` / ``retry_attempts`` / ``retry_backoff`` / ``faults``:
    the reliability layer (module docstring).  ``mesh`` / ``tp_axis``:
    tensor parallelism over a ``DeviceMesh`` dimension (module
    docstring); the attention and KV head counts, the draft model's
    included, must divide its size.  ``tp_overlap``: ``None`` or an int
    >= 2, the output-feature segments of each row-parallel product, each
    all-reduced behind the next one's GEMM (``models/llama_decode.py``
    ``_mm_reduce``).  ``registry`` /
    ``instrument``: metrics.  ``recorder``: ``True`` (default) builds a
    ``FlightRecorder``, ``False`` turns request-scoped recording off
    (timelines included), or pass a configured one (capacity,
    ``dump_dir``).  ``slo``: ``None`` (``DEFAULT_OBJECTIVES``), an
    iterable of ``SLObjective`` or an ``SLOTracker``.  ``watchdog``:
    seconds of step-loop staleness (with work outstanding) that dump
    every thread's stack.  ``host_tier_bytes`` / ``host_tier`` /
    ``host_tier_min_blocks``: the host KV tier (paged engines; a budget
    builds a private ``BlockStore``, ``host_tier`` shares one; chains
    shorter than ``host_tier_min_blocks`` blocks are prefilled instead
    of restored).  ``prefill_only`` / ``on_prefilled``
    (disaggregation) are not ported and raise."""

    def __init__(self, model, batch_size=8, max_len=2048, mode="greedy",
                 sync_every=1, policy="continuous", prompt_buckets=None,
                 detokenizer=None, registry=None, instrument=True,
                 pipeline=True, decode_chunk=256, prefill_chunk=256,
                 prefill_budget=2, kv_block=None, max_live_tokens=None,
                 kv_dtype=None, attn_impl=None, prefill_impl=None,
                 spec_k=8, spec=None, weight_dtype=None, mesh=None,
                 tp_axis="mp", tp_overlap=None, max_pending=None,
                 retry_attempts=3, retry_backoff=0.05, faults=None,
                 recorder=True, slo=None, watchdog=None,
                 host_tier_bytes=None, host_tier=None,
                 host_tier_min_blocks=1, prefill_only=False,
                 on_prefilled=None):
        where = "ServingEngine"
        if mode not in ("greedy", "spec"):
            raise ValueError(f"unknown mode {mode!r}")
        if policy not in ("continuous", "gang"):
            raise ValueError(f"unknown policy {policy!r}")
        # one validated config for every drafting knob; the engine's
        # spec_k survives as the default depth
        if spec is not None and mode != "spec":
            raise ValueError(
                "spec= carries speculative-drafting knobs — construct "
                f"the engine with mode='spec' (got mode={mode!r})")
        if mode == "spec":
            if spec is None:
                spec = SpecConfig()
            elif isinstance(spec, dict):
                spec = SpecConfig(**spec)
            elif not isinstance(spec, SpecConfig):
                raise ValueError(
                    f"spec= must be a SpecConfig or a kwargs dict, got "
                    f"{type(spec).__name__}")
            if spec.spec_k is None:
                spec = spec.replace(spec_k=int(spec_k))
            if spec.source == "draft_model" and spec.draft_model is None:
                _warn_spec_fallback()
                spec = spec.replace(source="prompt_lookup", tree=None)
            if spec.tree is not None and kv_block is not None:
                raise ValueError(
                    "spec tree='top2' requires dense caches (kv_block="
                    "None): the accepted-branch row repair scatters into "
                    "dense per-slot cache rows")
            spec_k = spec.spec_k
        else:
            spec = None
        self._spec = spec
        self._dspec = spec is not None and spec.source == "draft_model"
        self._mode = mode
        self._spec_k = int(spec_k)
        # tensor parallelism: the mesh axis's process group, this rank and
        # the axis size, validated before anything is built
        self._tp_group, self._tp_rank, self._tp_n = (
            tp_coords(mesh, tp_axis) if mesh is not None else (None, 0, 1))
        # tp_overlap: split the row-parallel projections (wo/down) into N
        # output-feature segments so each segment's all-reduce overlaps
        # the next segment's GEMM; None keeps one GEMM and one reduction
        if tp_overlap is not None:
            if isinstance(tp_overlap, bool) or not isinstance(
                    tp_overlap, int) or tp_overlap < 2:
                raise ValueError(
                    f"ServingEngine: tp_overlap must be None or an int "
                    f">= 2 (segment count), got {tp_overlap!r}")
        if prefill_only or on_prefilled is not None:
            _not_ported(where, "prefill_only / on_prefilled",
                        "prefill/decode disaggregation")
        # a TP rank runs on its mesh's device (a CPU-resident model is
        # sharded there and each shard moved); otherwise on the model's
        self._model_device = model.llama.embed_tokens.weight.device
        self._device = self._model_device
        if mesh is not None:
            self._device = (
                torch.device("cuda", torch.cuda.current_device())
                if mesh.device_type == "cuda" else torch.device("cpu"))
        self._m = (EngineMetrics(registry, policy, int(batch_size),
                                 mesh_devices=self._tp_n)
                   if instrument else None)
        # request-scoped observability: the flight-recorder ring, the
        # rid-keyed lifecycle traces and the SLO window, fed from host
        # values only
        if recorder is True:
            recorder = FlightRecorder(policy=policy)
        elif recorder is False:
            recorder = None
        self._fr = recorder
        if self._fr is not None and self._fr.on_dump is None \
                and self._m is not None:
            self._fr.on_dump = self._m.recorder_dump
        if isinstance(slo, SLOTracker):
            self._slo = slo
        else:
            self._slo = SLOTracker(
                objectives=slo, policy=policy,
                registry=self._m.registry if self._m is not None else None)
        self._traces = OrderedDict()   # rid -> RequestTrace, newest last
        self._trace_cap = 1024
        self._trace_lock = threading.Lock()
        self._last_step_unix = 0.0     # the watchdog's progress probe
        self._B = int(batch_size)
        self._lmax = int(max_len)
        self._sync = max(1, int(sync_every))
        self._policy = policy
        self._detok = detokenizer
        self._pipeline = bool(pipeline)
        self._chunk = int(decode_chunk) if decode_chunk else None
        # None: monolithic prefill (one [1, bucket] forward an admission)
        self._pchunk = (min(int(prefill_chunk), self._lmax)
                        if prefill_chunk else None)
        if self._pchunk is not None and self._pchunk < 1:
            raise ValueError("prefill_chunk must be >= 1 or None")
        self._pbudget = max(1, int(prefill_budget))
        if self._dspec and self._pchunk is None:
            raise ValueError(
                "SpecConfig(source='draft_model') requires chunked "
                "prefill (prefill_chunk=): the draft model's prompt KV "
                "is built by per-chunk draft prefill dispatches riding "
                "the admission path")
        self._paged = kv_block is not None
        if self._paged:
            kv_block = int(kv_block)
            if self._pchunk is None:
                raise ValueError(
                    "paged KV (kv_block=) requires chunked prefill "
                    "(prefill_chunk=)")
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
        # per generated token: every projection element once (1 byte)
        # plus 2 bytes of scale per output channel, counted on the whole
        # model (placement-independent, as the reference's gauge)
        w8_bytes = sum(
            lp[n].numel() + 2 * lp[n + "_scale"].numel()
            for lp in self._params["layers"]
            for n in QUANT_WEIGHTS) if self._w8 else 0
        self._dparams = self._dcfg = self._dcaches = None
        if self._dspec:
            self._init_draft(spec.draft_model, nkv, hd)
        if mesh is not None:
            if nkv % self._tp_n or nh % self._tp_n:
                raise ValueError(
                    f"heads not shardable {self._tp_n}-way along "
                    f"{tp_axis!r}: num_attention_heads={nh}, "
                    f"num_key_value_heads={nkv} (the KV cache shards "
                    "along heads)")
            if self._dspec:
                dnh, dnkv, _, _ = self._dcfg
                if dnkv % self._tp_n or dnh % self._tp_n:
                    raise ValueError(
                        f"draft heads not shardable {self._tp_n}-way along "
                        f"{tp_axis!r}: num_attention_heads={dnh}, "
                        f"num_key_value_heads={dnkv} (the draft KV "
                        "shards along heads like the target's)")
                self._dparams, self._dcfg = self._shard(
                    spec.draft_model, self._dparams, self._dcfg, tp_axis)
            self._params, self._cfg = self._shard(model, self._params,
                                                  self._cfg, tp_axis)
        self._attn_impl = _resolve_engine_impl("attn_impl", attn_impl,
                                               self._device)
        self._prefill_impl = _resolve_engine_impl(
            "prefill_impl", prefill_impl, self._device)
        # the kernels cover every verify width (T = k+1 rows a slot):
        # the gates depend on the cache geometry and head_dim only (the
        # monolithic prefill's mini caches are gated with the buckets)
        for hdim in (hd, self._dcfg[2]) if self._dspec else (hd,):
            if self._attn_impl == "cuda":
                reason = fused_decode_supported(self._chunk, self._lmax,
                                                hdim, dense=not self._paged)
                if reason is not None:
                    raise ValueError(f"{where}: the decode kernel (K8) does "
                                     f"not cover this geometry — {reason}")
            if self._prefill_impl == "cuda" and self._pchunk is not None:
                reason = fused_prefill_supported(
                    self._chunk, self._lmax, self._pchunk, self._paged, hdim)
                if reason is not None:
                    raise ValueError(f"{where}: the prefill kernel (K9) "
                                     f"does not cover this geometry — "
                                     f"{reason}")
        # the dispatch events' labels
        self._kvq = "int8" if self._q8 else "off"
        self._wq = "int8" if self._w8 else "off"
        self._pk = ProgramKey(attn_impl=self._attn_impl,
                              prefill_impl=self._prefill_impl,
                              kv_dtype="int8" if self._q8 else None,
                              weight_dtype="int8" if self._w8 else None,
                              tp_overlap=tp_overlap,
                              draft_source=spec.source if spec else None,
                              spec_depth=self._spec_k if spec else None,
                              spec_tree=spec.tree if spec else None)
        # adaptive depth: per-slot AcceptWindows pick a rung on a ladder
        # [k_min .. spec_k] (powers of two between); the batch runs ONE
        # depth a round, the most conservative live slot's, approached
        # one rung a round.  Each rung is its own ProgramKey, made here
        # once.
        if spec is not None and spec.adaptive_window is not None:
            rungs = {spec.k_min, self._spec_k}
            r = 1
            while r < self._spec_k:
                if r > spec.k_min:
                    rungs.add(r)
                r *= 2
            self._k_rungs = sorted(rungs)
            self._awin = [AcceptWindow(spec.adaptive_window)
                          for _ in range(self._B)]
        else:
            self._k_rungs = [self._spec_k]
            self._awin = None
        self._k_cur = self._k_rungs[-1]
        self._k_want = [len(self._k_rungs) - 1] * self._B
        self._spec_pks = {k: self._pk.replace(spec_depth=k)
                          for k in self._k_rungs} if spec else {}
        # host KV tier: evictions demote into a byte-budgeted host-RAM
        # BlockStore and admission restores from it (a copy, not a suffix
        # prefill); ``host_tier=`` shares a caller-built store
        if host_tier is not None and host_tier_bytes is not None:
            raise ValueError(
                "pass host_tier= (a BlockStore) OR host_tier_bytes= (a "
                "budget for a private one), not both")
        host_store = host_tier
        if host_store is None and host_tier_bytes:
            if not self._paged:
                raise ValueError(
                    "host_tier_bytes requires paged KV (kv_block=): only "
                    "a block pool has demotable prefix chains")
            host_store = BlockStore(int(host_tier_bytes), block=kv_block)
        if host_store is not None and not self._paged:
            raise ValueError(
                "host_tier requires paged KV (kv_block=): only a block "
                "pool has demotable prefix chains")
        self._host_min_blocks = max(1, int(host_tier_min_blocks))
        self._restore_s = []   # per-admission restore wall times
        # the caches hold this rank's heads (all of them without a mesh)
        local_nkv = self._cfg[1]
        if self._paged:
            # a draft model is a second pool tenant whose chains grow in
            # lockstep with the target's, so the default pool doubles (an
            # explicit max_live_tokens is respected as given)
            self._kv = PagedKVCacheManager(
                len(self._params["layers"]), self._B, self._lmax, local_nkv,
                hd, dtype, block=kv_block,
                max_live_tokens=(int(max_live_tokens) if max_live_tokens
                                 else (2 if self._dspec else 1)
                                 * self._B * self._lmax),
                device=self._device, on_event=self._kv_event,
                host_store=host_store)
        else:
            self._kv = KVCacheManager(len(self._params["layers"]), self._B,
                                      self._lmax, local_nkv, hd, dtype,
                                      device=self._device)
            if self._dspec:
                # dense draft tenancy: separate per-draft-layer caches
                # (dense rows are slot-indexed; sharing would clobber),
                # at the rank's draft heads (self._dcfg is local)
                _, dnkv, dhd, _ = self._dcfg
                ddtype = dtype if kv_dtype is not None else \
                    self._dparams["embed"].dtype
                self._dcaches = [
                    init_kv_cache(self._B, self._lmax, dnkv, dhd, ddtype,
                                  self._device)
                    for _ in self._dparams["layers"]]
        if self._m is not None:
            self._m.set_kernels(self._attn_impl, self._prefill_impl)
            self._m.set_kv_quant("int8" if self._q8 else "off")
            self._m.set_weight_quant("int8" if self._w8 else "off")
            if spec is not None:
                self._m.set_spec_source(spec.source)
                self._m.spec_draft_k.set(self._spec_k)
            n_layers = len(self._params["layers"])
            if self._q8:
                # per context token: 1 byte per (head, dim) element plus a
                # 2-byte f16 scale per (position, head), k and v, every
                # layer
                self._m.hbm_gb_per_tok_q8.set(
                    n_layers * 2 * nkv * (hd + 2) / 1e9)
            if self._w8:
                self._m.hbm_gb_per_tok_w8.set(w8_bytes / 1e9)
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
        if self._pchunk is None and self._attn_impl == "cuda":
            # monolithic prefill reads each bucket's [1, bucket] mini
            # cache with K8 at T = bucket
            for b in self._buckets:
                reason = fused_decode_supported(self._chunk, b, hd,
                                                dense=True)
                if reason is not None:
                    raise ValueError(
                        f"{where}: the decode kernel (K8) does not cover "
                        f"the prompt bucket {b} — {reason}")
        self._cur = np.zeros((self._B,), np.int32)   # host next-token mirror
        # the prompt-lookup history, on the device (a draft model needs
        # none)
        self._hist = self._hist_len = None
        # tree verification: the rounds' taken branches, counted on the
        # device (read only by ``tree_branches_taken``)
        self._tree_taken = (
            torch.zeros((1,), dtype=torch.int64, device=self._device)
            if spec is not None and spec.tree else None)
        if spec is not None and not self._dspec:
            self._hist = torch.zeros((self._B, self._lmax),
                                     dtype=torch.int32, device=self._device)
            self._hist_len = torch.zeros((self._B,), dtype=torch.int32,
                                         device=self._device)
        self._queue = deque()
        self._finished = []
        self._next_rid = 0
        self._rids = set()
        # pipelined-dispatch state: the outstanding (dispatched, not yet
        # drained) step and the device-resident carried tokens
        self._inflight = None
        self._dev_cur = None
        self._dev_len = None     # spec: the device-known accepted lengths
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
        # reliability: the bounded admission queue, the retry policy, the
        # fault plan (None in production) and the preemption tallies
        self._max_pending = (int(max_pending)
                             if max_pending is not None else None)
        if self._max_pending is not None and self._max_pending < 0:
            raise ValueError("max_pending must be >= 0 or None")
        self._retry_attempts = max(1, int(retry_attempts))
        self._retry_backoff = float(retry_backoff)
        self._faults = faults
        self._n_preempted = 0
        self._n_resume_suffix = 0
        self._n_resume_total = 0
        self._n_host_reuse_tokens = 0
        # monolithic prefill: the slots admitted since the last dispatch
        # (their first token and length are host values) and whether this
        # step ran an admission wave
        self._adm_pending = set()
        self._adm_wave = False
        # the runtime deadlock watchdog (a daemon thread), armed last: its
        # probe reads the step stamp, 0 until the first step
        self._watchdog = None
        if watchdog:
            self._watchdog = DeadlockWatchdog(
                self._watchdog_probe, stall_after=float(watchdog),
                recorder=self._fr,
                registry=self._m.registry if self._m is not None else None,
                component=policy).start()

    # ------------------------------------------------------------- scheduling
    @property
    def has_work(self):
        return (bool(self._queue) or self._kv.any_live()
                or self._inflight is not None)

    def _watchdog_probe(self):
        """The watchdog's progress probe: the last step's wall clock while
        work is outstanding, None while idle (an idle engine is not
        stalled)."""
        t = self._last_step_unix
        if not t or not self.has_work:
            return None
        return t

    @property
    def kv_manager(self):
        return self._kv

    def _init_draft(self, draft_model, nkv, hd):
        """The resident draft model's decode params, checked against the
        target: the same vocabulary and device; on a paged pool (shared
        blocks) the same KV row geometry and dtype, and at most as many
        layers (draft layer ``l`` rides target layer ``l``'s pool)."""
        where = "ServingEngine"
        dev = draft_model.llama.embed_tokens.weight.device
        if dev != self._model_device:
            raise ValueError(f"{where}: the draft model is on {dev}, the "
                             f"target on {self._model_device}")
        self._dparams, self._dcfg = _decode_params_of(draft_model,
                                                      self._lmax)
        _, dnkv, dhd, _ = self._dcfg
        dv, tv = (int(self._dparams["embed"].shape[0]),
                  int(self._params["embed"].shape[0]))
        if dv != tv:
            raise ValueError(
                f"draft model vocab {dv} != target vocab {tv} — the verify "
                "forward compares token ids, so the vocabs must match")
        if self._paged:
            nd, nt = len(self._dparams["layers"]), len(self._params["layers"])
            if nd > nt:
                raise ValueError(
                    f"paged draft sharing: draft layer count {nd} exceeds "
                    f"target {nt} (draft layer l rides target layer l's "
                    "pool array)")
            if (dnkv, dhd) != (nkv, hd):
                raise ValueError(
                    f"paged draft sharing: draft KV geometry (kv_heads="
                    f"{dnkv}, head_dim={dhd}) != target ({nkv}, {hd}) — "
                    "blocks are model-agnostic bytes only when the "
                    "per-row shapes match; use a dense engine for "
                    "mismatched drafters")
            if self._dparams["embed"].dtype != self._params["embed"].dtype:
                raise ValueError(
                    f"paged draft sharing: draft dtype "
                    f"{self._dparams['embed'].dtype} != target "
                    f"{self._params['embed'].dtype}")
        if self._w8:
            self._dparams = quantize_decode_weights(self._dparams, "int8")

    def _shard(self, model, params, cfg, axis):
        """This rank's shard of ``params`` on the engine's device and the
        local ``cfg`` (its heads).  The rope tables are rebuilt there when
        the model lives elsewhere, so they are the tables a single-device
        engine on this device would use."""
        nh, nkv, hd, eps = cfg
        n = self._tp_n
        params, _ = shard_decode_params(params, self._tp_rank, n, axis,
                                        device=self._device)
        if self._model_device != self._device:
            params["_rope"] = _rope_tables(
                self._lmax, hd, model.config.rope_theta,
                params["embed"].dtype, self._device)
        return params, (nh // n, nkv // n, hd, eps)

    def _headroom(self):
        # greedy may overshoot a retiring slot by < sync_every cache rows,
        # spec's verify forward writes spec_k+1 rows before the rewind
        # (+1 for the tree's branch row at L+k+1); a pipelined engine
        # discovers retirement one drain late
        if self._mode == "spec":
            per = self._spec_k + (2 if self._spec.tree else 1)
        else:
            per = self._sync
        return 2 * per if self._pipeline else per

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
        # shedding after validation (a malformed request stays a
        # ValueError) and before the rid (a shed request consumes no
        # engine state)
        if self._max_pending is not None \
                and len(self._queue) >= self._max_pending:
            request.status = "shed"
            if self._m is not None:
                self._m.terminal("shed")
            if self._fr is not None:
                self._fr.record("shed", step=self._step_idx,
                                rid=request.rid, queued=len(self._queue))
            raise EngineOverloaded(
                f"admission queue full ({len(self._queue)} pending >= "
                f"max_pending={self._max_pending}); request shed")
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
        if request.deadline_ms is not None:
            request._t_deadline = request.t_submit \
                + request.deadline_ms / 1e3
        # the lifecycle trace, born "queued", indexed by rid in a bounded
        # map for /debug/requests (recorder=False records none)
        if self._fr is not None:
            tr = RequestTrace(request.rid)
            request._trace = tr
            with self._trace_lock:
                self._traces[request.rid] = tr
                while len(self._traces) > self._trace_cap:
                    self._traces.popitem(last=False)
            tr.mark("queued")
            self._fr.record("submit", step=self._step_idx, rid=request.rid,
                            prompt_len=p, slo_class=request.slo_class)
        self._queue.append(request)
        if self._m is not None:
            self._m.queue_depth.set(len(self._queue))
        return request

    def _decodable(self, i):
        """Slot ``i`` holds a live request that finished prefilling."""
        return self._kv.reqs[i] is not None and i not in self._pf

    # --------------------------------------------------- priority preemption
    @staticmethod
    def _admission_ids(r):
        """The tokens a (re-)admission prefills: the prompt, plus every
        token a request resuming after preemption already emitted (the
        last one's forward yields the next token, so the ordinary chunked
        prefill continues the stream)."""
        if not r.output_ids:
            return r.prompt_ids
        return np.concatenate(
            [r.prompt_ids, np.asarray(r.output_ids, np.int32)])

    def _preempt_slot(self, slot):
        """Park ``slot``'s request mid-decode: register the rows known
        written (prompt plus every emitted token but the last) as a radix
        chain, so ``release`` parks it evictable and the resume re-adopts
        it; the draft tenant's chain frees outright.  An inflight
        pipelined dispatch for the slot writes only past that chain and
        its tokens fail the drain's identity check."""
        r = self._kv.reqs[slot]
        cached = self._admission_ids(r)[:-1]
        self._kv.register_prefix(slot, cached)
        self._kv.release(slot)
        self._forget_slot(slot)
        r.preempts += 1
        r._adm_ids = None
        self._n_preempted += 1
        if r._trace is not None:
            r._trace.mark("preempted", slot=slot)
        if self._fr is not None:
            self._fr.record("preempt", step=self._step_idx, rid=r.rid,
                            slot=slot, cached_tokens=int(cached.size),
                            n_out=len(r.output_ids))
        self._queue.appendleft(r)
        if self._m is not None:
            self._m.preempted.inc()
            self._m.queue_depth.set(len(self._queue))
            self._m.slots_occupied.set(self._kv.occupied())
            self._m.live_tokens.set(self._kv.live_tokens())

    def _maybe_preempt(self):
        """Park low-priority resident work while a strictly higher-priority
        waiter is blocked (no free slot, or the pool cannot cover its
        worst case): lowest priority first, the most recently submitted
        within a class.  Paged continuous engines only; a no-op while no
        queued priority exceeds a resident one."""
        if not self._paged or self._policy != "continuous" \
                or not self._queue:
            return
        top = max(self._queue, key=lambda q: q.priority)
        for _ in range(self._B):
            victims = [
                (i, self._kv.reqs[i]) for i in range(self._B)
                if self._kv.reqs[i] is not None and i not in self._pf
                and self._kv.reqs[i].t_first is not None
                and self._kv.reqs[i].priority < top.priority]
            if not victims:
                return
            # is the head blocked?  the admission arithmetic
            budget = self._admission_budget(top)[2]
            if self._kv.free_slots() and self._kv.can_reserve(budget):
                return
            slot, _ = min(victims,
                          key=lambda sr: (sr[1].priority, -sr[1].t_submit))
            self._preempt_slot(slot)

    def _admission_budget(self, r, restore=False):
        """Paged admission arithmetic for ``r``: ``(need rows, matched
        prefix tokens, new blocks to reserve, matched blocks, matched
        tokens restored from the host tier)`` — its worst case (admission
        tokens + remaining tokens + headroom, capped at max_len) minus the
        radix match, aligned down to a prefill-chunk boundary so a hit
        runs the same chunks a miss would.  With ``restore`` (admission),
        a device match that breaks before its cap first pulls the host
        tier's continuation into the pool and matches again: restored
        blocks park like a released chain, so the rest is tier-blind."""
        tok = self._admission_ids(r)
        C, P = self._kv.block, self._pchunk
        p = int(tok.size)
        rem = max(1, r.max_new_tokens - len(r.output_ids))
        need = min(self._lmax, p + rem + self._headroom())
        off0, shared = self._kv.match_prefix(tok)
        off_dev = off0
        host = self._kv.host_tier
        if (restore and host is not None and host.n_blocks
                and len(shared) < (p - 1) // C):
            t0 = time.perf_counter()
            got = self._kv.restore_from_host(
                tok, rid=r.rid, min_blocks=self._host_min_blocks)
            if got:
                self._restore_s.append(time.perf_counter() - t0)
                if self._m is not None:
                    self._m.tier_restore_seconds.observe(self._restore_s[-1])
                off0, shared = self._kv.match_prefix(tok)
        if P > C:
            off0 = (off0 // P) * P
            shared = shared[:off0 // C]
        return (need, off0, -(-need // C) - len(shared), shared,
                max(0, off0 - min(off_dev, off0)))

    # -------------------------------------------------- request lifecycle
    # every terminal path below retires through the write-drop parking the
    # scheduler already uses: the freed slot is parked at lmax from the
    # next dispatch on and its stale pipelined tokens fail the drain's
    # identity check
    def _on_terminal(self, r, status, slot=None):
        """The request-scoped fanout of one terminal transition: the
        timeline's terminal mark, the recorder's ``retire`` event (and
        its auto-dump for ``timed_out`` / ``poisoned``), the phase
        histograms and the SLO window.  Host bookkeeping only."""
        tr = r._trace
        if tr is not None:
            if slot is not None:
                tr.mark(status, slot=slot)
            else:
                tr.mark(status)
        if self._fr is not None:
            self._fr.record("retire", step=self._step_idx, rid=r.rid,
                            slot=slot, status=status,
                            n_out=len(r.output_ids))
            if status in ("timed_out", "poisoned"):
                self._fr.auto_dump(status)
        if self._m is not None and tr is not None:
            self._m.observe_phases(tr.durations())
        self._slo.observe(r)

    def _terminal_queued(self, r, status):
        """Retire a request that never reached a slot."""
        r.status = status
        r.done = True
        r.t_done = time.perf_counter()
        self._finished.append(r)
        if self._m is not None:
            self._m.terminal(status)
        self._on_terminal(r, status)

    def _forget_slot(self, slot):
        self._pf.pop(slot, None)
        self._dev_first.pop(slot, None)
        self._adm_pending.discard(slot)
        self._pending_firsts = [t for t in self._pending_firsts
                                if t[0] != slot]

    def _retire(self, slot, status):
        """Retire ``slot``'s request with a non-``done`` status
        (timed_out / cancelled / poisoned), keeping the tokens it already
        emitted."""
        r = self._kv.reqs[slot]
        r.status = status
        r.done = True
        r.t_done = time.perf_counter()
        self._kv.release(slot)
        self._forget_slot(slot)
        self._finished.append(r)
        if self._m is not None:
            self._m.terminal(status)
            self._m.slots_occupied.set(self._kv.occupied())
        self._on_terminal(r, status, slot=slot)

    def cancel(self, rid):
        """Retire ``rid`` wherever it is — queued, mid-prefill or decoding
        (stale pipelined tokens are discarded at the drain) — with status
        ``"cancelled"`` and its partial output.  Returns True if it was
        live, False otherwise (finished, shed or unknown)."""
        for r in self._queue:
            if r.rid == rid:
                self._queue.remove(r)
                if self._fr is not None:
                    self._fr.record("cancel", step=self._step_idx, rid=rid)
                self._terminal_queued(r, "cancelled")
                if self._m is not None:
                    self._m.queue_depth.set(len(self._queue))
                return True
        for slot, r in enumerate(self._kv.reqs):
            if r is not None and r.rid == rid:
                if self._fr is not None:
                    self._fr.record("cancel", step=self._step_idx, rid=rid,
                                    slot=slot)
                self._retire(slot, "cancelled")
                return True
        return False

    def _expire_deadlines(self):
        """Retire every request past its ``deadline_ms``: queued ones
        never reach a slot, resident ones free theirs this step.  Under
        TP rank 0's clock decides for every rank (``_rank0_decides``), and
        only while some request carries a deadline."""
        queued = [r for r in self._queue if r._t_deadline is not None]
        live = [(slot, r) for slot, r in enumerate(self._kv.reqs)
                if r is not None and r._t_deadline is not None]
        if not queued and not live:
            return
        now = time.perf_counter()
        due = self._rank0_decides(
            [now >= r._t_deadline for r in queued]
            + [now >= r._t_deadline for _, r in live])
        expired = [r for r, d in zip(queued, due) if d]
        for r in expired:
            self._queue.remove(r)
            self._terminal_queued(r, "timed_out")
        if expired and self._m is not None:
            self._m.queue_depth.set(len(self._queue))
        for (slot, _), d in zip(live, due[len(queued):]):
            if d:
                self._retire(slot, "timed_out")

    def _rank0_decides(self, flags):
        """A host decision every rank must share: rank 0's ``flags``,
        broadcast over the TP group (the ranks' lists are equally long —
        their queues and slots agree); one host read.  Unchanged without
        TP."""
        if self._tp_group is None:
            return flags
        t = torch.tensor(flags, dtype=torch.uint8, device=self._device)
        dist.broadcast(t, src=dist.get_global_rank(self._tp_group, 0),
                       group=self._tp_group)
        return [bool(x) for x in t.tolist()]

    # ------------------------------------------------- faults and retries
    def _inject_nan(self, slot):
        """Fault seam (``FaultPlan.poison``): NaN into the slot's first
        cached key row (layer 0, position 0, which every later query of
        the slot reads), in place between steps; a paged engine poisons
        the slot's first mapped block instead.  An int8 cache cannot hold
        a NaN in its codes: the poison lands in the scale leaf, which
        dequantizes the row to NaN."""
        k = self._kv.caches[0][0]
        leaf = k[1] if isinstance(k, tuple) else k
        if self._paged:
            b = int(self._kv.block_tables[slot, 0])
            if b >= self._kv.num_blocks:
                return   # nothing mapped yet
            leaf[b, 0].fill_(float("nan"))
            return
        leaf[slot, 0].fill_(float("nan"))

    def _apply_poison(self):
        """Inject every due NaN payload of the fault plan, once the slot
        has a cache row written (a slot still at prefill offset 0 would
        overwrite the poison with its first chunk)."""
        f = self._faults
        if f is None or not f.poison:
            return
        for slot, r in enumerate(self._kv.reqs):
            if r is None or not f.poison_due(r.rid, self._step_idx):
                continue
            st = self._pf.get(slot)
            if st is not None and st["off"] == 0:
                continue
            self._inject_nan(slot)
            f.mark_poisoned(r.rid)
            if self._fr is not None:
                self._fr.record("poison", step=self._step_idx, rid=r.rid,
                                slot=slot)

    def _apply_host_corrupt(self):
        """Inject every due ``FaultPlan(host_tier_corrupt=...)`` payload:
        damage the host-tier entries along a token chain (or every entry),
        so the next restore meets the validation and falls back to suffix
        prefill.  No-op without a host tier; the device pool is never
        touched."""
        f = self._faults
        if (f is None or not f.host_tier_corrupt or not self._paged
                or self._kv.host_tier is None):
            return
        for tokens, mode in f.host_corrupts_due(self._step_idx):
            n = self._kv.corrupt_host(tokens, mode=mode)
            if self._fr is not None:
                self._fr.record("host_corrupt", step=self._step_idx,
                                mode=mode, entries=n)

    def _fault_point(self, kind, attempt):
        if self._faults is not None:
            self._faults.maybe_dispatch_error(kind, self._step_idx,
                                              attempt)

    def _retry(self, fn, what):
        """Run ``fn(attempt)`` up to ``retry_attempts`` times against
        ``_RETRYABLE`` errors, backing off exponentially; exhaustion
        re-raises the last error.  A retried attempt re-issues the same
        kernels (never a plain version); the fault points raise before
        the dispatch launches anything."""
        delay = self._retry_backoff
        for attempt in range(self._retry_attempts):
            try:
                return fn(attempt)
            except _RETRYABLE as e:
                exhausted = attempt + 1 >= self._retry_attempts
                if exhausted and self._fr is not None:
                    # about to surface the error: snapshot what led here
                    self._fr.record(
                        "retry", step=self._step_idx, what=what,
                        attempt=attempt + 1, error=type(e).__name__,
                        exhausted=True)
                    self._fr.auto_dump("retry_exhausted")
                # under TP a real device error (out of memory) hit one
                # rank mid-dispatch, after some of the group's collectives
                # were issued: a re-issue on that rank alone would pair
                # its collectives with the wrong ones of the others
                if exhausted or (
                        self._tp_group is not None
                        and not isinstance(e, InjectedDispatchError)):
                    raise
                if self._m is not None:
                    self._m.dispatch_retries.inc()
                if self._fr is not None:
                    self._fr.record("retry", step=self._step_idx,
                                    what=what, attempt=attempt + 1,
                                    error=type(e).__name__)
                _LOG.warning(
                    "serving %s failed (%s: %s) — retrying (attempt %d/%d) "
                    "after %.3fs backoff", what, type(e).__name__, e,
                    attempt + 1, self._retry_attempts - 1, delay)
                _backoff_sleep(delay)
                delay *= 2

    def _fetch(self, kind, fetch):
        """``_host_fetch`` behind the bounded retry and the fault seam:
        waiting on the same event and reading the same pinned buffers
        again is idempotent."""
        def go(attempt):
            self._fault_point(kind, attempt)
            return _host_fetch(fetch)
        return self._retry(go, kind)

    # --------------------------------------------------- program dispatch
    def _kv_event(self, kind, **info):
        """The paged manager's event hook: allocator and host-tier events
        (``block_alloc`` / ``block_free`` / ``demote`` / ``restore`` /
        ``host_evict`` / ``host_error``) go to the flight recorder, and
        the pool and host-tier gauges stay current."""
        if self._fr is not None:
            self._fr.record(kind, step=self._step_idx, **info)
        if self._m is not None:
            draft_used = self._kv.draft_blocks_used()
            self._m.set_kv_blocks(self._kv.blocks_used() - draft_used,
                                  draft_used, self._kv.free_count())
            host = self._kv.host_tier
            if host is not None:
                self._m.kv_host_blocks.set(host.n_blocks)
                self._m.kv_host_bytes.set(host.total_bytes)
                if kind == "demote":
                    self._m.tier_demotions.inc(info.get("n_blocks", 1))
                elif kind == "restore":
                    self._m.tier_restores.inc(info.get("n_blocks", 1))
                elif kind == "host_error":
                    self._m.host_tier_errors.inc()

    def _tables(self):
        return self._kv.device_tables() if self._paged else None

    def _call_decode(self, cur, dev_len):
        toks, ok, _ = serving_decode_steps(
            self._params, self._cfg, cur, self._kv.caches, dev_len,
            n_steps=self._sync, chunk_size=self._chunk,
            block_tables=self._tables(), program_key=self._pk,
            tp_group=self._tp_group)
        return toks, ok

    def _call_spec(self, cur, dev_len, active, k):
        """One speculative round at draft depth ``k`` (a ladder rung):
        ``(emitted, j, cur', new_len, ok)``, all on the device."""
        pk = self._spec_pks[k]
        if self._dspec:
            return serving_spec_draft_step(
                self._params, self._dparams, self._cfg, self._dcfg, cur,
                self._kv.caches, None if self._paged else self._dcaches,
                dev_len, active, spec_k=k, chunk_size=self._chunk,
                block_tables=self._tables(),
                draft_tables=(self._kv.device_draft_tables()
                              if self._paged else None),
                program_key=pk, branch_count=self._tree_taken,
                tp_group=self._tp_group)
        return serving_spec_step(
            self._params, self._cfg, cur, self._kv.caches, dev_len,
            self._hist, self._hist_len, active, spec_k=k,
            chunk_size=self._chunk, block_tables=self._tables(),
            program_key=pk, tp_group=self._tp_group)

    def _call_prefill_slot(self, tokens, prompt_len, slot):
        first, ok, _ = serving_prefill_slot(
            self._params, self._cfg, h2d(tokens, self._device), prompt_len,
            self._kv.caches, slot, chunk_size=self._chunk,
            program_key=self._pk, hist=self._hist, hist_len=self._hist_len,
            tp_group=self._tp_group)
        return first, ok

    def _call_prefill_chunk(self, chunk, offset, prompt_len, slot):
        first, ok, _ = serving_prefill_chunk(
            self._params, self._cfg, h2d(chunk, self._device), offset,
            prompt_len, self._kv.caches, slot, chunk_size=self._chunk,
            block_tables=self._tables(), program_key=self._pk,
            hist=self._hist, hist_len=self._hist_len,
            tp_group=self._tp_group)
        return first, ok

    def _call_draft_prefill_chunk(self, chunk, offset, prompt_len, slot):
        """One DRAFT-model prefill chunk: fills the draft tenant's rows
        (paged: the first ``d`` pool layers through the draft tables;
        dense: the separate draft caches).  Its first token and finite
        flag are dropped — draft KV only moves the accept rate."""
        serving_prefill_chunk(
            self._dparams, self._dcfg, h2d(chunk, self._device), offset,
            prompt_len, self._kv.caches if self._paged else self._dcaches,
            slot, chunk_size=self._chunk,
            block_tables=(self._kv.device_draft_tables() if self._paged
                          else None), program_key=self._pk,
            tp_group=self._tp_group)

    # ------------------------------------------------ adaptive draft depth
    def _reset_spec_slot(self, slot):
        """A fresh request in ``slot``: restart its accept window at the
        ladder's top (its draftability is unknown)."""
        if self._awin is not None:
            self._awin[slot].reset()
            self._k_want[slot] = len(self._k_rungs) - 1

    def _adapt_k(self, rounds, k):
        """Feed drained rounds ``[(slot, j)]`` at depth ``k`` into each
        slot's window; with a full window, >= 80% accepted moves the
        slot's wanted rung up one, <= 40% down one.  The batch depth is
        chosen at the NEXT dispatch."""
        if self._awin is None:
            return
        for slot, j in rounds:
            w = self._awin[slot]
            w.push(k, j)
            r = w.rate()
            if r is None or len(w) < w.window:
                continue
            if r >= 0.8 and self._k_want[slot] < len(self._k_rungs) - 1:
                self._k_want[slot] += 1
            elif r <= 0.4 and self._k_want[slot] > 0:
                self._k_want[slot] -= 1

    def _next_k(self, live):
        """The batch depth for the next dispatch: the most conservative
        live slot's wanted rung, approached one rung a round."""
        if self._awin is None or not live:
            return self._k_cur
        want = min(self._k_want[i] for i in live)
        cur = self._k_rungs.index(self._k_cur)
        nxt = cur + (1 if want > cur else -1 if want < cur else 0)
        self._k_cur = self._k_rungs[nxt]
        if self._m is not None:
            self._m.spec_draft_k.set(self._k_cur)
        return self._k_cur

    def _admit(self):
        free = self._kv.free_slots()
        if not free or not self._queue:
            return
        if self._policy == "gang" and len(free) < self._B:
            return  # run-to-completion: wait for the whole batch to drain
        if self._pchunk is None:
            self._admit_monolithic(free)
            return
        m = self._m
        P = self._pchunk
        while free and self._queue:
            # the highest-priority waiter first; max() is stable, so
            # all-default traffic admits in exact FIFO order.  ``tok`` is
            # the (re-)admission sequence: a preemption resume includes
            # its emitted tokens and re-adopts its parked chain
            r = max(self._queue, key=lambda q: q.priority)
            tok = self._admission_ids(r)
            p = int(tok.size)
            off0, shared, budget, need, host_tok = 0, [], 0, 0, 0
            doff0, dshared, dbudget = 0, [], 0
            if self._paged:
                # token-budget admission: reserve the request's worst-case
                # block count minus its radix-matched prefix (aligned down
                # to a prefill-chunk boundary: byte-identity across hit
                # and miss), host-tier restores included; a head the pool
                # can't cover defers
                C = self._kv.block
                need, off0, budget, shared, host_tok = \
                    self._admission_budget(r, restore=True)
                if self._dspec:
                    # the draft chain needs the same block count (its
                    # own namespace), reserved up front so a slot is
                    # never stranded with target KV and no draft KV
                    doff0, dshared = self._kv.match_draft_prefix(tok)
                    if P > C:
                        doff0 = (doff0 // P) * P
                        dshared = dshared[:doff0 // C]
                    dbudget = -(-need // C) - len(dshared)
                if not self._kv.can_reserve(budget + dbudget):
                    if self._fr is not None:
                        self._fr.record("admit_defer", step=self._step_idx,
                                        rid=r.rid,
                                        need_blocks=budget + dbudget)
                    break
            self._queue.remove(r)
            slot = free.pop(0)
            self._kv.assign(slot, r)
            self._reset_spec_slot(slot)
            if self._paged:
                self._kv.adopt_prefix(slot, shared)
                if self._dspec:
                    self._kv.adopt_draft_prefix(slot, dshared)
                self._kv.reserve(slot, budget + dbudget)
                self._need_rows[slot] = need
                self._n_prompt_tokens += p
                self._n_reuse_tokens += off0
                self._n_host_reuse_tokens += host_tok
            r._adm_ids = tok
            if r._trace is not None:
                r._trace.mark("prefilling", slot=slot)
            if self._fr is not None:
                self._fr.record("admit", step=self._step_idx, rid=r.rid,
                                slot=slot, bucket=r._bucket)
            if r.preempts:
                # a preemption resume: the adopted chain covers [0, off0),
                # the suffix is the whole recompute cost
                self._n_resume_suffix += p - off0
                self._n_resume_total += p
                if self._fr is not None:
                    self._fr.record("resume", step=self._step_idx,
                                    rid=r.rid, slot=slot,
                                    suffix_tokens=p - off0, total_tokens=p)
                if m is not None:
                    m.preempt_resume_tokens.inc(p - off0)
            padded = np.zeros((-(-p // P) * P,), np.int32)
            padded[:p] = tok
            if off0 and self._fr is not None:
                self._fr.record("prefix_hit", step=self._step_idx,
                                rid=r.rid, slot=slot, tokens=off0,
                                host_tokens=host_tok)
            if off0 and self._hist is not None:
                # the skipped chunks would have written history columns
                # [0, off0): rebuild the slot's whole prompt row (draft
                # quality only — emission never depends on it)
                row = np.zeros((self._lmax,), np.int32)
                w = min(padded.size, self._lmax)
                row[:w] = padded[:w]
                self._hist[slot] = h2d(row, self._device)
            self._pf[slot] = {"req": r, "tok": padded, "p": p, "off": off0,
                              "doff": doff0, "first": None, "okf": None}
            if m is not None:
                m.admitted.inc()
                m.prefill(r._bucket)
                if self._paged:
                    m.prompt_tokens.inc(p)
                if off0:
                    m.prefix_reuse_tokens.inc(off0)
                    if off0 > host_tok:
                        m.prefix_hit("device")
                    if host_tok:
                        m.prefix_hit("host")
                m.queue_wait.observe(time.perf_counter() - r.t_submit)
        if m is not None:
            m.queue_depth.set(len(self._queue))
            m.slots_occupied.set(self._kv.occupied())
            m.live_tokens.set(self._kv.live_tokens())

    def _admit_monolithic(self, free):
        """``prefill_chunk=None``: admit queued requests FIFO into the
        free slots, each prompt in one ``[1, bucket]`` prefill
        (``serving_prefill_slot``), then read the wave's first tokens and
        finite flags from the device once and emit them.  Those slots
        join the next dispatch with host-known tokens and lengths
        (``_adm_pending``)."""
        self._adm_wave = True
        m = self._m
        pending = []
        while free and self._queue:
            r = self._queue.popleft()
            slot = free.pop(0)
            self._kv.assign(slot, r)
            self._reset_spec_slot(slot)
            p = int(r.prompt_ids.size)
            if r._trace is not None:
                r._trace.mark("prefilling", slot=slot)
            if self._fr is not None:
                self._fr.record("admit", step=self._step_idx, rid=r.rid,
                                slot=slot, bucket=r._bucket)
            if m is not None:
                m.admitted.inc()
                m.prefill(r._bucket)
                m.queue_wait.observe(time.perf_counter() - r.t_submit)
            tokens = np.zeros((1, r._bucket), np.int32)
            tokens[0, :p] = r.prompt_ids
            with m.span_prefill if m is not None else _NULL_CTX:
                first, okf = self._call_prefill_slot(tokens, p, slot)
            self._kv.lengths[slot] = p
            self._adm_pending.add(slot)
            pending.append((slot, first, okf))
        # every prefill of the wave is enqueued; one wait for all of their
        # first tokens and finite flags
        vals = _host_fetch(_Fetch([x for _, f, o in pending
                                   for x in (f, o)]))
        for n, (slot, _, _) in enumerate(pending):
            fv, ov = vals[2 * n], vals[2 * n + 1]
            if not bool(ov[0]):
                self._retire(slot, "poisoned")
                continue
            self._cur[slot] = int(fv[0])
            self._emit(slot, [int(fv[0])])
        if m is not None:
            m.queue_depth.set(len(self._queue))
            m.slots_occupied.set(self._kv.occupied())

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
                    k = st["off"] // P
                    if st["req"]._trace is not None:
                        st["req"]._trace.mark("prefilling", chunk=k,
                                              slot=slot)
                    if self._fr is not None:
                        self._fr.record("prefill_chunk",
                                        step=self._step_idx,
                                        rid=st["req"].rid, slot=slot,
                                        chunk=k)
                    if self._paged:
                        # map the chunk's real rows before its writes go
                        # out (pad rows past the prompt drop on the
                        # sentinel)
                        self._kv.ensure_rows(
                            slot, min(st["off"] + P, st["p"]))
                    chunk = st["tok"][st["off"]:st["off"] + P][None, :]
                    with m.span_prefill if m is not None else _NULL_CTX:
                        first, okf = self._call_prefill_chunk(
                            chunk, st["off"], st["p"], slot)
                    st["off"] += P
                    if m is not None:
                        m.prefill_chunks.inc()
                    if st["off"] >= st["p"]:
                        st["first"], st["okf"] = first, okf
                if self._dspec and st["doff"] < st["p"]:
                    # the draft's prompt KV rides the same budget unit:
                    # one target chunk + one draft chunk a spend, with its
                    # own cursor (a target radix hit skips chunks the
                    # draft may still need)
                    if self._paged:
                        self._kv.ensure_draft_rows(
                            slot, min(st["doff"] + P, st["p"]))
                    with m.span_prefill if m is not None else _NULL_CTX:
                        self._call_draft_prefill_chunk(
                            st["tok"][st["doff"]:st["doff"] + P][None, :],
                            st["doff"], st["p"], slot)
                    st["doff"] += P
                budget -= 1
                spent += 1
                if st["off"] >= st["p"] and (
                        not self._dspec or st["doff"] >= st["p"]):
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
            # the admission ids: a resume's chain covers its emitted tokens
            self._kv.register_prefix(slot, r._adm_ids)
            if self._dspec:
                self._kv.register_draft_prefix(slot, r._adm_ids)
        self._cur[slot] = int(fv[0])
        return self._emit(slot, [int(fv[0])])

    def _flush_firsts(self):
        """Synchronous-mode first-token drain: wait once for the wave of
        pending final chunks and emit."""
        if not self._pending_firsts:
            return 0
        pend, self._pending_firsts = self._pending_firsts, []
        vals = self._fetch("drain", _Fetch([x for _, _, f, o in pend
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
                if r._trace is not None:
                    r._trace.mark("decoding", slot=slot)
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
                    if self._faults is not None:
                        self._faults.maybe_crash_stream_cb(self._step_idx)
                    r.stream_cb(r, r.output_ids[-took:])
                except Exception as e:  # a user callback must not kill
                    if m is not None:   # the scheduler mid-batch
                        m.stream_cb_error(type(e).__name__)
                    if not r._cb_err_logged:
                        r._cb_err_logged = True
                        _LOG.warning(
                            "stream_cb for request %r raised %s: %s — "
                            "further errors from this request are "
                            "counted but not logged", r.rid,
                            type(e).__name__, e)
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
            self._on_terminal(r, "done", slot=slot)
        return took

    # ------------------------------------------------------------ step / run
    @torch.no_grad()
    def step(self):
        """One scheduler iteration: admit, spend the prefill budget, then
        one decode dispatch over every live slot (under the
        ``serving.step`` span).  Returns tokens emitted."""
        self._last_step_unix = time.time()
        m = self._m
        if m is None:
            return self._step_impl()
        m.steps.inc()
        m.last_step_time.set(self._last_step_unix)
        with m.span_step:
            return self._step_impl()

    def _step_impl(self):
        self._step_idx += 1
        if self._faults is not None:
            stalled = self._faults.maybe_slow_step(self._step_idx)
            if stalled and self._fr is not None:
                self._fr.record("stall", step=self._step_idx,
                                seconds=stalled, injected=True)
        self._expire_deadlines()
        self._apply_poison()
        self._apply_host_corrupt()
        self._maybe_preempt()
        self._adm_wave = False
        self._admit()
        spent = self._spend_prefill()
        # an admission wave ran, chunks went out, or a prefill is pending
        adm_active = self._adm_wave or spent > 0 or bool(self._pf)
        if not self._pipeline:
            self._adm_pending.clear()
            out = self._step_sync(adm_active)
        else:
            # the double buffer: issue the next dispatch, then drain the
            # previous one while the new one runs on the card
            prev, self._inflight = self._inflight, None
            self._dispatch(adm_active)
            out = self._drain(prev)
        if self._paged:
            # staged demotions reach the host between steps: their
            # gathers ran long ago, ahead of the dispatches drained here
            self._kv.pump_host_tier()
        return out

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
            if self._dspec:
                # the draft chain writes the same rows this round (its
                # appends ride the same lengths)
                self._kv.ensure_draft_rows(i, upto)

    def _step_sync(self, adm_active=False):
        """``pipeline=False``: dispatch one step and wait for its tokens
        in the same iteration."""
        emitted = self._flush_firsts()
        live = [i for i in range(self._B) if self._decodable(i)]
        if not live:
            return emitted
        self._ensure_decode_rows(live)
        m = self._m
        active = np.array([self._decodable(i) for i in range(self._B)])
        cur = h2d(self._cur, self._device)
        dev_len = self._kv.device_lengths(active)
        self._record_dispatch(live, False)
        if self._mode == "spec":
            k = self._next_k(live)
            self._record_draft(k, live)
            dev_active = h2d(active, self._device)

            def go(attempt):
                self._fault_point("dispatch", attempt)
                return self._call_spec(cur, dev_len, dev_active, k)
            with m.span_spec if m is not None else _NULL_CTX:
                blk, j, cur2, _, oks = self._retry(go, "spec dispatch")
                blk, j, cur2, oks = self._fetch(
                    "drain", _Fetch([blk, j, cur2, oks]))
            if self._fr is not None:
                self._fr.record("drain", step=self._step_idx, mode="spec",
                                n_live=len(live))
            rounds = []
            for i in live:
                if not bool(oks[i]):
                    self._retire(i, "poisoned")
                    continue
                emitted += self._emit(i, blk[i, :int(j[i]) + 1].tolist())
                self._kv.lengths[i] += int(j[i]) + 1
                self._cur[i] = cur2[i]
                rounds.append((i, int(j[i])))
            self._spec_drained(rounds, k, adm_active)
            return emitted
        def go(attempt):
            self._fault_point("dispatch", attempt)
            return self._call_decode(cur, dev_len)
        with m.span_decode if m is not None else _NULL_CTX:
            toks, okd = self._retry(go, "decode dispatch")
            toks, okd = self._fetch("drain", _Fetch([toks, okd]))
        if self._fr is not None:
            self._fr.record("drain", step=self._step_idx, mode="greedy",
                            n_live=len(live))
        self._observe_interference(adm_active, self._sync)
        for i in live:
            if not bool(okd[i]):
                self._retire(i, "poisoned")
                continue
            emitted += self._emit(i, toks[i].tolist())
            self._kv.lengths[i] += self._sync
            self._cur[i] = toks[i, -1]
        return emitted

    def _record_dispatch(self, live, pipelined):
        """The recorder's ``dispatch`` event of one decode dispatch."""
        if self._fr is None:
            return
        extra = {"pipelined": True} if pipelined else {}
        self._fr.record("dispatch", step=self._step_idx, mode=self._mode,
                        n_live=len(live), **extra, kv_quant=self._kvq,
                        attn_impl=self._attn_impl,
                        prefill_impl=self._prefill_impl,
                        weight_dtype=self._wq)

    def _record_draft(self, k, live):
        """The recorder's ``draft`` event of one spec dispatch."""
        if self._fr is not None:
            self._fr.record("draft", step=self._step_idx,
                            source=self._spec.source, k=k, n_live=len(live))

    def _spec_drained(self, rounds, k, adm_active):
        """Book one drained verify round: ``rounds`` ``[(slot, j)]`` of
        the slots that emitted, each of which drafted ``k`` and accepted
        ``j`` (the +1 bonus token is the verify forward's own pick)."""
        accepted = sum(j for _, j in rounds)
        if self._fr is not None:
            self._fr.record("verify", step=self._step_idx, k=k,
                            drafted=k * len(rounds), accepted=accepted)
            self._fr.record("rewind", step=self._step_idx,
                            tokens=k * len(rounds) - accepted)
        self._adapt_k(rounds, k)
        self._observe_interference(
            adm_active, 1.0 + accepted / max(1, len(rounds)))
        if self._m is not None and rounds:
            self._m.spec_round(k * len(rounds), accepted)

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
        m = self._m
        self._record_dispatch(live, True)
        active = np.array([self._decodable(i) for i in range(self._B)])
        host_len = self._kv.device_lengths(active)
        host_cur = h2d(self._cur, self._device)
        # the host knows better for dead slots and for slots a monolithic
        # prefill admitted since the last dispatch
        use_host = ~active
        use_host[list(self._adm_pending)] = True
        self._adm_pending.clear()
        if self._dev_cur is None:
            cur = host_cur
        else:
            cur = torch.where(h2d(use_host, self._device), host_cur,
                              self._dev_cur)
        fresh = list(self._dev_first)
        for s, f in self._dev_first.items():
            cur[s] = f[0]
        self._dev_first.clear()
        firsts, self._pending_firsts = self._pending_firsts, []
        fo = [x for _, _, f, o in firsts for x in (f, o)]
        if self._mode == "spec":
            # spec lengths advance by the DEVICE-known j+1: the previous
            # round's new_len is the carry; the host mirror is right only
            # for dead slots (masked to lmax), freshly admitted ones and
            # slots whose final prefill chunk just went out (the prompt
            # length)
            use_host[fresh] = True
            dev_len = host_len if self._dev_len is None else torch.where(
                h2d(use_host, self._device), host_len, self._dev_len)
            k = self._next_k(live)
            self._record_draft(k, live)
            dev_active = h2d(active, self._device)

            def go(attempt):
                self._fault_point("dispatch", attempt)
                return self._call_spec(cur, dev_len, dev_active, k)
            with m.span_spec if m is not None else _NULL_CTX:
                blk, j, cur2, new_len, oks = self._retry(go,
                                                         "spec dispatch")
            self._dev_cur, self._dev_len = cur2, new_len
            self._inflight = {"fetch": _Fetch([blk, j, oks] + fo), "k": k,
                              "reqs": list(self._kv.reqs), "live": live,
                              "firsts": firsts, "adm": adm_active}
            if m is not None:
                m.inflight.set(1)
            return
        def go(attempt):
            self._fault_point("dispatch", attempt)
            return self._call_decode(cur, host_len)
        with m.span_decode if m is not None else _NULL_CTX:
            toks, okd = self._retry(go, "decode dispatch")
        self._dev_cur = toks[:, -1]
        # greedy lengths are host-derivable: every live slot advances
        # exactly sync_every per dispatch
        for i in live:
            self._kv.lengths[i] += self._sync
        fetch = _Fetch([toks, okd] + fo)
        self._inflight = {"fetch": fetch, "reqs": list(self._kv.reqs),
                          "live": live, "firsts": firsts, "adm": adm_active}
        if m is not None:
            m.inflight.set(1)

    def _drain(self, rec):
        """Wait for the PREVIOUS dispatch's outputs (the next one is
        already issued) and emit them.  A slot whose Request changed since
        that dispatch gets its stale tokens discarded."""
        if rec is None:
            return 0
        m = self._m
        still_inflight = 1 if self._inflight is not None else 0
        t0 = time.perf_counter()
        vals = self._fetch("drain", rec["fetch"])
        stall = time.perf_counter() - t0
        spec = "k" in rec
        nout = 3 if spec else 2
        fvals = vals[nout:]
        if m is not None:
            m.pipeline_stall.observe(stall)
            m.inflight.set(still_inflight)
        if self._fr is not None:
            self._fr.record("stall", step=self._step_idx, seconds=stall)
            self._fr.record("drain", step=self._step_idx,
                            mode="spec" if spec else "greedy",
                            n_live=len(rec["live"]), pipelined=True)
        if not spec:
            self._observe_interference(rec["adm"], self._sync)
        emitted = 0
        # first tokens were dispatched before this decode step (stream
        # order): emit them ahead of the slot's decode block
        for n, (slot, r, _, _) in enumerate(rec["firsts"]):
            if self._kv.reqs[slot] is not r:
                continue
            emitted += self._emit_first(slot, r, fvals[2 * n],
                                        fvals[2 * n + 1])
        if spec:
            blk, j, oks = vals[:3]
            rounds = []
            for i in rec["live"]:
                if self._kv.reqs[i] is not rec["reqs"][i]:
                    continue
                if not bool(oks[i]):
                    self._retire(i, "poisoned")
                    continue
                emitted += self._emit(i, blk[i, :int(j[i]) + 1].tolist())
                self._kv.lengths[i] += int(j[i]) + 1
                rounds.append((i, int(j[i])))
            self._spec_drained(rounds, rec["k"], rec["adm"])
            return emitted
        toks, okd = vals[:2]
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
        """Run to quiescence (deadlines and faults still apply);
        ``{rid: terminal status}`` over every request the engine
        finished."""
        self.run()
        return {r.rid: r.status for r in self._finished}

    def close(self):
        """Abort outstanding work: drain the inflight pipelined dispatch
        first (its tokens still emit, so in-flight requests keep their
        partial output), then retire every queued and resident request
        as ``"cancelled"``.  Returns ``{rid: terminal status}`` over every
        request the engine finished; a second call returns the same
        map.  Stops the watchdog first."""
        if self._watchdog is not None:
            self._watchdog.stop()
        if self._inflight is not None:
            prev, self._inflight = self._inflight, None
            self._drain(prev)
        while self._queue:
            self._terminal_queued(self._queue.popleft(), "cancelled")
        for slot in range(self._B):
            if self._kv.reqs[slot] is not None:
                self._retire(slot, "cancelled")
        if self._m is not None:
            self._m.queue_depth.set(len(self._queue))
        return {r.rid: r.status for r in self._finished}

    def tree_branches_taken(self):
        """Slot-rounds whose top-2 branch was taken so far (0 without a
        tree); reads one device counter, so call it outside the step
        loop."""
        if self._tree_taken is None:
            return 0
        return int(_host_fetch(_Fetch([self._tree_taken]))[0][0])

    def stats(self):
        """Scheduling snapshot: backlog, occupancy, the cumulative paged
        prompt / prefix-reuse token tallies and the preemption
        tallies."""
        return {
            "queue_depth": len(self._queue),
            "slots_occupied": self._kv.occupied(),
            "slots_total": self._B,
            "prefill_slots": len(self._pf),
            "inflight": 1 if self._inflight is not None else 0,
            "live_tokens": int(self._kv.live_tokens()),
            "prompt_tokens": self._n_prompt_tokens,
            "prefix_reuse_tokens": self._n_reuse_tokens,
            "host_reuse_tokens": self._n_host_reuse_tokens,
            "preempted": self._n_preempted,
            "preempt_resume_suffix_tokens": self._n_resume_suffix,
            "preempt_resume_total_tokens": self._n_resume_total,
        }

    # ------------------------------------------------- debug introspection
    @property
    def recorder(self):
        """The engine's ``FlightRecorder`` (None when ``recorder=False``)."""
        return self._fr

    @property
    def slo_tracker(self):
        """The engine's ``SLOTracker``."""
        return self._slo

    def requests_snapshot(self, last=64):
        """JSON-ready view of the newest ``last`` request timelines
        (still-live requests included); copies under the trace lock, so a
        scrape thread may call it mid-``step()``."""
        with self._trace_lock:
            traces = list(self._traces.values())[-int(last):]
        return {
            "n_tracked": len(traces),
            "requests": [{"rid": t.rid, "phase": t.phase,
                          "timeline": t.as_dicts()} for t in traces],
        }

    def recorder_snapshot(self, last=256):
        """JSON-ready flight-recorder view, with the fault plan when one
        is set."""
        if self._fr is None:
            return {"enabled": False}
        snap = self._fr.snapshot(last=last)
        snap["enabled"] = True
        if self._faults is not None:
            snap["fault_plan"] = self._faults.snapshot()
        return snap

    def slo_snapshot(self):
        """JSON-ready windowed SLO attainment / burn-rate view."""
        return self._slo.snapshot()

    def debug_sources(self):
        """``{name: callable}`` for ``MetricsExporter``: the engine's
        ``/debug/requests``, ``/debug/flightrecorder`` and ``/debug/slo``
        endpoints in one call::

            MetricsExporter(debug_sources=engine.debug_sources()).start()
        """
        return {"requests": self.requests_snapshot,
                "flightrecorder": self.recorder_snapshot,
                "slo": self.slo_snapshot}
