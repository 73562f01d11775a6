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

* **Speculative decoding** (``mode="spec"``, ``spec=SpecConfig(...)``):
  each round drafts ``k`` tokens a slot — by prompt lookup in the slot's
  token history (``serving_spec_step``) or with a resident draft model
  (``serving_spec_draft_step``, linear chain) — and verifies them in one
  ``[B, k+1]`` target forward (K8 with ``T = k+1`` query rows a slot on
  the card), emitting the longest matched prefix plus the target's own
  next pick: exactly the verify forward's greedy picks.  The accepted
  length is known only on the device, so a pipelined engine feeds the
  previous round's device lengths straight into the next dispatch and
  its host mirror catches up at the drain.  The adaptive policy
  (``adaptive_window``) moves the batch depth along a ladder of rungs
  ``k_min .. spec_k`` (powers of two), one ``ProgramKey`` per rung.  A
  draft model's KV lives in separate dense caches or, paged, as a second
  tenant of the same block pool (``serving/kv_cache.py``).

Not ported yet (each raises ``NotImplementedError`` naming its slice):
top-2 tree verification (``SpecConfig(tree="top2")``), tensor
parallelism, the reliability layer (deadlines, load shedding, retries,
fault injection, preemption), the request-scoped observability layer
(flight recorder, SLO tracker, watchdog), the host KV tier,
prefill/decode disaggregation and the monolithic
(``prefill_chunk=None``) prefill.
"""
from __future__ import annotations

import bisect
import dataclasses
import logging
import time
import warnings
from collections import deque

import numpy as np
import torch

from paddle_tpu_torch.core.device import h2d, resolve_impl
from paddle_tpu_torch.models.llama_decode import (
    QUANT_WEIGHTS, _decode_params_of, canon_weight_dtype,
    quantize_decode_weights, serving_decode_steps, serving_prefill_chunk,
    serving_spec_draft_step, serving_spec_step,
)
from paddle_tpu_torch.ops.decode_attention import init_kv_cache
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

__all__ = ["AcceptWindow", "KVPoolExhausted", "Request", "ServingEngine",
           "SpecConfig"]

_LOG = logging.getLogger(__name__)


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
    ladder.  ``k_min``: the ladder's floor.  ``tree``: ``None`` or
    ``"top2"`` (validated; the engine raises ``NotImplementedError`` for
    it — not ported yet)."""

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
    card) or ``"reference"`` (plain versions; CPU only).  ``mode``:
    ``"greedy"`` or ``"spec"`` (speculative decoding; ``spec`` a
    ``SpecConfig`` or its kwargs dict, ``spec_k`` the default depth).
    ``registry`` / ``instrument``: metrics.  ``recorder`` defaults to
    ``False`` here — the flight recorder is not ported yet."""

    def __init__(self, model, batch_size=8, max_len=2048, mode="greedy",
                 sync_every=1, policy="continuous", prompt_buckets=None,
                 detokenizer=None, registry=None, instrument=True,
                 pipeline=True, decode_chunk=256, prefill_chunk=256,
                 prefill_budget=2, kv_block=None, max_live_tokens=None,
                 kv_dtype=None, attn_impl=None, prefill_impl=None,
                 spec_k=8, spec=None, weight_dtype=None, mesh=None,
                 tp_axis=None, tp_overlap=None, max_pending=None,
                 retry_attempts=None, retry_backoff=None, faults=None,
                 recorder=False, slo=None, watchdog=None,
                 host_tier_bytes=None, host_tier=None,
                 host_tier_min_blocks=None, prefill_only=False,
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
            if spec.tree is not None:
                _not_ported(where, "SpecConfig(tree='top2')",
                            "top-2 tree verification (K8 with the branch "
                            "row's hidden range)")
            spec_k = spec.spec_k
        else:
            spec = None
        self._spec = spec
        self._dspec = spec is not None and spec.source == "draft_model"
        self._mode = mode
        self._spec_k = int(spec_k)
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
        self._dparams = self._dcfg = self._dcaches = None
        if self._dspec:
            self._init_draft(spec.draft_model, nkv, hd)
        self._attn_impl = _resolve_engine_impl("attn_impl", attn_impl,
                                               self._device)
        self._prefill_impl = _resolve_engine_impl(
            "prefill_impl", prefill_impl, self._device)
        # the kernels cover every verify width (T = k+1 rows a slot):
        # the gates depend on the cache geometry and head_dim only
        for hdim in (hd, self._dcfg[2]) if self._dspec else (hd,):
            if self._attn_impl == "cuda":
                reason = fused_decode_supported(self._chunk, self._lmax,
                                                hdim)
                if reason is not None:
                    raise ValueError(f"{where}: the decode kernel (K8) does "
                                     f"not cover this geometry — {reason}")
            if self._prefill_impl == "cuda":
                reason = fused_prefill_supported(
                    self._chunk, self._lmax, self._pchunk, self._paged, hdim)
                if reason is not None:
                    raise ValueError(f"{where}: the prefill kernel (K9) "
                                     f"does not cover this geometry — "
                                     f"{reason}")
        self._pk = ProgramKey(attn_impl=self._attn_impl,
                              prefill_impl=self._prefill_impl,
                              kv_dtype="int8" if self._q8 else None,
                              weight_dtype="int8" if self._w8 else None,
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
        if self._paged:
            # a draft model is a second pool tenant whose chains grow in
            # lockstep with the target's, so the default pool doubles (an
            # explicit max_live_tokens is respected as given)
            self._kv = PagedKVCacheManager(
                len(self._params["layers"]), self._B, self._lmax, nkv, hd,
                dtype, block=kv_block,
                max_live_tokens=(int(max_live_tokens) if max_live_tokens
                                 else (2 if self._dspec else 1)
                                 * self._B * self._lmax),
                device=self._device, on_event=self._kv_event)
        else:
            self._kv = KVCacheManager(len(self._params["layers"]), self._B,
                                      self._lmax, nkv, hd, dtype,
                                      device=self._device)
            if self._dspec:
                # dense draft tenancy: separate per-draft-layer caches
                # (dense rows are slot-indexed; sharing would clobber)
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
        # the prompt-lookup history, on the device (a draft model needs
        # none)
        self._hist = self._hist_len = None
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

    # ------------------------------------------------------------- scheduling
    @property
    def has_work(self):
        return (bool(self._queue) or self._kv.any_live()
                or self._inflight is not None)

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
        if dev != self._device:
            raise ValueError(f"{where}: the draft model is on {dev}, the "
                             f"target on {self._device}")
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

    def _headroom(self):
        # greedy may overshoot a retiring slot by < sync_every cache rows,
        # spec's verify forward writes spec_k+1 rows before the rewind; a
        # pipelined engine discovers retirement one drain late
        per = self._spec_k + 1 if self._mode == "spec" else self._sync
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
            draft_used = self._kv.draft_blocks_used()
            self._m.set_kv_blocks(self._kv.blocks_used() - draft_used,
                                  draft_used, self._kv.free_count())

    def _tables(self):
        return self._kv.device_tables() if self._paged else None

    def _call_decode(self, cur, dev_len):
        toks, ok, _ = serving_decode_steps(
            self._params, self._cfg, cur, self._kv.caches, dev_len,
            n_steps=self._sync, chunk_size=self._chunk,
            block_tables=self._tables(), program_key=self._pk)
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
                program_key=pk)
        return serving_spec_step(
            self._params, self._cfg, cur, self._kv.caches, dev_len,
            self._hist, self._hist_len, active, spec_k=k,
            chunk_size=self._chunk, block_tables=self._tables(),
            program_key=pk)

    def _call_prefill_chunk(self, chunk, offset, prompt_len, slot):
        first, ok, _ = serving_prefill_chunk(
            self._params, self._cfg, h2d(chunk, self._device), offset,
            prompt_len, self._kv.caches, slot, chunk_size=self._chunk,
            block_tables=self._tables(), program_key=self._pk,
            hist=self._hist, hist_len=self._hist_len)
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
                          else None), program_key=self._pk)

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
        m = self._m
        P = self._pchunk
        while free and self._queue:
            r = self._queue[0]
            tok = r.prompt_ids
            p = int(tok.size)
            off0, shared, budget, need = 0, [], 0, 0
            doff0, dshared, dbudget = 0, [], 0
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
                    break
            self._queue.popleft()
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
            padded = np.zeros((-(-p // P) * P,), np.int32)
            padded[:p] = tok
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
                if self._dspec and st["doff"] < st["p"]:
                    # the draft's prompt KV rides the same budget unit:
                    # one target chunk + one draft chunk a spend, with its
                    # own cursor (a target radix hit skips chunks the
                    # draft may still need)
                    if self._paged:
                        self._kv.ensure_draft_rows(
                            slot, min(st["doff"] + P, st["p"]))
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
            self._kv.register_prefix(slot, r.prompt_ids)
            if self._dspec:
                self._kv.register_draft_prefix(slot, r.prompt_ids)
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
        active = np.array([self._decodable(i) for i in range(self._B)])
        cur = h2d(self._cur, self._device)
        dev_len = self._kv.device_lengths(active)
        if self._mode == "spec":
            k = self._next_k(live)
            blk, j, cur2, _, oks = self._call_spec(
                cur, dev_len, h2d(active, self._device), k)
            blk, j, cur2, oks = _host_fetch(_Fetch([blk, j, cur2, oks]))
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
        toks, okd = self._call_decode(cur, dev_len)
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

    def _spec_drained(self, rounds, k, adm_active):
        """Book one drained verify round: ``rounds`` ``[(slot, j)]`` of
        the slots that emitted, each of which drafted ``k`` and accepted
        ``j`` (the +1 bonus token is the verify forward's own pick)."""
        accepted = sum(j for _, j in rounds)
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
        active = np.array([self._decodable(i) for i in range(self._B)])
        host_len = self._kv.device_lengths(active)
        host_cur = h2d(self._cur, self._device)
        if self._dev_cur is None:
            cur = host_cur
        else:
            cur = torch.where(h2d(~active, self._device), host_cur,
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
            # for dead slots (masked to lmax) and slots whose final
            # prefill chunk just went out (the prompt length)
            use_host = ~active
            use_host[fresh] = True
            dev_len = host_len if self._dev_len is None else torch.where(
                h2d(use_host, self._device), host_len, self._dev_len)
            k = self._next_k(live)
            blk, j, cur2, new_len, oks = self._call_spec(
                cur, dev_len, h2d(active, self._device), k)
            self._dev_cur, self._dev_len = cur2, new_len
            self._inflight = {"fetch": _Fetch([blk, j, oks] + fo), "k": k,
                              "reqs": list(self._kv.reqs), "live": live,
                              "firsts": firsts, "adm": adm_active}
            if self._m is not None:
                self._m.inflight.set(1)
            return
        toks, okd = self._call_decode(cur, host_len)
        self._dev_cur = toks[:, -1]
        # greedy lengths are host-derivable: every live slot advances
        # exactly sync_every per dispatch
        for i in live:
            self._kv.lengths[i] += self._sync
        fetch = _Fetch([toks, okd] + fo)
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
        spec = "k" in rec
        nout = 3 if spec else 2
        fvals = vals[nout:]
        if m is not None:
            m.pipeline_stall.observe(time.perf_counter() - t0)
            m.inflight.set(still_inflight)
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
