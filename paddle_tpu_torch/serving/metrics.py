"""Pre-bound observability series for one serving engine.

Counterpart of ``paddle_tpu/serving/metrics.py`` ``EngineMetrics``,
trimmed to the families this slice's engine posts: request and token
counters, TTFT / TPOT / end-to-end latency, queue wait, chunked-prefill
progress, the pipelined-dispatch stall, paged-pool occupancy by tenant
(target / draft), prefix reuse, the speculative-decoding series
(drafted / accepted counters, the accept rate and draft-source info
gauge by source, the depth in effect; ``paddle_tpu/serving/
metrics.py:135-167``), the decode / prefill implementation info
gauges, the int8 KV / weight quantization info gauges with their
analytic bytes per token (``paddle_tpu/serving/metrics.py:279-290,
323-335``), and the reliability series — requests retired by reason
(shed / timed out / cancelled / poisoned), dispatch retries, priority
preemptions and their resume cost, and ``stream_cb`` errors by
exception type (``paddle_tpu/serving/metrics.py:93-135, 220-232,
386-390``), every one registered at zero at construction.  The series
live in ``registry`` (default: the process-wide one) under a ``policy``
label; every touch is host-side bookkeeping.
"""
from __future__ import annotations

from paddle_tpu_torch.observability.metrics import get_registry

__all__ = ["EngineMetrics"]

_IMPLS = ("reference", "cuda")
_QUANT_MODES = ("off", "int8")
_SPEC_SOURCES = ("prompt_lookup", "draft_model")


class EngineMetrics:
    """One engine's metric children, bound once at construction."""

    def __init__(self, registry, policy, batch_size):
        reg = registry if registry is not None else get_registry()
        self.registry = reg
        L = ("policy",)
        lbl = {"policy": policy}
        self._policy = policy
        self.queue_depth = reg.gauge(
            "serving_queue_depth", "requests waiting for a slot",
            L).labels(**lbl)
        self.slots_occupied = reg.gauge(
            "serving_slots_occupied", "batch slots holding a live request",
            L).labels(**lbl)
        self.slots_total = reg.gauge(
            "serving_slots_total", "engine batch size", L).labels(**lbl)
        self.slots_total.set(batch_size)
        self.admitted = reg.counter(
            "serving_requests_admitted_total",
            "requests admitted into a slot", L).labels(**lbl)
        self.retired = reg.counter(
            "serving_requests_retired_total",
            "requests completed (EOS or max_new_tokens)", L).labels(**lbl)
        # the reliability series, pre-bound so a scrape sees them at 0
        # before the first shed / timeout / cancel / poison / retry
        self.shed = reg.counter(
            "serving_requests_shed_total",
            "requests rejected at submit() by the bounded admission "
            "queue (load shedding)", L).labels(**lbl)
        self.timed_out = reg.counter(
            "serving_requests_timed_out_total",
            "requests retired by deadline_ms expiry", L).labels(**lbl)
        self.cancelled = reg.counter(
            "serving_requests_cancelled_total",
            "requests retired by host-side cancel()/close()",
            L).labels(**lbl)
        self.poisoned = reg.counter(
            "serving_requests_poisoned_total",
            "requests quarantined after non-finite logits",
            L).labels(**lbl)
        self.dispatch_retries = reg.counter(
            "serving_dispatch_retries_total",
            "transient dispatch/drain failures retried with backoff",
            L).labels(**lbl)
        self.preempted = reg.counter(
            "serving_preempted_total",
            "resident requests parked by priority preemption (blocks "
            "released evictable, the radix chain kept for the resume)",
            L).labels(**lbl)
        self.preempt_resume_tokens = reg.counter(
            "serving_preempt_resume_tokens_total",
            "suffix tokens prefilled when preempted requests resumed "
            "(the preemption recompute cost)", L).labels(**lbl)
        # by exception type; the error="Exception" child is registered so
        # the family exports before the first crash
        self._stream_cb_errors = reg.counter(
            "serving_stream_cb_errors_total",
            "stream_cb exceptions swallowed by the scheduler, by "
            "exception type", ("policy", "error"))
        self._stream_cb_errors.labels(policy=policy, error="Exception")
        self.emitted = reg.counter(
            "serving_tokens_emitted_total",
            "tokens delivered to requests", L).labels(**lbl)
        self.steps = reg.counter(
            "serving_steps_total", "scheduler iterations", L).labels(**lbl)
        self._prefills = reg.counter(
            "serving_prefill_total", "slot prefills by prompt bucket",
            ("policy", "bucket"))
        self.queue_wait = reg.histogram(
            "serving_queue_wait_seconds",
            "submit -> slot admission", L).labels(**lbl)
        self.ttft = reg.histogram(
            "serving_ttft_seconds", "submit -> first token", L).labels(**lbl)
        self.tpot = reg.histogram(
            "serving_tpot_seconds",
            "mean per-token time after the first", L).labels(**lbl)
        self.e2e = reg.histogram(
            "serving_e2e_seconds", "submit -> completion", L).labels(**lbl)
        self.prefill_chunks = reg.counter(
            "serving_prefill_chunks_total",
            "prompt chunks dispatched by the chunked-prefill path",
            L).labels(**lbl)
        self.prefill_backlog = reg.gauge(
            "serving_prefill_backlog",
            "prompt chunks still to dispatch across slots mid-prefill",
            L).labels(**lbl)
        self.tpot_admission = reg.histogram(
            "serving_tpot_during_admission_seconds",
            "per-token decode interval observed while a chunked prefill "
            "was in progress — the decode-interference histogram",
            L).labels(**lbl)
        self.pipeline_stall = reg.histogram(
            "serving_pipeline_stall_seconds",
            "drain-side block waiting on the inflight dispatch",
            L).labels(**lbl)
        self.inflight = reg.gauge(
            "serving_inflight_steps",
            "device steps dispatched but not yet drained", L).labels(**lbl)
        self.spec_drafted = reg.counter(
            "serving_spec_drafted_total",
            "draft tokens proposed per speculative round", L).labels(**lbl)
        self.spec_accepted = reg.counter(
            "serving_spec_accepted_total",
            "draft tokens accepted by the verify forward", L).labels(**lbl)
        # by draft source, both children pre-registered; the engine
        # points set_spec_source at its own
        self.spec_accept_rate = reg.gauge(
            "serving_spec_accept_rate",
            "cumulative accepted/drafted ratio, by draft source",
            ("policy", "source"))
        self._spec_draft_source = reg.gauge(
            "serving_spec_draft_source",
            "draft-source info gauge: the child whose source label names "
            "the engine's drafting policy reads 1, the other "
            "pre-registered child 0", ("policy", "source"))
        for source in _SPEC_SOURCES:
            self.spec_accept_rate.labels(policy=policy, source=source)
            self._spec_draft_source.labels(policy=policy,
                                           source=source).set(0)
        self._spec_source = "prompt_lookup"
        self.spec_draft_k = reg.gauge(
            "serving_spec_draft_k",
            "draft tokens per speculative round currently in effect "
            "(moves under the adaptive-k policy; fixed-k engines hold "
            "the constructor knob)", L).labels(**lbl)
        # pool occupancy by tenant: target = the served model's chains
        # plus evictable cached prefixes, draft = the draft model's live
        # chains (0 again after drain)
        self.kv_blocks_used = reg.gauge(
            "serving_kv_blocks_used",
            "KV pool blocks live or holding an evictable cached prefix, "
            "by tenant model", ("policy", "model"))
        for model in ("target", "draft"):
            self.kv_blocks_used.labels(policy=policy, model=model)
        self.kv_blocks_free = reg.gauge(
            "serving_kv_blocks_free",
            "KV pool blocks on the free list", L).labels(**lbl)
        self.live_tokens = reg.gauge(
            "serving_live_tokens",
            "context tokens held by live slots (token-budget admission "
            "numerator)", L).labels(**lbl)
        self.prefix_reuse_tokens = reg.counter(
            "serving_prefix_reuse_tokens_total",
            "prompt tokens satisfied from cached prefix blocks instead "
            "of being prefilled", L).labels(**lbl)
        self.prompt_tokens = reg.counter(
            "serving_prompt_tokens_total",
            "prompt tokens admitted on the paged path (prefix hit-rate "
            "denominator)", L).labels(**lbl)
        self.prefix_hits = reg.counter(
            "serving_prefix_hits_total",
            "admissions that adopted a cached prefix from the pool",
            L).labels(**lbl)
        # implementation info gauges: every known child pre-registered to
        # 0, the active one set to 1 at construction
        self._decode_kernel = reg.gauge(
            "serving_decode_kernel",
            "decode cache-read implementation info gauge: 'cuda' (the "
            "hand-written paged decode kernel) or 'reference' (the plain "
            "PyTorch loop); the active child reads 1", ("policy", "impl"))
        self._prefill_kernel = reg.gauge(
            "serving_prefill_kernel",
            "chunked-prefill implementation info gauge: 'cuda' (the "
            "hand-written prefill+append kernel) or 'reference' (plain "
            "append + chunked read); the active child reads 1",
            ("policy", "impl"))
        for impl in _IMPLS:
            self._decode_kernel.labels(policy=policy, impl=impl).set(0)
            self._prefill_kernel.labels(policy=policy, impl=impl).set(0)
        # quantization info gauges (every mode pre-registered to 0, the
        # active one set to 1 at construction) and the analytic bytes
        # per token at int8 (0 when unquantized)
        self._kv_quant_mode = reg.gauge(
            "serving_kv_quant_mode",
            "KV cache quantization mode info gauge: the child whose "
            "mode label names the active storage scheme reads 1, every "
            "other pre-registered child 0", ("policy", "mode"))
        self.hbm_gb_per_tok_q8 = reg.gauge(
            "serving_hbm_gb_per_tok_q8",
            "analytic KV bytes (GB) read per context token at int8 "
            "storage: layers * 2 * Hkv * (D + 2 scale bytes); zero when "
            "kv_dtype is unquantized", L).labels(**lbl)
        self._weight_quant_mode = reg.gauge(
            "serving_weight_quant_mode",
            "decode matmul weight quantization mode info gauge: the "
            "child whose mode label names the active storage scheme "
            "reads 1, every other pre-registered child 0",
            ("policy", "mode"))
        self.hbm_gb_per_tok_w8 = reg.gauge(
            "serving_hbm_gb_per_tok_w8",
            "analytic decode-weight bytes (GB) read per generated token "
            "at int8 storage: every projection element once (1 byte) + "
            "2 f16 scale bytes per output channel; zero when "
            "weight_dtype is unquantized", L).labels(**lbl)
        for mode in _QUANT_MODES:
            self._kv_quant_mode.labels(policy=policy, mode=mode).set(0)
            self._weight_quant_mode.labels(policy=policy, mode=mode).set(0)

    def prefill(self, bucket):
        self._prefills.labels(policy=self._policy, bucket=bucket).inc()

    def terminal(self, status):
        """Count a non-``done`` terminal status (``done`` keeps its own
        ``retired`` counter)."""
        c = {"shed": self.shed, "timed_out": self.timed_out,
             "cancelled": self.cancelled,
             "poisoned": self.poisoned}.get(status)
        if c is not None:
            c.inc()

    def stream_cb_error(self, etype):
        self._stream_cb_errors.labels(policy=self._policy,
                                      error=etype).inc()

    def set_kernels(self, decode_impl, prefill_impl):
        """Point the two info gauges at the active implementations."""
        for i in _IMPLS:
            self._decode_kernel.labels(policy=self._policy, impl=i).set(
                1 if i == decode_impl else 0)
            self._prefill_kernel.labels(policy=self._policy, impl=i).set(
                1 if i == prefill_impl else 0)

    def set_kv_quant(self, mode):
        """Point the KV-quant info gauge at ``mode`` ('off' or 'int8')."""
        for m in _QUANT_MODES:
            self._kv_quant_mode.labels(policy=self._policy, mode=m).set(
                1 if m == mode else 0)

    def set_weight_quant(self, mode):
        """Point the weight-quant info gauge at ``mode``."""
        for m in _QUANT_MODES:
            self._weight_quant_mode.labels(policy=self._policy, mode=m).set(
                1 if m == mode else 0)

    def set_kv_blocks(self, target_used, draft_used, free):
        """The tenant-split pool occupancy in one call."""
        self.kv_blocks_used.labels(
            policy=self._policy, model="target").set(target_used)
        self.kv_blocks_used.labels(
            policy=self._policy, model="draft").set(draft_used)
        self.kv_blocks_free.set(free)

    def set_spec_source(self, source):
        """Point the draft-source info gauge at ``source`` and route
        later ``spec_round`` accept-rate updates to that child."""
        self._spec_source = source
        for s in _SPEC_SOURCES:
            self._spec_draft_source.labels(
                policy=self._policy, source=s).set(1 if s == source else 0)

    def spec_round(self, drafted, accepted):
        self.spec_drafted.inc(drafted)
        self.spec_accepted.inc(accepted)
        total = self.spec_drafted.value
        if total:
            self.spec_accept_rate.labels(
                policy=self._policy, source=self._spec_source).set(
                self.spec_accepted.value / total)
