#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``paddle_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero before the result line):

1. Card: name and power limit (``nvidia-smi``); build the hand-written
   kernels from ``paddle_tpu_torch/ops/csrc`` with ``nvcc`` (sm_90a).
2. Kernels against their plain PyTorch versions on the card, at the
   serving path's shapes, for bf16 and int8 caches (the int8 rows'
   written codes and scales bitwise): K8, the split-K paged decode
   attention (B 8, Hkv 4, G 4, D 128, C 256, lmax 2048, bf16 pool; dense
   and paged, T 1 and 4 and the verify widths T 2, 3, 5, 9, mixed lengths
   with a parked slot, a shuffled table with sentinels, and a batch with
   a row on every block and span edge at T 1 and 4; ``atol=rtol=1e-4``
   on the f32 output, one launch a call, two launches bitwise equal; its
   time also at T 5 and 9) and K9 fused prefill through its tensor-core
   instance (T 256, offsets 0/256/768/1792, dense and paged, a sentinel
   destination; output within 2 bf16 ulps or 1e-6, the cache BITWISE
   equal after the append).  Each kernel's time (CUDA events, after
   warm-up, rotating over four layers' caches so the 50 MB L2 does not
   hold them), its device time per launch (the profiler), its plain
   version's, one PyTorch library call's (scaled_dot_product_attention on
   a dense cache, a yardstick the port never calls) and its bound.  K8
   with hidden key ranges (the tree verify's branch row at T 3, 6, 10,
   and two whole 64-key spans hidden at T 4), dense and paged, bf16 and
   int8, bitwise run to run; its time at T 10 with and without the
   ranges, and SDPA with the same boolean mask.
3. Serving at full width: the serving bench model (vocab 32000, hidden
   2048, 16 layers, 16 heads, 4 KV heads, bf16, random weights from a
   seed) behind ``ServingEngine(batch_size=8, max_len=2048,
   kv_block=prefill_chunk=decode_chunk=256)``, 16 requests of 64-1024
   prompt and 64-256 output tokens, two sharing a 768-token prefix; run
   three times: bf16 KV, int8 KV (``bench.py`` A/B 9's configuration)
   and int8 weights, each with its token drift against the bf16 streams.
   The kernels' launch counters are set to 0 just before each run and
   read just after; the plain versions must not run, the bf16- and
   int8-KV runs must launch K8 7280 and K9 640 times, and every K9 launch
   must take its tensor-core instance.  The profiled decode window gives
   K8's device µs a decode step.
3b. Speculative serving at full width: the same model on bench_serving's
   workload (``bench.py:216-380``: prompts 64-1024 tiled from 32-token
   segments, outputs log-uniform 128-512; 16 requests where the bench
   has 64), batch 8, max_len 2048, sync_every 4, spec_k 8, in six arms:
   greedy; prompt lookup (dense, pipelined); the same with
   ``pipeline=False``; the quarter-depth draft model (4 layers, the
   target's widths, seed 1; dense); the target drafting for itself on the
   paged pool (blocks of 256, ``max_live_tokens`` 2·8·2048); prompt
   lookup with the adaptive ladder (window 8, k_min 1: T 2, 3, 5, 9) and
   int8 KV, paged; then the top-2 tree arm (self-draft, dense, its verify
   [B, 10]: K8 with the branch row's hidden range) beside its linear twin
   on the same requests.  Counters set to 0 just before each arm and
   read just after: every request finishes with its token count, K8 and
   K9 launch and no plain version runs, K8's launches by width are
   exactly the verify widths dispatched (and the drafts' one-row steps;
   the tree's every verify launch carries its range); prompt lookup
   pipelined == not, bit for bit; the self-draft arm leaks no draft block
   and accepts >= 0.9 of its drafts (in bf16 the one-row draft steps and
   the nine-row verify round near-ties differently); the tree arm takes
   at least one branch (a device count read once, after the run).
   Prints tok/s, TTFT and TPOT p50/p95, the accept rate and the drift
   of each spec arm against the greedy streams.
3c. Reliability at full width: the serving model on three short
   requests (two slots): injected dispatch and drain errors on three
   steps (streams bit-equal to a clean run in the same call), a poisoned
   request (status ``poisoned``, the others bit-equal), a cancel in
   flight, a queued deadline forced by a slow step with ``max_pending``
   shedding, and a priority preemption on a small paged pool (the
   resumed stream's drift against its unpreempted run printed).
3d. Tensor-parallel serving (``ServingEngine(mesh=DeviceMesh)``): K8 and
   K9 at a TP-2 rank's heads (the serving model split two ways: Hkv 2,
   G 4, D 128), bf16 and int8, dense and paged, against their plain
   versions with phase 2's tolerances, and their times there; then the
   first 8 requests of phase 3's mix (outputs capped at 64 tokens) at
   full width: (a) TP 1 over NCCL (``init_device_mesh("cuda", (1,))``),
   whose streams must be bitwise those of ``mesh=None``, and once with
   ``tp_overlap=2`` (bitwise or not printed); (b) TP 2 as two processes
   of this script on the one card over an explicit gloo group (NCCL
   refuses two ranks on one device; gloo stages the all-reduces through
   the host): bf16 greedy and prompt lookup on the paged pool with int8
   KV, and an f32 greedy arm (phase 4's 2-layer model, 4 requests of 24
   tokens).  Counters set to 0 just before each arm and read just after:
   every K8/K9 launch on the kernels, none on a plain version; the two
   ranks' streams bitwise equal; the f32 streams equal to the
   single-device f32 run.  Printed: the bf16 arms' drift against the
   single-device streams, and tok/s as a record only (the two ranks
   time-share the card).  Both ranks are joined with a timeout and
   stopped; a rank's failure fails the run.
3e. The request observability layer, monolithic prefill and the host KV
   tier at full width, on the serving model.  (a) Phase 3's first 8
   requests (outputs capped at 64) with the recorder on and off: the
   streams bitwise equal; the events by kind, a JSONL and a chrome-trace
   dump written and read back, every timeline ordered, the SLO gauges on
   the page; a 4 s ``FaultPlan(slow_steps=)`` stall under
   ``watchdog=1.5`` gives exactly one stall dump and ``close()`` stops
   the thread; an exporter on port 0 is scraped during a run
   (``/metrics``, ``/healthz``, ``/debug/flightrecorder``); a
   ``torch.profiler`` session over three steps shows the ``serving.*``
   spans; tok/s with the recorder on and off (record only).  (b) K8 at
   T = 64, 256 and 1024 query rows over a fresh dense ``[1, T]`` cache
   (the monolithic prefill's mini cache), bf16 and int8, against its
   plain version with phase 2's tolerances and bitwise run to run; its
   time by events and device time, its bound, and SDPA (causal) at the
   same shape.  Then phase 3's 16 requests (outputs capped at 64) on a
   dense batch cache with ``prefill_chunk=None`` against chunked
   prefill, bf16 and int8 KV: K8 launches 16 times a request at T = its
   bucket, K9 never, no plain version; the token drift between the two.
   (c) One slot on a pool of 8 blocks: the request leading the
   768-token shared prefix, the two longest others (their admission
   evicts its chain into the host tier) and the follower, whose
   admission restores the prefix: host hits and restored blocks above
   0, streams bit-equal to a pool that holds everything, and a tier
   garbled (``FaultPlan(host_tier_corrupt=)``) at the restoring step
   falls back to prefill with the same streams.
4. End-to-end parity: the same engine at full width, 2 layers, f32, on
   the card (kernels) and on the CPU (plain versions), with float KV,
   int8 KV, int8 weights, and both: the streams match token for token
   (a divergence is allowed only where the CPU's top-2 logit margin is
   below 1e-3, a near tie that summation order may break).  In f32 the
   card's monolithic prefill (dense caches) gives the streams of its
   chunked prefill, dense and paged.
5. The training path's kernels against their plain versions at the
   training shape (B 16, L 2048, H 16, Hkv 4, D 128, bf16, causal): K1/K2
   forward (out, lse), K3 delta, K4 dK/dV, K5 dQ, K6 RoPE (forward and
   inverse, bitwise; its share of the byte bound); every bf16 dQ launch
   through its wgmma instance; the forward, delta and dQ again at the
   long-context shape (B 1, L 16384: K2 and K5's streamed dQ, timed there
   with their bounds), the flash kernels once at head_dim 64.  Each
   kernel's time, its plain version's, its bound and the library
   yardstick (scaled_dot_product_attention forward; its backward stands
   for K3+K4+K5 together).  The loss chunk's bf16 logits GEMM with an f32
   result (the card's branch of ``ops/chunked_ce.py``) against the
   widened f32 GEMM at the training chunk (8192 x 2048 x 32000): loss
   and gradients.  K7, the fused int8-moment AdamW, at the bench's seven
   parameter shapes, bf16 without a master and f32 with one: bitwise
   equal to its plain version; one optimizer step of it (147 launches)
   timed against its bound.
6. Training at full width: the ``bench_llama`` configuration (the
   serving model's widths, recompute of the first 7 layers, loss chunks
   of 8192 tokens) with ``AdamW(moment_dtype="int8")`` — the bench's own
   optimizer: int8 first moments through K7 —, batch 16, seq 2048,
   random weights and data from seed 0: 2 warm-up and 5 timed steps;
   the loss must be finite and fall; every training kernel must launch
   exactly as often as the model calls it (counters set to 0 just before
   the timed steps; the forward, dK/dV and dQ through their wgmma
   instances, K6 through its vector one), and no plain version or dense
   attention may run.
   Prints tokens/s, step ms, MFU (``bench.py``'s FLOP count over the
   dense bf16 peak), peak memory, and a profiled step's device-busy
   share and top device operations.
6b. The training-step knobs at phase 6's configuration: (a) AdamW with
   int8 moments under a warmup/cosine schedule and global-norm clipping,
   merged over 2 micro-steps, 4 micro-steps: K7 launches 147 times on
   each apply step and never on the others, the parameters stay
   bit-equal across the non-apply steps, each rate is the host
   scheduler's, each clip factor its f64 recomputation's; (b) amp O1 on
   f32 parameters (batch ``AMP_BATCH``), every attention launch on the
   bf16 wgmma instances; (c) every knob at once (clip, schedule, merge,
   amp O1, recompute ``dots`` / ``named``) for Momentum, AdamW-amsgrad,
   Lamb and AdamW-int8 (K7), card against the CPU port at phase 7's
   shapes; (d) the eager ``step()`` bitwise equal to ``build_train_step``
   (Momentum + clip, full width), and ``GradScaler`` under float16
   ``auto_cast`` on a stack of ``Linear`` layers skipping a step with an
   injected inf and halving its scale; (e) recompute ``dots`` against
   ``full``.  Prints the accumulate and apply step times beside phase 6's
   plain step, each arm's peak memory, and the launches.
7. Training parity: the same trainer at full width, 2 layers, f32,
   batch 2, seq 256, 3 steps, on the card (kernels) and on the CPU
   (plain versions), with f32 and with int8 moments; with int8 moments
   every first-moment code at every step is held within what the step
   before carries (``code_drift``).  f32 takes the CUDA-core templates
   of the flash kernels; the bf16 tensor-core ones are held to their
   plain versions one kernel at a time (phase 5).

5b. The segment-masked flash kernels (K1/K2, K4, K5 with segment ids;
   K3 on their zeroed dout) against their plain versions, bf16, with
   phase 5's tolerances, at bench_bert's attention shape (B 64, L 512,
   H 12, D 64, key padding with lengths 128-512 from seed 0 and one
   all-padding row, whose output must be the mean of V) and at the
   varlen long-context shape (B 1, 16384 tokens in 16 sequences plus a
   pad tail that must come out zero, H 16, Hkv 4, D 128, causal).  Times
   at both, bounds per same-segment visible pair, and the library
   yardstick (scaled_dot_product_attention with the boolean mask, and
   its backward against K3+K4+K5); at the BERT shape also the unsegmented
   instances and SDPA without a mask, forward and backward.
5c. K10, flash attention with RoPE inside the kernels
   (``flash_attention_packed_rope``, the reference's :1370), on its own
   entry point: forward and backward once at the Llama attention shape
   (B 16, L 2048, H 16/4, D 128, causal, bf16) with the launch counters
   set to 0 just before and read just after (K10-fwd, K3, K10-dkv,
   K10-dq once each); output and gradients against the composition the
   model runs (K6 then K1; K3/K4/K5 then K6 inverse); the three kernels
   against their plain versions there, at a cached prefill (Lq 512 <
   Lk 2048), at head_dim 256 and in f32; their times, the composition's,
   the plain versions', SDPA's on K6-rotated q and k, and the bounds.
8. BERT training at full width: bench_bert's configuration (BERT-base,
   bf16, batch 64, seq 512, AdamW lr 1e-4 / weight decay 0.01, 15% of
   positions labelled) through ``build_train_step``, unmasked (the
   unsegmented kernels) and with a padding mask of lengths 128-512 (the
   segmented ones), 2 warm-up and 5 timed steps each: the loss falls,
   every flash kernel launches 12 times a step and no plain version or
   dense attention runs; samples/s, step ms, MFU, peak memory and a
   profiled step.
9. BERT parity: the same trainer at full width, 2 layers, f32, batch 2,
   seq 512, padding mask, 3 steps on the card (kernels) and on the CPU
   (plain versions): losses and the fraction of parameters off.

The last lines are the ``kernels`` JSON, the card line and the result
JSON ``{"ok": true, "device": {...}}``.
"""
import json
import re
import subprocess
import sys
import time

import numpy as np

H100_BYTES_PER_S = 3.35e12          # HBM3, NVIDIA H100 SXM data sheet
H100_BF16_FLOPS = 989e12            # dense bf16 tensor-core peak


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def card_line():
    for _ in range(2):
        r = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        if r.returncode == 0 and r.stdout.strip():
            return r.stdout.strip().splitlines()[0]
    raise RuntimeError(f"nvidia-smi failed: {r.stderr.strip()}")


def time_ms(torch, fn, iters, warm=3):
    """Mean ms per call of ``fn(i)`` (CUDA events around ``iters``
    calls, after ``warm`` calls)."""
    for i in range(warm):
        fn(i)
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for i in range(iters):
        fn(i)
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / iters


def device_ms(torch, fn, key, iters=50):
    """Mean device time per launch (ms) of the kernels whose profiler name
    holds ``key``, over ``iters`` calls of ``fn(i)`` under
    ``torch.profiler`` after 3 warm-up calls (the kernel alone, where
    ``time_ms`` also sees the host's launch cost); None if the profiler
    recorded no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for i in range(3):
        fn(i)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(iters):
            fn(i)
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA and key in e.key)
    return us / iters / 1e3 if us else None


def wgmma_ptxas(report):
    """What ptxas said about the wgmma instances (``ptf::wg`` kernels) in
    a library's build log: ``{"fwd_kernel<D=128, SEG=0, ROPE=0>":
    "N bytes stack frame, ... | Used N registers, ..."}``."""
    out, cur = {}, None
    for line in report.splitlines():
        m = re.search(r"Function properties for _ZN3ptf2wg\d+(\w+?)ILi(\d+)"
                      r"ELb(\d)ELb(\d)E", line)
        if m:
            cur = f"{m[1]}<D={m[2]}, SEG={m[3]}, ROPE={m[4]}>"
            out[cur] = []
        elif cur and ("spill" in line or "registers" in line):
            out[cur].append(line.replace("ptxas info    :", "").strip())
            if "registers" in line:
                out[cur] = " | ".join(out[cur])
                cur = None
    return out


def bound(nbytes, flops):
    t_b = nbytes / H100_BYTES_PER_S
    t_f = flops / H100_BF16_FLOPS
    return (max(t_b, t_f) * 1e3, "bytes" if t_b >= t_f else "operations")


def sdpa(torch, q, k, v, mask):
    """One library attention call (the yardstick): GQA through
    ``enable_gqa`` where this PyTorch has it."""
    F = torch.nn.functional
    try:
        return F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                              enable_gqa=True)
    except TypeError:
        g = q.shape[1] // k.shape[1]
        return F.scaled_dot_product_attention(
            q, k.repeat_interleave(g, 1), v.repeat_interleave(g, 1),
            attn_mask=mask)


def bf16_ulps(a, b):
    """Elementwise distance in bf16 units in the last place."""
    import torch
    ia = a.contiguous().view(torch.int16).int()
    ib = b.contiguous().view(torch.int16).int()
    # sign-magnitude -> ordered integers
    ia = torch.where(ia < 0, -32768 - ia, ia)
    ib = torch.where(ib < 0, -32768 - ib, ib)
    return (ia - ib).abs()


# ----------------------------------------------------------------- phase 2
#: K8's widths held against its plain version: a decode step (1), phase
#: 2's earlier T 4, and the verify widths of the spec_k=8 depth ladder
#: (k+1 for k in 1, 2, 4, 8)
K8_WIDTHS = (1, 2, 3, 4, 5, 9)
#: the verify widths timed
VERIFY_TIMED = (5, 9)
#: the top-2 tree verify widths, k+2 rows a slot for k = 1, 4, 8: K8 with
#: the last row's hidden key range; the last one timed
K8_TREE_WIDTHS = (3, 6, 10)


def tree_hidden(torch, lengths, t):
    """The tree verify's ranges at ``t = k+2`` rows a slot: the branch
    row (the last) hides the linear chain, keys ``[L+1, L+k+1)``; the
    other rows hide nothing."""
    h = torch.zeros((lengths.shape[0], t, 2), dtype=torch.int32,
                    device=lengths.device)
    h[:, t - 1, 0] = lengths + 1
    h[:, t - 1, 1] = lengths + (t - 1)
    return h


def k8_range_checks(torch, dev, gen, tag, pools, denses, lengths):
    """K8 with hidden key ranges against its plain version at the serving
    widths (Hkv 4, G 4, D 128, C 256, lmax 2048; ``pools`` carry
    ``(k, v, table)``): the tree verify widths (``K8_TREE_WIDTHS``),
    dense and paged, and one op-level case that hides keys [128, 256) —
    two whole 64-key spans — from every query of every row, T 4.  Live
    rows within atol=rtol=1e-4, one ``launches_hidden`` a call, two
    launches bitwise equal, and the whole-span ranges change the rows
    that see those keys.  Returns the largest absolute error."""
    from paddle_tpu_torch.ops import paged_attention_cuda as k8

    HKV, G, D, C = 4, 4, 128, 256
    B = lengths.shape[0]
    live = slice(0, B - 1)                   # the last row is parked
    err = 0.0
    cases = [(t, tree_hidden(torch, lengths, t), "tree")
             for t in K8_TREE_WIDTHS]
    span = torch.zeros((B, 4, 2), dtype=torch.int32, device=dev)
    span[..., 0], span[..., 1] = 2 * k8._SPLIT, 4 * k8._SPLIT
    cases.append((4, span, "whole spans [128, 256)"))
    for paged in (False, True):
        kc, vc, tb = pools if paged else denses
        for t, hid, what in cases:
            qg = torch.randn(B, HKV, G, t, D, generator=gen, device=dev)
            n0 = k8.launches_hidden
            out = k8.paged_decode_attention(qg, kc, vc, lengths, D ** -0.5,
                                            C, tb, impl="cuda", hidden=hid)
            again = k8.paged_decode_attention(
                qg, kc, vc, lengths, D ** -0.5, C, tb, impl="cuda",
                hidden=hid)
            ref = k8.paged_decode_attention_reference(
                qg, kc, vc, lengths, D ** -0.5, C, tb, hidden=hid)
            torch.cuda.synchronize()
            check(k8.launches_hidden == n0 + 2,
                  f"{tag}: a range launch was not counted")
            check(bool(torch.isfinite(out).all()), f"{tag} range output "
                  "not finite")
            check(torch.equal(out, again), f"{tag} range differs from "
                  "itself run to run")
            err = max(err, check_f32(
                f"{tag} range {'paged' if paged else 'dense'} T={t} "
                f"({what}; bitwise run to run)", out[live], ref[live],
                1e-4, 1e-4))
            if what != "tree":
                plain = k8.paged_decode_attention(
                    qg, kc, vc, lengths, D ** -0.5, C, tb, impl="cuda")
                sees = lengths[live] > 2 * k8._SPLIT
                check(bool((plain[live][sees] != out[live][sees]).any()),
                      f"{tag}: hiding two whole spans changed nothing")
    return err


def k8_range_times(torch, dev, gen, pools, lengths, tbl, lens):
    """K8 at the last tree width with and without the ranges on the paged
    serving pools: times by events and by the profiler, the plain
    version's, the bound (the hidden keys are read all the same — other
    rows see them — and only their products are skipped), and SDPA with
    the same boolean mask as the library yardstick."""
    from paddle_tpu_torch.ops import paged_attention_cuda as k8

    B, HKV, G, D, C = len(lens), 4, 4, 128, 256
    t = K8_TREE_WIDTHS[-1]
    qg = torch.randn(B, HKV, G, t, D, generator=gen, device=dev)
    hid = tree_hidden(torch, lengths, t)
    out = {}
    for tag, h in (("range", hid), ("no_range", None)):
        def run(i, h=h):
            return k8.paged_decode_attention(qg, *pools[i % len(pools)],
                                             lengths, D ** -0.5, C, tbl,
                                             impl="cuda", hidden=h)
        out[tag] = (time_ms(torch, run, 200),
                    device_ms(torch, run, "paged_decode_kernel"))
    plain = time_ms(torch, lambda i: k8.paged_decode_attention_reference(
        qg, *pools[i % len(pools)], lengths, D ** -0.5, C, tbl, hidden=hid),
        10, warm=1)
    LMAX = C * tbl.shape[1]
    pos = (lengths[:, None] + torch.arange(t, device=dev)[None, :]) \
        .clamp(max=LMAX - 1)
    keys = torch.arange(LMAX, device=dev)[None, None, :]
    mask = (keys <= pos[:, :, None]) & ~(
        (keys >= hid[..., :1]) & (keys < hid[..., 1:]))
    q_t = torch.randn(B, HKV * G, t, D, generator=gen, device=dev).to(
        torch.bfloat16)
    kd = [(torch.randn(B, HKV, LMAX, D, generator=gen, device=dev).to(
        torch.bfloat16), torch.randn(B, HKV, LMAX, D, generator=gen,
                                     device=dev).to(torch.bfloat16))
          for _ in range(2)]
    lib = time_ms(torch, lambda i: sdpa(torch, q_t, kd[i % 2][0],
                                        kd[i % 2][1], mask[:, None]), 200)
    live = [int(x) for x in lens[:-1]]
    b_ms, b_by = k8_bound(lens, tbl, t, HKV * D * 2,
                          hidden_keys=sum(t - 2 for _ in live))
    del kd
    return dict(ms=out["range"][0], device_ms=out["range"][1],
                plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                library_ms=lib, width=t, ms_no_range=out["no_range"][0],
                device_ms_no_range=out["no_range"][1])


def phase_kernels(torch, dev):
    from paddle_tpu_torch.ops import paged_attention_cuda as k8
    from paddle_tpu_torch.ops import prefill_attention_cuda as k9

    gen = torch.Generator(device=dev)
    gen.manual_seed(1234)
    B, HKV, G, D, C, W = 8, 4, 4, 128, 256, 8
    LMAX, N, ROT = C * W, 64, 4
    scale = D ** -0.5

    def rnd(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    pools = [(rnd(N, C, HKV, D, dtype=torch.bfloat16),
              rnd(N, C, HKV, D, dtype=torch.bfloat16)) for _ in range(ROT)]
    denses = [(rnd(B, LMAX, HKV, D, dtype=torch.bfloat16),
               rnd(B, LMAX, HKV, D, dtype=torch.bfloat16))
              for _ in range(ROT)]
    lens = np.array([0, 255, 256, 700, 1023, 1500, 2040, LMAX], np.int32)
    perm = torch.randperm(N, generator=gen, device=dev).cpu().numpy()
    table = np.full((B, W), N, np.int32)
    nxt = 0
    for b in range(B - 1):                   # the last row is parked
        for w in range(-(-(int(lens[b]) + 4) // C)):
            table[b, w] = perm[nxt]
            nxt += 1
    tbl = torch.from_numpy(table).to(dev)
    lengths = torch.from_numpy(lens).to(dev)
    live = slice(0, B - 1)
    res = {}

    # ---- K8: dense and paged, T = 1, 4 and the verify widths
    err8 = 0.0
    for paged in (False, True):
        for t in K8_WIDTHS:
            kc, vc = pools[0] if paged else denses[0]
            tb = tbl if paged else None
            qg = rnd(B, HKV, G, t, D)
            out = k8.paged_decode_attention(qg, kc, vc, lengths, scale, C,
                                            tb, impl="cuda")
            ref = k8.paged_decode_attention_reference(qg, kc, vc, lengths,
                                                      scale, C, tb)
            torch.cuda.synchronize()
            check(bool(torch.isfinite(out).all()), "K8 output not finite")
            d = (out[live] - ref[live]).abs()
            ok = bool((d <= 1e-4 + 1e-4 * ref[live].abs()).all())
            err8 = max(err8, float(d.max()))
            print(f"K8 {'paged' if paged else 'dense'} T={t}: max_abs_err "
                  f"{float(d.max()):.3e} {'ok' if ok else 'MISMATCH'}",
                  flush=True)
            check(ok, f"K8 disagrees with its plain version "
                      f"(paged={paged}, T={t})")
    # the main-path shape (paged, T = 1): one launch a call, bitwise the
    # same run to run (the split-K merge runs in span order)
    qg = rnd(B, HKV, G, 1, D)
    n0 = k8.launches
    o1 = k8.paged_decode_attention(qg, *pools[0], lengths, scale, C, tbl,
                                   impl="cuda")
    o2 = k8.paged_decode_attention(qg, *pools[0], lengths, scale, C, tbl,
                                   impl="cuda")
    torch.cuda.synchronize()
    check(k8.launches == n0 + 2, "K8 made more than one launch a call")
    check(torch.equal(o1, o2), "K8 differs from itself run to run")
    print("K8 paged T=1: one launch a call, bitwise equal run to run, ok",
          flush=True)
    err8 = max(err8, k8_edges(torch, dev, gen, "K8", lambda shape: rnd(
        *shape, dtype=torch.bfloat16)))
    err_range = k8_range_checks(torch, dev, gen, "K8", (*pools[0], tbl),
                                (*denses[0], None), lengths)
    ms8 = time_ms(torch, lambda i: k8.paged_decode_attention(
        qg, *pools[i % ROT], lengths, scale, C, tbl, impl="cuda"), 200)
    dev8 = device_ms(torch, lambda i: k8.paged_decode_attention(
        qg, *pools[i % ROT], lengths, scale, C, tbl, impl="cuda"),
        "paged_decode_kernel")
    plain8 = time_ms(torch, lambda i: k8.paged_decode_attention_reference(
        qg, *pools[i % ROT], lengths, scale, C, tbl), 10, warm=1)
    # library yardstick: SDPA over the dense cache at the same lengths
    q_sd = qg.reshape(B, HKV * G, 1, D).to(torch.bfloat16)
    kd = [(k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous())
          for k, v in denses]
    mask = (torch.arange(LMAX, device=dev)[None, :]
            <= lengths[:, None].clamp(max=LMAX - 1))[:, None, None, :]
    lib8 = time_ms(torch, lambda i: sdpa(
        torch, q_sd, kd[i % ROT][0], kd[i % ROT][1], mask), 200)
    b_ms, b_by = k8_bound(lens, tbl, 1, HKV * D * 2)
    # the verify widths: SDPA with T query rows a slot, causal among them
    lib8_t = {}
    for t in VERIFY_TIMED:
        q_t = rnd(B, HKV * G, t, D, dtype=torch.bfloat16)
        pos = (lengths[:, None] + torch.arange(t, device=dev)[None, :]) \
            .clamp(max=LMAX - 1)
        m_t = (torch.arange(LMAX, device=dev)[None, None, :]
               <= pos[:, :, None])[:, None]
        lib8_t[t] = time_ms(torch, lambda i: sdpa(
            torch, q_t, kd[i % ROT][0], kd[i % ROT][1], m_t), 200)
    res["paged_decode_attention"] = dict(
        max_abs_err=err8, ms=ms8, device_ms=dev8, plain_ms=plain8,
        bound_ms=b_ms, bound_by=b_by, library_ms=lib8,
        verify_widths={str(t): k8_width(torch, dev, gen, pools, lengths,
                                        tbl, lens, t, HKV * D * 2,
                                        lib8_t[t])
                       for t in VERIFY_TIMED})
    res["paged_decode_attention_range"] = dict(
        max_abs_err=err_range,
        **k8_range_times(torch, dev, gen, pools, lengths, tbl, lens))

    # ---- K9: offsets 0/256/768/1792, dense and paged, a sentinel dest
    T = 256
    err9, ulp9 = 0.0, 0
    slot = 3
    trow = torch.from_numpy(perm[:W].astype(np.int32).reshape(1, W)) \
        .to(dev)
    for paged in (False, True):
        for off in (0, 256, 768, 1792):
            kc, vc = pools[1] if paged else denses[1]
            tr = trow.clone() if paged else None
            if paged and off == 1792:
                tr[0, off // C] = N          # unmapped destination: drops
            q = rnd(1, T, HKV * G, D, dtype=torch.bfloat16)
            kn = rnd(1, T, HKV, D, dtype=torch.bfloat16)
            vn = rnd(1, T, HKV, D, dtype=torch.bfloat16)
            k2, v2 = kc.clone(), vc.clone()
            n_mma = k9.launches_mma
            o1, _, _ = k9.prefill_attention(q, kn, vn, kc, vc, slot, off,
                                            scale, C, tr, impl="cuda")
            o2, _, _ = k9.prefill_attention_reference(
                q, kn, vn, k2, v2, slot, off, scale, C, tr)
            torch.cuda.synchronize()
            check(k9.launches_mma == n_mma + 1,
                  "K9 bf16 did not take its tensor-core instance")
            check(torch.equal(kc, k2) and torch.equal(vc, v2),
                  f"K9 cache differs from the plain append (paged={paged}, "
                  f"offset={off})")
            if tr is not None and int(tr[0, off // C]) >= N:
                # the append dropped: the plain version then reads back
                # the clamped block's bytes where the kernel attends to
                # the chunk's own rows, so only the cache is compared
                print(f"K9 paged offset={off} (sentinel destination): "
                      "cache bitwise equal, ok", flush=True)
                continue
            d = (o1.float() - o2.float()).abs()
            u = bf16_ulps(o1, o2)
            ok = bool(((u <= 2) | (d <= 1e-6)).all())
            err9 = max(err9, float(d.max()))
            ulp9 = max(ulp9, int(u.max()))
            print(f"K9 {'paged' if paged else 'dense'} offset={off}: "
                  f"max_abs_err {float(d.max()):.3e} max_ulps {int(u.max())}"
                  f" cache bitwise equal, {'ok' if ok else 'MISMATCH'}",
                  flush=True)
            check(ok, f"K9 output beyond 2 bf16 ulps (paged={paged}, "
                      f"offset={off})")
    off = 768
    q = rnd(1, T, HKV * G, D, dtype=torch.bfloat16)
    kn = rnd(1, T, HKV, D, dtype=torch.bfloat16)
    vn = rnd(1, T, HKV, D, dtype=torch.bfloat16)
    ms9 = time_ms(torch, lambda i: k9.prefill_attention(
        q, kn, vn, *pools[i % ROT], slot, off, scale, C, trow,
        impl="cuda"), 200)
    dev9 = device_ms(torch, lambda i: k9.prefill_attention(
        q, kn, vn, *pools[i % ROT], slot, off, scale, C, trow,
        impl="cuda"), "prefill_mma_kernel")
    plain9 = time_ms(torch, lambda i: k9.prefill_attention_reference(
        q, kn, vn, *pools[i % ROT], slot, off, scale, C, trow), 10, warm=1)
    qs = q.transpose(1, 2)
    ks = [(k[slot, :off + T].transpose(0, 1)[None].contiguous(),
           v[slot, :off + T].transpose(0, 1)[None].contiguous())
          for k, v in denses]
    m9 = (torch.arange(off + T, device=dev)[None, :]
          <= off + torch.arange(T, device=dev)[:, None])
    lib9 = time_ms(torch, lambda i: sdpa(
        torch, qs, ks[i % ROT][0], ks[i % ROT][1], m9), 200)
    io9 = (T * HKV * G * D * 2 * 2            # q in, out
           + 2 * T * HKV * D * 2 * 2          # k_new/v_new in, appended
           + off * HKV * D * 2 * 2 + W * 4)   # prefix K/V, table row
    fl9 = 4 * HKV * G * D * (T * off + T * (T + 1) // 2)
    b_ms, b_by = bound(io9, fl9)
    res["prefill_attention"] = dict(
        max_abs_err=err9, ms=ms9, device_ms=dev9, plain_ms=plain9,
        bound_ms=b_ms, bound_by=b_by, library_ms=lib9, max_ulps=ulp9)
    res.update(phase_kernels_int8(torch, dev, gen, lib8, lib9, lib8_t))
    for name, r in res.items():
        for tag, x in [("", r)] + [(f" T={t}", v) for t, v in
                                   r.get("verify_widths", {}).items()]:
            dev = ("not measured" if x["device_ms"] is None
                   else f"{x['device_ms'] * 1e3:.1f} us")
            print(f"{name}{tag}: {x['ms'] * 1e3:.1f} us/launch (device "
                  f"{dev}), plain {x['plain_ms'] * 1e3:.1f} us, library "
                  f"{x['library_ms'] * 1e3:.1f} us, bound "
                  f"{x['bound_ms'] * 1e3:.2f} us ({x['bound_by']})",
                  flush=True)
    return res


def k8_bound(lens, tbl, t, row_bytes, hidden_keys=0, HKV=4):
    """K8's least time at the serving shape (B 8, Hkv 4 — ``HKV`` 2 at a
    TP-2 rank —, G 4, D 128) for ``t`` query rows a slot: each live row
    reads its (length + t) keys of K and V once (``row_bytes`` a token:
    Hkv·D·2 in bf16, Hkv·(D + 2) in int8), q and out once in f32, the
    table and lengths; query row i sees length + i + 1 keys, 4·D
    operations each per query head, less ``hidden_keys`` (query, key)
    pairs that hidden ranges skip."""
    G, D = 4, 128
    live = [int(x) for x in lens[:-1]]               # the last row parked
    kv_bytes = sum(n + t for n in live) * row_bytes * 2
    io_bytes = 2 * len(lens) * HKV * G * t * D * 4 + tbl.numel() * 4 \
        + len(lens) * 4
    flops = sum(4 * HKV * G * D * (t * n + t * (t + 1) // 2) for n in live)
    return bound(kv_bytes + io_bytes, flops - 4 * HKV * G * D * hidden_keys)


def k8_width(torch, dev, gen, pools, lengths, tbl, lens, t, row_bytes,
             lib_ms):
    """K8 at ``t`` query rows a slot (a verify width) on the paged serving
    pools: its time by events and by the profiler, its plain version's,
    its bound, and the library yardstick ``lib_ms`` (SDPA at the same
    width)."""
    from paddle_tpu_torch.ops import paged_attention_cuda as k8

    B, HKV, G, D, C = len(lens), 4, 4, 128, 256
    qg = torch.randn(B, HKV, G, t, D, generator=gen, device=dev)

    def run(i):
        return k8.paged_decode_attention(qg, *pools[i % len(pools)],
                                         lengths, D ** -0.5, C, tbl,
                                         impl="cuda")
    ms = time_ms(torch, run, 200)
    dms = device_ms(torch, run, "paged_decode_kernel")
    plain = time_ms(torch, lambda i: k8.paged_decode_attention_reference(
        qg, *pools[i % len(pools)], lengths, D ** -0.5, C, tbl), 10, warm=1)
    b_ms, b_by = k8_bound(lens, tbl, t, row_bytes)
    return dict(ms=ms, device_ms=dms, plain_ms=plain, bound_ms=b_ms,
                bound_by=b_by, library_ms=lib_ms)


def k8_edges(torch, dev, gen, tag, make):
    """K8 at the serving widths (Hkv 4, G 4, D 128, C 256, lmax 2048) with
    one batch row on every edge of its pool blocks and of its spans of S
    keys (0, 1, S-1, S, S+1, C-1, C, C+1, 2C-1, lmax-1), one parked at
    lmax and one past it; dense and paged (sentinels past each row's
    blocks), T 1 and 4: live rows within atol=rtol=1e-4 of the plain
    version, two launches bitwise equal.  ``make(shape)`` makes a cache
    leaf (a tensor or an int8 pair).  Returns the largest absolute
    error."""
    from paddle_tpu_torch.ops import paged_attention_cuda as k8

    HKV, G, D, C, W = 4, 4, 128, 256, 8
    LMAX = C * W
    S = k8._SPLIT
    lens = sorted({0, 1, S - 1, S, S + 1, C - 1, C, C + 1, 2 * C - 1,
                   LMAX - 1}) + [LMAX, LMAX + 5]
    B, N = len(lens), len(lens) * W
    pool, dense = ((make((N, C, HKV, D)), make((N, C, HKV, D))),
                   (make((B, LMAX, HKV, D)), make((B, LMAX, HKV, D))))
    perm = torch.randperm(N, generator=gen, device=dev).cpu()
    table = torch.full((B, W), N, dtype=torch.int32)
    for b, n in enumerate(lens[:-2]):
        used = min(-(-(n + 4) // C), W)
        table[b, :used] = perm[b * W:b * W + used]
    tbl = table.to(dev)
    lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
    live = slice(0, B - 2)
    err = 0.0
    for paged in (False, True):
        for t in (1, 4):
            kc, vc = pool if paged else dense
            tb = tbl if paged else None
            qg = torch.randn(B, HKV, G, t, D, generator=gen, device=dev)
            out = k8.paged_decode_attention(qg, kc, vc, lengths, D ** -0.5,
                                            C, tb, impl="cuda")
            again = k8.paged_decode_attention(qg, kc, vc, lengths,
                                              D ** -0.5, C, tb, impl="cuda")
            ref = k8.paged_decode_attention_reference(qg, kc, vc, lengths,
                                                      D ** -0.5, C, tb)
            torch.cuda.synchronize()
            check(bool(torch.isfinite(out).all()), f"{tag} output not finite")
            check(torch.equal(out, again), f"{tag} differs from itself run "
                  "to run at the split edges")
            err = max(err, check_f32(
                f"{tag} split edges {'paged' if paged else 'dense'} T={t} "
                "(bitwise run to run)", out[live], ref[live], 1e-4, 1e-4))
    return err


def phase_kernels_int8(torch, dev, gen, lib8, lib9, lib8_t):
    """K8's and K9's int8 branches at the same serving shapes, on int8
    pools quantized from bf16 values: K8 dense and paged, T 1 and 4,
    within atol=rtol=1e-4 of its plain version (dequantization is exact;
    summation order only); K9 at offsets 0/256/768/1792 with a sentinel
    destination, its written codes and f16 scales BITWISE equal both to
    the plain append and to ``_q8_quantize`` of the new rows, its bf16
    output within 2 bf16 ulps (as the float rows).  Bounds: the live
    bytes, Hkv·(D + 2) per token per K and V (1040 B per token per
    layer).  The library yardsticks are the bf16 rows' SDPA calls (no
    library call reads int8 K/V)."""
    from paddle_tpu_torch.ops import paged_attention_cuda as k8
    from paddle_tpu_torch.ops import prefill_attention_cuda as k9
    from paddle_tpu_torch.ops.decode_attention import _q8_quantize

    B, HKV, G, D, C, W = 8, 4, 4, 128, 256, 8
    LMAX, N, ROT = C * W, 64, 4
    scale = D ** -0.5

    def rnd(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    def q8(*shape):
        return _q8_quantize(rnd(*shape, dtype=torch.bfloat16))

    pools = [(q8(N, C, HKV, D), q8(N, C, HKV, D)) for _ in range(ROT)]
    denses = [(q8(B, LMAX, HKV, D), q8(B, LMAX, HKV, D)) for _ in range(ROT)]
    lens = np.array([0, 255, 256, 700, 1023, 1500, 2040, LMAX], np.int32)
    perm = torch.randperm(N, generator=gen, device=dev).cpu().numpy()
    table = np.full((B, W), N, np.int32)
    nxt = 0
    for b in range(B - 1):                   # the last row is parked
        for w in range(-(-(int(lens[b]) + 4) // C)):
            table[b, w] = perm[nxt]
            nxt += 1
    tbl = torch.from_numpy(table).to(dev)
    lengths = torch.from_numpy(lens).to(dev)
    live = slice(0, B - 1)
    res = {}

    err8 = 0.0
    for paged in (False, True):
        for t in K8_WIDTHS:
            kc, vc = pools[0] if paged else denses[0]
            tb = tbl if paged else None
            qg = rnd(B, HKV, G, t, D)
            out = k8.paged_decode_attention(qg, kc, vc, lengths, scale, C,
                                            tb, impl="cuda")
            ref = k8.paged_decode_attention_reference(qg, kc, vc, lengths,
                                                      scale, C, tb)
            torch.cuda.synchronize()
            check(bool(torch.isfinite(out).all()), "K8-int8 output not "
                  "finite")
            err8 = max(err8, check_f32(
                f"K8-int8 {'paged' if paged else 'dense'} T={t}", out[live],
                ref[live], 1e-4, 1e-4))
    err8 = max(err8, k8_edges(torch, dev, gen, "K8-int8", lambda shape: q8(
        *shape)))
    err8_range = k8_range_checks(torch, dev, gen, "K8-int8",
                                 (*pools[0], tbl), (*denses[0], None),
                                 lengths)
    qg = rnd(B, HKV, G, 1, D)
    ms8 = time_ms(torch, lambda i: k8.paged_decode_attention(
        qg, *pools[i % ROT], lengths, scale, C, tbl, impl="cuda"), 200)
    dev8 = device_ms(torch, lambda i: k8.paged_decode_attention(
        qg, *pools[i % ROT], lengths, scale, C, tbl, impl="cuda"),
        "paged_decode_kernel")
    plain8 = time_ms(torch, lambda i: k8.paged_decode_attention_reference(
        qg, *pools[i % ROT], lengths, scale, C, tbl), 10, warm=1)
    b_ms, b_by = k8_bound(lens, tbl, 1, HKV * (D + 2))
    res["paged_decode_attention_int8"] = dict(
        max_abs_err=err8, max_abs_err_range=err8_range, ms=ms8, device_ms=dev8, plain_ms=plain8,
        bound_ms=b_ms, bound_by=b_by, library_ms=lib8,
        verify_widths={str(t): k8_width(torch, dev, gen, pools, lengths,
                                        tbl, lens, t, HKV * (D + 2),
                                        lib8_t[t])
                       for t in VERIFY_TIMED})

    T = 256
    err9 = 0.0
    slot = 3
    trow = torch.from_numpy(perm[:W].astype(np.int32).reshape(1, W)) \
        .to(dev)
    for paged in (False, True):
        for off in (0, 256, 768, 1792):
            kc, vc = pools[1] if paged else denses[1]
            tr = trow.clone() if paged else None
            if paged and off == 1792:
                tr[0, off // C] = N          # unmapped destination: drops
            q = rnd(1, T, HKV * G, D, dtype=torch.bfloat16)
            kn = rnd(1, T, HKV, D, dtype=torch.bfloat16)
            vn = rnd(1, T, HKV, D, dtype=torch.bfloat16)
            k2 = tuple(x.clone() for x in kc)
            v2 = tuple(x.clone() for x in vc)
            n_mma = k9.launches_mma
            o1, _, _ = k9.prefill_attention(q, kn, vn, kc, vc, slot, off,
                                            scale, C, tr, impl="cuda")
            o2, _, _ = k9.prefill_attention_reference(
                q, kn, vn, k2, v2, slot, off, scale, C, tr)
            torch.cuda.synchronize()
            check(k9.launches_mma == n_mma + 1,
                  "K9-int8 did not take its tensor-core instance")
            same = all(torch.equal(a, b) for a, b in zip(kc + vc, k2 + v2))
            where = f"paged={paged}, offset={off}"
            check(same, f"K9-int8 cache differs from the plain append "
                        f"({where})")
            # the written rows are _q8_quantize of the new rows, bitwise
            dropped = tr is not None and int(tr[0, off // C]) >= N
            if not dropped:
                for cache, new in ((kc, kn), (vc, vn)):
                    wq, ws = _q8_quantize(new[0])
                    if paged:
                        blk = int(tr[0, off // C])
                        got = (cache[0][blk], cache[1][blk])
                    else:
                        got = (cache[0][slot, off:off + T],
                               cache[1][slot, off:off + T])
                    check(torch.equal(got[0], wq) and torch.equal(got[1], ws),
                          f"K9-int8 codes/scales differ from _q8_quantize "
                          f"({where})")
            if dropped:
                print(f"K9-int8 paged offset={off} (sentinel destination): "
                      "cache bitwise equal, ok", flush=True)
                continue
            # the output is bf16 (q's dtype): within 2 bf16 ulps, as the
            # float rows
            err9 = max(err9, check_bf16(
                f"K9-int8 {'paged' if paged else 'dense'} offset={off} "
                "(codes and scales bitwise = plain append = _q8_quantize)",
                o1, o2, ulps=2, atol=1e-6))
    off = 768
    q = rnd(1, T, HKV * G, D, dtype=torch.bfloat16)
    kn = rnd(1, T, HKV, D, dtype=torch.bfloat16)
    vn = rnd(1, T, HKV, D, dtype=torch.bfloat16)
    ms9 = time_ms(torch, lambda i: k9.prefill_attention(
        q, kn, vn, *pools[i % ROT], slot, off, scale, C, trow,
        impl="cuda"), 200)
    dev9 = device_ms(torch, lambda i: k9.prefill_attention(
        q, kn, vn, *pools[i % ROT], slot, off, scale, C, trow,
        impl="cuda"), "prefill_mma_kernel")
    plain9 = time_ms(torch, lambda i: k9.prefill_attention_reference(
        q, kn, vn, *pools[i % ROT], slot, off, scale, C, trow), 10, warm=1)
    row8 = HKV * (D + 2)                      # int8 bytes per token per K/V
    io9 = (T * HKV * G * D * 2 * 2            # q in, out (bf16)
           + 2 * T * HKV * D * 2              # k_new/v_new in (bf16)
           + 2 * T * row8                     # appended codes + scales
           + off * row8 * 2 + W * 4)          # prefix K/V, table row
    fl9 = 4 * HKV * G * D * (T * off + T * (T + 1) // 2)
    b_ms, b_by = bound(io9, fl9)
    res["prefill_attention_int8"] = dict(
        max_abs_err=err9, ms=ms9, device_ms=dev9, plain_ms=plain9,
        bound_ms=b_ms, bound_by=b_by, library_ms=lib9)
    del pools, denses
    torch.cuda.empty_cache()
    return res


# ----------------------------------------------------------------- phase 3
SERVE_CFG = dict(vocab_size=32000, hidden_size=2048, intermediate_size=5632,
                 num_hidden_layers=16, num_attention_heads=16,
                 num_key_value_heads=4, max_position_embeddings=2048,
                 dtype="bfloat16")
ENGINE = dict(batch_size=8, max_len=2048, kv_block=256, prefill_chunk=256,
              decode_chunk=256, max_live_tokens=8 * 2048)


def serving_workload(seed=0, n=16):
    rng = np.random.default_rng(seed)
    vocab = SERVE_CFG["vocab_size"]
    plens = rng.integers(64, 1025, n)
    olens = rng.integers(64, 257, n)
    prompts = [rng.integers(0, vocab, int(p)) for p in plens]
    # request 0 leads a shared 768-token prefix and decodes long; the
    # last request (submitted last) follows it
    shared = rng.integers(0, vocab, 768)
    prompts[0] = np.concatenate([shared, rng.integers(0, vocab, 256)])
    olens[0] = 256
    prompts[-1] = np.concatenate([shared, rng.integers(0, vocab, 200)])
    return prompts, [int(o) for o in olens]


#: the kernel launches the bf16- and int8-KV serving runs of this workload
#: make (16 layers x 455 decode steps and x 40 prefill chunks), every K9
#: launch through its tensor-core instance (bf16 queries)
SERVE_LAUNCHES = dict(k8=7280, k9=640, k9_mma=640)

#: the serving cell's runs: bf16 (the model's dtype), then the reference's
#: own int8 configuration (bench.py A/B 9: int8 KV on the paged pool),
#: then int8 decode weights (A/B 8) on the same workload
SERVE_RUNS = (("bf16", {}), ("kv8", dict(kv_dtype="int8")),
              ("w8", dict(weight_dtype="int8")))


def drift(ref, got):
    """``bench.py``'s drift counts against the bf16 streams: the share of
    positions that differ, and the first-divergence rate per token
    compared up to it (immune to one flip cascading)."""
    diff = sum(sum(x != y for x, y in zip(a, b)) for a, b in zip(ref, got))
    total = sum(len(a) for a in ref)
    div = cmp = 0
    for a, b in zip(ref, got):
        k = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)
        div += k is not None
        cmp += len(a) if k is None else k + 1
    return diff / total, div / cmp


def phase_serving(torch, dev):
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.observability import MetricsRegistry
    from paddle_tpu_torch.serving import Request, ServingEngine

    model = LlamaForCausalLM(LlamaConfig(**SERVE_CFG), device=dev, seed=0)
    # warm-up engine (cuBLAS handles, allocator) on a separate registry
    warm = ServingEngine(model, **ENGINE, registry=MetricsRegistry())
    warm.submit(Request(np.arange(300) % SERVE_CFG["vocab_size"], 8))
    warm.run()
    del warm
    prompts, olens = serving_workload()
    runs, streams = {}, {}
    for tag, knobs in SERVE_RUNS:
        runs[tag], streams[tag] = serve_run(torch, model, prompts, olens,
                                            tag, knobs)
        if tag != "bf16":
            runs[tag]["drift"], runs[tag]["flip_per_tok"] = drift(
                streams["bf16"], streams[tag])
            print(f"serving {tag} token drift vs bf16: "
                  f"{runs[tag]['drift']:.4f} of positions, first-divergence "
                  f"rate {runs[tag]['flip_per_tok']:.4f} per token",
                  flush=True)
    del model
    torch.cuda.empty_cache()
    return runs


def serve_run(torch, model, prompts, olens, tag, knobs):
    """One full-width serving run with ``knobs``: the kernels' launch
    counters set to 0 just before and read just after; every request
    must finish, both kernels must have launched and no plain version
    may have run.  Then a profiled decode window for the device-busy
    share."""
    from paddle_tpu_torch.observability import MetricsRegistry
    from paddle_tpu_torch.ops import paged_attention_cuda as k8
    from paddle_tpu_torch.ops import prefill_attention_cuda as k9
    from paddle_tpu_torch.serving import Request, ServingEngine

    reg = MetricsRegistry()
    eng = ServingEngine(model, **ENGINE, **knobs, registry=reg)
    torch.cuda.synchronize()
    k8.launches = k9.launches = k8.plain_runs = k9.plain_runs = 0
    k9.launches_mma = 0
    t0 = time.perf_counter()
    reqs = [eng.submit(Request(p, o)) for p, o in zip(prompts, olens)]
    eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(k8=k8.launches, k9=k9.launches, k9_mma=k9.launches_mma,
                  k8_plain=k8.plain_runs, k9_plain=k9.plain_runs)
    for r, o in zip(reqs, olens):
        check(r.status == "done" and len(r.output_ids) == o,
              f"{tag}: request {r.rid} finished {r.status} with "
              f"{len(r.output_ids)}/{o} tokens")
    check(counts["k8"] > 0 and counts["k9"] > 0,
          f"{tag}: a kernel did not run on the main path: {counts}")
    check(counts["k8_plain"] == 0 and counts["k9_plain"] == 0,
          f"{tag}: a plain version ran on the card: {counts}")
    check(counts["k9_mma"] == counts["k9"],
          f"{tag}: K9 left its tensor-core instance: {counts}")
    if "weight_dtype" not in knobs:
        check(all(counts[k] == n for k, n in SERVE_LAUNCHES.items()),
              f"{tag}: launches {counts}, expected {SERVE_LAUNCHES}")
    st = eng.stats()
    check(st["prefix_reuse_tokens"] > 0, f"{tag}: no prefix reuse: {st}")
    lbl = dict(policy="continuous")
    ttft = reg.get("serving_ttft_seconds").labels(**lbl)
    tpot = reg.get("serving_tpot_seconds").labels(**lbl)
    steps = int(reg.get("serving_steps_total").labels(**lbl).value)
    chunks = int(reg.get("serving_prefill_chunks_total").labels(**lbl).value)
    n_tok = sum(olens)
    out = dict(run=tag, knobs=knobs, requests=len(reqs), tokens=n_tok,
               wall_s=wall, tok_per_s=n_tok / wall,
               ttft_p50_s=ttft.percentile(50), ttft_p95_s=ttft.percentile(95),
               tpot_p50_s=tpot.percentile(50), tpot_p95_s=tpot.percentile(95),
               steps=steps, prefill_chunks=chunks,
               prompt_tokens=st["prompt_tokens"],
               prefix_reuse_tokens=st["prefix_reuse_tokens"],
               launches=counts)
    out["exact"] = {f"{k}_p{q}_s": float(np.percentile(v, q))
                    for k, v in (("ttft", [r.ttft for r in reqs]),
                                 ("tpot", [r.tpot for r in reqs]))
                    for q in (50, 95)}
    for fam in ("serving_hbm_gb_per_tok_q8", "serving_hbm_gb_per_tok_w8"):
        out[fam] = reg.get(fam).labels(**lbl).value
    out["device_busy"], out["k8_us_per_decode_step"] = profile_decode(
        torch, model, prompts, tag, knobs)
    print(f"serving {tag} " + json.dumps(out), flush=True)
    toks = [list(r.output_ids) for r in reqs]
    del eng
    torch.cuda.empty_cache()
    return out, toks


def profile_decode(torch, model, prompts, tag, knobs, n_steps=20):
    """Where a steady decode step's time goes: ``n_steps`` scheduler
    steps of 8 live slots (prefills done first) timed without the
    profiler, then ``n_steps`` more under ``torch.profiler``: device time
    by kernel (device-side events only) and its share of the unprofiled
    wall.  Returns the device-busy share and K8's device µs a decode step
    (both None if not measured)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from paddle_tpu_torch.observability import MetricsRegistry
    from paddle_tpu_torch.serving import Request, ServingEngine

    eng = ServingEngine(model, **ENGINE, **knobs,
                        registry=MetricsRegistry())
    for p in prompts[:8]:
        eng.submit(Request(p, 2 * n_steps + 8))
    while eng.stats()["queue_depth"] or eng.stats()["prefill_slots"]:
        eng.step()
    eng.step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_steps):
        eng.step()
    torch.cuda.synchronize()
    wall_us = (time.perf_counter() - t0) * 1e6
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n_steps):
            eng.step()
        torch.cuda.synchronize()
    eng.run()
    rows = sorted(((float(e.self_device_time_total), e.key, e.count)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and e.self_device_time_total > 0), reverse=True)
    total = sum(r[0] for r in rows)
    if not total:
        print(f"profile {tag}: the profiler recorded no device time (not "
              "measured)", flush=True)
        return None, None
    print(f"profile {tag} decode window: {n_steps} steps, wall "
          f"{wall_us / n_steps:.1f} us/step unprofiled, device "
          f"{total / n_steps:.1f} us/step, device busy "
          f"{total / wall_us:.3f}", flush=True)
    for us, key, count in rows[:10]:
        print(f"profile {tag}: {us / n_steps:9.1f} us/step "
              f"{count / n_steps:6.1f} launches/step  {key[:80]}",
              flush=True)
    k8_us = sum(us for us, key, _ in rows if "paged_decode_kernel" in key)
    print(f"profile {tag}: K8 {k8_us / n_steps:.1f} us of "
          f"{total / n_steps:.1f} us device time a decode step "
          f"({k8_us / total:.3f})", flush=True)
    return total / wall_us, k8_us / n_steps


# ---------------------------------------------------------------- phase 3b
#: bench_serving's spec geometry (``bench.py:216-380``, :654-725): batch 8,
#: max_len 2048, sync_every 4, spec_k 8
SPEC_ENGINE = dict(batch_size=8, max_len=2048, sync_every=4, spec_k=8)
#: the quarter-depth draft (bench's ``dcfg_kw``: the target's widths)
DRAFT_LAYERS = SERVE_CFG["num_hidden_layers"] // 4
#: the arms, in one call: (tag, engine knobs, SpecConfig knobs or None
#: for greedy); ``draft_model`` "quarter" / "self" names the drafter
SPEC_ARMS = (
    ("greedy", {}, None),
    ("pl", {}, {}),
    ("pl_sync", dict(pipeline=False), {}),
    ("dm_quarter", {}, dict(source="draft_model", draft_model="quarter")),
    ("dm_self_paged", dict(kv_block=256, max_live_tokens=2 * 8 * 2048),
     dict(source="draft_model", draft_model="self")),
    ("pl_adaptive_kv8_paged", dict(kv_block=256, kv_dtype="int8"),
     dict(adaptive_window=8, k_min=1)),
)


#: the top-2 tree arm and its linear twin: the target drafting for itself
#: (the drafter whose rejections are mostly the verify's second choice),
#: dense bf16 caches, on the first ``TREE_REQUESTS`` requests: all 16 —
#: on the first 8 the tree's verify rejected 9 drafted tokens of 2104 and
#: took no branch
TREE_ARMS = (
    ("dm_self_tree", {}, dict(source="draft_model", draft_model="self",
                              tree="top2")),
    ("dm_self_linear", {}, dict(source="draft_model", draft_model="self")),
)
TREE_REQUESTS = 16


def spec_workload(seed=0, n=16):
    """bench_serving's workload at 16 requests (it serves 64): prompts
    uniform 64-1024 tokens, tiled from one 32-token segment each (the
    prompt-lookup regime), outputs log-uniform 128-512."""
    rng = np.random.default_rng(seed)
    vocab = SERVE_CFG["vocab_size"]
    plens = rng.integers(64, 1025, n)
    olens = np.rint(np.exp(rng.uniform(np.log(128), np.log(512), n)))
    prompts = [np.tile(rng.integers(0, vocab, 32), int(p) // 32 + 1)[:p]
               for p in plens]
    return prompts, [int(o) for o in olens]


def phase_spec(torch, dev):
    """Speculative serving at full width: the serving model behind the
    spec arms of ``SPEC_ARMS`` on bench_serving's workload, each run with
    the kernels' launch counters set to 0 just before and read just
    after.  Checks: every request finishes with its token count; K8 and
    K9 launch and no plain version runs; K8's launches by width are
    exactly the verify widths the engine dispatched (k+1 rows a slot, 16
    target layers a round) plus the drafts' one-row steps; prompt lookup
    pipelined == synchronous bit for bit; the self-draft arm leaks no
    draft block and accepts >= 0.9 of its drafts.  Prints tok/s, TTFT
    and TPOT p50/p95, the accept rate and each spec arm's drift against
    the greedy streams."""
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.observability import MetricsRegistry
    from paddle_tpu_torch.serving import Request, ServingEngine, SpecConfig

    model = LlamaForCausalLM(LlamaConfig(**SERVE_CFG), device=dev, seed=0)
    quarter = LlamaForCausalLM(
        LlamaConfig(**{**SERVE_CFG, "num_hidden_layers": DRAFT_LAYERS}),
        device=dev, seed=1)
    drafters = {"quarter": quarter, "self": model}
    # warm-up (cuBLAS at the verify and draft shapes) on its own registry
    for tag, ekw, skw in SPEC_ARMS + TREE_ARMS[:1]:
        if tag not in ("dm_quarter", "pl_adaptive_kv8_paged",
                       "dm_self_tree"):
            continue
        warm = ServingEngine(model, **SPEC_ENGINE, **ekw, mode="spec",
                             spec=spec_config(SpecConfig, skw, drafters),
                             registry=MetricsRegistry())
        warm.submit(Request(np.arange(100) % SERVE_CFG["vocab_size"], 24))
        warm.run()
        del warm
    prompts, olens = spec_workload()
    runs, streams = {}, {}
    for tag, ekw, skw in SPEC_ARMS:
        runs[tag], streams[tag] = spec_run(
            torch, model, drafters, prompts, olens, tag, ekw, skw)
        if tag != "greedy":
            runs[tag]["drift"], runs[tag]["flip_per_tok"] = drift(
                streams["greedy"], streams[tag])
            print(f"spec {tag} token drift vs greedy: "
                  f"{runs[tag]['drift']:.4f} of positions, first-divergence "
                  f"rate {runs[tag]['flip_per_tok']:.4f} per token",
                  flush=True)
    check(streams["pl"] == streams["pl_sync"],
          "spec: prompt lookup pipelined differs from pipeline=False")
    print("spec: prompt lookup pipelined == pipeline=False, bit for bit",
          flush=True)
    check(runs["dm_self_paged"]["accept_rate"] >= 0.9,
          f"spec: the self-draft arm accepted "
          f"{runs['dm_self_paged']['accept_rate']:.4f} < 0.9 of its drafts")
    n = TREE_REQUESTS
    for tag, ekw, skw in TREE_ARMS:
        runs[tag], streams[tag] = spec_run(
            torch, model, drafters, prompts[:n], olens[:n], tag, ekw, skw)
        runs[tag]["drift"], runs[tag]["flip_per_tok"] = drift(
            streams["greedy"][:n], streams[tag])
    tree, lin = runs["dm_self_tree"], runs["dm_self_linear"]
    tree["drift_vs_linear"], _ = drift(streams["dm_self_linear"],
                                       streams["dm_self_tree"])
    print(f"spec tree: accept rate {tree['accept_rate']:.4f} (linear "
          f"{lin['accept_rate']:.4f}), branches taken "
          f"{tree['branches_taken']} in {tree['slot_rounds']} slot-rounds, "
          f"tok/s {tree['tok_per_s']:.1f} (linear {lin['tok_per_s']:.1f}, "
          f"greedy {runs['greedy']['tok_per_s']:.1f} on "
          f"{len(prompts)} requests), drift vs greedy "
          f"{tree['drift']:.4f} (linear {lin['drift']:.4f}), vs linear "
          f"{tree['drift_vs_linear']:.4f}", flush=True)
    check(tree["branches_taken"] > 0,
          "spec: the tree arm took no branch")
    del model, quarter, drafters
    torch.cuda.empty_cache()
    return runs


def spec_config(SpecConfig, skw, drafters):
    if skw is None:
        return None
    skw = dict(skw)
    if "draft_model" in skw:
        skw["draft_model"] = drafters[skw["draft_model"]]
    return SpecConfig(**skw)


def spec_run(torch, model, drafters, prompts, olens, tag, ekw, skw):
    """One spec-phase arm (``phase_spec``); returns its figures and its
    token streams."""
    from paddle_tpu_torch.observability import MetricsRegistry
    from paddle_tpu_torch.ops import paged_attention_cuda as k8
    from paddle_tpu_torch.ops import prefill_attention_cuda as k9
    from paddle_tpu_torch.serving import Request, ServingEngine, SpecConfig

    reg = MetricsRegistry()
    spec = spec_config(SpecConfig, skw, drafters)
    eng = ServingEngine(model, **SPEC_ENGINE, **ekw, registry=reg,
                        mode="greedy" if spec is None else "spec",
                        spec=spec)
    rounds, slot_rounds = {}, [0]
    call_spec = eng._call_spec

    def counted(cur, dev_len, active, k):       # verify rounds by depth
        rounds[k] = rounds.get(k, 0) + 1
        slot_rounds[0] += sum(map(eng._decodable, range(eng._B)))
        return call_spec(cur, dev_len, active, k)
    eng._call_spec = counted
    torch.cuda.synchronize()
    k8.launches = k9.launches = k8.plain_runs = k9.plain_runs = 0
    k9.launches_mma = k8.launches_hidden = 0
    k8.launches_t.clear()
    t0 = time.perf_counter()
    reqs = [eng.submit(Request(p, o)) for p, o in zip(prompts, olens)]
    eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(k8=k8.launches, k9=k9.launches, k9_mma=k9.launches_mma,
                  k8_plain=k8.plain_runs, k9_plain=k9.plain_runs,
                  k8_hidden=k8.launches_hidden,
                  k8_by_t=dict(sorted(k8.launches_t.items())))
    for r, o in zip(reqs, olens):
        check(r.status == "done" and len(r.output_ids) == o,
              f"spec {tag}: request {r.rid} finished {r.status} with "
              f"{len(r.output_ids)}/{o} tokens")
    tree = spec is not None and spec.tree == "top2"
    check(counts["k8"] > 0 and counts["k9"] > 0,
          f"spec {tag}: a kernel did not run on the main path: {counts}")
    check(counts["k8_plain"] == 0 and counts["k9_plain"] == 0,
          f"spec {tag}: a plain version ran on the card: {counts}")
    check(counts["k9_mma"] == counts["k9"],
          f"spec {tag}: K9 left its tensor-core instance: {counts}")
    n_layers = SERVE_CFG["num_hidden_layers"]
    if spec is None:
        check(set(counts["k8_by_t"]) == {1},
              f"spec {tag}: greedy K8 launches at widths other than 1: "
              f"{counts}")
    else:
        # every verify round: k+1 rows a slot (k+2 with the tree's branch
        # row, every launch with its hidden range) through every target
        # layer; a draft model adds k+1 one-row steps through its layers
        d_layers = (len(eng._dparams["layers"]) if eng._dspec else 0)
        want = {}
        for k, n in rounds.items():
            w = k + (2 if tree else 1)
            want[w] = want.get(w, 0) + n * n_layers
            if d_layers:
                want[1] = want.get(1, 0) + n * (k + 1) * d_layers
        check(counts["k8_by_t"] == dict(sorted(want.items())),
              f"spec {tag}: K8 launches by width {counts['k8_by_t']}, the "
              f"rounds dispatched {rounds} need {want}")
        n_hidden = sum(rounds.values()) * n_layers if tree else 0
        check(counts["k8_hidden"] == n_hidden,
              f"spec {tag}: {counts['k8_hidden']} K8 launches with a "
              f"hidden range, the rounds need {n_hidden}")
    lbl = dict(policy="continuous")
    n_tok = sum(olens)
    out = dict(run=tag, knobs={**ekw, **{k: v for k, v in (skw or {}).items()
                                         if k != "draft_model"}},
               drafter=(skw or {}).get("draft_model"), requests=len(reqs),
               tokens=n_tok, wall_s=wall, tok_per_s=n_tok / wall,
               steps=int(reg.get("serving_steps_total").labels(**lbl).value),
               rounds_by_k=dict(sorted(rounds.items())), launches=counts)
    out.update({f"{k}_p{q}_s": float(np.percentile(v, q))
                for k, v in (("ttft", [r.ttft for r in reqs]),
                             ("tpot", [r.tpot for r in reqs]))
                for q in (50, 95)})
    if spec is not None:
        drafted = reg.get("serving_spec_drafted_total").labels(**lbl).value
        accepted = reg.get("serving_spec_accepted_total").labels(**lbl).value
        out.update(drafted=int(drafted), accepted=int(accepted),
                   accept_rate=accepted / drafted if drafted else None,
                   draft_k_final=reg.get("serving_spec_draft_k").labels(
                       **lbl).value)
        if tree:
            # one device counter, read once, after the run
            out.update(branches_taken=eng.tree_branches_taken(),
                       slot_rounds=slot_rounds[0])
        gauge = reg.get("serving_spec_accept_rate").labels(
            source=spec.source, **lbl).value
        check(drafted > 0 and abs(gauge - out["accept_rate"]) <= 1e-9,
              f"spec {tag}: accept-rate gauge {gauge} vs counters {out}")
    if eng._paged:
        kv = eng.kv_manager
        out["draft_blocks_leaked"] = kv.draft_blocks_used()
        out["draft_blocks_gauge"] = reg.get("serving_kv_blocks_used").labels(
            model="draft", **lbl).value
        check(kv.draft_blocks_used() == 0 and out["draft_blocks_gauge"] == 0
              and kv.outstanding() == 0,
              f"spec {tag}: draft blocks leaked after drain: {out}")
    print(f"spec {tag} " + json.dumps(out), flush=True)
    toks = [list(r.output_ids) for r in reqs]
    del eng
    torch.cuda.empty_cache()
    return out, toks


# ---------------------------------------------------------------- phase 3c
#: the reliability phase's engine: the serving model, two slots, dense
#: caches; the preemption case's paged pool holds two slots' worst case
REL_ENGINE = dict(batch_size=2, max_len=1024, decode_chunk=256,
                  prefill_chunk=256)
REL_PAGED = dict(REL_ENGINE, kv_block=256, max_live_tokens=2 * 1024)
REL_NEW = 24


def rel_workload(seed=3, n=3, lo=64, hi=300):
    rng = np.random.default_rng(seed)
    vocab = SERVE_CFG["vocab_size"]
    return [rng.integers(0, vocab, int(p)) for p in rng.integers(lo, hi, n)]


def fill_card(torch):
    """Allocate the card's free memory until an allocation of every size
    down to 512 bytes fails, so the next allocation raises
    ``torch.cuda.OutOfMemoryError``; returns the tensors that hold it."""
    torch.cuda.empty_cache()
    held = []
    for shift in range(34, 8, -1):
        while True:
            try:
                held.append(torch.empty(1 << shift, dtype=torch.uint8,
                                        device="cuda"))
            except torch.cuda.OutOfMemoryError:
                break
    return held


def oom_retry(torch, run):
    """A dispatch meets a full card: at step 5 every free byte is taken
    just before the decode dispatch, which raises
    ``torch.cuda.OutOfMemoryError`` wherever it first allocates (before
    its first launch or between launches); the engine's backoff — here
    the moment the memory is given back — precedes a retry that
    re-issues the same kernels.  Returns the streams and the retry
    count."""
    import paddle_tpu_torch.serving.engine as engine_mod

    held, calls = [], []
    sleep = engine_mod._backoff_sleep

    def free_then_sleep(seconds):
        held.clear()
        torch.cuda.empty_cache()
        sleep(seconds)

    def hook(eng):
        real = eng._call_decode

        def filled(cur, dev_len):
            if eng._step_idx == 5 and not calls:
                calls.append(1)
                held.extend(fill_card(torch))
            return real(cur, dev_len)
        eng._call_decode = filled
    engine_mod._backoff_sleep = free_then_sleep
    try:
        eng, reg, reqs, st = run(retry_backoff=1e-3, hook=hook)
    finally:
        engine_mod._backoff_sleep = sleep
        held.clear()
    return [list(r.output_ids) for r in reqs], int(reg.get(
        "serving_dispatch_retries_total").labels(policy="continuous").value)


def phase_reliability(torch, dev):
    """The reliability layer on the card, with the serving model at full
    width on three short requests (two slots, dense bf16): a clean run,
    then injected dispatch and drain errors on three steps (streams equal
    the clean run bit for bit), one poisoned request (status
    ``poisoned``, the others bit-equal), a cancel in flight, a queued
    deadline forced by a slow step with ``max_pending`` shedding, and a
    priority preemption on a small paged pool (the resumed stream's
    drift against its unpreempted run is printed: bf16 on the card).
    The kernels' counters are set to 0 before the first run and read
    after the last: K8 and K9 launch, no plain version runs."""
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.observability import MetricsRegistry
    from paddle_tpu_torch.ops import paged_attention_cuda as k8
    from paddle_tpu_torch.ops import prefill_attention_cuda as k9
    from paddle_tpu_torch.serving import (
        EngineOverloaded, FaultPlan, Request, ServingEngine,
    )

    model = LlamaForCausalLM(LlamaConfig(**SERVE_CFG), device=dev, seed=0)
    prompts = rel_workload()
    lbl = dict(policy="continuous")

    def run(faults=None, cancel_after=None, hook=None, **kw):
        reg = MetricsRegistry()
        eng = ServingEngine(model, **REL_ENGINE, registry=reg,
                            faults=faults, **kw)
        if hook is not None:
            hook(eng)
        reqs = [eng.submit(Request(p, REL_NEW)) for p in prompts]
        if cancel_after is not None:
            for _ in range(cancel_after):
                eng.step()
            check(eng.cancel(0), "reliability: request 0 was not live")
        return eng, reg, reqs, eng.drain()

    torch.cuda.synchronize()
    k8.launches = k9.launches = k8.plain_runs = k9.plain_runs = 0
    t0 = time.perf_counter()
    clean_eng, _, clean_reqs, st = run()
    clean = [list(r.output_ids) for r in clean_reqs]
    check(set(st.values()) == {"done"}, f"reliability: clean run {st}")
    res = dict(clean_steps=clean_eng._step_idx + 1,
               clean_s=time.perf_counter() - t0)

    # errors at the dispatch seam (steps 1, 4) and the drain seam (the
    # last step, which only drains) are retried
    last = clean_eng._step_idx
    plan = FaultPlan(dispatch_error_steps={1, 4, last})
    _, reg, reqs, st = run(faults=plan, retry_backoff=1e-3)
    retries = reg.get("serving_dispatch_retries_total").labels(**lbl).value
    check([list(r.output_ids) for r in reqs] == clean
          and plan.stats["dispatch_errors"] == 3 and retries == 3,
          f"reliability: retried run differs from the clean one "
          f"({plan.stats}, {retries} retries)")
    print(f"reliability: 3 injected dispatch/drain errors retried "
          f"({int(retries)} retries), streams bit-equal to the clean run",
          flush=True)

    outs, retried = oom_retry(torch, run)
    check(outs == clean and retried == 1,
          f"reliability: the out-of-memory retry gave {retried} retries "
          "or streams that differ from the clean run")
    print("reliability: a real torch.cuda.OutOfMemoryError inside a decode "
          "dispatch was retried once, streams bit-equal to the clean run",
          flush=True)

    plan = FaultPlan(poison={1: 3})
    _, reg, reqs, st = run(faults=plan)
    outs = [list(r.output_ids) for r in reqs]
    check(st == {0: "done", 1: "poisoned", 2: "done"}
          and outs[0] == clean[0] and outs[2] == clean[2]
          and outs[1] == clean[1][:len(outs[1])],
          f"reliability: poison run {st}, {[len(o) for o in outs]}")
    print(f"reliability: request 1 poisoned after {len(outs[1])} tokens, "
          "cohabitants bit-equal to the clean run", flush=True)
    res["poisoned_after_tokens"] = len(outs[1])

    _, reg, reqs, st = run(cancel_after=4)
    outs = [list(r.output_ids) for r in reqs]
    check(st == {0: "cancelled", 1: "done", 2: "done"}
          and outs[1:] == clean[1:] and outs[0] == clean[0][:len(outs[0])],
          f"reliability: cancel run {st}")
    print(f"reliability: request 0 cancelled in flight after "
          f"{len(outs[0])} tokens, the others bit-equal", flush=True)
    res["cancelled_after_tokens"] = len(outs[0])

    # a queued deadline forced by a slow step, and shedding at the door
    reg = MetricsRegistry()
    eng = ServingEngine(model, **REL_ENGINE, registry=reg, max_pending=3,
                        faults=FaultPlan(slow_steps={2: 0.6}))
    reqs = [eng.submit(Request(p, REL_NEW, deadline_ms=500 if i == 2
                               else None)) for i, p in enumerate(prompts)]
    shed = Request(prompts[0], REL_NEW)
    try:
        eng.submit(shed)
        check(False, "reliability: max_pending=3 took a fourth request")
    except EngineOverloaded:
        pass
    st = eng.drain()
    outs = [list(r.output_ids) for r in reqs]
    check(st == {0: "done", 1: "done", 2: "timed_out"} and outs[2] == []
          and outs[:2] == clean[:2] and shed.status == "shed"
          and shed.rid is None and len(st) == 3
          and reg.get("serving_requests_shed_total").labels(**lbl).value == 1
          and reg.get("serving_requests_timed_out_total").labels(
              **lbl).value == 1,
          f"reliability: deadline/shed run {st}")
    print("reliability: queued request timed out at the slow step, the "
          "fourth submit was shed, the others bit-equal", flush=True)

    # preemption on a small paged pool: two low-priority decodes, then a
    # priority-5 request only a park can admit; prompts past one 256-row
    # block, so the parked chain keeps a full block to re-adopt
    wprompts = rel_workload(seed=5, lo=300, hi=400)

    def wave(preempt):
        eng = ServingEngine(model, **REL_PAGED, registry=MetricsRegistry())
        lows = [eng.submit(Request(p, 64)) for p in wprompts[:2]]
        hi = None
        if preempt:
            for _ in range(6):
                eng.step()
            hi = eng.submit(Request(wprompts[2], 16, priority=5))
        eng.run()
        return eng, lows, hi
    peng, lows, hi = wave(True)
    _, ref_lows, _ = wave(False)
    s_ = peng.stats()
    check([q.preempts for q in lows] == [0, 1] and hi.status == "done"
          and len(hi.output_ids) == 16
          and all(q.status == "done" and len(q.output_ids) == 64
                  for q in lows)
          and s_["preempted"] == 1
          and 0 < s_["preempt_resume_suffix_tokens"]
          < s_["preempt_resume_total_tokens"]
          and peng.kv_manager.outstanding() == 0,
          f"reliability: preemption {[q.preempts for q in lows]} {s_}")
    res["preempt_drift"], res["preempt_flip_per_tok"] = drift(
        [list(ref_lows[1].output_ids)], [list(lows[1].output_ids)])
    res["preempt_resume"] = {k: s_[k] for k in (
        "preempt_resume_suffix_tokens", "preempt_resume_total_tokens")}
    print(f"reliability: preemption parked request 1 "
          f"({res['preempt_resume']}); its resumed stream drifts "
          f"{res['preempt_drift']:.4f} of positions from its unpreempted "
          f"run (first-divergence rate {res['preempt_flip_per_tok']:.4f})",
          flush=True)
    torch.cuda.synchronize()
    res["launches"] = dict(k8=k8.launches, k9=k9.launches,
                           k8_plain=k8.plain_runs, k9_plain=k9.plain_runs)
    check(k8.launches > 0 and k9.launches > 0 and k8.plain_runs == 0
          and k9.plain_runs == 0,
          f"reliability: kernels {res['launches']}")
    print("reliability " + json.dumps(res), flush=True)
    del model, clean_eng, peng, eng
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------- phase 3d
#: phase 3d's requests: the first 8 of phase 3's mix, outputs capped at 64
#: tokens (two processes time-share the one card, their all-reduces go
#: through the host)
TP_REQUESTS, TP_NEW = 8, 64
#: the TP-2 arms' knobs over ``ENGINE``: bf16 greedy, and prompt lookup
#: on the paged pool with int8 KV
TP_ARMS = (("greedy", {}),
           ("lookup-kv8", dict(mode="spec", spec_k=8, kv_dtype="int8")))
#: the f32 arm: phase 4's 2-layer full-width f32 model (seed 1), four
#: requests of 24 tokens
TP_F32_PROMPTS, TP_F32_NEW = (300, 520, 260, 130), 24
#: the parent's wait for both TP-2 ranks
TP_RANK_TIMEOUT_S = 480


def tp_workload():
    prompts, olens = serving_workload()
    return (prompts[:TP_REQUESTS],
            [min(o, TP_NEW) for o in olens[:TP_REQUESTS]])


def tp_f32_model(torch, dev):
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM

    cfg = LlamaConfig(**{**SERVE_CFG, "num_hidden_layers": 2,
                         "dtype": "float32"})
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in TP_F32_PROMPTS]
    return (LlamaForCausalLM(cfg, device=dev, seed=1), prompts,
            [TP_F32_NEW] * len(prompts))


def tp_serve(torch, model, prompts, olens, tag, **knobs):
    """One run of ``ServingEngine(model, **ENGINE, **knobs)`` with the
    kernels' counters set to 0 just before and read just after: every
    request must finish with its token count, K8 and K9 must launch and no
    plain version may run.  Returns ``(streams, launches, wall seconds)``."""
    from paddle_tpu_torch.ops import paged_attention_cuda as k8
    from paddle_tpu_torch.ops import prefill_attention_cuda as k9
    from paddle_tpu_torch.serving import Request, ServingEngine

    eng = ServingEngine(model, **ENGINE, **knobs, instrument=False)
    torch.cuda.synchronize()
    k8.launches = k9.launches = k8.plain_runs = k9.plain_runs = 0
    k9.launches_mma = 0
    k8.launches_t.clear()
    t0 = time.perf_counter()
    reqs = [eng.submit(Request(p, o)) for p, o in zip(prompts, olens)]
    eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(k8=k8.launches, k9=k9.launches, k9_mma=k9.launches_mma,
                  k8_plain=k8.plain_runs, k9_plain=k9.plain_runs,
                  k8_by_t={str(t): n for t, n in k8.launches_t.items()})
    for r, o in zip(reqs, olens):
        check(r.status == "done" and len(r.output_ids) == o,
              f"{tag}: request {r.rid} finished {r.status} with "
              f"{len(r.output_ids)}/{o} tokens")
    check(counts["k8"] > 0 and counts["k9"] > 0
          and counts["k8_plain"] == 0 and counts["k9_plain"] == 0,
          f"{tag}: a kernel did not run, or a plain version did: {counts}")
    return [list(map(int, r.output_ids)) for r in reqs], counts, wall


def tp2_kernels(torch, dev):
    """K8 and K9 at a TP-2 rank's heads — the serving model's 16/4 split
    two ways: Hkv 2, G 4, D 128 — against their plain versions with
    phase 2's tolerances, bf16 and int8 caches, dense and paged: K8 at T 1
    and 9 (the spec_k 8 verify) within atol=rtol=1e-4 on the live rows,
    bitwise run to run; K9 at offsets 0/256/768/1792, the caches bitwise
    the plain append's, the bf16 output within 2 bf16 ulps or 1e-6.  Then
    each one's time by events and by the profiler at the serving lengths
    (bf16, paged), its plain version's, its bound and SDPA's over the
    same heads."""
    from paddle_tpu_torch.ops import paged_attention_cuda as k8
    from paddle_tpu_torch.ops import prefill_attention_cuda as k9
    from paddle_tpu_torch.ops.decode_attention import _q8_quantize

    gen = torch.Generator(device=dev)
    gen.manual_seed(4321)
    B, HKV, G, D, C, W = 8, 2, 4, 128, 256, 8
    LMAX, N, ROT = C * W, 64, 4
    scale = D ** -0.5

    def rnd(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    def cache(kv, *shape):
        x = rnd(*shape, dtype=torch.bfloat16)
        return _q8_quantize(x) if kv == "int8" else x

    def clone(x):
        return tuple(y.clone() for y in x) if isinstance(x, tuple) \
            else x.clone()

    def equal(a, b):
        if isinstance(a, tuple):
            return all(torch.equal(x, y) for x, y in zip(a, b))
        return torch.equal(a, b)

    lens = np.array([0, 255, 256, 700, 1023, 1500, 2040, LMAX], np.int32)
    perm = torch.randperm(N, generator=gen, device=dev).cpu().numpy()
    table = np.full((B, W), N, np.int32)
    nxt = 0
    for b in range(B - 1):                   # the last row is parked
        for w in range(min(W, -(-(int(lens[b]) + 9) // C))):
            table[b, w] = perm[nxt]
            nxt += 1
    tbl = torch.from_numpy(table).to(dev)
    lengths = torch.from_numpy(lens).to(dev)
    live = slice(0, B - 1)
    trow = torch.from_numpy(perm[:W].astype(np.int32).reshape(1, W)).to(dev)
    err8 = err9 = 0.0
    pools = {}
    for kv in ("bf16", "int8"):
        pools[kv] = [(cache(kv, N, C, HKV, D), cache(kv, N, C, HKV, D))
                     for _ in range(ROT if kv == "bf16" else 1)]
        dense = (cache(kv, B, LMAX, HKV, D), cache(kv, B, LMAX, HKV, D))
        for paged in (False, True):
            kc, vc = pools[kv][0] if paged else dense
            tb = tbl if paged else None
            for t in (1, 9):
                qg = rnd(B, HKV, G, t, D)
                n0 = k8.launches
                out = k8.paged_decode_attention(qg, kc, vc, lengths, scale,
                                                C, tb, impl="cuda")
                out2 = k8.paged_decode_attention(qg, kc, vc, lengths, scale,
                                                 C, tb, impl="cuda")
                ref = k8.paged_decode_attention_reference(
                    qg, kc, vc, lengths, scale, C, tb)
                torch.cuda.synchronize()
                d = (out[live] - ref[live]).abs()
                ok = bool((d <= 1e-4 + 1e-4 * ref[live].abs()).all()) \
                    and k8.launches == n0 + 2 and torch.equal(out, out2) \
                    and bool(torch.isfinite(out).all())
                err8 = max(err8, float(d.max()))
                print(f"K8 at Hkv 2 {kv} {'paged' if paged else 'dense'} "
                      f"T={t}: max_abs_err {float(d.max()):.3e}, bitwise "
                      f"run to run {'ok' if ok else 'MISMATCH'}", flush=True)
                check(ok, f"K8 at Hkv 2 disagrees with its plain version "
                          f"({kv}, paged={paged}, T={t})")
            kc, vc = (clone(c) for c in (pools[kv][0] if paged else dense))
            for off in (0, 256, 768, 1792):
                q = rnd(1, 256, HKV * G, D, dtype=torch.bfloat16)
                kn = rnd(1, 256, HKV, D, dtype=torch.bfloat16)
                vn = rnd(1, 256, HKV, D, dtype=torch.bfloat16)
                k2, v2 = clone(kc), clone(vc)
                n_mma = k9.launches_mma
                o1, _, _ = k9.prefill_attention(q, kn, vn, kc, vc, 3, off,
                                                scale, C,
                                                trow if paged else None,
                                                impl="cuda")
                o2, _, _ = k9.prefill_attention_reference(
                    q, kn, vn, k2, v2, 3, off, scale, C,
                    trow if paged else None)
                torch.cuda.synchronize()
                dd = (o1.float() - o2.float()).abs()
                ok = (k9.launches_mma == n_mma + 1 and equal(kc, k2)
                      and equal(vc, v2)
                      and bool(((bf16_ulps(o1, o2) <= 2)
                                | (dd <= 1e-6)).all()))
                err9 = max(err9, float(dd.max()))
                print(f"K9 at Hkv 2 {kv} {'paged' if paged else 'dense'} "
                      f"offset={off}: max_abs_err {float(dd.max()):.3e}, "
                      f"cache bitwise {'ok' if ok else 'MISMATCH'}",
                      flush=True)
                check(ok, f"K9 at Hkv 2 disagrees with its plain version "
                          f"({kv}, paged={paged}, offset={off})")
    res = {}
    bf = pools["bf16"]
    kd = [(k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous())
          for k, v in ((rnd(B, LMAX, HKV, D, dtype=torch.bfloat16),
                        rnd(B, LMAX, HKV, D, dtype=torch.bfloat16))
                       for _ in range(ROT))]
    for t in (1, 9):
        qg = rnd(B, HKV, G, t, D)

        def run(i, qg=qg):
            return k8.paged_decode_attention(qg, *bf[i % ROT], lengths,
                                             scale, C, tbl, impl="cuda")
        q_sd = rnd(B, HKV * G, t, D, dtype=torch.bfloat16)
        pos = (lengths[:, None] + torch.arange(t, device=dev)[None, :]) \
            .clamp(max=LMAX - 1)
        mask = (torch.arange(LMAX, device=dev)[None, None, :]
                <= pos[:, :, None])[:, None]
        b_ms, b_by = k8_bound(lens, tbl, t, HKV * D * 2, HKV=HKV)
        res[f"k8_t{t}"] = dict(
            ms=time_ms(torch, run, 200),
            device_ms=device_ms(torch, run, "paged_decode_kernel"),
            plain_ms=time_ms(torch, lambda i, qg=qg:
                             k8.paged_decode_attention_reference(
                                 qg, *bf[i % ROT], lengths, scale, C, tbl),
                             10, warm=1),
            bound_ms=b_ms, bound_by=b_by,
            library_ms=time_ms(torch, lambda i: sdpa(
                torch, q_sd, kd[i % ROT][0], kd[i % ROT][1], mask), 200))
    off, T = 768, 256
    q = rnd(1, T, HKV * G, D, dtype=torch.bfloat16)
    kn = rnd(1, T, HKV, D, dtype=torch.bfloat16)
    vn = rnd(1, T, HKV, D, dtype=torch.bfloat16)

    def run9(i):
        return k9.prefill_attention(q, kn, vn, *bf[i % ROT], 3, off, scale,
                                    C, trow, impl="cuda")
    qs = q.transpose(1, 2)
    ks = [(k[3, :off + T].transpose(0, 1)[None].contiguous(),
           v[3, :off + T].transpose(0, 1)[None].contiguous())
          for k, v in ((rnd(B, LMAX, HKV, D, dtype=torch.bfloat16),
                        rnd(B, LMAX, HKV, D, dtype=torch.bfloat16))
                       for _ in range(ROT))]
    m9 = (torch.arange(off + T, device=dev)[None, :]
          <= off + torch.arange(T, device=dev)[:, None])
    io9 = (T * HKV * G * D * 2 * 2 + 2 * T * HKV * D * 2 * 2
           + off * HKV * D * 2 * 2 + W * 4)
    fl9 = 4 * HKV * G * D * (T * off + T * (T + 1) // 2)
    b_ms, b_by = bound(io9, fl9)
    res["k9"] = dict(
        ms=time_ms(torch, run9, 200),
        device_ms=device_ms(torch, run9, "prefill_mma_kernel"),
        plain_ms=time_ms(torch, lambda i: k9.prefill_attention_reference(
            q, kn, vn, *bf[i % ROT], 3, off, scale, C, trow), 10, warm=1),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=time_ms(torch, lambda i: sdpa(
            torch, qs, ks[i % ROT][0], ks[i % ROT][1], m9), 200))
    for name, x in res.items():
        dms = ("not measured" if x["device_ms"] is None
               else f"{x['device_ms'] * 1e3:.1f} us")
        print(f"{name} at Hkv 2: {x['ms'] * 1e3:.1f} us/launch (device "
              f"{dms}), plain {x['plain_ms'] * 1e3:.1f} us, library "
              f"{x['library_ms'] * 1e3:.1f} us, bound "
              f"{x['bound_ms'] * 1e3:.2f} us ({x['bound_by']})", flush=True)
    return dict(k8=dict(max_abs_err=err8, **{
                    f"t{t}": res[f"k8_t{t}"] for t in (1, 9)}),
                k9=dict(max_abs_err=err9, **res["k9"]))


def phase_tp(torch, dev, card):
    """Phase 3d, tensor-parallel serving (module docstring)."""
    import tempfile

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM

    res = dict(kernels=tp2_kernels(torch, dev))
    model = LlamaForCausalLM(LlamaConfig(**SERVE_CFG), device=dev, seed=0)
    prompts, olens = tp_workload()
    single, single_tps = {}, {}
    for tag, knobs in TP_ARMS:
        single[tag], _, wall = tp_serve(torch, model, prompts, olens,
                                        f"tp single {tag}", **knobs)
        single_tps[tag] = sum(olens) / wall
    work = tempfile.mkdtemp(prefix="chip_smoke_tp_")
    # (a) TP 1 over NCCL: the all-reduce is the identity
    dist.init_process_group("nccl", init_method=f"file://{work}/nccl",
                            world_size=1, rank=0)
    try:
        mesh = init_device_mesh("cuda", (1,), mesh_dim_names=("mp",))
        tp1, c1, w1 = tp_serve(torch, model, prompts, olens, "tp1 nccl",
                               mesh=mesh)
        check(tp1 == single["greedy"],
              "TP 1 over NCCL differs from the single-device engine")
        ov, _, w_ov = tp_serve(torch, model, prompts, olens,
                               "tp1 nccl tp_overlap=2", mesh=mesh,
                               tp_overlap=2)
    finally:
        dist.destroy_process_group()
    res["tp1"] = dict(bitwise=True, launches=c1, tok_per_s=sum(olens) / w1,
                      single_tok_per_s=single_tps["greedy"],
                      overlap_bitwise=ov == single["greedy"],
                      overlap_drift=drift(single["greedy"], ov)[0],
                      overlap_tok_per_s=sum(olens) / w_ov)
    print(f"tp 1 over NCCL: streams bitwise equal to mesh=None, ok; "
          f"tp_overlap=2 {'bitwise equal' if ov == single['greedy'] else 'NOT bitwise equal'}"
          f" (drift {res['tp1']['overlap_drift']:.4f}); tok/s "
          f"{res['tp1']['tok_per_s']:.1f} / "
          f"{res['tp1']['overlap_tok_per_s']:.1f}, one device "
          f"{single_tps['greedy']:.1f} (record only)", flush=True)
    del model
    torch.cuda.empty_cache()
    f32, fprompts, folens = tp_f32_model(torch, dev)
    single["f32"], _, _ = tp_serve(torch, f32, fprompts, folens,
                                   "tp single f32")
    del f32
    torch.cuda.empty_cache()
    # (b) TP 2: two processes on the one card, an explicit gloo group
    ranks = tp2_spawn(work)
    for tag in [t for t, _ in TP_ARMS] + ["f32"]:
        a, b = (r[tag] for r in ranks)
        check(a["streams"] == b["streams"],
              f"tp2 {tag}: the two ranks' streams differ")
        for r in ranks:
            c = r[tag]["launches"]
            check(c["k8"] > 0 and c["k9"] > 0 and c["k8_plain"] == 0
                  and c["k9_plain"] == 0,
                  f"tp2 {tag}: a kernel did not run, or a plain version "
                  f"did: {c}")
        if tag == "f32":
            check(a["streams"] == single["f32"],
                  "tp2 f32: streams differ from the single-device f32 run")
        dr, flip = drift(single[tag], a["streams"])
        res[f"tp2_{tag}"] = dict(
            launches=[r[tag]["launches"] for r in ranks], drift=dr,
            flip_per_tok=flip, tok_per_s=[r[tag]["tok_per_s"]
                                          for r in ranks],
            single_tok_per_s=single_tps.get(tag))
        print(f"tp 2 over gloo {tag}: ranks bitwise equal, ok; drift vs "
              f"single device {dr:.4f} of positions (first-divergence "
              f"{flip:.4f} per token); K8 {a['launches']['k8']} / K9 "
              f"{a['launches']['k9']} launches a rank "
              f"{json.dumps(a['launches']['k8_by_t'])}; tok/s "
              + " / ".join(f"{r[tag]['tok_per_s']:.1f}" for r in ranks)
              + (f", one device {single_tps[tag]:.1f}" if tag in single_tps
                 else "")
              + f" (record only: two processes share the card, the "
              f"all-reduce goes through the host; {card})", flush=True)
    print("tp " + json.dumps(res), flush=True)
    return res


def tp2_entry(tp, key):
    """A kernel's TP-2 record for the ``kernels`` line: its check and
    times at Hkv 2 (phase 3d) and each TP path's launches on rank 0."""
    out = dict(tp["kernels"][key])
    out["launches"] = {tag: tp[tag]["launches"][0][key] for tag in tp
                       if tag.startswith("tp2_")}
    out["launches"]["tp1"] = tp["tp1"]["launches"][key]
    return out


def tp2_spawn(work):
    """Start the two TP-2 ranks (this script with ``--tp2-rank``), join
    them with a timeout and return their results; a rank that fails or
    hangs fails the phase, and every rank is stopped."""
    procs = []
    for r in range(2):
        log = open(f"{work}/rank{r}.log", "w")
        procs.append((subprocess.Popen(
            [sys.executable, __file__, "--tp2-rank", str(r), work],
            stdout=log, stderr=subprocess.STDOUT), log))
    t0 = time.perf_counter()
    try:
        for p, _ in procs:
            p.wait(timeout=max(1.0, TP_RANK_TIMEOUT_S
                               - (time.perf_counter() - t0)))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    print(f"tp 2: ranks joined in {time.perf_counter() - t0:.1f} s",
          flush=True)
    for r, (p, _) in enumerate(procs):
        if p.returncode != 0:
            with open(f"{work}/rank{r}.log") as f:
                print(f"tp2 rank {r} log tail:\n{f.read()[-4000:]}",
                      flush=True)
        check(p.returncode == 0, f"tp2 rank {r} exited {p.returncode}")
    out = []
    for r in range(2):
        with open(f"{work}/result_r{r}.json") as f:
            out.append(json.load(f))
    return out


def tp2_rank(torch, rank, work):
    """One TP-2 rank: join the gloo group (a file store in ``work``), mesh
    the card's two ranks, serve ``TP_ARMS`` and the f32 arm through
    ``ServingEngine(mesh=)``, and write the streams, launches and tok/s to
    ``work/result_r{rank}.json``."""
    import datetime

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    dist.init_process_group("gloo", init_method=f"file://{work}/gloo",
                            world_size=2, rank=rank,
                            timeout=datetime.timedelta(seconds=300))
    mesh = init_device_mesh("cuda", (2,), mesh_dim_names=("mp",))
    out = {}
    model = LlamaForCausalLM(LlamaConfig(**SERVE_CFG), device=dev, seed=0)
    prompts, olens = tp_workload()
    for tag, knobs in TP_ARMS:
        streams, counts, wall = tp_serve(torch, model, prompts, olens,
                                         f"tp2 rank {rank} {tag}",
                                         mesh=mesh, **knobs)
        out[tag] = dict(streams=streams, launches=counts, wall_s=wall,
                        tok_per_s=sum(olens) / wall)
    del model
    torch.cuda.empty_cache()
    f32, fprompts, folens = tp_f32_model(torch, dev)
    streams, counts, wall = tp_serve(torch, f32, fprompts, folens,
                                     f"tp2 rank {rank} f32", mesh=mesh)
    out["f32"] = dict(streams=streams, launches=counts, wall_s=wall,
                      tok_per_s=sum(folens) / wall)
    with open(f"{work}/result_r{rank}.json", "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()
    return 0


# ---------------------------------------------------------------- phase 3e
#: the observability arms: phase 3's first 8 requests, outputs capped at 64
OBS_REQUESTS, OBS_NEW = 8, 64
#: the monolithic arms: phase 3's 16 requests, outputs capped at 64; the
#: dense geometry both prefills share (monolithic prefill needs one)
MONO_NEW = 64
MONO_ENGINE = dict(batch_size=8, max_len=2048, decode_chunk=256)
#: K8 at T = the prompt bucket, checked and timed
MONO_TIMED = (64, 256, 1024)
#: the host-tier arms: one slot, outputs of 16 tokens; a pool of 8 blocks
#: of 256 (one full-length request) evicts the 768-token shared prefix
#: before the request that shares it arrives; the untiered twin's pool
#: holds everything
TIER_ENGINE = dict(batch_size=1, max_len=2048, kv_block=256,
                   prefill_chunk=256, decode_chunk=256)
TIER_SMALL, TIER_BIG, TIER_NEW = 2048, 8 * 2048, 16


def k8_bucket(torch, dev, gen, t, q8, lib_ms=None):
    """K8 at ``t`` query rows over a fresh dense ``[1, t]`` cache at length
    0 (a monolithic prefill's mini cache; Hkv 4, G 4, D 128, chunk 256 —
    clamped for t < 256), bf16 or int8: within atol=rtol=1e-4 of its plain
    version, bitwise run to run; its time by events and device time, its
    plain version's, its bound and SDPA (causal, bf16) at the same
    shape."""
    from paddle_tpu_torch.ops import paged_attention_cuda as k8

    HKV, G, D, C = 4, 4, 128, 256
    shape = (1, t, HKV, D)
    if q8:
        def leaf():
            return (torch.randint(-127, 128, shape, generator=gen,
                                  device=dev, dtype=torch.int8),
                    (0.001 + 0.05 * torch.rand(shape[:-1], generator=gen,
                                               device=dev))
                    .to(torch.float16))
    else:
        def leaf():
            return torch.randn(shape, generator=gen, device=dev) \
                .to(torch.bfloat16)
    kc, vc = leaf(), leaf()
    qg = torch.randn(1, HKV, G, t, D, generator=gen, device=dev)
    lengths = torch.zeros((1,), dtype=torch.int32, device=dev)
    scale = D ** -0.5

    def run(i=0):
        return k8.paged_decode_attention(qg, kc, vc, lengths, scale, C,
                                         impl="cuda")
    n0 = k8.launches
    out, again = run(), run()
    ref = k8.paged_decode_attention_reference(qg, kc, vc, lengths, scale, C)
    torch.cuda.synchronize()
    check(k8.launches == n0 + 2, "K8 at the bucket: not one launch a call")
    check(torch.equal(out, again), f"K8 T={t} differs from itself run to "
          "run")
    tag = f"K8 monolithic {'int8' if q8 else 'bf16'} T={t}"
    err = check_f32(tag + " (bitwise run to run)", out, ref, 1e-4, 1e-4)
    ms = time_ms(torch, run, 100)
    dms = device_ms(torch, run, "paged_decode_kernel")
    plain = time_ms(torch, lambda i: k8.paged_decode_attention_reference(
        qg, kc, vc, lengths, scale, C), 10, warm=1)
    row = HKV * (D + 2) if q8 else HKV * D * 2
    b_ms, b_by = bound(2 * t * row + 2 * HKV * G * t * D * 4 + 4,
                       4 * HKV * G * D * t * (t + 1) // 2)
    if lib_ms is None:
        F = torch.nn.functional
        qs = torch.randn(1, HKV * G, t, D, generator=gen, device=dev) \
            .to(torch.bfloat16)
        ks = torch.randn(1, HKV, t, D, generator=gen, device=dev) \
            .to(torch.bfloat16)
        lib_ms = time_ms(torch, lambda i: F.scaled_dot_product_attention(
            qs, ks, ks, is_causal=True, enable_gqa=True), 100)
    dev_s = "not measured" if dms is None else f"{dms * 1e3:.1f} us"
    print(f"{tag}: {ms * 1e3:.1f} us/launch (device {dev_s}), plain "
          f"{plain * 1e3:.1f} us, SDPA causal {lib_ms * 1e3:.1f} us, bound "
          f"{b_ms * 1e3:.2f} us ({b_by})", flush=True)
    return dict(max_abs_err=err, ms=ms, device_ms=dms, plain_ms=plain,
                bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms)


def obs_serve(torch, model, prompts, olens, **knobs):
    """One observability-arm run on ``ENGINE``: ``(engine, registry,
    requests, wall seconds)``."""
    from paddle_tpu_torch.observability import MetricsRegistry
    from paddle_tpu_torch.serving import Request, ServingEngine

    reg = MetricsRegistry()
    eng = ServingEngine(model, **ENGINE, registry=reg, **knobs)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reqs = [eng.submit(Request(p, o)) for p, o in zip(prompts, olens)]
    eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    for r, o in zip(reqs, olens):
        check(r.status == "done" and len(r.output_ids) == o,
              f"observability: request {r.rid} finished {r.status} with "
              f"{len(r.output_ids)}/{o} tokens")
    return eng, reg, reqs, wall


def obs_phase(torch, model):
    """(a): recorder on against off (bitwise streams), the dumps, the
    timelines, the SLO gauges, a watchdog stall, a live scrape and the
    spans in a profiler session."""
    import tempfile
    import urllib.request

    from torch.profiler import ProfilerActivity, profile

    from paddle_tpu_torch.observability import MetricsExporter
    from paddle_tpu_torch.serving import FaultPlan, Request

    prompts, olens = serving_workload()
    prompts = prompts[:OBS_REQUESTS]
    olens = [min(o, OBS_NEW) for o in olens[:OBS_REQUESTS]]
    # warm-up (cuBLAS handles, the allocator), so neither timed arm is
    # the first run on a fresh model
    obs_serve(torch, model, prompts[:1], [8], recorder=False)
    on, reg, reqs, w_on = obs_serve(torch, model, prompts, olens)
    _, _, off_reqs, w_off = obs_serve(torch, model, prompts, olens,
                                      recorder=False)
    streams = [list(r.output_ids) for r in reqs]
    check(streams == [list(r.output_ids) for r in off_reqs],
          "observability: recorder-on streams differ from recorder-off")
    fr = on.recorder
    kinds = {}
    for e in fr.events():
        kinds[e["kind"]] = kinds.get(e["kind"], 0) + 1
    check(kinds.get("submit") == len(prompts)
          and kinds.get("retire") == len(prompts) and not fr.dumps,
          f"observability: events {kinds}, dumps {fr.dumps}")
    for r in reqs:
        tl = r.timeline()
        ts = [x["t"] for x in tl]
        phases = [x["phase"] for x in tl]
        check(ts == sorted(ts) and phases[0] == "queued"
              and phases[-1] == "done" and "decoding" in phases
              and phases.index("decoding") > phases.index("prefilling"),
              f"observability: request {r.rid} timeline out of order: "
              f"{phases}")
    with tempfile.TemporaryDirectory() as tmp:
        jl = fr.dump_jsonl(f"{tmp}/events.jsonl")
        ct = fr.dump_chrome_trace(f"{tmp}/trace.json")
        with open(jl, encoding="utf-8") as f:
            back = [json.loads(ln) for ln in f]
        with open(ct, encoding="utf-8") as f:
            trace = json.load(f)
    check(back == json.loads(json.dumps(fr.events(), default=str))
          and len(trace["traceEvents"]) == len(back),
          "observability: the JSONL / chrome-trace dumps do not read back")
    text = reg.to_prometheus()
    for fam in ('serving_slo_attainment{policy="continuous",'
                'slo_class="interactive"}',
                'serving_slo_burn_rate{policy="continuous",'
                'slo_class="batch"}', "span_seconds_count",
                "serving_queue_seconds_count"):
        check(fam in text, f"observability: {fam} missing from /metrics")
    att = on.slo_tracker.snapshot()["classes"]["interactive"]
    res = dict(events=len(back), kinds=kinds, dropped=fr.dropped,
               tok_per_s_on=sum(olens) / w_on,
               tok_per_s_off=sum(olens) / w_off,
               slo_interactive=att)
    print(f"observability: recorder on/off streams bitwise equal, ok; "
          f"events by kind {json.dumps(kinds)}; JSONL and chrome-trace "
          f"dumps read back ({len(back)} events); timelines ordered; SLO "
          f"interactive attainment {att['attainment']:.3f} burn "
          f"{att['burn_rate']:.3f}; tok/s recorder on "
          f"{res['tok_per_s_on']:.1f} / off {res['tok_per_s_off']:.1f} "
          "(record only)", flush=True)

    # a slow step under the watchdog: exactly one stall dump
    plan = FaultPlan(slow_steps={4: 4.0})
    wd, wreg, _, _ = obs_serve(torch, model, prompts[:2],
                               [16, 16], faults=plan, watchdog=1.5)
    wd.close()
    dumps = [d["reason"] for d in wd.recorder.dumps]
    stalls = wreg.get("serving_watchdog_stalls_total").labels(
        component="continuous").value
    check(dumps == ["stall"] and stalls == 1
          and not wd._watchdog.is_alive,
          f"observability: watchdog dumps {dumps}, stalls {stalls}")
    res["watchdog_dumps"] = dumps
    print(f"observability: a 4.0 s slow step under watchdog=1.5 gave one "
          f"stall dump ({sum(1 for e in wd.recorder.events() if e['kind'] == 'stall')} "
          "stall events), the thread stopped at close(), ok", flush=True)

    # a live scrape, and the spans in a profiler session
    from paddle_tpu_torch.observability import MetricsRegistry
    from paddle_tpu_torch.serving import ServingEngine

    reg = MetricsRegistry()
    eng = ServingEngine(model, **ENGINE, registry=reg)
    exp = MetricsExporter(registry=reg, port=0,
                          debug_sources=eng.debug_sources()).start()
    try:
        for p, o in zip(prompts, olens):
            eng.submit(Request(p, min(o, 16)))
        for _ in range(3):
            eng.step()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                eng.step()
            torch.cuda.synchronize()
        scraped = {}
        for path in ("/metrics", "/healthz", "/debug/flightrecorder"):
            with urllib.request.urlopen(exp.url + path, timeout=10) as r:
                scraped[path] = (r.status, r.read().decode())
        eng.run()
    finally:
        exp.stop()
    health = json.loads(scraped["/healthz"][1])
    rec = json.loads(scraped["/debug/flightrecorder"][1])
    check(all(s == 200 for s, _ in scraped.values())
          and "serving_steps_total" in scraped["/metrics"][1]
          and health["queue_depth"] is not None and rec["recorded"] > 0,
          f"observability: scrape {health}")
    spans = sorted(e.key for e in prof.key_averages()
                   if e.key.startswith("serving."))
    check({"serving.step", "serving.decode"} <= set(spans),
          f"observability: the profiler shows the spans {spans}")
    res.update(scrape_health=health, profiler_spans=spans)
    print(f"observability: live scrape of /metrics, /healthz and "
          f"/debug/flightrecorder during the run ({rec['recorded']} events, "
          f"healthz {json.dumps(health)}), profiler spans {spans}, ok",
          flush=True)
    return res


def mono_phase(torch, dev, model):
    """(b): K8 at T = the prompt bucket against its plain version, timed;
    then phase 3's 16 requests with monolithic against chunked prefill,
    bf16 and int8 KV: K8 launched at every touched bucket's width, no plain
    version, the token drift between the two."""
    from paddle_tpu_torch.ops import paged_attention_cuda as k8
    from paddle_tpu_torch.ops import prefill_attention_cuda as k9
    from paddle_tpu_torch.serving import Request, ServingEngine

    gen = torch.Generator(device=dev)
    gen.manual_seed(4321)
    res = dict(k8={})
    for t in MONO_TIMED:
        bf = k8_bucket(torch, dev, gen, t, False)
        q8 = k8_bucket(torch, dev, gen, t, True, lib_ms=bf["library_ms"])
        res["k8"][str(t)] = dict(bf16=bf, int8=q8)
    prompts, olens = serving_workload()
    olens = [min(o, MONO_NEW) for o in olens]
    buckets = {}
    for p in prompts:
        b = 16
        while b < p.size:
            b *= 2
        buckets[b] = buckets.get(b, 0) + 1
    n_layers = SERVE_CFG["num_hidden_layers"]
    streams = {}
    for kv in ("bf16", "kv8"):
        knobs = dict(kv_dtype="int8") if kv == "kv8" else {}
        for pre in ("mono", "chunk"):
            eng = ServingEngine(
                model, **MONO_ENGINE, instrument=False, **knobs,
                prefill_chunk=None if pre == "mono" else 256)
            torch.cuda.synchronize()
            k8.launches = k9.launches = k8.plain_runs = k9.plain_runs = 0
            k8.launches_t.clear()
            t0 = time.perf_counter()
            reqs = [eng.submit(Request(p, o)) for p, o in zip(prompts,
                                                             olens)]
            eng.run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            by_t = dict(k8.launches_t)
            tag = f"monolithic {kv} {pre}"
            for r, o in zip(reqs, olens):
                check(r.status == "done" and len(r.output_ids) == o,
                      f"{tag}: request {r.rid} finished {r.status}")
            check(k8.plain_runs == 0 and k9.plain_runs == 0,
                  f"{tag}: a plain version ran")
            if pre == "mono":
                check(k9.launches == 0 and all(
                    by_t.get(b) == n * n_layers
                    for b, n in buckets.items()),
                      f"{tag}: K8 by width {by_t}, buckets {buckets}")
                res[f"{kv}_launches_by_t"] = {str(k): v
                                              for k, v in by_t.items()}
                if kv == "bf16":
                    res["launches"] = sum(by_t.get(b, 0) for b in buckets)
            else:
                check(k9.launches > 0, f"{tag}: K9 did not launch")
            streams[(kv, pre)] = [list(map(int, r.output_ids))
                                  for r in reqs]
            res[f"{kv}_{pre}_tok_per_s"] = sum(olens) / wall
            del eng
        dr, flip = drift(streams[(kv, "chunk")], streams[(kv, "mono")])
        res[f"{kv}_drift"], res[f"{kv}_flip_per_tok"] = dr, flip
        print(f"monolithic {kv}: K8 at T = every touched bucket "
              f"{json.dumps(res[f'{kv}_launches_by_t'])} ({buckets} "
              f"requests by bucket x {n_layers} layers), no plain version, "
              f"ok; drift against chunked prefill {dr:.4f} of positions "
              f"(first-divergence {flip:.4f} per token); tok/s mono "
              f"{res[f'{kv}_mono_tok_per_s']:.1f} / chunked "
              f"{res[f'{kv}_chunk_tok_per_s']:.1f} (record only)",
              flush=True)
    torch.cuda.empty_cache()
    return res


def tier_phase(torch, model):
    """(c): the host tier on a pool that evicts the 768-token shared
    prefix before its follower arrives: host hits and restores, streams
    bit-equal to a pool that holds everything, and a corrupted tier that
    falls back to prefill with the same streams."""
    from paddle_tpu_torch.observability import MetricsRegistry
    from paddle_tpu_torch.serving import FaultPlan, Request, ServingEngine

    prompts, _ = serving_workload()
    # the leader, two long fillers that evict its chain, the follower
    order = [0] + sorted(range(1, len(prompts) - 1),
                         key=lambda i: -prompts[i].size)[:2] \
        + [len(prompts) - 1]
    reqs_in = [prompts[i] for i in order]

    def run(pool, **knobs):
        reg = MetricsRegistry()
        eng = ServingEngine(model, **TIER_ENGINE, max_live_tokens=pool,
                            registry=reg, **knobs)
        reqs = [eng.submit(Request(p, TIER_NEW)) for p in reqs_in]
        eng.run()
        for r in reqs:
            check(r.status == "done" and len(r.output_ids) == TIER_NEW,
                  f"host tier: request {r.rid} finished {r.status}")
        return eng, reg, [list(map(int, r.output_ids)) for r in reqs]

    _, _, full = run(TIER_BIG)
    eng, reg, tiered = run(TIER_SMALL, host_tier_bytes=1 << 30)
    lbl = dict(policy="continuous")
    host = eng.kv_manager.host_tier
    hits = reg.get("serving_prefix_hits_total").labels(
        policy="continuous", tier="host").value
    restores = reg.get("serving_tier_restores_total").labels(**lbl).value
    check(tiered == full and hits > 0 and restores > 0
          and eng.stats()["host_reuse_tokens"] >= 768,
          f"host tier: streams equal {tiered == full}, host hits {hits}, "
          f"restores {restores}, {eng.stats()}")
    restore_step = next(e["step"] for e in eng.recorder.events()
                        if e["kind"] == "restore")
    plan = FaultPlan(host_tier_corrupt={restore_step: ("*", "garble")})
    _, creg, corrupt = run(TIER_SMALL, host_tier_bytes=1 << 30,
                           faults=plan)
    errs = creg.get("serving_host_tier_errors_total").labels(**lbl).value
    check(corrupt == full and errs > 0
          and plan.stats["host_corrupts"] == 1,
          f"host tier: the corrupted arm's streams equal "
          f"{corrupt == full}, errors {errs}")
    res = dict(host_hits=hits, restores=restores,
               host_reuse_tokens=eng.stats()["host_reuse_tokens"],
               demoted=host.stats["demoted"], corrupt_errors=errs,
               restore_ms=[s * 1e3 for s in eng._restore_s])
    print(f"host tier: {int(restores)} blocks restored in {int(hits)} host "
          f"hits ({res['host_reuse_tokens']} tokens; restore "
          f"{', '.join(f'{x:.2f}' for x in res['restore_ms'])} ms), "
          f"{host.stats['demoted']} demoted; streams bit-equal to the pool "
          f"that holds everything, ok; a garbled tier at step "
          f"{restore_step} fell back to prefill ({int(errs)} rejected), "
          "streams equal, ok", flush=True)
    return res


def phase_observability(torch, dev):
    """Phase 3e (module docstring): the request observability layer,
    monolithic prefill (K8 at T = the prompt bucket) and the host KV tier
    on the serving model at full width."""
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM

    model = LlamaForCausalLM(LlamaConfig(**SERVE_CFG), device=dev, seed=0)
    res = dict(observability=obs_phase(torch, model))
    res["monolithic"] = mono_phase(torch, dev, model)
    res["host_tier"] = tier_phase(torch, model)
    del model
    torch.cuda.empty_cache()
    print("observability " + json.dumps(res, default=str), flush=True)
    return res


# ----------------------------------------------------------------- phase 4
def phase_parity(torch, dev):
    from paddle_tpu_torch.models import llama_decode as ld
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.ops.decode_attention import (
        init_kv_cache, init_kv_pool,
    )
    from paddle_tpu_torch.serving import Request, ServingEngine

    cfg = LlamaConfig(**{**SERVE_CFG, "num_hidden_layers": 2,
                         "dtype": "float32"})
    gpu = LlamaForCausalLM(cfg, device=dev, seed=1)
    cpu = LlamaForCausalLM(cfg, device="cpu", seed=1)
    with torch.no_grad():
        for (_, pc), (_, pg) in zip(cpu.named_parameters(),
                                    gpu.named_parameters()):
            pc.copy_(pg.cpu())
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, cfg.vocab_size, n)
               for n in (300, 520, 260)]
    new = 24
    C, P = 256, 256

    @torch.no_grad()
    def first_step_logits(model, prompt):
        d = model.llama.embed_tokens.weight.device
        params, pcfg = ld._decode_params_of(model, 2048)
        _, nkv, hd, _ = pcfg
        caches = [init_kv_pool(8, C, nkv, hd, "float32", d)
                  for _ in range(2)]
        table = torch.arange(8, dtype=torch.int32, device=d)[None]
        padded = np.zeros((-(-prompt.size // P) * P,), np.int32)
        padded[:prompt.size] = prompt
        for off in range(0, prompt.size, P):
            tok = torch.from_numpy(padded[off:off + P][None]).to(d)
            first, _, caches = ld.serving_prefill_chunk(
                params, pcfg, tok, off, prompt.size, caches, 0,
                chunk_size=C, block_tables=table)
        lengths = torch.tensor([prompt.size], dtype=torch.int32, device=d)
        logits, _, _ = ld._forward_step(params, pcfg, first[:, None],
                                        caches, lengths, chunk_size=C,
                                        block_tables=table)
        return logits.cpu()

    lg = first_step_logits(gpu, prompts[0])
    lc = first_step_logits(cpu, prompts[0])
    dl = (lg - lc).abs()
    ok = bool((dl <= 1e-3 + 1e-3 * lc.abs()).all())
    print(f"parity: first decode-step logits max_abs_diff "
          f"{float(dl.max()):.3e} {'ok' if ok else 'MISMATCH'}", flush=True)
    check(ok, "first decode-step logits differ between card and CPU")

    def serve(model, knobs):
        eng = ServingEngine(model, **ENGINE, **knobs)
        reqs = [eng.submit(Request(p, new)) for p in prompts]
        eng.run()
        return [list(r.output_ids) for r in reqs]

    @torch.no_grad()
    def cpu_margin(prompt, prefix, knobs):
        """The CPU plain path's top-2 logit margin after ``prefix``, with
        the run's int8 KV / weights (one full-read forward)."""
        params, pcfg = ld._decode_params_of(cpu, 2048)
        if knobs.get("weight_dtype"):
            params = ld.quantize_decode_weights(params)
        toks = torch.from_numpy(
            np.concatenate([prompt, np.asarray(prefix, np.int64)])[None])
        caches = [init_kv_cache(1, 2048, pcfg[1], pcfg[2],
                                knobs.get("kv_dtype", "float32"), "cpu")
                  for _ in range(2)]
        logits, _, _ = ld._forward(params, pcfg, toks, caches,
                                   torch.zeros((1,), dtype=torch.int32),
                                   last_only=True)
        top = torch.topk(logits[0], 2).values
        return float(top[0] - top[1])

    res = dict(logits_max_abs_diff=float(dl.max()))
    for tag, knobs in (("f32", {}), ("kv8", dict(kv_dtype="int8")),
                       ("w8", dict(weight_dtype="int8")),
                       ("kv8-w8", dict(kv_dtype="int8",
                                       weight_dtype="int8"))):
        out_g, out_c = serve(gpu, knobs), serve(cpu, knobs)
        match = total = 0
        for i, (a, b) in enumerate(zip(out_g, out_c)):
            for j, (x, y) in enumerate(zip(a, b)):
                total += 1
                if x == y:
                    match += 1
                    continue
                margin = cpu_margin(prompts[i], b[:j], knobs)
                print(f"parity {tag}: request {i} diverges at token {j} "
                      f"(card {x}, cpu {y}); cpu top-2 margin {margin:.3e}",
                      flush=True)
                check(margin < 1e-3, f"{tag}: request {i} diverges at "
                                     f"token {j} with a top-2 margin of "
                                     f"{margin:.3e} >= 1e-3")
                break
        print(f"parity {tag}: token match rate {match}/{total} = "
              f"{match / max(total, 1):.4f}", flush=True)
        res[tag] = dict(match=match, total=total)
        if tag == "f32":
            # monolithic against chunked prefill on the card (dense
            # caches, which monolithic prefill needs): K8 at T = the
            # bucket against K9, both in f32
            dense = {}
            for pre in (None, 256):
                eng = ServingEngine(gpu, **MONO_ENGINE, prefill_chunk=pre,
                                    instrument=False)
                reqs = [eng.submit(Request(p, new)) for p in prompts]
                eng.run()
                dense[pre] = [list(r.output_ids) for r in reqs]
            check(dense[None] == dense[256] == out_g,
                  "parity f32: monolithic and chunked prefill streams "
                  "differ on the card")
            print("parity f32: monolithic prefill streams equal chunked "
                  "(dense) and paged on the card, ok", flush=True)
    return res


# ----------------------------------------------------------------- phase 5
FLASH_TRAIN = dict(B=16, L=2048, H=16, HKV=4, D=128)     # bench_llama
FLASH_LONG = dict(B=1, L=16384, H=16, HKV=4, D=128)      # bench_llama_long
FLASH_D64 = dict(B=2, L=256, H=8, HKV=8, D=64)           # entry() widths


def check_bf16(name, got, ref, ulps=2, atol=1e-5):
    """bf16 results within ``ulps`` units in the last place of the plain
    version's, or at most ``atol`` (a number or a per-element tensor)
    apart — near zero, where the two may differ in sign and their ulp
    distance means nothing."""
    d = (got.float() - ref.float()).abs()
    far = d > atol
    u = bf16_ulps(got, ref) * far
    ok = bool((u <= ulps).all())
    print(f"{name}: max_abs_err {float(d.max()):.3e} max_ulps {int(u.max())}"
          f" (elements beyond the absolute slack: {int(far.sum())}) "
          f"{'ok' if ok else 'MISMATCH'}", flush=True)
    check(ok, f"{name} beyond {ulps} bf16 ulps of its plain version")
    return float(d.max())


def grad_slack(ref, exp=16):
    """An absolute slack of 2^-exp of the tensor's largest magnitude."""
    return 2.0 ** -exp * float(ref.float().abs().max())


def check_f32(name, got, ref, atol, rtol):
    d = (got - ref).abs()
    ok = bool((d <= atol + rtol * ref.abs()).all())
    print(f"{name}: max_abs_err {float(d.max()):.3e} "
          f"{'ok' if ok else 'MISMATCH'}", flush=True)
    check(ok, f"{name} beyond atol={atol} rtol={rtol} of its plain version")
    return float(d.max())


def took_wgmma(kfa, before, key, tag):
    """Fail unless the launch since ``before`` (a copy of the counters) of
    flash kernel ``key`` went through its wgmma instance."""
    moved = {k: kfa.launches[k] - before[k] for k in (key, key + "_wgmma")}
    check(moved == {key: 1, key + "_wgmma": 1},
          f"{tag}: {key} did not take its wgmma instance ({moved})")


def flash_case(torch, dev, gen, B, L, H, HKV, D, dtype=None):
    dtype = dtype or torch.bfloat16

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)
    return (rnd(B, L, H * D), rnd(B, L, HKV * D), rnd(B, L, HKV * D),
            rnd(B, L, H * D))


def check_chunked_ce(torch, dev, gen):
    """One loss chunk of the training path (8192 tokens, hidden 2048,
    vocab 32000): the card's bf16 branch (one tensor-core GEMM with an f32
    result) against the same chunk widened to f32 first (the branch the
    CPU takes).  Both form exact products of bf16 values and sum them in
    f32, in another order: the loss within 1e-6 relative; dh and dw
    (bf16) within one bf16 ulp (2^-7 of their magnitude; rounding alone
    takes up to half) of the f32 branch's gradients, or near zero within
    2^-16 of the tensor's largest magnitude."""
    from paddle_tpu_torch.ops.chunked_ce import chunked_token_ce

    n, hid, vocab = (TRAIN_CFG[k] for k in ("loss_chunk_size",
                                            "hidden_size", "vocab_size"))
    h = torch.randn(1, n, hid, generator=gen, device=dev).to(torch.bfloat16)
    w = (0.02 * torch.randn(hid, vocab, generator=gen, device=dev)) \
        .to(torch.bfloat16)
    labels = torch.randint(0, vocab, (1, n), generator=gen, device=dev)
    labels[0, -100:] = -1                      # ignored tokens, as padding
    res = {}
    for tag, dt in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        hx = h.to(dt).requires_grad_(True)
        wx = w.to(dt).requires_grad_(True)
        loss = chunked_token_ce(hx, labels, wx, n)
        res[tag] = (loss.detach(), *torch.autograd.grad(loss, (hx, wx)))
    torch.cuda.synchronize()
    (lb, dhb, dwb), (lf, dhf, dwf) = res["bf16"], res["f32"]
    rel = abs(float(lb) - float(lf)) / abs(float(lf))
    print(f"chunked CE bf16 GEMM (f32 result) vs widened f32: loss "
          f"{float(lb):.6f} vs {float(lf):.6f}, rel diff {rel:.3e} "
          f"{'ok' if rel <= 1e-6 else 'MISMATCH'}", flush=True)
    check(rel <= 1e-6, f"chunked CE loss differs between its branches "
                       f"({rel:.3e})")
    for name, got, ref in (("dh", dhb, dhf), ("dw", dwb, dwf)):
        check(got.dtype == torch.bfloat16, f"chunked CE {name} not bf16")
        d = (got.float() - ref).abs()
        lim = 2.0 ** -7 * ref.abs() + grad_slack(ref)
        ok = bool((d <= lim).all())
        print(f"chunked CE {name}: max_abs_err {float(d.max()):.3e}, worst "
              f"share of the one-ulp bound {float((d / lim).max()):.3f} "
              f"{'ok' if ok else 'MISMATCH'}", flush=True)
        check(ok, f"chunked CE {name} beyond one bf16 ulp of the f32 "
                  "branch's gradient")
    del h, w, res
    torch.cuda.empty_cache()


def causal_pairs(lq, lk):
    off = lk - lq
    return sum(min(lk, off + p + 1) for p in range(lq))


def phase_train_kernels(torch, dev):
    """The training path's kernels (K1/K2 forward, K3 delta, K4 dK/dV, K5
    dQ, K6 RoPE) against their plain versions at the training shapes, the
    forward and dQ at the long-context (streamed) shape, the flash kernels
    once at head_dim 64; then their times, bounds and library yardsticks.
    Tolerances: f32 statistics (lse, delta) ``atol=rtol=1e-5``; bf16
    gradients within 2 bf16 ulps of the plain version, or near zero within
    2^-10 of the tensor's largest magnitude: both round p and ds to bf16
    before their products, as the reference does, from scores and dp
    summed in another order, and where one ds rounds the other way a
    gradient element moves by up to 2^-8·|ds·k| however small the element
    is (the dQ check prints how far that rounding puts each from
    unrounded f32); the bf16 forward output within
    2 ulps or
    ``2^-8 * (P|V|)`` (the bf16 rounding of p, against different maxima);
    RoPE bitwise."""
    from paddle_tpu_torch.ops import flash_attention as tfa
    from paddle_tpu_torch.ops import flash_attention_cuda as kfa
    from paddle_tpu_torch.ops import fused_rope as trope
    from paddle_tpu_torch.ops import fused_rope_cuda as k6

    gen = torch.Generator(device=dev)
    gen.manual_seed(4321)
    err = {}

    def check_flash(tag, cfg, backward=True, dq_only=False, vs_f32=False):
        B, L, H, HKV, D = (cfg[k] for k in ("B", "L", "H", "HKV", "D"))
        q, k, v, do = flash_case(torch, dev, gen, B, L, H, HKV, D)
        sc = D ** -0.5
        out, lse = kfa.flash_fwd(q, k, v, H, HKV, True, sc)
        ref, rlse = tfa.flash_fwd_reference(q, k, v, H, HKV, True, sc)
        # p is rounded to bf16 before p.V in both, against the running
        # max in the kernel and the final max in the plain version: the
        # outputs may differ by 2^-8 * sum(p |v|) / l
        pv_abs = tfa.flash_fwd_reference(q, k, v.abs(), H, HKV, True,
                                         sc)[0].float()
        torch.cuda.synchronize()
        e = check_bf16(f"K1/K2 forward out {tag}", out, ref,
                       atol=2.0 ** -8 * pv_abs + 1e-5)
        del pv_abs
        err["fwd"] = max(err.get("fwd", 0.0), e,
                         check_f32(f"K1/K2 forward lse {tag}", lse, rlse,
                                   1e-5, 1e-5))
        del ref, rlse
        if not backward:
            return
        delta = kfa.flash_delta(do, out, H)
        err["delta"] = max(err.get("delta", 0.0), check_f32(
            f"K3 delta {tag}", delta, tfa.flash_delta_reference(do, out, H),
            1e-5, 1e-5))
        before = dict(kfa.launches)
        dq = kfa.flash_bwd_dq(q, k, v, do, lse, delta, H, HKV, True, sc)
        took_wgmma(kfa, before, "dq", f"K5 dQ {tag}")
        if not dq_only:
            dk, dv = kfa.flash_bwd_dkv(q, k, v, do, lse, delta, H, HKV, True,
                                       sc)
        rdq, rdk, rdv = tfa.flash_bwd_reference(q, k, v, do, lse, delta, H,
                                                HKV, True, sc)
        torch.cuda.synchronize()
        # near zero, the rounding of ds sets the noise: hold gradients to
        # 2^-10 of the tensor's largest magnitude there
        err["dq"] = max(err.get("dq", 0.0), check_bf16(
            f"K5 dQ {tag}", dq, rdq, atol=grad_slack(rdq, 10)))
        if vs_f32:
            # how far the reference's rounding of p and ds puts each from
            # dQ without it (the plain version on the widened inputs)
            fdq = tfa.flash_bwd_reference(q.float(), k.float(), v.float(),
                                          do.float(), lse, delta, H, HKV,
                                          True, sc)[0]
            print(f"K5 dQ {tag} from unrounded f32 dQ: kernel "
                  f"{float((dq.float() - fdq).abs().max()):.3e}, plain "
                  f"{float((rdq.float() - fdq).abs().max()):.3e}, largest "
                  f"magnitude {float(fdq.abs().max()):.4g}", flush=True)
            del fdq
        if not dq_only:
            err["dkv"] = max(err.get("dkv", 0.0),
                             check_bf16(f"K4 dK {tag}", dk, rdk,
                                        atol=grad_slack(rdk, 10)),
                             check_bf16(f"K4 dV {tag}", dv, rdv,
                                        atol=grad_slack(rdv, 10)))

    check_flash("training shape", FLASH_TRAIN, vs_f32=True)
    check_flash("L 16384 (streamed shape)", FLASH_LONG, dq_only=True)
    check_flash("head_dim 64", FLASH_D64)
    torch.cuda.empty_cache()
    check_chunked_ce(torch, dev, gen)

    # ---- K6 at the training shape, forward and inverse: bitwise
    B, L, H, HKV, D = (FLASH_TRAIN[k] for k in ("B", "L", "H", "HKV", "D"))
    q, k, _, _ = flash_case(torch, dev, gen, B, L, H, HKV, D)
    ang = torch.rand(L, D, generator=gen, device=dev) * 6.0
    cos, sin = ang.cos().to(torch.bfloat16), ang.sin().to(torch.bfloat16)
    for neg in (False, True):
        oq, ok_ = k6.rope(q, k, cos, sin, H, HKV, neg)
        rq, rk = trope.rope_reference(q, k, cos, sin, H, HKV, neg)
        torch.cuda.synchronize()
        same = torch.equal(oq, rq) and torch.equal(ok_, rk)
        print(f"K6 rope {'inverse' if neg else 'forward'} training shape: "
              f"{'bitwise equal, ok' if same else 'MISMATCH'}", flush=True)
        check(same, "K6 differs from its plain version")
    err["rope"] = 0.0
    del oq, ok_, rq, rk

    # ---- times at the training shape (CUDA events, after warm-up)
    q, k, v, do = flash_case(torch, dev, gen, B, L, H, HKV, D)
    sc = D ** -0.5
    out, lse = kfa.flash_fwd(q, k, v, H, HKV, True, sc)
    delta = kfa.flash_delta(do, out, H)
    it = 10
    ms = dict(
        fwd=time_ms(torch, lambda i: kfa.flash_fwd(q, k, v, H, HKV, True,
                                                   sc), it),
        delta=time_ms(torch, lambda i: kfa.flash_delta(do, out, H), 50),
        dkv=time_ms(torch, lambda i: kfa.flash_bwd_dkv(
            q, k, v, do, lse, delta, H, HKV, True, sc), it),
        dq=time_ms(torch, lambda i: kfa.flash_bwd_dq(
            q, k, v, do, lse, delta, H, HKV, True, sc), it),
        rope=time_ms(torch, lambda i: k6.rope(q, k, cos, sin, H, HKV), 50))
    plain_bwd = time_ms(torch, lambda i: tfa.flash_bwd_reference(
        q, k, v, do, lse, delta, H, HKV, True, sc), 2, warm=1)
    plain = dict(
        fwd=time_ms(torch, lambda i: tfa.flash_fwd_reference(
            q, k, v, H, HKV, True, sc), 2, warm=1),
        delta=time_ms(torch, lambda i: tfa.flash_delta_reference(do, out, H),
                      10, warm=1),
        dkv=plain_bwd, dq=plain_bwd,
        rope=time_ms(torch, lambda i: trope.rope_reference(
            q, k, cos, sin, H, HKV), 10, warm=1))
    # library yardsticks (never called by the port): SDPA forward, and its
    # backward — which computes K3 + K4 + K5 together
    F = torch.nn.functional
    q4, k4, v4 = (x.view(B, L, -1, D).transpose(1, 2) for x in (q, k, v))
    lib_fwd = time_ms(torch, lambda i: F.scaled_dot_product_attention(
        q4, k4, v4, is_causal=True, enable_gqa=True), it)
    qg, kg, vg = (x.detach().requires_grad_(True) for x in (q4, k4, v4))
    o4 = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True,
                                        enable_gqa=True)
    do4 = do.view(B, L, H, D).transpose(1, 2)
    lib_bwd = time_ms(torch, lambda i: torch.autograd.grad(
        o4, (qg, kg, vg), do4, retain_graph=True), it)
    del o4, qg, kg, vg
    # K3's yardstick: one einsum computing the same row sums
    do4d, out4d = do.view(B, L, H, D), out.view(B, L, H, D)
    lib_delta = time_ms(torch, lambda i: torch.einsum(
        "blhd,blhd->bhl", do4d, out4d), 50)

    pairs = B * H * causal_pairs(L, L)
    el = 2                                            # bf16 bytes
    qb, kb = B * L * H * D * el, B * L * HKV * D * el
    stat = B * H * L * 4
    bounds = dict(
        fwd=bound(qb + 2 * kb + qb + stat, 4 * D * pairs),
        delta=bound(2 * qb + stat, 2 * B * L * H * D),
        # dK/dV must rebuild s and dp and form dv and dk: 8 D per pair;
        # dQ rebuilds s and dp and forms dq: 6 D per pair (one backward
        # doing all of it needs 10 D: 2.5x the forward's 4 D)
        dkv=bound(2 * qb + 2 * kb + 2 * stat + 2 * kb, 8 * D * pairs),
        dq=bound(2 * qb + 2 * kb + 2 * stat + qb, 6 * D * pairs),
        rope=bound(2 * (qb + kb) + 2 * L * D * el, 6 * B * L * (H + HKV) * D))
    lib = dict(fwd=lib_fwd, delta=lib_delta, dkv=lib_bwd, dq=None,
               rope=None)
    res = {}
    for name in ("fwd", "delta", "dkv", "dq", "rope"):
        b_ms, b_by = bounds[name]
        res[name] = dict(max_abs_err=err[name], ms=ms[name],
                         plain_ms=plain[name], bound_ms=b_ms, bound_by=b_by,
                         library_ms=lib[name])
        libs = "—" if lib[name] is None else f"{lib[name] * 1e3:.1f} us"
        print(f"{name}: {ms[name] * 1e3:.1f} us/launch, plain "
              f"{plain[name] * 1e3:.1f} us, library {libs}, bound "
              f"{b_ms * 1e3:.2f} us ({b_by})", flush=True)
    print(f"library SDPA backward {lib_bwd * 1e3:.1f} us vs K3+K4+K5 "
          f"{(ms['delta'] + ms['dkv'] + ms['dq']) * 1e3:.1f} us", flush=True)
    print(f"K6 rope: {bounds['rope'][0] / ms['rope']:.3f} of its "
          f"{bounds['rope'][1]} bound", flush=True)
    res["dkv"]["library_covers"] = "K3+K4+K5 (SDPA backward)"
    del q, k, v, do, out, lse, delta
    torch.cuda.empty_cache()
    res["fwd"]["long"], res["dq"]["long"] = time_long(torch, dev, gen)
    res["adamw"] = phase_adamw_kernel(torch, dev, gen)
    return res


def time_long(torch, dev, gen):
    """K2 (the forward at the streamed shape) and K5's streamed dQ at the
    long-context shape (B 1, L 16384, H 16/4, D 128, causal, bf16): µs a
    launch, bounds (4·D and 6·D operations per visible pair, or the
    bytes) and SDPA's forward as the yardstick.  Their values are held to
    the plain versions in ``check_flash``."""
    from paddle_tpu_torch.ops import flash_attention_cuda as kfa

    B, L, H, HKV, D = (FLASH_LONG[k] for k in ("B", "L", "H", "HKV", "D"))
    q, k, v, do = flash_case(torch, dev, gen, B, L, H, HKV, D)
    sc = D ** -0.5
    out, lse = kfa.flash_fwd(q, k, v, H, HKV, True, sc)
    delta = kfa.flash_delta(do, out, H)
    ms_fwd = time_ms(torch, lambda i: kfa.flash_fwd(q, k, v, H, HKV, True,
                                                    sc), 5)
    ms_dq = time_ms(torch, lambda i: kfa.flash_bwd_dq(
        q, k, v, do, lse, delta, H, HKV, True, sc), 5)
    F = torch.nn.functional
    q4, k4, v4 = (x.view(B, L, -1, D).transpose(1, 2) for x in (q, k, v))
    lib = time_ms(torch, lambda i: F.scaled_dot_product_attention(
        q4, k4, v4, is_causal=True, enable_gqa=True), 5)
    pairs = B * H * causal_pairs(L, L)
    qb, kb, stat = B * L * H * D * 2, B * L * HKV * D * 2, B * H * L * 4
    b_fwd = bound(qb + 2 * kb + qb + stat, 4 * D * pairs)
    b_dq = bound(2 * qb + 2 * kb + 2 * stat + qb, 6 * D * pairs)
    print(f"K2 forward L 16384: {ms_fwd * 1e3:.1f} us/launch, library "
          f"{lib * 1e3:.1f} us, bound {b_fwd[0] * 1e3:.2f} us ({b_fwd[1]});"
          f" K5 streamed dQ: {ms_dq * 1e3:.1f} us/launch, bound "
          f"{b_dq[0] * 1e3:.2f} us ({b_dq[1]})", flush=True)
    del q, k, v, do, out, lse, delta
    torch.cuda.empty_cache()
    return (dict(ms=ms_fwd, bound_ms=b_fwd[0], bound_by=b_fwd[1],
                 library_ms=lib),
            dict(ms=ms_dq, bound_ms=b_dq[0], bound_by=b_dq[1],
                 library_ms=None))


def bench_param_shapes():
    """The shapes of ``bench_llama``'s 147 parameters and how many of
    each: the embedding, the untied lm_head, per layer wq/wo, wk/wv,
    gate/up, down and the two norm gains, and the final norm."""
    h, i, v = (TRAIN_CFG[k] for k in ("hidden_size", "intermediate_size",
                                      "vocab_size"))
    kv = h // TRAIN_CFG["num_attention_heads"] \
        * TRAIN_CFG["num_key_value_heads"]
    n = TRAIN_CFG["num_hidden_layers"]
    return {(v, h): 1, (h, v): 1, (h, h): 2 * n, (h, kv): 2 * n,
            (h, i): 2 * n, (i, h): n, (h,): 2 * n + 1}


def phase_adamw_kernel(torch, dev, gen):
    """K7 against its plain version at each of the bench's seven
    parameter shapes, from nontrivial moments, in both of the
    optimizer's forms: a bf16 parameter without a master and a bf16
    gradient (the bench's), and an f32 master with an f32 gradient.
    Parameter, master, codes, scales and second moment must be BITWISE
    equal (both round every operation once, in the same order); if not,
    the count and the largest difference are printed and the check fails,
    unless only codes differ, each by one, with everything else bitwise
    (a tie rounded the other way).  Then one optimizer step's worth of
    launches (147, bf16, no master) timed against its plain version and
    its bound: 12.03 bytes an element moved, at 3.35 TB/s."""
    from paddle_tpu_torch.ops import fused_adamw as k7

    shapes = bench_param_shapes()
    sc = k7.adamw_scalars(0.9, 0.999, 1e-8, 1e-4, 3, 0.01)

    def case(shape, master):
        p32 = torch.randn(shape, generator=gen, device=dev)
        codes, scales = k7.q8_encode(
            0.01 * torch.randn(shape, generator=gen, device=dev))
        g = 0.01 * torch.randn(shape, generator=gen, device=dev)
        return dict(p=p32.to(torch.bfloat16),
                    g=g if master else g.to(torch.bfloat16),
                    codes=codes, scales=scales,
                    v=(1e-4 * torch.randn(shape, generator=gen, device=dev)
                       .abs()).to(torch.bfloat16),
                    master=p32 if master else None)

    worst = 0.0
    for shape in shapes:
        for master in (False, True):
            a = case(shape, master)
            b = {k: (x.clone() if x is not None else None)
                 for k, x in a.items()}
            k7.fused_adamw_q8(a["p"], a["g"], a["codes"], a["scales"],
                              a["v"], sc, master=a["master"], impl="cuda")
            k7.fused_adamw_q8(b["p"], b["g"], b["codes"], b["scales"],
                              b["v"], sc, master=b["master"],
                              impl="reference")
            torch.cuda.synchronize()
            tag = f"K7 {list(shape)} {'f32 master' if master else 'bf16'}"
            bad = {}
            for key in ("p", "master", "codes", "scales", "v"):
                if a[key] is None or torch.equal(a[key], b[key]):
                    continue
                d = (a[key].float() - b[key].float()).abs()
                bad[key] = (int((d > 0).sum()), float(d.max()))
                worst = max(worst, float(d.max()))
            if bad:
                print(f"{tag}: NOT bitwise: {bad} (elements, largest "
                      "difference)", flush=True)
                check(set(bad) == {"codes"} and bad["codes"][1] <= 1,
                      f"{tag}: not bitwise {bad}: only codes may differ, "
                      "by one, with everything else bitwise")
            else:
                print(f"{tag}: parameter, codes, scales, v"
                      f"{', master' if master else ''} bitwise equal, ok",
                      flush=True)
            del a, b
    torch.cuda.empty_cache()

    # one optimizer step: every bench parameter once, bf16, no master
    step = [case(shape, False) for shape, n in shapes.items()
            for _ in range(n)]
    check(len(step) == 147, f"bench_llama has {len(step)} parameters")

    def run(impl):
        for t in step:
            k7.fused_adamw_q8(t["p"], t["g"], t["codes"], t["scales"],
                              t["v"], sc, impl=impl)
    ms = time_ms(torch, lambda i: run("cuda"), 10)
    plain = time_ms(torch, lambda i: run("reference"), 1, warm=1)
    n_el = sum(t["p"].numel() for t in step)
    n_blk = sum(t["scales"].numel() for t in step)
    nbytes = n_el * (2 + 2 + 1 + 2 + 2 + 1 + 2) + n_blk * 4 * 2
    b_ms, b_by = bound(nbytes, 20 * n_el)
    print(f"K7 one optimizer step (147 launches, {n_el} values): "
          f"{ms:.3f} ms, plain {plain:.3f} ms, bound {b_ms:.3f} ms "
          f"({b_by}, {nbytes / n_el:.3f} B a value), "
          f"{nbytes / (ms * 1e-3) / 1e12:.3f} TB/s", flush=True)
    del step
    torch.cuda.empty_cache()
    return dict(max_abs_err=worst, ms=ms / 147, plain_ms=plain / 147,
                bound_ms=b_ms / 147, bound_by=b_by, library_ms=None,
                step_ms=ms, step_plain_ms=plain, step_bound_ms=b_ms)


# ---------------------------------------------------------------- phase 5b
BERT_CFG = dict(vocab_size=30522, hidden_size=768, num_hidden_layers=12,
                num_attention_heads=12, intermediate_size=3072,
                max_position_embeddings=512, hidden_dropout_prob=0.0,
                dtype="bfloat16")                 # bench_bert: BERT-base
BERT_BATCH, BERT_SEQ = 64, 512
SEG_BERT = dict(B=BERT_BATCH, L=BERT_SEQ, H=12, HKV=12, D=64)
SEG_VARLEN = dict(B=1, L=16384, H=16, HKV=4, D=128)   # K2's shape


def bert_lengths(seed=0):
    """Per-row live lengths of the padded BERT batch: 128-512 from seed."""
    return np.random.default_rng(seed).integers(128, BERT_SEQ + 1,
                                                BERT_BATCH)


def seg_inputs(torch, dev, kind):
    """Segment ids (int32, on the card) and the same-segment visible
    (query, key) pairs per head: ``bert`` is key padding at bench_bert's
    shape with lengths from ``bert_lengths`` and the last row all padding
    (a dead row); ``varlen`` is 16 packed sequences cut at random from
    seed 0 in all but the last 384 tokens, causal, and that pad tail
    (q -1, k -2)."""
    if kind == "bert":
        lengths = bert_lengths(0)
        lengths[-1] = 0
        pos = np.arange(BERT_SEQ)
        kseg = np.where(pos[None, :] < lengths[:, None], 0, -2)
        qseg = np.zeros_like(kseg)
        pairs = int(BERT_SEQ * lengths.sum())
    else:
        rng = np.random.default_rng(0)
        total = SEG_VARLEN["L"] - 384
        cu = np.concatenate([[0], np.sort(rng.choice(
            np.arange(1, total), 15, replace=False)), [total]])
        pos = np.arange(SEG_VARLEN["L"])
        seg = np.searchsorted(cu[1:], pos, side="right")
        qseg = np.where(pos < cu[-1], seg, -1)[None]
        kseg = np.where(pos < cu[-1], seg, -2)[None]
        n = np.diff(cu)
        pairs = int((n * (n + 1) // 2).sum())
    to = lambda x: torch.from_numpy(x.astype(np.int32)).to(dev)  # noqa
    return to(qseg), to(kseg), pairs


def phase_seg_kernels(torch, dev):
    """The segment-masked K1/K2, K4 and K5, and K3 on their zeroed dout,
    against their plain versions at bench_bert's attention shape (B 64,
    L 512, H 12, D 64, non-causal, key padding, one dead row) and at the
    varlen long-context shape (B 1, 16384 tokens in 16 sequences plus a
    pad tail, H 16, Hkv 4, D 128, causal), bf16, with phase 5's
    tolerances; the dead row holds the mean of V and the pad tail zeros.
    At the BERT shape the unsegmented K1, K3, K4 and K5 (what the
    unmasked run takes) are held the same way on the same inputs.  Times
    at both shapes (at the BERT shape also the unsegmented instances',
    with their bounds and SDPA's forward without a mask: what the switch
    costs); bounds count 4·D / 8·D / 6·D operations per same-segment
    visible pair (the unsegmented ones every pair); the library yardstick
    is scaled_dot_product_attention with the boolean mask — [B, 1, 1, L]
    key padding at the BERT shape, the block-diagonal causal [1, 1, L, L]
    at the varlen shape (k and v widened to the query heads) — and its
    backward."""
    from paddle_tpu_torch.ops import flash_attention as tfa
    from paddle_tpu_torch.ops import flash_attention_cuda as kfa

    def hold(tag, q, k, v, do, H, HKV, causal, sc, qseg=None, kseg=None):
        """Forward (out, lse), K3 delta, dQ and dK/dV against their plain
        versions with phase 5's tolerances (lse on live query rows only:
        a padding row's is never read); returns the largest errors, out,
        lse and delta."""
        out, lse = kfa.flash_fwd(q, k, v, H, HKV, causal, sc, qseg, kseg)
        ref, rlse = tfa.flash_fwd_reference(q, k, v, H, HKV, causal, sc,
                                            qseg, kseg)
        # p rounds to bf16 before p.V against different maxima: the
        # outputs may differ by 2^-8 * sum(p |v|) / l (phase 5)
        pv_abs = tfa.flash_fwd_reference(q, k, v.abs(), H, HKV, causal, sc,
                                         qseg, kseg)[0].float()
        torch.cuda.synchronize()
        live = 1 if qseg is None else (qseg >= 0)[:, None, :]
        err = dict(fwd=max(
            check_bf16(f"K1/K2 forward out {tag}", out, ref,
                       atol=2.0 ** -8 * pv_abs + 1e-5),
            check_f32(f"K1/K2 forward lse {tag}", lse * live, rlse * live,
                      1e-5, 1e-5)))
        del ref, rlse, pv_abs
        delta = kfa.flash_delta(do, out, H)
        err["delta"] = check_f32(f"K3 delta {tag}", delta,
                                 tfa.flash_delta_reference(do, out, H),
                                 1e-5, 1e-5)
        before = dict(kfa.launches)
        dq = kfa.flash_bwd_dq(q, k, v, do, lse, delta, H, HKV, causal, sc,
                              qseg, kseg)
        took_wgmma(kfa, before, "dq" if qseg is None else "dq_seg",
                   f"K5 dQ {tag}")
        dk, dv = kfa.flash_bwd_dkv(q, k, v, do, lse, delta, H, HKV, causal,
                                   sc, qseg, kseg)
        rdq, rdk, rdv = tfa.flash_bwd_reference(q, k, v, do, lse, delta, H,
                                                HKV, causal, sc, qseg, kseg)
        torch.cuda.synchronize()
        err["dq"] = check_bf16(f"K5 dQ {tag}", dq, rdq,
                               atol=grad_slack(rdq, 10))
        err["dkv"] = max(
            check_bf16(f"K4 dK {tag}", dk, rdk, atol=grad_slack(rdk, 10)),
            check_bf16(f"K4 dV {tag}", dv, rdv, atol=grad_slack(rdv, 10)))
        del rdq, rdk, rdv, dq, dk, dv
        return err, out, lse, delta

    gen = torch.Generator(device=dev)
    gen.manual_seed(2468)
    res = {}
    for kind, cfg, causal in (("bert", SEG_BERT, False),
                              ("varlen", SEG_VARLEN, True)):
        B, L, H, HKV, D = (cfg[k] for k in ("B", "L", "H", "HKV", "D"))
        qseg, kseg, pairs = seg_inputs(torch, dev, kind)
        q, k, v, do = flash_case(torch, dev, gen, B, L, H, HKV, D)
        pad = (qseg < 0)[:, :, None]
        do = do.masked_fill(pad, 0)           # as the autograd.Function
        sc = D ** -0.5
        tag = f"segmented {kind}"
        err, out, lse, delta = hold(tag, q, k, v, do, H, HKV, causal, sc,
                                    qseg, kseg)
        res["delta_err"] = max(res.get("delta_err", 0.0), err["delta"])
        if kind == "bert":
            # the dead row: every query row holds the mean of V
            mean_v = v[-1].float().view(L, HKV, D).mean(0).reshape(-1)
            d = float((out[-1].float() - mean_v).abs().max())
            slack = 2.0 ** -7 * float(mean_v.abs().max()) + 1e-3
            print(f"{tag}: dead row vs the mean of V: max_abs_err {d:.3e} "
                  f"{'ok' if d <= slack else 'MISMATCH'}", flush=True)
            check(d <= slack, "the dead row is not the mean of V")
        else:
            z = float(out.masked_select(pad).float().abs().max())
            print(f"{tag}: pad-tail rows max |out| {z} "
                  f"{'ok' if z == 0 else 'MISMATCH'}", flush=True)
            check(z == 0, "pad-tail rows are not zero")

        it = 10
        ms = dict(
            fwd=time_ms(torch, lambda i: kfa.flash_fwd(
                q, k, v, H, HKV, causal, sc, qseg, kseg), it),
            dkv=time_ms(torch, lambda i: kfa.flash_bwd_dkv(
                q, k, v, do, lse, delta, H, HKV, causal, sc, qseg, kseg),
                it),
            dq=time_ms(torch, lambda i: kfa.flash_bwd_dq(
                q, k, v, do, lse, delta, H, HKV, causal, sc, qseg, kseg),
                it))
        k3 = time_ms(torch, lambda i: kfa.flash_delta(do, out, H), 50)
        plain_bwd = time_ms(torch, lambda i: tfa.flash_bwd_reference(
            q, k, v, do, lse, delta, H, HKV, causal, sc, qseg, kseg), 1,
            warm=1)
        plain = dict(fwd=time_ms(torch, lambda i: tfa.flash_fwd_reference(
            q, k, v, H, HKV, causal, sc, qseg, kseg), 1, warm=1),
            dkv=plain_bwd, dq=plain_bwd)
        lib = dict(fwd=None, dkv=None, dq=None)
        unseg = dict(fwd=None, dkv=None, dq=None)
        F = torch.nn.functional
        if kind == "varlen":
            # the library on the same work: SDPA with the block-diagonal
            # causal boolean mask (k and v widened to the query heads
            # first, outside the timing), forward and backward
            q4 = q.view(B, L, H, D).transpose(1, 2)
            k4, v4 = (x.view(B, L, HKV, D).transpose(1, 2)
                      .repeat_interleave(H // HKV, 1) for x in (k, v))
            pos = torch.arange(L, device=dev)
            m4 = ((qseg[0][:, None] == kseg[0][None, :])
                  & (pos[None, :] <= pos[:, None]))[None, None]
            lib["fwd"] = time_ms(torch, lambda i: F.scaled_dot_product_attention(
                q4, k4, v4, attn_mask=m4), 3)
            qg, kg, vg = (x.detach().requires_grad_(True)
                          for x in (q4, k4, v4))
            o4 = F.scaled_dot_product_attention(qg, kg, vg, attn_mask=m4)
            do4 = do.view(B, L, H, D).transpose(1, 2)
            lib["dkv"] = time_ms(torch, lambda i: torch.autograd.grad(
                o4, (qg, kg, vg), do4, retain_graph=True), 3)
            del o4, qg, kg, vg, q4, k4, v4, m4
        if kind == "bert":
            # the unsegmented instances on the same inputs (the bench's
            # own, unmasked, run takes them): right at this shape, and
            # what the segment switch costs
            res["unsegmented"], o_u, lse_u, delta_u = hold(
                "unsegmented bert", q, k, v, do, H, HKV, causal, sc)
            unseg = dict(
                fwd=time_ms(torch, lambda i: kfa.flash_fwd(
                    q, k, v, H, HKV, causal, sc), it),
                dkv=time_ms(torch, lambda i: kfa.flash_bwd_dkv(
                    q, k, v, do, lse_u, delta_u, H, HKV, causal, sc), it),
                dq=time_ms(torch, lambda i: kfa.flash_bwd_dq(
                    q, k, v, do, lse_u, delta_u, H, HKV, causal, sc), it))
            del o_u, lse_u, delta_u
            q4, k4, v4 = (x.view(B, L, -1, D).transpose(1, 2)
                          for x in (q, k, v))
            # the yardsticks of K1 and of K3+K4+K5 at this shape: SDPA with
            # no mask, forward and backward
            unseg_lib = dict(fwd=time_ms(
                torch, lambda i: F.scaled_dot_product_attention(q4, k4, v4),
                it))
            qg, kg, vg = (x.detach().requires_grad_(True)
                          for x in (q4, k4, v4))
            o4 = F.scaled_dot_product_attention(qg, kg, vg)
            do4 = do.view(B, L, H, D).transpose(1, 2)
            unseg_lib["dkv"] = time_ms(torch, lambda i: torch.autograd.grad(
                o4, (qg, kg, vg), do4, retain_graph=True), it)
            del o4, qg, kg, vg
            m4 = (kseg == 0)[:, None, None, :]
            lib["fwd"] = time_ms(torch, lambda i: F.scaled_dot_product_attention(
                q4, k4, v4, attn_mask=m4), it)
            qg, kg, vg = (x.detach().requires_grad_(True)
                          for x in (q4, k4, v4))
            o4 = F.scaled_dot_product_attention(qg, kg, vg, attn_mask=m4)
            do4 = do.view(B, L, H, D).transpose(1, 2)
            lib["dkv"] = time_ms(torch, lambda i: torch.autograd.grad(
                o4, (qg, kg, vg), do4, retain_graph=True), it)
            del o4, qg, kg, vg
        el = 2
        qb, kb = B * L * H * D * el, B * L * HKV * D * el
        stat, segb = B * H * L * 4, 2 * B * L * 4
        bounds = dict(
            fwd=bound(qb + 2 * kb + qb + stat + segb, 4 * D * H * pairs),
            dkv=bound(2 * qb + 2 * kb + 2 * stat + 2 * kb + segb,
                      8 * D * H * pairs),
            dq=bound(2 * qb + 2 * kb + 2 * stat + qb + segb,
                     6 * D * H * pairs))
        # the unsegmented instances' bounds at the BERT shape: every pair
        # of every batch row
        all_pairs = B * L * L
        unseg_bounds = dict(
            fwd=bound(qb + 2 * kb + qb + stat, 4 * D * H * all_pairs),
            dkv=bound(2 * qb + 2 * kb + 2 * stat + 2 * kb,
                      8 * D * H * all_pairs),
            dq=bound(2 * qb + 2 * kb + 2 * stat + qb, 6 * D * H * all_pairs))
        res[kind] = {}
        for name in ("fwd", "dkv", "dq"):
            b_ms, b_by = bounds[name]
            res[kind][name] = dict(
                max_abs_err=err[name], ms=ms[name], plain_ms=plain[name],
                bound_ms=b_ms, bound_by=b_by, library_ms=lib[name])
            libs = "—" if lib[name] is None else f"{lib[name] * 1e3:.1f} us"
            uns = ""
            if unseg[name] is not None:
                ub_ms, ub_by = unseg_bounds[name]
                res[kind][name].update(unsegmented_ms=unseg[name],
                                       unsegmented_bound_ms=ub_ms,
                                       unsegmented_bound_by=ub_by)
                uns = (f", unsegmented {unseg[name] * 1e3:.1f} us (bound "
                       f"{ub_ms * 1e3:.2f} us, {ub_by})")
                if name in unseg_lib:
                    res[kind][name]["unsegmented_library_ms"] = \
                        unseg_lib[name]
                    uns += (f", SDPA {'backward ' if name == 'dkv' else ''}"
                            f"without a mask {unseg_lib[name] * 1e3:.1f} us")
            print(f"{name} {tag}: {ms[name] * 1e3:.1f} us/launch{uns}, "
                  f"plain {plain[name] * 1e3:.1f} us, library {libs}, bound "
                  f"{b_ms * 1e3:.2f} us ({b_by}; {pairs} visible pairs a "
                  "head)", flush=True)
        res[kind]["dkv"]["library_covers"] = \
            "K3+K4+K5 (SDPA backward with the mask)"
        res[kind]["delta_ms"] = k3
        print(f"library SDPA backward with the mask "
              f"{lib['dkv'] * 1e3:.1f} us vs K3+K4+K5 ({tag}) "
              f"{(k3 + ms['dkv'] + ms['dq']) * 1e3:.1f} us", flush=True)
        if kind == "bert":
            print(f"library SDPA backward without a mask "
                  f"{unseg_lib['dkv'] * 1e3:.1f} us vs K3+K4+K5 (unsegmented "
                  f"bert) {(k3 + unseg['dkv'] + unseg['dq']) * 1e3:.1f} us",
                  flush=True)
        del q, k, v, do, out, lse, delta
        torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------- phase 5c
# K10's shapes: (i) the flagship Llama attention (bench_llama), (ii) a
# cached prefill (the q tables bottom-right), (iii) head_dim 256 (the
# CUDA-core bf16 instances), (iv) f32 (the f32 instances)
ROPE_CASES = (
    ("Llama training shape", dict(B=16, LQ=2048, LK=2048, H=16, HKV=4,
                                  D=128), "bfloat16"),
    ("cached prefill Lq 512 < Lk 2048", dict(B=2, LQ=512, LK=2048, H=16,
                                             HKV=4, D=128), "bfloat16"),
    ("head_dim 256", dict(B=2, LQ=512, LK=512, H=8, HKV=2, D=256),
     "bfloat16"),
    ("f32", dict(B=2, LQ=256, LK=256, H=4, HKV=2, D=128), "float32"))


def phase_rope_kernels(torch, dev):
    """K10: ``flash_attention_packed_rope`` (the reference's :1370, the
    ``rope=True`` branches of the forward, dK/dV and dQ kernels), its own
    entry point.  First its main path: forward and backward once through
    ``autograd`` at the Llama shape (B 16, L 2048, H 16/4, D 128, causal,
    bf16, the model's RoPE tables), counters set to 0 just before and
    read just after: K10-fwd, K3, K10-dkv and K10-dq once each, nothing
    else.  Its output and gradients against the composition the model
    runs on the same inputs (K6, then K1; backward K3/K4/K5, then K6 with
    sin negated): the two round the rotation differently (K6 once, K10
    each product and the sum, as the reference's ``_rot_tile``), and dq,
    dk twice against once: every element within 4 ulps or within 2^-6
    of the tensor's largest magnitude (the plain versions on the CPU at
    B 1, L 2048: at most 2 ulps beyond 2^-7, none beyond 2^-6).  Then the
    kernels against their plain versions at the four ``ROPE_CASES``
    (phase 5's tolerances at bf16: out within 2 ulps or 2^-8 (P|V|), lse
    and K3's delta ``atol=rtol=1e-5``, gradients within 2 ulps or 2^-10 of
    the largest magnitude; f32: out 2e-5, gradients 2e-4, as the JAX
    package's kernel tests).  Times at the Llama shape: the three K10
    kernels, the composition's kernels (K6 + K1; K3 + K4 + K5 + K6
    inverse), the plain versions, and the library (SDPA on K6-rotated q
    and k, and its backward); bounds 4·D / 8·D / 6·D operations per
    visible causal pair or the bytes of q, k, v, the four tables and the
    outputs."""
    from paddle_tpu_torch.models.llama import LlamaConfig, _rope_cos_sin
    from paddle_tpu_torch.ops import flash_attention as tfa
    from paddle_tpu_torch.ops import flash_attention_cuda as kfa
    from paddle_tpu_torch.ops import fused_rope as trope
    from paddle_tpu_torch.ops import fused_rope_cuda as k6

    gen = torch.Generator(device=dev)
    gen.manual_seed(1357)
    _, cfg, _ = ROPE_CASES[0]
    B, L, H, HKV, D = (cfg[k] for k in ("B", "LQ", "H", "HKV", "D"))
    q, k, v, do = flash_case(torch, dev, gen, B, L, H, HKV, D)
    cos, sin = _rope_cos_sin(L, D, LlamaConfig(**TRAIN_CFG).rope_theta,
                             torch.bfloat16, dev)

    # ---- the main path, counted
    for key in kfa.launches:
        kfa.launches[key] = 0
    for key in tfa.plain_runs:
        tfa.plain_runs[key] = 0
    k6.launches = trope.plain_runs = 0
    xs = [x.detach().requires_grad_(True) for x in (q, k, v)]
    out = tfa.flash_attention_packed_rope(*xs, cos, sin, H, HKV, causal=True)
    out.backward(do)
    torch.cuda.synchronize()
    counts = dict(kfa.launches, rope=k6.launches,
                  plain=sum(tfa.plain_runs.values()) + trope.plain_runs)
    want = {key: 0 for key in counts}
    want.update(fwd_rope=1, delta=1, dkv_rope=1, dq_rope=1,
                fwd_rope_wgmma=1, dkv_rope_wgmma=1, dq_rope_wgmma=1)
    print(f"K10 main path (flash_attention_packed_rope forward + backward, "
          f"Llama shape) launches: {counts}", flush=True)
    check(counts == want, f"K10 path launches {counts}, expected {want}")
    launches = dict(fwd=counts["fwd_rope"], dkv=counts["dkv_rope"],
                    dq=counts["dq_rope"], delta=counts["delta"])
    launches_wgmma = dict(fwd=counts["fwd_rope_wgmma"],
                          dkv=counts["dkv_rope_wgmma"],
                          dq=counts["dq_rope_wgmma"])
    k10 = [out.detach()] + [x.grad for x in xs]

    # ---- against the composition the model runs (K6, then K1-K5)
    ys = [x.detach().requires_grad_(True) for x in (q, k, v)]
    rq, rk = trope.fused_rope(ys[0], ys[1], cos, sin, H, HKV)
    out2 = tfa.flash_attention_packed(rq, rk, ys[2], H, HKV, causal=True)
    out2.backward(do)
    torch.cuda.synchronize()
    comp = {}
    for name, a, b in zip(("out", "dq", "dk", "dv"), k10,
                          [out2.detach()] + [y.grad for y in ys]):
        diff = (a.float() - b.float()).abs()
        d, top = float(diff.max()), float(b.float().abs().max())
        u = int((bf16_ulps(a, b) * (diff > 2.0 ** -6 * top)).max())
        comp[name] = d
        print(f"K10 vs K6 + K1-K5 {name}: max_abs_err {d:.3e} "
              f"({d / top:.3e} of the largest magnitude {top:.4g}); "
              f"{u} ulps beyond 2^-6 of it {'ok' if u <= 4 else 'MISMATCH'}",
              flush=True)
        check(u <= 4, f"K10 {name} beyond 4 bf16 ulps and 2^-6 of the "
                      "composition's largest magnitude")
    del k10, xs, ys, out, out2, rq, rk

    # ---- the kernels against their plain versions
    err = dict(fwd=0.0, delta=0.0, dkv=0.0, dq=0.0)
    for tag, c, dt in ROPE_CASES:
        dtype = getattr(torch, dt)
        B, LQ, LK, H, HKV, D = (c[k] for k in ("B", "LQ", "LK", "H", "HKV",
                                                "D"))
        if tag.startswith("Llama"):
            qq, kk, vv, dd = q, k, v, do
        else:
            qq, kk, vv, dd = flash_case(torch, dev, gen, B, LK, H, HKV, D,
                                        dtype)
            qq, dd = qq[:, LK - LQ:].contiguous(), dd[:, LK - LQ:].contiguous()
        ang = torch.rand(LK, D, generator=gen, device=dev) * 6.0
        rope = tfa.rope_kernel_tables(ang.cos(), ang.sin(), LQ, LK, dtype)
        sc = D ** -0.5
        o, lse = kfa.flash_fwd(qq, kk, vv, H, HKV, True, sc, rope=rope)
        ro, rlse = tfa.flash_fwd_reference(qq, kk, vv, H, HKV, True, sc,
                                           rope=rope)
        delta = kfa.flash_delta(dd, o, H)
        rdelta = tfa.flash_delta_reference(dd, o, H)
        dk, dv = kfa.flash_bwd_dkv(qq, kk, vv, dd, lse, delta, H, HKV, True,
                                   sc, rope=rope)
        before = dict(kfa.launches)
        dq = kfa.flash_bwd_dq(qq, kk, vv, dd, lse, delta, H, HKV, True, sc,
                              rope=rope)
        if dtype == torch.bfloat16 and D in kfa.WGMMA_HEAD_DIMS:
            took_wgmma(kfa, before, "dq_rope", f"K10 {tag} dQ")
        rdq, rdk, rdv = tfa.flash_bwd_reference(qq, kk, vv, dd, lse, delta, H,
                                                HKV, True, sc, rope=rope)
        torch.cuda.synchronize()
        tag = f"K10 {tag}"
        if dtype == torch.bfloat16:
            pv_abs = tfa.flash_fwd_reference(qq, kk, vv.abs(), H, HKV, True,
                                             sc, rope=rope)[0].float()
            e_out = check_bf16(f"{tag} forward out", o, ro,
                               atol=2.0 ** -8 * pv_abs + 1e-5)
            del pv_abs
            e_dq = check_bf16(f"{tag} dQ", dq, rdq, atol=grad_slack(rdq, 10))
            e_dkv = max(check_bf16(f"{tag} dK", dk, rdk,
                                   atol=grad_slack(rdk, 10)),
                        check_bf16(f"{tag} dV", dv, rdv,
                                   atol=grad_slack(rdv, 10)))
        else:
            e_out = check_f32(f"{tag} forward out", o, ro, 2e-5, 2e-5)
            e_dq = check_f32(f"{tag} dQ", dq, rdq, 2e-4, 2e-4)
            e_dkv = max(check_f32(f"{tag} dK", dk, rdk, 2e-4, 2e-4),
                        check_f32(f"{tag} dV", dv, rdv, 2e-4, 2e-4))
        e_lse = check_f32(f"{tag} forward lse", lse, rlse, 1e-5, 1e-5)
        e_delta = check_f32(f"{tag} K3 delta", delta, rdelta, 1e-5, 1e-5)
        for key, e in (("fwd", max(e_out, e_lse)), ("delta", e_delta),
                       ("dkv", e_dkv), ("dq", e_dq)):
            err[key] = max(err[key], e)
        del o, lse, ro, rlse, delta, rdelta, dk, dv, dq, rdq, rdk, rdv
        torch.cuda.empty_cache()

    # ---- times at the Llama shape (CUDA events, after warm-up)
    _, cfg, _ = ROPE_CASES[0]
    B, L, H, HKV, D = (cfg[k] for k in ("B", "LQ", "H", "HKV", "D"))
    sc = D ** -0.5
    rope = tfa.rope_kernel_tables(cos, sin, L, L, torch.bfloat16)
    out, lse = kfa.flash_fwd(q, k, v, H, HKV, True, sc, rope=rope)
    delta = kfa.flash_delta(do, out, H)
    rq, rk = k6.rope(q, k, cos, sin, H, HKV)
    out1, lse1 = kfa.flash_fwd(rq, rk, v, H, HKV, True, sc)
    delta1 = kfa.flash_delta(do, out1, H)
    it = 10
    ms = dict(
        fwd=time_ms(torch, lambda i: kfa.flash_fwd(
            q, k, v, H, HKV, True, sc, rope=rope), it),
        dkv=time_ms(torch, lambda i: kfa.flash_bwd_dkv(
            q, k, v, do, lse, delta, H, HKV, True, sc, rope=rope), it),
        dq=time_ms(torch, lambda i: kfa.flash_bwd_dq(
            q, k, v, do, lse, delta, H, HKV, True, sc, rope=rope), it),
        delta=time_ms(torch, lambda i: kfa.flash_delta(do, out, H), 50))
    cms = dict(
        k6=time_ms(torch, lambda i: k6.rope(q, k, cos, sin, H, HKV), 50),
        k1=time_ms(torch, lambda i: kfa.flash_fwd(rq, rk, v, H, HKV, True,
                                                  sc), it),
        k4=time_ms(torch, lambda i: kfa.flash_bwd_dkv(
            rq, rk, v, do, lse1, delta1, H, HKV, True, sc), it),
        k5=time_ms(torch, lambda i: kfa.flash_bwd_dq(
            rq, rk, v, do, lse1, delta1, H, HKV, True, sc), it),
        k6_inv=time_ms(torch, lambda i: k6.rope(rq, rk, cos, sin, H, HKV,
                                                True), 50))
    plain_bwd = time_ms(torch, lambda i: tfa.flash_bwd_reference(
        q, k, v, do, lse, delta, H, HKV, True, sc, rope=rope), 2, warm=1)
    plain = dict(fwd=time_ms(torch, lambda i: tfa.flash_fwd_reference(
        q, k, v, H, HKV, True, sc, rope=rope), 2, warm=1),
        dkv=plain_bwd, dq=plain_bwd)
    F = torch.nn.functional
    q4, k4, v4 = (x.view(B, L, -1, D).transpose(1, 2) for x in (rq, rk, v))
    lib_fwd = time_ms(torch, lambda i: F.scaled_dot_product_attention(
        q4, k4, v4, is_causal=True, enable_gqa=True), it)
    qg, kg, vg = (x.detach().requires_grad_(True) for x in (q4, k4, v4))
    o4 = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True,
                                        enable_gqa=True)
    do4 = do.view(B, L, H, D).transpose(1, 2)
    lib_bwd = time_ms(torch, lambda i: torch.autograd.grad(
        o4, (qg, kg, vg), do4, retain_graph=True), it)
    del o4, qg, kg, vg

    pairs = B * H * causal_pairs(L, L)
    el = 2
    qb, kb = B * L * H * D * el, B * L * HKV * D * el
    stat, tab = B * H * L * 4, 4 * L * D * el
    bounds = dict(
        fwd=bound(qb + 2 * kb + tab + qb + stat, 4 * D * pairs),
        dkv=bound(2 * qb + 2 * kb + 2 * stat + tab + 2 * kb, 8 * D * pairs),
        dq=bound(2 * qb + 2 * kb + 2 * stat + tab + qb, 6 * D * pairs))
    lib = dict(fwd=lib_fwd, dkv=lib_bwd, dq=None)
    res = {}
    for name in ("fwd", "dkv", "dq"):
        b_ms, b_by = bounds[name]
        res[name] = dict(max_abs_err=err[name], ms=ms[name],
                         plain_ms=plain[name], bound_ms=b_ms, bound_by=b_by,
                         library_ms=lib[name], launches=launches[name])
        if name in launches_wgmma:
            res[name]["launches_wgmma"] = launches_wgmma[name]
        libs = "—" if lib[name] is None else f"{lib[name] * 1e3:.1f} us"
        print(f"K10 {name}: {ms[name] * 1e3:.1f} us/launch, plain "
              f"{plain[name] * 1e3:.1f} us, library {libs}, bound "
              f"{b_ms * 1e3:.2f} us ({b_by})", flush=True)
    res["dkv"]["library_covers"] = "K3+K10-dkv+K10-dq (SDPA backward on " \
        "K6-rotated q, k)"
    fwd_k10, fwd_comp = ms["fwd"], cms["k6"] + cms["k1"]
    bwd_k10 = ms["delta"] + ms["dkv"] + ms["dq"]
    bwd_comp = ms["delta"] + cms["k4"] + cms["k5"] + cms["k6_inv"]
    print(f"K10 forward {fwd_k10 * 1e3:.1f} us vs K6 + K1 "
          f"{cms['k6'] * 1e3:.1f} + {cms['k1'] * 1e3:.1f} = "
          f"{fwd_comp * 1e3:.1f} us; backward K3 + K10-dkv + K10-dq "
          f"{bwd_k10 * 1e3:.1f} us vs K3 + K4 + K5 + K6 inverse "
          f"{ms['delta'] * 1e3:.1f} + {cms['k4'] * 1e3:.1f} + "
          f"{cms['k5'] * 1e3:.1f} + {cms['k6_inv'] * 1e3:.1f} = "
          f"{bwd_comp * 1e3:.1f} us; step total {(fwd_k10 + bwd_k10) * 1e3:.1f}"
          f" vs {(fwd_comp + bwd_comp) * 1e3:.1f} us", flush=True)
    res["composition_ms"] = dict(cms, k3=ms["delta"])
    res["vs_composition_max_abs_err"] = comp
    res["delta_err"] = err["delta"]
    del q, k, v, do, out, lse, delta, rq, rk, out1, lse1, delta1
    torch.cuda.empty_cache()
    return res


# ----------------------------------------------------------------- phase 6
TRAIN_CFG = dict(SERVE_CFG, recompute=True, recompute_layers=7,
                 loss_chunk_size=8192)
TRAIN_BATCH, TRAIN_SEQ = 16, 2048


def kernel_counters():
    from paddle_tpu_torch.nn.functional import attention as attn
    from paddle_tpu_torch.ops import flash_attention as tfa
    from paddle_tpu_torch.ops import flash_attention_cuda as kfa
    from paddle_tpu_torch.ops import fused_adamw as k7
    from paddle_tpu_torch.ops import fused_rope as trope
    from paddle_tpu_torch.ops import fused_rope_cuda as k6

    def read():
        return dict(fwd=kfa.launches["fwd"], delta=kfa.launches["delta"],
                    dkv=kfa.launches["dkv"], dq=kfa.launches["dq"],
                    fwd_seg=kfa.launches["fwd_seg"],
                    dkv_seg=kfa.launches["dkv_seg"],
                    dq_seg=kfa.launches["dq_seg"],
                    fwd_wgmma=kfa.launches["fwd_wgmma"],
                    dkv_wgmma=kfa.launches["dkv_wgmma"],
                    fwd_seg_wgmma=kfa.launches["fwd_seg_wgmma"],
                    dkv_seg_wgmma=kfa.launches["dkv_seg_wgmma"],
                    dq_wgmma=kfa.launches["dq_wgmma"],
                    dq_seg_wgmma=kfa.launches["dq_seg_wgmma"],
                    rope=k6.launches, rope_vec=k6.launches_vec,
                    adamw=k7.launches,
                    plain_flash=sum(tfa.plain_runs.values()),
                    plain_rope=trope.plain_runs, plain_adamw=k7.plain_runs,
                    dense_sdpa=attn.dense_runs)

    def zero():
        for key in kfa.launches:
            kfa.launches[key] = 0
        for key in tfa.plain_runs:
            tfa.plain_runs[key] = 0
        k6.launches = k6.launches_vec = trope.plain_runs = 0
        attn.dense_runs = 0
        k7.launches = k7.plain_runs = 0
    return read, zero


def phase_train(torch, dev, n_warm=2, n_steps=5):
    """The bench_llama training step (int8 moments, K7) at full width."""
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.static import build_train_step

    cfg = LlamaConfig(**TRAIN_CFG)
    model = LlamaForCausalLM(cfg, device=dev, seed=0)
    n_params = sum(p.numel() for p in model.parameters())
    opt = AdamW(learning_rate=1e-4, parameters=model.parameters(),
                weight_decay=0.01, moment_dtype="int8")
    step = build_train_step(model, None, opt)
    n_tensors = sum(1 for _ in model.parameters())
    rng = np.random.default_rng(0)
    shape = (TRAIN_BATCH, TRAIN_SEQ)
    ids = torch.from_numpy(rng.integers(0, cfg.vocab_size, shape)).to(dev)
    labels = torch.from_numpy(rng.integers(0, cfg.vocab_size, shape)).to(dev)
    read, zero = kernel_counters()
    torch.cuda.reset_peak_memory_stats()
    losses = [float(step(ids, labels)) for _ in range(n_warm)]
    zero()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    timed = [step(ids, labels) for _ in range(n_steps)]
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / n_steps
    counts = read()
    losses += [float(x) for x in timed]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print("train losses " + " ".join(f"{x:.5f}" for x in losses), flush=True)
    check(all(np.isfinite(losses)), f"non-finite loss: {losses}")
    check(losses[-1] < losses[0], f"loss did not fall: {losses}")
    L, n = cfg.num_hidden_layers, n_steps
    rl = cfg.recompute_layers
    # every bf16 head_dim-128 forward, dK/dV and dQ launch took the wgmma
    # instance, every K6 launch the vector one
    want = dict(fwd=(L + rl) * n, delta=L * n, dkv=L * n, dq=L * n,
                fwd_seg=0, dkv_seg=0, dq_seg=0, fwd_wgmma=(L + rl) * n,
                dkv_wgmma=L * n, fwd_seg_wgmma=0, dkv_seg_wgmma=0,
                dq_wgmma=L * n, dq_seg_wgmma=0, rope=(L + rl + L) * n,
                rope_vec=(L + rl + L) * n, adamw=n_tensors * n,
                plain_flash=0, plain_rope=0, plain_adamw=0, dense_sdpa=0)
    print(f"train launches over {n} steps: {counts}", flush=True)
    check(counts == want, f"kernel launches {counts}, expected {want}")
    tok_s = TRAIN_BATCH * TRAIN_SEQ / dt
    flops_tok = 6 * n_params + 6 * L * cfg.hidden_size * TRAIN_SEQ
    mfu = flops_tok * tok_s / H100_BF16_FLOPS
    st = step._states
    state_gb = sum(t.numel() * t.element_size() for d in st.values()
                   for t in d.values()) / 1e9
    out = dict(params=n_params, tensors=n_tensors, batch=TRAIN_BATCH,
               seq=TRAIN_SEQ, step_ms=dt * 1e3, tokens_per_s=tok_s, mfu=mfu,
               peak_mem_gb=peak_gb, optimizer_state_gb=state_gb,
               moment_dtypes={n: str(next(iter(d.values())).dtype)
                              for n, d in st.items()},
               losses=losses,
               launches_per_step={k: v / n for k, v in counts.items()})
    print("train " + json.dumps(out), flush=True)

    # one profiled step: device time by kernel, device-busy share of the
    # unprofiled step's wall
    prof, rows = profile_step(torch, lambda: step(ids, labels), dt * 1e3,
                              "train step")
    if prof:
        opt_us = sum(us for us, key, _ in rows if "fused_adamw" in key)
        print(f"profile train step: the optimizer (K7) {opt_us / 1e3:.2f} "
              f"ms, {opt_us / 1e3 / prof['device_ms']:.4f} of the step's "
              "device time", flush=True)
        out["device_busy"] = prof["device_busy"]
        out["optimizer_ms"] = opt_us / 1e3
        out["optimizer_share"] = opt_us / 1e3 / prof["device_ms"]
    del model, opt, step, timed
    torch.cuda.empty_cache()
    return out, counts


# ----------------------------------------------------------------- phase 7
def phase_train_parity(torch, dev, n_steps=3, lr=1e-4):
    """The same trainer at full width, 2 layers, f32, batch 2, seq 256, on
    the card (kernels) and on the CPU (plain versions), from the same
    weights and data, with f32 moments and with int8 moments (K7 on the
    card; decode, update, re-encode on the CPU).  Losses agree to 1e-4
    relative.  Parameters: every element within 2.02·lr·steps — AdamW's
    first updates are ~lr·sign(g) (|m̂|/sqrt(v̂) is at most 1.004 at each
    of the first 3 steps), so an element whose gradient is near zero may
    move by up to that in opposite directions on the two devices; the
    decay terms differ by lr·wd times the parameters' difference only —
    and all but 1e-4 of them within 1e-5 + 1e-5·|p| (f32 moments).  With
    int8 moments the gradients' summation-order noise also flips a
    first-moment code where ``m'/s'`` sits at a rounding boundary, which
    moves that element's next update by ``lr·s/sqrt(v)``.  A flip at
    step t is one code of that step's scale s_t; the next step carries
    0.9 of it, which is 0.9·s_t/s_t+1 codes of the next scale — more than
    one where the block's scale shrank (its largest first moment turned
    back).  So every code, at every step, must be within
    ``floor(0.9·|m_card - m_cpu|/s + 0.5) + 1`` of the CPU's, where
    ``m_card - m_cpu`` is the decoded first moments' difference from the
    step before (0 at the first) and the 0.5 covers the gradients' noise
    and the scales' card-vs-CPU difference (at most 3.5e-3 relative, 0.45
    of a code at 127).  On an H100 the 9 codes off by 2-3 after 3 steps
    (all in lm_head) sat in blocks whose scale shrank 1.6-3.5x since
    their flip, and each offset is 0.9·s_t/s_t+1 to within 0.02 (this
    phase prints them).  Beside that: codes differ on at most 2.5e-4 of
    the elements (7.2e-5 measured on an H100), by more than one on at
    most 2e-7 (4.1e-8), and parameters beyond 1e-5 on at most 2e-5
    (5.3e-6 measured; the tier-1 test against JAX measures 3e-4)."""
    res = {}
    for md in (None, "int8"):
        res[md or "f32"] = train_parity_run(torch, dev, md, n_steps, lr)
    return res


def train_parity_run(torch, dev, moment_dtype, n_steps, lr):
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.static import build_train_step

    tag_m = moment_dtype or "f32"
    cfg = LlamaConfig(**{**TRAIN_CFG, "num_hidden_layers": 2,
                         "recompute_layers": 1, "dtype": "float32"})
    gpu = LlamaForCausalLM(cfg, device=dev, seed=2)
    cpu = LlamaForCausalLM(cfg, device="cpu", seed=2)
    cpu.load_numpy_state(gpu.numpy_state())
    rng = np.random.default_rng(3)
    ids = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 256)))
    labels = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 256)))
    read, zero = kernel_counters()
    steps, losses, states = {}, {}, {}
    for tag, model in (("card", gpu), ("cpu", cpu)):
        d = model.llama.embed_tokens.weight.device
        st = build_train_step(model, None, AdamW(
            learning_rate=lr, parameters=model.parameters(),
            weight_decay=0.01, moment_dtype=moment_dtype))
        zero()
        losses[tag], states[tag] = [], []
        for _ in range(n_steps):
            losses[tag].append(float(st(ids.to(d), labels.to(d))))
            if moment_dtype == "int8":
                # each step's first moments, codes and scales
                states[tag].append({k: (c.cpu().clone(), st._states[
                    "moment1@scale"][k].cpu().clone())
                    for k, c in st._states["moment1"].items()})
        steps[tag] = read()
    print(f"parity train {tag_m} launches: {steps}", flush=True)
    check(steps["card"]["fwd"] > 0 and steps["card"]["plain_flash"] == 0,
          f"card run did not take the kernels: {steps['card']}")
    check(steps["cpu"]["fwd"] == 0 and steps["cpu"]["plain_flash"] > 0,
          f"cpu run did not take the plain versions: {steps['cpu']}")
    if moment_dtype == "int8":
        check(steps["card"]["adamw"] > 0 and steps["cpu"]["adamw"] == 0,
              f"only the card run takes K7: {steps}")
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses["card"],
                                                    losses["cpu"]))
    print(f"parity train {tag_m} losses card {losses['card']} cpu "
          f"{losses['cpu']} max rel diff {rel:.3e}", flush=True)
    check(rel <= 1e-4, f"training losses differ card vs cpu: {rel:.3e}")
    pg, pc = gpu.numpy_state(), cpu.numpy_state()
    worst, n_off, n_all = 0.0, 0, 0
    for name in pc:
        diff = np.abs(pg[name] - pc[name])
        worst = max(worst, float(diff.max()))
        n_off += int((diff > 1e-5 + 1e-5 * np.abs(pc[name])).sum())
        n_all += diff.size
    frac = n_off / n_all
    print(f"parity train {tag_m} params after {n_steps} steps: max abs "
          f"diff {worst:.3e}, {n_off}/{n_all} ({frac:.2e}) beyond 1e-5",
          flush=True)
    frac_max = 2e-5 if moment_dtype == "int8" else 1e-4
    check(frac <= frac_max and worst <= 2.02 * lr * n_steps,
          f"parameters differ card vs cpu (max {worst:.3e}, {frac:.2e})")
    out = dict(losses=losses, max_rel_loss=rel, max_param_diff=worst,
               frac_param_off=frac)
    if moment_dtype == "int8":
        n = code_drift(torch, states["card"], states["cpu"])
        print(f"parity train int8 codes after {n_steps} steps: "
              f"{n['off']}/{n['all']} ({n['off'] / n['all']:.2e}) differ, "
              f"{n['big']} ({n['big'] / n['all']:.2e}) by more than one "
              f"(max {n['max']}); every step's codes within the carried "
              f"bound: {n['beyond'] == 0} (largest offset less 0.9·|dm|/s: "
              f"{n['excess']:.3f} codes)", flush=True)
        check(n["beyond"] == 0, f"{n['beyond']} int8 codes differ card vs "
              "cpu beyond what the step before carries")
        check(n["off"] <= 2.5e-4 * n["all"] and n["big"] <= 2e-7 * n["all"],
              f"int8 codes differ card vs cpu beyond the stated bounds: {n}")
        out["codes_off"] = n["off"] / n["all"]
    del gpu, cpu
    torch.cuda.empty_cache()
    return out


def code_drift(torch, card, cpu, show=20):
    """Int8 first-moment codes card vs CPU over the steps of phase 7
    (``card[t][name] = (codes, scales)`` after step t+1).  Counts the
    last step's codes that differ and by more than one, and holds every
    code at every step within ``floor(0.9·|dm|/s + 0.5) + 1`` of the
    CPU's: ``dm`` the decoded first moments' difference the step before
    carries, ``s`` this step's CPU scale (phase 7's docstring gives the
    reason).  Prints each code off by more than one at the last step with
    its block's scales at every step."""
    from paddle_tpu_torch.ops.fused_adamw import Q8_BLOCK, q8_decode
    n = dict(off=0, all=0, big=0, max=0, beyond=0, excess=0.0)
    last = len(cpu) - 1
    for t in range(len(cpu)):
        for k, (pc, ps) in cpu[t].items():
            cc = card[t][k][0]
            check(cc.dtype == torch.int8, f"{k}: moment1 is {cc.dtype}")
            dc = (cc.int() - pc.int()).abs().reshape(-1).float()
            s = ps.clamp(min=1e-30).repeat_interleave(Q8_BLOCK)[:dc.numel()]
            if t:
                dm = (q8_decode(*card[t - 1][k])
                      - q8_decode(*cpu[t - 1][k])).abs().reshape(-1)
                carried = 0.9 * dm / s
            else:
                carried = torch.zeros_like(dc)
            n["beyond"] += int((dc > torch.floor(carried + 0.5) + 1).sum())
            if bool((dc > 0).any()):
                n["excess"] = max(n["excess"], float((dc - carried).max()))
            if t != last:
                continue
            n["off"] += int((dc > 0).sum())
            n["all"] += dc.numel()
            n["big"] += int((dc > 1).sum())
            n["max"] = max(n["max"], int(dc.max()))
            for i in torch.nonzero(dc > 1).reshape(-1).tolist()[:show]:
                b = i // Q8_BLOCK
                hist = " ".join(
                    f"step {u + 1}: {int(card[u][k][0].reshape(-1)[i])}/"
                    f"{int(cpu[u][k][0].reshape(-1)[i])} "
                    f"s {float(cpu[u][k][1][b]):.4e}" for u in range(t + 1))
                print(f"parity train int8 {k}[{i}] card/cpu code, cpu "
                      f"scale: {hist}; carried {float(carried[i]):.3f} "
                      "codes", flush=True)
    return n


# ----------------------------------------------------------------- phase 6b
#: the knobs-on trainer's schedule: LinearWarmup over CosineAnnealingDecay
KNOB_LR = dict(peak=1e-4, T_max=100, warmup_steps=2, start=1e-5)
#: the knobs-on trainer's clip limit: its merged gradients' global norm
#: is 0.39 and 0.34 at its two apply steps (an H100, 700 W), so a limit
#: of 1.0 would never clip; 0.25 clips both
KNOB_CLIP = 0.25
#: amp O1 on f32 parameters: batch cut from 16 so that f32 weights, f32
#: moments, their f32 gradients and the f32 residual stream sit well
#: inside the card's 80 GB
AMP_BATCH = 8
#: the eager-API arm's batch (full widths and depth)
EAGER_BATCH = 4
#: phase 6b(c): (optimizer, recompute policy, peak rate of its schedule)
KNOB_PARITY_ARMS = (("momentum", "dots", 0.1),
                    ("adamw_amsgrad", "named", 1e-4),
                    ("lamb", "dots", 1e-3),
                    ("adamw_int8", "named", 1e-4))


def knob_schedule(tlr, peak, T_max=100, warmup_steps=2):
    return tlr.LinearWarmup(tlr.CosineAnnealingDecay(peak, T_max=T_max),
                            warmup_steps=warmup_steps, start_lr=peak / 10,
                            end_lr=peak)


def recording_clip(clip_norm):
    """A ``ClipGradByGlobalNorm`` that keeps its last call's factor and the
    gradients it was computed from (references, no copies), so the factor
    can be held to a recomputation after the step."""
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm

    class RecordingClip(ClipGradByGlobalNorm):
        last = None

        def _dygraph_clip(self, params_grads):
            out = super()._dygraph_clip(params_grads)
            self.last = (self.global_scale(params_grads),
                         [g for p, g in params_grads
                          if g is not None and getattr(p, "need_clip",
                                                       True)])
            return out
    return RecordingClip(clip_norm)


def clip_factor_check(torch, clip, tag):
    """The recorded factor against ``min(clip_norm / norm, 1)`` with the
    norm recomputed in f64 from the same gradients: within 1e-5 relative
    (f32 sums of f32 squares in another order)."""
    s, grads = clip.last
    norm = float(sum(g.double().square().sum() for g in grads).sqrt())
    want = min(clip.clip_norm / max(norm, 1e-12), 1.0)
    got = float(s)
    print(f"train knobs {tag}: global norm {norm:.6e}, clip factor "
          f"{got:.9e} vs f64 recomputation {want:.9e} (rel "
          f"{abs(got - want) / want:.2e})", flush=True)
    check(abs(got - want) <= 1e-5 * want,
          f"{tag}: clip factor {got} vs recomputed {want}")
    clip.last = None
    return dict(norm=norm, factor=got, factor_f64=want)


def phase_train_knobs(torch, dev, plain):
    """Phase 6b: the training-step knobs at full width (see the module
    docstring).  ``plain`` is phase 6's summary, printed beside."""
    res = dict(knobs=knobs_trainer(torch, dev, plain))
    res["amp_o1"] = amp_trainer(torch, dev)
    res["parity"] = {arm: knobs_parity_run(torch, dev, arm, policy, peak)
                     for arm, policy, peak in KNOB_PARITY_ARMS}
    res["eager"] = eager_vs_train_step(torch, dev)
    res["scaler"] = scaler_arm(torch, dev)
    res["dots"] = dots_trainer(torch, dev, plain)
    return res


def per_step_launches(cfg, n_tensors, k7):
    """One training step's launches at phase 6's configuration (``k7``:
    whether K7 runs)."""
    L, rl = cfg["num_hidden_layers"], cfg["recompute_layers"]
    return dict(fwd=L + rl, delta=L, dkv=L, dq=L, fwd_seg=0, dkv_seg=0,
                dq_seg=0, fwd_wgmma=L + rl, dkv_wgmma=L, fwd_seg_wgmma=0,
                dkv_seg_wgmma=0, dq_wgmma=L, dq_seg_wgmma=0,
                rope=2 * L + rl, rope_vec=2 * L + rl,
                adamw=n_tensors if k7 else 0, plain_flash=0, plain_rope=0,
                plain_adamw=0, dense_sdpa=0)


def train_batch(torch, dev, vocab, b, seed=0):
    rng = np.random.default_rng(seed)
    shape = (b, TRAIN_SEQ)
    return (torch.from_numpy(rng.integers(0, vocab, shape)).to(dev),
            torch.from_numpy(rng.integers(0, vocab, shape)).to(dev))


def knobs_trainer(torch, dev, plain, n_micro=4):
    """(a) ``AdamW(moment_dtype="int8")`` under a warmup/cosine schedule
    and ``ClipGradByGlobalNorm(KNOB_CLIP)``, merged over 2 micro-steps, 4
    micro-steps at phase 6's configuration: K7 launches 147 times on each
    apply step and never on the others, the parameters are bit-equal
    across the non-apply steps, each step's rate is the CPU scheduler's,
    the clip factor is its recomputation's, the losses are finite."""
    from paddle_tpu_torch.incubate.optimizer import GradientMergeOptimizer
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.optimizer import lr as tlr
    from paddle_tpu_torch.static import build_train_step

    cfg = LlamaConfig(**TRAIN_CFG)
    model = LlamaForCausalLM(cfg, device=dev, seed=0)
    n_tensors = sum(1 for _ in model.parameters())
    sched = knob_schedule(tlr, KNOB_LR["peak"])
    twin = knob_schedule(tlr, KNOB_LR["peak"])      # host floats only
    clip = recording_clip(KNOB_CLIP)
    inner = AdamW(learning_rate=sched, parameters=model.parameters(),
                  weight_decay=0.01, grad_clip=clip, moment_dtype="int8")
    inner._lr_scheduler = sched
    step = build_train_step(model, None, GradientMergeOptimizer(inner, 2))
    ids, labels = train_batch(torch, dev, cfg.vocab_size, TRAIN_BATCH)
    read, zero = kernel_counters()
    torch.cuda.reset_peak_memory_stats()
    losses, ms, k7, rates, clips = [], [], [], [], []
    total = {}
    for i in range(n_micro):
        rate = twin()
        twin.step()
        check(inner.get_lr() == rate,
              f"step {i + 1}: rate {inner.get_lr()} vs the scheduler's {rate}")
        rates.append(rate)
        apply = (i + 1) % 2 == 0
        before = None if apply else [p.detach().clone()
                                     for p in model.parameters()]
        zero()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = step(ids, labels)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        counts = read()
        losses.append(float(loss))
        k7.append(counts["adamw"])
        total = {k: total.get(k, 0) + v for k, v in counts.items()}
        want = per_step_launches(TRAIN_CFG, n_tensors, apply)
        check(counts == want, f"knobs step {i + 1}: launches {counts}, "
              f"expected {want}")
        if apply:
            clips.append(clip_factor_check(torch, clip, f"step {i + 1}"))
        else:
            same = all(torch.equal(a, b)
                       for a, b in zip(before, model.parameters()))
            check(same, f"step {i + 1} (no apply) moved the parameters")
            del before
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check(all(np.isfinite(losses)), f"non-finite knobs loss: {losses}")
    out = dict(losses=losses, step_ms=ms, rates=rates, k7_launches=k7,
               clip=clips, accumulate_ms=ms[2], apply_ms=ms[3],
               plain_step_ms=plain["step_ms"], peak_mem_gb=peak_gb,
               plain_peak_mem_gb=plain["peak_mem_gb"], launches=total)
    print("train knobs " + json.dumps(out), flush=True)
    print(f"train knobs: accumulate step {ms[2]:.1f} ms, apply step "
          f"{ms[3]:.1f} ms, phase 6's plain step {plain['step_ms']:.1f} ms; "
          f"peak memory {peak_gb:.2f} GB vs {plain['peak_mem_gb']:.2f} GB",
          flush=True)
    del model, inner, step, clip
    torch.cuda.empty_cache()
    return out


def amp_trainer(torch, dev, n_steps=2):
    """(b) Amp O1 on f32 parameters at phase 6's widths and depth, batch
    ``AMP_BATCH``, f32 AdamW moments: every attention launch takes the
    bf16 wgmma instances, K6 its vector one, no plain version runs."""
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.static import build_train_step

    cfg = LlamaConfig(**dict(TRAIN_CFG, dtype="float32"))
    model = LlamaForCausalLM(cfg, device=dev, seed=0)
    n_tensors = sum(1 for _ in model.parameters())
    step = build_train_step(model, None, AdamW(
        learning_rate=1e-4, parameters=model.parameters(),
        weight_decay=0.01), amp_level="O1")
    ids, labels = train_batch(torch, dev, cfg.vocab_size, AMP_BATCH)
    read, zero = kernel_counters()
    torch.cuda.reset_peak_memory_stats()
    zero()
    losses, ms = [], []
    for _ in range(n_steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(float(step(ids, labels)))
        ms.append((time.perf_counter() - t0) * 1e3)
    counts = read()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    want = {k: v * n_steps for k, v in
            per_step_launches(TRAIN_CFG, n_tensors, False).items()}
    print(f"train amp O1 (f32 parameters, batch {AMP_BATCH}): losses "
          f"{losses}, step ms {ms}, peak memory {peak_gb:.2f} GB, launches "
          f"{counts}", flush=True)
    check(all(np.isfinite(losses)), f"non-finite amp loss: {losses}")
    check(counts == want, f"amp O1 launches {counts}, expected {want}")
    del model, step
    torch.cuda.empty_cache()
    return dict(batch=AMP_BATCH, losses=losses, step_ms=ms[-1],
                peak_mem_gb=peak_gb, launches=counts)


def knob_optimizer(arm, sched, params, clip):
    from paddle_tpu_torch import optimizer as topt

    if arm == "momentum":
        return topt.Momentum(sched, parameters=params, grad_clip=clip)
    if arm == "lamb":
        return topt.Lamb(sched, parameters=params, grad_clip=clip)
    return topt.AdamW(sched, parameters=params, weight_decay=0.01,
                      grad_clip=clip, amsgrad=arm == "adamw_amsgrad",
                      moment_dtype="int8" if arm == "adamw_int8" else None)


def knobs_parity_run(torch, dev, arm, policy, peak, n_micro=4):
    """(c) Every knob at once — clip, schedule, merge k=2, amp O1,
    recompute ``policy`` — at phase 7's shapes (full width, 2 layers, f32
    weights, batch 2, seq 256), card (kernels) against CPU (plain
    versions) from the same weights and data, 4 micro-steps.  Under amp
    the two sides round bf16 products in another order, so: losses
    within 2e-3 relative (bf16 keeps 2^-8); with f32 moments (amsgrad)
    every parameter within 2.02 times the sum of the apply steps' rates
    (Adam's first updates are at most 1.004·lr, phase 7); with int8
    moments all but 1e-5 of them: a first-moment code that flips between
    the two sides at the first apply (their bf16 gradients differ) moves
    that element's second update by 0.9·s/(c1·sqrt(v̂)), which exceeds lr
    where the block's scale s is large against the element's own
    moments (phase 7 holds such flips step by step at f32; here they are
    counted); for Momentum and Lamb the card's update of the parameters
    (final less initial) within 5e-2 of the CPU's in norm."""
    from paddle_tpu_torch.incubate.optimizer import GradientMergeOptimizer
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import lr as tlr
    from paddle_tpu_torch.static import build_train_step

    cfg = LlamaConfig(**{**TRAIN_CFG, "num_hidden_layers": 2,
                         "recompute_layers": 1, "dtype": "float32",
                         "recompute_policy": policy})
    gpu = LlamaForCausalLM(cfg, device=dev, seed=2)
    cpu = LlamaForCausalLM(cfg, device="cpu", seed=2)
    p0 = gpu.numpy_state()
    cpu.load_numpy_state(p0)
    n_tensors = len(p0)
    rng = np.random.default_rng(3)
    ids = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 256)))
    labels = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 256)))
    read, zero = kernel_counters()
    losses, counts, rates = {}, {}, []
    for tag, model in (("card", gpu), ("cpu", cpu)):
        d = model.llama.embed_tokens.weight.device
        sched = knob_schedule(tlr, peak)
        inner = knob_optimizer(arm, sched, model.parameters(),
                               ClipGradByGlobalNorm(1.0))
        inner._lr_scheduler = sched
        st = build_train_step(model, None, GradientMergeOptimizer(inner, 2),
                              amp_level="O1")
        zero()
        losses[tag] = []
        for i in range(n_micro):
            if tag == "cpu" and i % 2:
                rates.append(inner.get_lr())
            losses[tag].append(float(st(ids.to(d), labels.to(d))))
        counts[tag] = read()
    tag_a = f"{arm}/{policy}"
    check(counts["card"]["fwd"] > 0 and counts["card"]["plain_flash"] == 0
          and counts["card"]["fwd_wgmma"] == counts["card"]["fwd"],
          f"parity knobs {tag_a}: card run did not take the bf16 kernels: "
          f"{counts['card']}")
    check(counts["cpu"]["fwd"] == 0 and counts["cpu"]["plain_flash"] > 0,
          f"parity knobs {tag_a}: cpu run took no plain versions")
    k7 = counts["card"]["adamw"]
    check(k7 == (n_tensors * n_micro // 2 if arm == "adamw_int8" else 0)
          and counts["cpu"]["adamw"] == 0,
          f"parity knobs {tag_a}: K7 launches {k7}")
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses["card"],
                                                    losses["cpu"]))
    pg, pc = gpu.numpy_state(), cpu.numpy_state()
    worst = max(float(np.abs(pg[n] - pc[n]).max()) for n in pc)
    bound_adam = 2.02 * sum(rates)
    n_all = sum(v.size for v in pc.values())
    n_beyond = sum(int((np.abs(pg[n] - pc[n]) > bound_adam).sum())
                   for n in pc)
    du = np.sqrt(sum(float(np.square((pg[n] - p0[n]) - (pc[n] - p0[n]))
                           .sum()) for n in pc))
    un = np.sqrt(sum(float(np.square(pc[n] - p0[n]).sum()) for n in pc))
    print(f"parity knobs {tag_a}: losses card {losses['card']} cpu "
          f"{losses['cpu']} max rel {rel:.3e}; params max abs diff "
          f"{worst:.3e} (Adam bound {bound_adam:.3e}, {n_beyond} of "
          f"{n_all} beyond); update diff "
          f"{du:.3e} of {un:.3e} ({du / max(un, 1e-30):.3e}); K7 {k7}",
          flush=True)
    check(rel <= 2e-3, f"parity knobs {tag_a}: losses differ {rel:.3e}")
    if arm == "adamw_int8":
        check(n_beyond <= 1e-5 * n_all, f"parity knobs {tag_a}: "
              f"{n_beyond} parameters beyond {bound_adam:.3e}")
    elif arm.startswith("adamw"):
        check(worst <= bound_adam, f"parity knobs {tag_a}: parameters "
              f"differ by {worst:.3e} > {bound_adam:.3e}")
    else:
        check(du <= 5e-2 * un, f"parity knobs {tag_a}: updates differ "
              f"{du / un:.3e} of their norm")
    del gpu, cpu
    torch.cuda.empty_cache()
    return dict(losses=losses, max_rel_loss=rel, max_param_diff=worst,
                beyond_adam_bound=n_beyond, adam_bound=bound_adam,
                update_rel_diff=du / max(un, 1e-30), k7_launches=k7)


def eager_vs_train_step(torch, dev, n_steps=2):
    """(d) ``Momentum`` (f32 masters of the bf16 parameters: the eager
    step keeps them, as the reference's does) with
    ``ClipGradByGlobalNorm(1.0)`` at phase 6's widths and depth, batch
    ``EAGER_BATCH``: ``loss.backward(); opt.step(); opt.clear_grad()``
    against ``build_train_step`` over the same optimizer — the same
    kernels in the same order, the parameters bitwise equal after each
    step."""
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import Momentum
    from paddle_tpu_torch.static import build_train_step

    cfg = LlamaConfig(**TRAIN_CFG)
    ids, labels = train_batch(torch, dev, cfg.vocab_size, EAGER_BATCH)

    def make(model):
        return Momentum(1e-3, parameters=model.parameters(),
                        grad_clip=ClipGradByGlobalNorm(1.0),
                        multi_precision=True)
    eager = LlamaForCausalLM(cfg, device=dev, seed=0)
    fused = LlamaForCausalLM(cfg, device=dev, seed=0)
    opt = make(eager)
    step = build_train_step(fused, None, make(fused))
    read, zero = kernel_counters()
    counts = {}
    for i in range(n_steps):
        zero()
        loss_e = eager(ids, labels)
        loss_e.backward()
        opt.step()
        opt.clear_grad()
        counts["eager"] = read()
        zero()
        loss_f = step(ids, labels)
        counts["train_step"] = read()
        check(torch.equal(loss_e.detach(), loss_f),
              f"eager step {i + 1}: loss {float(loss_e.detach())} vs "
              f"{float(loss_f)}")
        same = all(torch.equal(a, b) for a, b in zip(eager.parameters(),
                                                     fused.parameters()))
        check(same, f"eager step {i + 1}: parameters differ from "
              "build_train_step's")
        check(counts["eager"] == counts["train_step"],
              f"eager launches {counts}")
    print(f"train eager: Momentum + global clip, {n_steps} steps bitwise "
          f"equal to build_train_step (loss {float(loss_f):.6f}); "
          f"launches a step {counts['eager']}", flush=True)
    del eager, fused, opt, step
    torch.cuda.empty_cache()
    return dict(bitwise=True, loss=float(loss_f), launches=counts["eager"])


def scaler_arm(torch, dev):
    """(d) ``GradScaler`` under ``auto_cast(dtype="float16")`` on an
    attention-free stack of the port's ``Linear`` layers (4 x 2048 wide,
    4096 rows): a clean step moves the parameters; a step with an
    injected inf is skipped and halves the scale."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.nn.layer import Linear
    from paddle_tpu_torch.optimizer import SGD

    g = torch.Generator(device=dev).manual_seed(0)
    layers = []
    for _ in range(4):
        lin = Linear(2048, 2048, device=dev)
        lin.reset_parameters(g)
        layers += [lin, torch.nn.ReLU()]
    net = torch.nn.Sequential(*layers[:-1])
    opt = SGD(1e-3, parameters=net.parameters())
    scaler = amp.GradScaler(init_loss_scaling=2.0 ** 16)
    x = torch.randn((4096, 2048), device=dev, generator=g)
    y = torch.randn((4096, 2048), device=dev, generator=g)
    scales, moved = [], []
    for i in range(2):
        with amp.auto_cast(dtype="float16"):
            out = net(x)
            check(out.dtype == torch.float16, f"f16 amp output {out.dtype}")
            loss = ((out.float() - y) ** 2).mean()
        scaler.scale(loss).backward()
        if i == 1:
            net[0].weight.grad[0, 0] = float("inf")
        before = [p.detach().clone() for p in net.parameters()]
        scaler.step(opt)
        scaler.update()
        opt.clear_grad()
        moved.append(not all(torch.equal(a, b) for a, b in
                             zip(before, net.parameters())))
        scales.append(scaler.get_init_loss_scaling())
    print(f"train scaler: f16 Linear stack, moved {moved}, scales "
          f"{scales}", flush=True)
    check(moved == [True, False], f"GradScaler steps moved {moved}")
    check(scales == [2.0 ** 16, 2.0 ** 15], f"GradScaler scales {scales}")
    del net, opt
    torch.cuda.empty_cache()
    return dict(moved=moved, scales=scales)


def dots_trainer(torch, dev, plain, n_steps=2):
    """(e) Phase 6's trainer with ``recompute_policy="dots"`` on its 7
    recomputed layers: the launches as phase 6's (the recompute re-runs
    the kernels; only the matmuls' outputs are kept), step ms and peak
    memory beside phase 6's full recompute."""
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.static import build_train_step

    cfg = LlamaConfig(**dict(TRAIN_CFG, recompute_policy="dots"))
    model = LlamaForCausalLM(cfg, device=dev, seed=0)
    n_tensors = sum(1 for _ in model.parameters())
    step = build_train_step(model, None, AdamW(
        learning_rate=1e-4, parameters=model.parameters(),
        weight_decay=0.01, moment_dtype="int8"))
    ids, labels = train_batch(torch, dev, cfg.vocab_size, TRAIN_BATCH)
    read, zero = kernel_counters()
    torch.cuda.reset_peak_memory_stats()
    losses = [float(step(ids, labels))]
    zero()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    timed = [step(ids, labels) for _ in range(n_steps)]
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / n_steps * 1e3
    counts = read()
    losses += [float(x) for x in timed]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    want = {k: v * n_steps for k, v in
            per_step_launches(TRAIN_CFG, n_tensors, True).items()}
    full_ms = plain["step_ms"]
    print(f"train recompute dots: step {dt:.1f} ms vs full {full_ms:.1f} "
          f"ms, peak memory {peak_gb:.2f} GB vs "
          f"{plain['peak_mem_gb']:.2f} GB; losses {losses}", flush=True)
    check(all(np.isfinite(losses)), f"non-finite dots loss: {losses}")
    check(counts == want, f"dots launches {counts}, expected {want}")
    del model, step, timed
    torch.cuda.empty_cache()
    return dict(step_ms=dt, peak_mem_gb=peak_gb, losses=losses,
                full_step_ms=plain["step_ms"],
                full_peak_mem_gb=plain["peak_mem_gb"])


# ----------------------------------------------------------------- phase 8
def mlm_net(torch, model):
    """bench_bert's ``_Net``: the model's own chunked masked-LM loss, with
    the padding mask as an input."""
    class Net(torch.nn.Module):
        def __init__(self, m):
            super().__init__()
            self.m = m

        def forward(self, ids, mask, labels):
            return self.m(ids, attention_mask=mask, labels=labels,
                          return_logits=False)[0]
    return Net(model)


def bert_batch(torch, vocab, b, l, lengths=None, seed=0):
    """bench_bert's data: ids and labels from ``seed`` (15% of positions
    labelled, -100 elsewhere); with ``lengths`` a 1/0 mask padding each
    row past its length, and -100 on the padding."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, vocab, (b, l))
    labels = rng.integers(0, vocab, (b, l))
    labels[rng.random((b, l)) > 0.15] = -100
    mask = None
    if lengths is not None:
        live = np.arange(l)[None, :] < np.asarray(lengths)[:, None]
        labels[~live] = -100
        mask = torch.from_numpy(live.astype(np.int64))
    return torch.from_numpy(ids), mask, torch.from_numpy(labels)


def profile_step(torch, fn, wall_ms, tag, show=15):
    """One profiled call of ``fn``: prints device time by kernel and the
    device-busy share of the unprofiled wall; returns (a summary, or None
    when the profiler records no device time, and the rows ``(device µs,
    kernel, launches)``)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = sorted(((float(e.self_device_time_total), e.key, e.count)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and e.self_device_time_total > 0), reverse=True)
    total = sum(r[0] for r in rows)
    if not total:
        print(f"profile {tag}: the profiler recorded no device time (not "
              "measured)", flush=True)
        return None, None, rows
    print(f"profile {tag}: wall {wall_ms:.1f} ms unprofiled, device "
          f"{total / 1e3:.1f} ms, device busy "
          f"{total / 1e3 / wall_ms:.3f}", flush=True)
    for us, key, count in rows[:show]:
        print(f"profile {tag}: {us / 1e3:9.2f} ms {count:6d} launches  "
              f"{key[:80]}", flush=True)
    flash = sum(us for us, key, _ in rows if any(
        f"{k}_kernel" in key for k in ("fwd", "delta", "dkv", "dq")))
    print(f"profile {tag}: the flash kernels {flash / 1e3:.2f} ms, "
          f"{flash / total:.4f} of the step's device time", flush=True)
    return dict(device_ms=total / 1e3, device_busy=total / 1e3 / wall_ms,
                flash_ms=flash / 1e3, flash_share=flash / total), rows


def phase_bert(torch, dev, n_warm=2, n_steps=5):
    """bench_bert's training step at full width (BERT-base, bf16, batch
    64, seq 512, AdamW lr 1e-4 / weight decay 0.01, 15% of positions
    labelled, random weights and data from seed 0) through
    ``build_train_step``, twice: (a) with no mask, the bench's own run,
    on the unsegmented flash kernels; (b) with a per-row padding mask of
    lengths 128-512 from seed 0 (labels -100 on the padding), on the
    segmented ones.  Each run: 2 warm-up and 5 timed steps; the loss is
    finite and falls; counters set to 0 just before the timed steps show
    every flash kernel launched 12 times a step (forward, delta, dK/dV,
    dQ), the forward and dK/dV through their wgmma instances, and no
    plain version or dense attention.  Prints samples/s, step
    ms, MFU (bench.py's FLOP count over the dense bf16 peak), peak memory
    and one profiled step."""
    from paddle_tpu_torch.models.bert import BertConfig, BertForMaskedLM
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.static import build_train_step

    cfg = BertConfig(**BERT_CFG)
    read, zero = kernel_counters()
    res = {}
    for tag, lengths in (("unmasked", None), ("padded", bert_lengths(0))):
        model = BertForMaskedLM(cfg, device=dev, seed=0)
        n_params = sum(p.numel() for p in model.parameters())
        opt = AdamW(learning_rate=1e-4, parameters=model.parameters(),
                    weight_decay=0.01)
        step = build_train_step(mlm_net(torch, model), None, opt)
        ids, mask, labels = bert_batch(torch, cfg.vocab_size, BERT_BATCH,
                                       BERT_SEQ, lengths)
        args = [x.to(dev) if x is not None else None
                for x in (ids, mask, labels)]
        torch.cuda.reset_peak_memory_stats()
        losses = [float(step(*args)) for _ in range(n_warm)]
        zero()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        timed = [step(*args) for _ in range(n_steps)]
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) / n_steps
        counts = read()
        losses += [float(x) for x in timed]
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        print(f"bert {tag} losses " + " ".join(f"{x:.5f}" for x in losses),
              flush=True)
        check(all(np.isfinite(losses)), f"bert {tag}: non-finite loss")
        check(losses[-1] < losses[0], f"bert {tag}: loss did not fall: "
                                      f"{losses}")
        L, n = cfg.num_hidden_layers, n_steps
        seg = lengths is not None
        # every bf16 head_dim-64 forward, dK/dV and dQ launch took the
        # wgmma instance
        want = dict(fwd=0 if seg else L * n, delta=L * n,
                    dkv=0 if seg else L * n, dq=0 if seg else L * n,
                    fwd_seg=L * n if seg else 0, dkv_seg=L * n if seg else 0,
                    dq_seg=L * n if seg else 0,
                    fwd_wgmma=0 if seg else L * n,
                    dkv_wgmma=0 if seg else L * n,
                    fwd_seg_wgmma=L * n if seg else 0,
                    dkv_seg_wgmma=L * n if seg else 0,
                    dq_wgmma=0 if seg else L * n,
                    dq_seg_wgmma=L * n if seg else 0, rope=0, rope_vec=0,
                    adamw=0, plain_flash=0, plain_rope=0, plain_adamw=0,
                    dense_sdpa=0)
        print(f"bert {tag} launches over {n} steps: {counts}", flush=True)
        check(counts == want, f"bert {tag} kernel launches {counts}, "
                              f"expected {want}")
        flops_tok = 6 * n_params + 12 * L * cfg.hidden_size * BERT_SEQ
        mfu = flops_tok * BERT_BATCH * BERT_SEQ / dt / H100_BF16_FLOPS
        out = dict(params=n_params, batch=BERT_BATCH, seq=BERT_SEQ,
                   step_ms=dt * 1e3, samples_per_s=BERT_BATCH / dt, mfu=mfu,
                   peak_mem_gb=peak_gb, losses=losses,
                   launches_per_step={k: v / n for k, v in counts.items()})
        if seg:
            out["live_tokens"] = int(np.sum(lengths))
        print(f"bert {tag} " + json.dumps(out), flush=True)
        prof, _ = profile_step(torch, lambda: step(*args), dt * 1e3,
                               f"bert {tag}")
        if prof:
            out.update(prof)
        res[tag] = (out, counts)
        del model, opt, step, timed, args
        torch.cuda.empty_cache()
    return res


# ----------------------------------------------------------------- phase 9
def phase_bert_parity(torch, dev, n_steps=3, lr=1e-4):
    """bench_bert's trainer at full width, 2 layers, f32, batch 2, seq
    512, with the padding mask (lengths from seed 3), 3 steps on the card
    (the segmented kernels' f32 templates) and on the CPU (their plain
    versions), from the same weights and data.  Losses within 1e-5
    relative; every parameter within 2.02·lr·steps (phase 7's reason) and
    all but 1e-5 of them within 1e-5 + 1e-5·|p| (limits a few times the
    readings, 1.5e-6 and 2.1e-6, as phase 7's are), not counting the key
    projection's bias, whose exact gradient is zero (a query row's
    softmax does not see q·b): Adam moves it by about lr·sign of
    summation noise, which differs between the devices."""
    from paddle_tpu_torch.models.bert import BertConfig, BertForMaskedLM
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.static import build_train_step

    cfg = BertConfig(**{**BERT_CFG, "num_hidden_layers": 2,
                        "dtype": "float32"})
    gpu = BertForMaskedLM(cfg, device=dev, seed=2)
    cpu = BertForMaskedLM(cfg, device="cpu", seed=2)
    cpu.load_numpy_state(gpu.numpy_state())
    lengths = np.random.default_rng(3).integers(128, BERT_SEQ + 1, 2)
    data = bert_batch(torch, cfg.vocab_size, 2, BERT_SEQ, lengths, seed=3)
    read, zero = kernel_counters()
    steps, losses = {}, {}
    for tag, model in (("card", gpu), ("cpu", cpu)):
        d = model.transform.weight.device
        st = build_train_step(mlm_net(torch, model), None, AdamW(
            learning_rate=lr, parameters=model.parameters(),
            weight_decay=0.01))
        zero()
        losses[tag] = [float(st(*(x.to(d) for x in data)))
                       for _ in range(n_steps)]
        steps[tag] = read()
    print(f"bert parity launches: {steps}", flush=True)
    check(steps["card"]["fwd_seg"] > 0 and steps["card"]["plain_flash"] == 0,
          f"card run did not take the segmented kernels: {steps['card']}")
    check(steps["cpu"]["fwd_seg"] == 0 and steps["cpu"]["plain_flash"] > 0,
          f"cpu run did not take the plain versions: {steps['cpu']}")
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses["card"],
                                                    losses["cpu"]))
    print(f"bert parity losses card {losses['card']} cpu {losses['cpu']} "
          f"max rel diff {rel:.3e}", flush=True)
    check(rel <= 1e-5, f"bert losses differ card vs cpu: {rel:.3e}")
    pg, pc = gpu.numpy_state(), cpu.numpy_state()
    worst, n_off, n_all = 0.0, 0, 0
    for name in pc:
        diff = np.abs(pg[name] - pc[name])
        worst = max(worst, float(diff.max()))
        if name.endswith("k_proj.bias"):
            continue
        n_off += int((diff > 1e-5 + 1e-5 * np.abs(pc[name])).sum())
        n_all += diff.size
    frac = n_off / n_all
    print(f"bert parity params after {n_steps} steps: max abs diff "
          f"{worst:.3e}, {n_off}/{n_all} ({frac:.2e}) beyond 1e-5",
          flush=True)
    check(frac <= 1e-5 and worst <= 2.02 * lr * n_steps,
          f"bert parameters differ card vs cpu (max {worst:.3e}, "
          f"{frac:.2e})")
    del gpu, cpu
    torch.cuda.empty_cache()
    return dict(losses=losses, max_rel_loss=rel, max_param_diff=worst,
                frac_param_off=frac)


def main():
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device — the port's smoke needs the card",
              file=sys.stderr)
        return 2
    if sys.argv[1:2] == ["--tp2-rank"]:
        # one rank of phase 3d's TP-2 arm, started by ``tp2_spawn``
        return tp2_rank(torch, int(sys.argv[2]), sys.argv[3])
    from paddle_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    card = card_line()
    name = torch.cuda.get_device_name(0)
    print(f"card: {card} (torch {torch.__version__}, CUDA "
          f"{torch.version.cuda})", flush=True)
    t0 = time.perf_counter()
    built = _build.build()
    print(f"build: {time.perf_counter() - t0:.1f} s wall, per source "
          + ", ".join(f"{k} {v:.1f} s" for k, v in built.items()),
          flush=True)
    for src in _build.SOURCES:
        for line in _build.ptxas_report(src).splitlines():
            if any(w in line for w in ("registers", "spill", "warning",
                                       "Performance Loss")):
                print(f"ptxas {src}: {line.strip()}", flush=True)
    wg_ptxas = {}
    for src in ("flash_attention_fwd", "flash_attention_bwd"):
        wg_ptxas.update(wgmma_ptxas(_build.ptxas_report(src)))
    for inst, line in wg_ptxas.items():
        print(f"ptxas wgmma instance {inst}: {line}", flush=True)

    t = time.perf_counter()
    kern = phase_kernels(torch, dev)
    print(f"phase kernels: {time.perf_counter() - t:.1f} s", flush=True)
    t = time.perf_counter()
    serving = phase_serving(torch, dev)
    print(f"phase serving: {time.perf_counter() - t:.1f} s", flush=True)
    t = time.perf_counter()
    spec = phase_spec(torch, dev)
    print(f"phase spec: {time.perf_counter() - t:.1f} s", flush=True)
    t = time.perf_counter()
    phase_reliability(torch, dev)
    print(f"phase reliability: {time.perf_counter() - t:.1f} s", flush=True)
    t = time.perf_counter()
    tp = phase_tp(torch, dev, card)
    print(f"phase tensor parallelism: {time.perf_counter() - t:.1f} s",
          flush=True)
    t = time.perf_counter()
    obs = phase_observability(torch, dev)
    print(f"phase observability: {time.perf_counter() - t:.1f} s",
          flush=True)
    t = time.perf_counter()
    phase_parity(torch, dev)
    print(f"phase parity: {time.perf_counter() - t:.1f} s", flush=True)
    t = time.perf_counter()
    tk = phase_train_kernels(torch, dev)
    print(f"phase train kernels: {time.perf_counter() - t:.1f} s", flush=True)
    t = time.perf_counter()
    sk = phase_seg_kernels(torch, dev)
    print(f"phase segmented kernels: {time.perf_counter() - t:.1f} s",
          flush=True)
    t = time.perf_counter()
    rk10 = phase_rope_kernels(torch, dev)
    print(f"phase rope kernels: {time.perf_counter() - t:.1f} s", flush=True)
    t = time.perf_counter()
    train_plain, train_launches = phase_train(torch, dev)
    print(f"phase train: {time.perf_counter() - t:.1f} s", flush=True)
    t = time.perf_counter()
    knobs = phase_train_knobs(torch, dev, train_plain)
    print(f"phase train knobs: {time.perf_counter() - t:.1f} s", flush=True)
    t = time.perf_counter()
    phase_train_parity(torch, dev)
    print(f"phase train parity: {time.perf_counter() - t:.1f} s", flush=True)
    t = time.perf_counter()
    bert = phase_bert(torch, dev)
    print(f"phase bert: {time.perf_counter() - t:.1f} s", flush=True)
    t = time.perf_counter()
    phase_bert_parity(torch, dev)
    print(f"phase bert parity: {time.perf_counter() - t:.1f} s", flush=True)

    bf16, kv8 = serving["bf16"]["launches"], serving["kv8"]["launches"]
    csrc = "paddle_tpu_torch/ops/csrc"
    # the spec arms' launches (K8 by width), bf16-KV arms on the bf16
    # rows, the int8-KV arm on the int8 rows
    spec_bf16, spec_kv8 = {}, {}
    for tag, r in spec.items():
        (spec_kv8 if "kv8" in tag else spec_bf16)[tag] = {
            "k8_by_t": r["launches"]["k8_by_t"], "k9": r["launches"]["k9"]}
    kernels = [
        dict(name="paged_decode_attention", route="cuda",
             source=f"{csrc}/paged_decode_attention.cu",
             replaces="paddle_tpu/ops/paged_attention_pallas.py:259",
             launches=bf16["k8"], **kern["paged_decode_attention"],
             us_per_decode_step=serving["bf16"]["k8_us_per_decode_step"],
             spec_launches=spec_bf16, tp2=tp2_entry(tp, "k8")),
        dict(name="paged_decode_attention_range", route="cuda",
             source=f"{csrc}/paged_decode_attention.cu",
             replaces="paddle_tpu/ops/paged_attention_pallas.py:259",
             branch="hidden key range (the tree verify's branch row)",
             launches=spec["dm_self_tree"]["launches"]["k8_hidden"],
             **kern["paged_decode_attention_range"]),
        dict(name="paged_decode_attention_prefill", route="cuda",
             source=f"{csrc}/paged_decode_attention.cu",
             replaces="paddle_tpu/ops/paged_attention_pallas.py:259",
             branch="T = the prompt bucket (monolithic prefill over a "
                    "[1, bucket] cache)",
             launches=obs["monolithic"]["launches"],
             launches_by_t=obs["monolithic"]["bf16_launches_by_t"],
             **obs["monolithic"]["k8"][str(MONO_TIMED[-1])]["bf16"],
             by_t=obs["monolithic"]["k8"]),
        dict(name="prefill_attention", route="cuda",
             source=f"{csrc}/prefill_attention.cu",
             replaces="paddle_tpu/ops/prefill_attention_pallas.py:418",
             launches=bf16["k9"], launches_mma=bf16["k9_mma"],
             **kern["prefill_attention"], tp2=tp2_entry(tp, "k9")),
        dict(name="paged_decode_attention_int8", route="cuda",
             source=f"{csrc}/paged_decode_attention.cu",
             replaces="paddle_tpu/ops/paged_attention_pallas.py:259",
             launches=kv8["k8"], **kern["paged_decode_attention_int8"],
             us_per_decode_step=serving["kv8"]["k8_us_per_decode_step"],
             spec_launches=spec_kv8),
        dict(name="prefill_attention_int8", route="cuda",
             source=f"{csrc}/prefill_attention.cu",
             replaces="paddle_tpu/ops/prefill_attention_pallas.py:418",
             launches=kv8["k9"], launches_mma=kv8["k9_mma"],
             **kern["prefill_attention_int8"]),
        dict(name="fused_adamw_q8", route="cuda",
             source=f"{csrc}/fused_adamw.cu",
             replaces="paddle_tpu/ops/fused_adamw.py:169",
             also_replaces="paddle_tpu/ops/fused_adamw.py:211",
             launches=train_launches["adamw"],
             launches_knobs=knobs["knobs"]["launches"]["adamw"],
             **tk["adamw"]),
    ]
    fa = "paddle_tpu/ops/flash_attention.py"
    unmasked = bert["unmasked"][1]

    def wgmma(key, SEG, ROPE):
        """The wgmma instances of a forward, dK/dV or dQ entry and their
        ptxas lines (registers, shared memory, spills)."""
        kern = f"{key}_kernel"
        ds = (128,) if ROPE else (64, 128)
        insts = [f"{kern}<D={d}, SEG={SEG}, ROPE={ROPE}>" for d in ds]
        return dict(kernel=[f"ptf::wg::{i}" for i in insts],
                    ptxas={i: wg_ptxas.get(i) for i in insts})
    for kname, key, src, replaces, also in (
            ("flash_attention_fwd", "fwd", "flash_attention_fwd.cu",
             f"{fa}:653", f"{fa}:571"),
            ("flash_attention_delta", "delta", "flash_attention_bwd.cu",
             f"{fa}:714", None),
            ("flash_attention_bwd_dkv", "dkv", "flash_attention_bwd.cu",
             f"{fa}:1131", None),
            ("flash_attention_bwd_dq", "dq", "flash_attention_bwd.cu",
             f"{fa}:1242", f"{fa}:1175"),
            ("fused_rope", "rope", "fused_rope.cu",
             "paddle_tpu/ops/fused_rope.py:84", None)):
        entry = dict(name=kname, route="cuda",
                     source=f"paddle_tpu_torch/ops/csrc/{src}",
                     replaces=replaces, launches=train_launches[key],
                     launches_knobs=knobs["knobs"]["launches"][key],
                     launches_amp_o1=knobs["amp_o1"]["launches"][key],
                     **tk[key])
        if key in ("fwd", "dkv", "dq"):
            entry.update(wgmma(key, SEG=0, ROPE=0),
                         launches_wgmma=train_launches[key + "_wgmma"])
        if key == "rope":
            entry["launches_vec"] = train_launches["rope_vec"]
        if key in sk["unsegmented"]:
            # also held at the BERT shape (and K3 on the segmented runs'
            # outputs); the unmasked BERT run launches them too
            entry["max_abs_err"] = max(
                entry["max_abs_err"], sk["unsegmented"][key],
                sk["delta_err"] if key == "delta" else 0.0)
            entry["bert_unmasked_launches"] = unmasked[key]
            if key != "delta":
                entry["bert_unmasked_launches_wgmma"] = \
                    unmasked[key + "_wgmma"]
                entry["bert"] = {f: sk["bert"][key][f] for f in (
                    "unsegmented_ms", "unsegmented_bound_ms",
                    "unsegmented_bound_by")}
                entry["bert"]["library_ms"] = \
                    sk["bert"][key].get("unsegmented_library_ms")
        if also:
            entry["also_replaces"] = also
        kernels.append(entry)
    padded = bert["padded"][1]
    for kname, key, src, replaces, also in (
            ("flash_attention_fwd_segmented", "fwd", "flash_attention_fwd.cu",
             f"{fa}:653", f"{fa}:571"),
            ("flash_attention_bwd_dkv_segmented", "dkv",
             "flash_attention_bwd.cu", f"{fa}:1131", None),
            ("flash_attention_bwd_dq_segmented", "dq",
             "flash_attention_bwd.cu", f"{fa}:1242", f"{fa}:1175")):
        entry = dict(name=kname, route="cuda",
                     source=f"paddle_tpu_torch/ops/csrc/{src}",
                     replaces=replaces, launches=padded[key + "_seg"],
                     **{f: v for f, v in sk["bert"][key].items()
                        if not f.startswith("unsegmented")})
        entry.update(wgmma(key, SEG=1, ROPE=0),
                     launches_wgmma=padded[key + "_seg_wgmma"])
        entry["max_abs_err"] = max(sk["bert"][key]["max_abs_err"],
                                   sk["varlen"][key]["max_abs_err"])
        entry["varlen"] = {f: sk["varlen"][key][f] for f in (
            "ms", "plain_ms", "bound_ms", "library_ms")}
        if also:
            entry["also_replaces"] = also
        kernels.append(entry)
    for kname, key, src, line in (
            ("flash_attention_fwd_rope", "fwd", "flash_attention_fwd.cu",
             653),
            ("flash_attention_bwd_dkv_rope", "dkv", "flash_attention_bwd.cu",
             1131),
            ("flash_attention_bwd_dq_rope", "dq", "flash_attention_bwd.cu",
             1242)):
        entry = dict(name=kname, route="cuda",
                     source=f"paddle_tpu_torch/ops/csrc/{src}",
                     replaces=f"{fa}:{line}", branch="rope=True",
                     via=f"{fa}:1370", **rk10[key])
        entry.update(wgmma(key, SEG=0, ROPE=1),
                     launches_wgmma=rk10[key]["launches_wgmma"])
        kernels.append(entry)
    for k in kernels:
        k.pop("max_ulps", None)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
