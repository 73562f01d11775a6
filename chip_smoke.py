#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``paddle_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero before the result line):

1. Card: name and power limit (``nvidia-smi``); build the hand-written
   kernels from ``paddle_tpu_torch/ops/csrc`` with ``nvcc`` (sm_90a).
2. Kernels against their plain PyTorch versions on the card, at the
   serving path's shapes: K8 paged decode attention (B 8, Hkv 4, G 4,
   D 128, C 256, lmax 2048, bf16 pool; dense and paged, T 1 and 4, mixed
   lengths with a parked slot, a shuffled table with sentinels;
   ``atol=rtol=1e-4`` on the f32 output) and K9 fused prefill (T 256,
   offsets 0/256/768/1792, dense and paged, a sentinel destination;
   output within 2 bf16 ulps, the cache BITWISE equal after the append).
   Each kernel's time (CUDA events, after warm-up, rotating over four
   layers' caches so the 50 MB L2 does not hold them), its plain
   version's, one PyTorch library call's (scaled_dot_product_attention on
   a dense cache, a yardstick the port never calls) and its bound.
3. Serving at full width: the serving bench model (vocab 32000, hidden
   2048, 16 layers, 16 heads, 4 KV heads, bf16, random weights from a
   seed) behind ``ServingEngine(batch_size=8, max_len=2048,
   kv_block=prefill_chunk=decode_chunk=256)``, 16 requests of 64-1024
   prompt and 64-256 output tokens, two sharing a 768-token prefix.  The
   kernels' launch counters are set to 0 just before and read just after;
   the plain versions must not run.
4. End-to-end parity: the same engine at full width, 2 layers, f32, on
   the card (kernels) and on the CPU (plain versions).
5. The training path's kernels against their plain versions at the
   training shape (B 16, L 2048, H 16, Hkv 4, D 128, bf16, causal): K1/K2
   forward (out, lse), K3 delta, K4 dK/dV, K5 dQ, K6 RoPE (forward and
   inverse, bitwise); the forward, delta and dQ again at the long-context
   shape (B 1, L 16384), the flash kernels once at head_dim 64.  Each
   kernel's time, its plain version's, its bound and the library
   yardstick (scaled_dot_product_attention forward; its backward stands
   for K3+K4+K5 together).  The loss chunk's bf16 logits GEMM with an f32
   result (the card's branch of ``ops/chunked_ce.py``) against the
   widened f32 GEMM at the training chunk (8192 x 2048 x 32000): loss
   and gradients.
6. Training at full width: the ``bench_llama`` configuration (the
   serving model's widths, recompute of the first 7 layers, loss chunks
   of 8192 tokens) with AdamW and f32 moments, batch 16, seq 2048,
   random weights and data from seed 0: 2 warm-up and 5 timed steps;
   the loss must be finite and fall; every training kernel must launch
   exactly as often as the model calls it (counters set to 0 just before
   the timed steps), and no plain version or dense attention may run.
   Prints tokens/s, step ms, MFU (``bench.py``'s FLOP count over the
   dense bf16 peak), peak memory, and a profiled step's device-busy
   share and top device operations.
7. Training parity: the same trainer at full width, 2 layers, f32,
   batch 2, seq 256, 3 steps, on the card (kernels) and on the CPU
   (plain versions).  f32 takes the CUDA-core templates of the flash
   kernels; the bf16 tensor-core ones are held to their plain versions
   one kernel at a time (phase 5).

The last lines are the ``kernels`` JSON, the card line and the result
JSON ``{"ok": true, "device": {...}}``.
"""
import json
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

    # ---- K8: dense and paged, T = 1 and T = 4
    err8 = 0.0
    for paged in (False, True):
        for t in (1, 4):
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
    # time the main-path shape: paged, T = 1
    qg = rnd(B, HKV, G, 1, D)
    ms8 = time_ms(torch, lambda i: k8.paged_decode_attention(
        qg, *pools[i % ROT], lengths, scale, C, tbl, impl="cuda"), 200)
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
    rows = [int(x) + 1 for x in lens[:-1]]
    kv_bytes = sum(rows) * HKV * D * 2 * 2
    io_bytes = 2 * B * HKV * G * D * 4 + tbl.numel() * 4 + B * 4
    flops = sum(4 * HKV * G * D * r for r in rows)
    b_ms, b_by = bound(kv_bytes + io_bytes, flops)
    res["paged_decode_attention"] = dict(
        max_abs_err=err8, ms=ms8, plain_ms=plain8, bound_ms=b_ms,
        bound_by=b_by, library_ms=lib8)

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
            o1, _, _ = k9.prefill_attention(q, kn, vn, kc, vc, slot, off,
                                            scale, C, tr, impl="cuda")
            o2, _, _ = k9.prefill_attention_reference(
                q, kn, vn, k2, v2, slot, off, scale, C, tr)
            torch.cuda.synchronize()
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
        max_abs_err=err9, ms=ms9, plain_ms=plain9, bound_ms=b_ms,
        bound_by=b_by, library_ms=lib9, max_ulps=ulp9)
    for name, r in res.items():
        print(f"{name}: {r['ms'] * 1e3:.1f} us/launch, plain "
              f"{r['plain_ms'] * 1e3:.1f} us, library "
              f"{r['library_ms'] * 1e3:.1f} us, bound "
              f"{r['bound_ms'] * 1e3:.2f} us ({r['bound_by']})", flush=True)
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


def phase_serving(torch, dev):
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.observability import MetricsRegistry
    from paddle_tpu_torch.ops import paged_attention_cuda as k8
    from paddle_tpu_torch.ops import prefill_attention_cuda as k9
    from paddle_tpu_torch.serving import Request, ServingEngine

    model = LlamaForCausalLM(LlamaConfig(**SERVE_CFG), device=dev, seed=0)
    # warm-up engine (cuBLAS handles, allocator) on a separate registry
    warm = ServingEngine(model, **ENGINE, registry=MetricsRegistry())
    warm.submit(Request(np.arange(300) % SERVE_CFG["vocab_size"], 8))
    warm.run()
    prompts, olens = serving_workload()
    reg = MetricsRegistry()
    eng = ServingEngine(model, **ENGINE, registry=reg)
    k8.launches = k9.launches = k8.plain_runs = k9.plain_runs = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reqs = [eng.submit(Request(p, o)) for p, o in zip(prompts, olens)]
    eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(k8=k8.launches, k9=k9.launches, k8_plain=k8.plain_runs,
                  k9_plain=k9.plain_runs)
    for r, o in zip(reqs, olens):
        check(r.status == "done" and len(r.output_ids) == o,
              f"request {r.rid} finished {r.status} with "
              f"{len(r.output_ids)}/{o} tokens")
    check(counts["k8"] > 0 and counts["k9"] > 0,
          f"a kernel did not run on the main path: {counts}")
    check(counts["k8_plain"] == 0 and counts["k9_plain"] == 0,
          f"a plain version ran on the card: {counts}")
    st = eng.stats()
    check(st["prefix_reuse_tokens"] > 0, f"no prefix reuse: {st}")
    lbl = dict(policy="continuous")
    ttft = reg.get("serving_ttft_seconds").labels(**lbl)
    tpot = reg.get("serving_tpot_seconds").labels(**lbl)
    steps = int(reg.get("serving_steps_total").labels(**lbl).value)
    chunks = int(reg.get("serving_prefill_chunks_total").labels(**lbl).value)
    n_tok = sum(olens)
    out = dict(requests=len(reqs), tokens=n_tok, wall_s=wall,
               tok_per_s=n_tok / wall, ttft_p50_s=ttft.percentile(50),
               ttft_p95_s=ttft.percentile(95), tpot_p50_s=tpot.percentile(50),
               tpot_p95_s=tpot.percentile(95), steps=steps,
               prefill_chunks=chunks, prompt_tokens=st["prompt_tokens"],
               prefix_reuse_tokens=st["prefix_reuse_tokens"],
               launches=counts)
    exact = {f"{k}_p{q}_s": float(np.percentile(v, q))
             for k, v in (("ttft", [r.ttft for r in reqs]),
                          ("tpot", [r.tpot for r in reqs]))
             for q in (50, 95)}
    out["exact"] = exact
    print("serving " + json.dumps(out), flush=True)
    profile_decode(torch, model, prompts)
    del model, eng, warm
    torch.cuda.empty_cache()
    return out


def profile_decode(torch, model, prompts, n_steps=20):
    """Where a steady decode step's time goes: ``n_steps`` scheduler
    steps of 8 live slots (prefills done first) timed without the
    profiler, then ``n_steps`` more under ``torch.profiler``: device time
    by kernel (device-side events only) and its share of the unprofiled
    wall (the device-busy share)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from paddle_tpu_torch.observability import MetricsRegistry
    from paddle_tpu_torch.serving import Request, ServingEngine

    eng = ServingEngine(model, **ENGINE, registry=MetricsRegistry())
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
        print("profile: the profiler recorded no device time (not "
              "measured)", flush=True)
        return
    print(f"profile decode window: {n_steps} steps, wall "
          f"{wall_us / n_steps:.1f} us/step unprofiled, device "
          f"{total / n_steps:.1f} us/step, device busy "
          f"{total / wall_us:.3f}", flush=True)
    for us, key, count in rows[:10]:
        print(f"profile: {us / n_steps:9.1f} us/step {count / n_steps:6.1f} "
              f"launches/step  {key[:80]}", flush=True)


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

    def serve(model):
        eng = ServingEngine(model, **ENGINE)
        reqs = [eng.submit(Request(p, new)) for p in prompts]
        eng.run()
        return [list(r.output_ids) for r in reqs]

    out_g, out_c = serve(gpu), serve(cpu)

    @torch.no_grad()
    def cpu_margin(prompt, prefix):
        params, pcfg = ld._decode_params_of(cpu, 2048)
        toks = torch.from_numpy(
            np.concatenate([prompt, np.asarray(prefix, np.int64)])[None])
        caches = [init_kv_cache(1, 2048, pcfg[1], pcfg[2], "float32",
                                "cpu") for _ in range(2)]
        logits, _, _ = ld._forward(params, pcfg, toks, caches,
                                   torch.zeros((1,), dtype=torch.int32),
                                   last_only=True)
        top = torch.topk(logits[0], 2).values
        return float(top[0] - top[1])

    match = total = 0
    for i, (a, b) in enumerate(zip(out_g, out_c)):
        for j, (x, y) in enumerate(zip(a, b)):
            total += 1
            if x == y:
                match += 1
                continue
            margin = cpu_margin(prompts[i], b[:j])
            print(f"parity: request {i} diverges at token {j} "
                  f"(card {x}, cpu {y}); cpu top-2 margin {margin:.3e}",
                  flush=True)
            check(margin < 1e-3, f"request {i} diverges at token {j} with "
                                 f"a top-2 margin of {margin:.3e} >= 1e-3")
            break
    rate = match / max(total, 1)
    print(f"parity: token match rate {match}/{total} = {rate:.4f}",
          flush=True)
    return dict(match=match, total=total, logits_max_abs_diff=float(dl.max()))


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
        dq = kfa.flash_bwd_dq(q, k, v, do, lse, delta, H, HKV, True, sc)
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
    lib = dict(fwd=lib_fwd, delta=None, dkv=lib_bwd, dq=None, rope=None)
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
    res["dkv"]["library_covers"] = "K3+K4+K5 (SDPA backward)"
    del q, k, v, do, out, lse, delta
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
    from paddle_tpu_torch.ops import fused_rope as trope
    from paddle_tpu_torch.ops import fused_rope_cuda as k6

    def read():
        return dict(fwd=kfa.launches["fwd"], delta=kfa.launches["delta"],
                    dkv=kfa.launches["dkv"], dq=kfa.launches["dq"],
                    rope=k6.launches, plain_flash=sum(tfa.plain_runs.values()),
                    plain_rope=trope.plain_runs, dense_sdpa=attn.dense_runs)

    def zero():
        for key in kfa.launches:
            kfa.launches[key] = 0
        for key in tfa.plain_runs:
            tfa.plain_runs[key] = 0
        k6.launches = trope.plain_runs = attn.dense_runs = 0
    return read, zero


def phase_train(torch, dev, n_warm=2, n_steps=5):
    """The bench_llama training step (f32 moments) at full width."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.static import build_train_step

    cfg = LlamaConfig(**TRAIN_CFG)
    model = LlamaForCausalLM(cfg, device=dev, seed=0)
    n_params = sum(p.numel() for p in model.parameters())
    opt = AdamW(learning_rate=1e-4, parameters=model.parameters(),
                weight_decay=0.01, moment_dtype=None)
    step = build_train_step(model, None, opt)
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
    want = dict(fwd=(L + rl) * n, delta=L * n, dkv=L * n, dq=L * n,
                rope=(L + rl + L) * n, plain_flash=0, plain_rope=0,
                dense_sdpa=0)
    print(f"train launches over {n} steps: {counts}", flush=True)
    check(counts == want, f"kernel launches {counts}, expected {want}")
    tok_s = TRAIN_BATCH * TRAIN_SEQ / dt
    flops_tok = 6 * n_params + 6 * L * cfg.hidden_size * TRAIN_SEQ
    mfu = flops_tok * tok_s / H100_BF16_FLOPS
    out = dict(params=n_params, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
               step_ms=dt * 1e3, tokens_per_s=tok_s, mfu=mfu,
               peak_mem_gb=peak_gb, losses=losses,
               launches_per_step={k: v / n for k, v in counts.items()})
    print("train " + json.dumps(out), flush=True)

    # one profiled step: device time by kernel, device-busy share of the
    # unprofiled step's wall
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step(ids, labels)
        torch.cuda.synchronize()
    rows = sorted(((float(e.self_device_time_total), e.key, e.count)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and e.self_device_time_total > 0), reverse=True)
    total = sum(r[0] for r in rows)
    if not total:
        print("profile: the profiler recorded no device time (not "
              "measured)", flush=True)
    else:
        print(f"profile train step: wall {dt * 1e3:.1f} ms unprofiled, "
              f"device {total / 1e3:.1f} ms, device busy "
              f"{total / 1e3 / (dt * 1e3):.3f}", flush=True)
        for us, key, count in rows[:15]:
            print(f"profile: {us / 1e3:9.2f} ms {count:6d} launches  "
                  f"{key[:80]}", flush=True)
        out["device_busy"] = total / 1e3 / (dt * 1e3)
    del model, opt, step, timed
    torch.cuda.empty_cache()
    return out, counts


# ----------------------------------------------------------------- phase 7
def phase_train_parity(torch, dev, n_steps=3, lr=1e-4):
    """The same trainer at full width, 2 layers, f32, batch 2, seq 256, on
    the card (kernels) and on the CPU (plain versions), from the same
    weights and data.  Losses agree to 1e-4 relative.  Parameters: 99.99%
    of elements within 1e-5 + 1e-5·|p|, and every element within
    2.02·lr·steps: AdamW's first updates are ~lr·sign(g) (|m̂|/sqrt(v̂) is
    at most 1.004 at each of the first 3 steps), so an element whose gradient is near
    zero may move by up to that in opposite directions on the two
    devices; the decay terms differ by lr·wd times the parameters'
    difference only."""
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.static import build_train_step

    cfg = LlamaConfig(**{**TRAIN_CFG, "num_hidden_layers": 2,
                         "recompute_layers": 1, "dtype": "float32"})
    gpu = LlamaForCausalLM(cfg, device=dev, seed=2)
    cpu = LlamaForCausalLM(cfg, device="cpu", seed=2)
    cpu.load_numpy_state(gpu.numpy_state())
    rng = np.random.default_rng(3)
    ids = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 256)))
    labels = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 256)))
    read, zero = kernel_counters()
    steps = {}
    losses = {}
    for tag, model in (("card", gpu), ("cpu", cpu)):
        d = model.llama.embed_tokens.weight.device
        st = build_train_step(model, None, AdamW(
            learning_rate=lr, parameters=model.parameters(),
            weight_decay=0.01))
        zero()
        losses[tag] = [float(st(ids.to(d), labels.to(d)))
                       for _ in range(n_steps)]
        steps[tag] = read()
    print(f"parity train launches: {steps}", flush=True)
    check(steps["card"]["fwd"] > 0 and steps["card"]["plain_flash"] == 0,
          f"card run did not take the kernels: {steps['card']}")
    check(steps["cpu"]["fwd"] == 0 and steps["cpu"]["plain_flash"] > 0,
          f"cpu run did not take the plain versions: {steps['cpu']}")
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses["card"],
                                                    losses["cpu"]))
    print(f"parity train losses card {losses['card']} cpu {losses['cpu']} "
          f"max rel diff {rel:.3e}", flush=True)
    check(rel <= 1e-4, f"training losses differ card vs cpu: {rel:.3e}")
    pg, pc = gpu.numpy_state(), cpu.numpy_state()
    worst, n_off, n_all = 0.0, 0, 0
    for name in pc:
        diff = np.abs(pg[name] - pc[name])
        worst = max(worst, float(diff.max()))
        n_off += int((diff > 1e-5 + 1e-5 * np.abs(pc[name])).sum())
        n_all += diff.size
    frac = n_off / n_all
    print(f"parity train params after {n_steps} steps: max abs diff "
          f"{worst:.3e}, {n_off}/{n_all} ({frac:.2e}) beyond 1e-5",
          flush=True)
    check(frac <= 1e-4 and worst <= 2.02 * lr * n_steps,
          f"parameters differ card vs cpu (max {worst:.3e}, {frac:.2e})")
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
            if "registers" in line or "spill" in line:
                print(f"ptxas {src}: {line.strip()}", flush=True)

    t = time.perf_counter()
    kern = phase_kernels(torch, dev)
    print(f"phase kernels: {time.perf_counter() - t:.1f} s", flush=True)
    t = time.perf_counter()
    serving = phase_serving(torch, dev)
    print(f"phase serving: {time.perf_counter() - t:.1f} s", flush=True)
    t = time.perf_counter()
    phase_parity(torch, dev)
    print(f"phase parity: {time.perf_counter() - t:.1f} s", flush=True)
    t = time.perf_counter()
    tk = phase_train_kernels(torch, dev)
    print(f"phase train kernels: {time.perf_counter() - t:.1f} s", flush=True)
    t = time.perf_counter()
    _, train_launches = phase_train(torch, dev)
    print(f"phase train: {time.perf_counter() - t:.1f} s", flush=True)
    t = time.perf_counter()
    phase_train_parity(torch, dev)
    print(f"phase train parity: {time.perf_counter() - t:.1f} s", flush=True)

    launches = serving["launches"]
    kernels = [
        dict(name="paged_decode_attention", route="cuda",
             source="paddle_tpu_torch/ops/csrc/paged_decode_attention.cu",
             replaces="paddle_tpu/ops/paged_attention_pallas.py:259",
             launches=launches["k8"], **kern["paged_decode_attention"]),
        dict(name="prefill_attention", route="cuda",
             source="paddle_tpu_torch/ops/csrc/prefill_attention.cu",
             replaces="paddle_tpu/ops/prefill_attention_pallas.py:418",
             launches=launches["k9"], **kern["prefill_attention"]),
    ]
    fa = "paddle_tpu/ops/flash_attention.py"
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
                     **tk[key])
        if also:
            entry["also_replaces"] = also
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
