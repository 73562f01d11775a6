#!/usr/bin/env python3
"""Measurements behind the port's serving kernels (K8, K9) on one NVIDIA card.

    python3 serving_probe.py spans         # K8 device µs a launch by span size
    python3 serving_probe.py accuracy      # K9 against a float64 recomputation
    python3 serving_probe.py host [TREE]   # host µs a K8 wrapper call
    python3 serving_probe.py serve [TREE]  # chip_smoke's bf16 serving run
    python3 serving_probe.py ab TREE_A TREE_B   # host and serve: A, B, B, A

TREE is a checkout of this repository (another commit unpacked with
``git archive``, say); the default is the directory of this script.  ``ab``
runs each side in its own process, in turns, so two versions are compared
on one card within one call.  Shapes are ``chip_smoke.py`` phase 2's (B 8,
Hkv 4, G 4, D 128, pool blocks of 256, lmax 2048; K9 at T 256, offset
768), weights and data random from fixed seeds.  Exits non-zero without a
CUDA card.
"""
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))


def use_tree(tree):
    """Import ``paddle_tpu_torch`` and ``chip_smoke`` from ``tree``."""
    root = os.path.abspath(tree)
    sys.path.insert(0, root)
    os.chdir(root)


def phase2_inputs(torch, dev, seed=1234):
    """Phase 2's decode inputs: four layers' bf16 pools and their int8
    twins, the mixed lengths with a parked slot, the shuffled table."""
    from paddle_tpu_torch.ops.decode_attention import _q8_quantize

    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    b, hkv, g, d, c, w, n = 8, 4, 4, 128, 256, 8, 64
    pools = [tuple(torch.randn(n, c, hkv, d, generator=gen, device=dev)
                   .to(torch.bfloat16) for _ in range(2)) for _ in range(4)]
    q8 = [tuple(_q8_quantize(x) for x in p) for p in pools]
    lens = [0, 255, 256, 700, 1023, 1500, 2040, c * w]
    perm = torch.randperm(n, generator=gen, device=dev).tolist()
    table = torch.full((b, w), n, dtype=torch.int32)
    nxt = 0
    for i, length in enumerate(lens[:-1]):
        for j in range(-(-(length + 4) // c)):
            table[i, j] = perm[nxt]
            nxt += 1
    lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
    qg = torch.randn(b, hkv, g, 1, d, generator=gen, device=dev)
    return pools, q8, lengths, table.to(dev), qg


def spans(torch, dev):
    """K8's device time a launch (profiler) for spans of 256/128/64/32
    keys, bf16 and int8 KV, twice over."""
    import chip_smoke as cs
    from paddle_tpu_torch.ops import paged_attention_cuda as k8

    pools, q8, lengths, tbl, qg = phase2_inputs(torch, dev)
    default = k8._SPLIT
    for _ in range(2):
        for split in (256, 128, 64, 32):
            k8._SPLIT = split
            ms = [cs.device_ms(torch, lambda i: k8.paged_decode_attention(
                qg, *kv[i % 4], lengths, 128 ** -0.5, 256, tbl,
                impl="cuda"), "paged_decode_kernel") for kv in (pools, q8)]
            print(f"K8 spans of {split} keys: device {ms[0] * 1e3:.1f} us "
                  f"(bf16), {ms[1] * 1e3:.1f} us (int8)", flush=True)
    k8._SPLIT = default


def accuracy(torch, dev):
    """K9's tensor-core instance over chained chunks (dense cache, C 64)
    against the plain version and a float64 recomputation from the same
    caches: the largest error over sum(p|v|)/l, and the elements beyond 2
    bf16 ulps and 1e-6 of the plain version."""
    from chip_smoke import bf16_ulps
    from paddle_tpu_torch.ops import decode_attention as tda
    from paddle_tpu_torch.ops import prefill_attention_cuda as k9

    for kv, t, hkv, offs in (("bfloat16", 16, 2, (0, 16, 32, 48)),
                             ("bfloat16", 256, 4, (0, 256, 768)),
                             ("int8", 256, 4, (0, 256, 768))):
        gen = torch.Generator().manual_seed(5)
        g, d, c = 4, 128, 64
        kc, vc = tda.init_kv_cache(3, 2048, hkv, d, kv, device=dev)
        k2, v2 = ((tuple(y.clone() for y in x) if isinstance(x, tuple)
                   else x.clone()) for x in (kc, vc))
        for off in offs:
            q, kn, vn = (torch.randn(1, t, n, d, generator=gen).to(
                dev, torch.bfloat16) for n in (hkv * g, hkv, hkv))
            o1, _, _ = k9.prefill_attention(q, kn, vn, kc, vc, 1, off,
                                            d ** -0.5, c, impl="cuda")
            o2, _, _ = k9.prefill_attention_reference(
                q, kn, vn, k2, v2, 1, off, d ** -0.5, c)

            def rows(x):
                x = tuple(y[1, :off + t] for y in x) if isinstance(x, tuple) \
                    else x[1, :off + t]
                return tda._as_f32(x).double()
            kf, vf = rows(k2), rows(v2)
            qd = q[0].double().view(t, hkv, g, d)
            s = torch.einsum("tkgd,lkd->tkgl", qd, kf) * d ** -0.5
            pos = torch.arange(off + t, device=dev)
            live = pos[None, :] <= off + torch.arange(t, device=dev)[:, None]
            p = torch.softmax(s.masked_fill(~live[:, None, None], -1e300),
                              -1)
            ex = torch.einsum("tkgl,lkd->tkgd", p, vf).reshape(o1.shape)
            pv = torch.einsum("tkgl,lkd->tkgd", p, vf.abs()).reshape(
                o1.shape)
            torch.cuda.synchronize()
            rb = (ex.to(torch.bfloat16).double() - ex).abs()
            err = ((o1.double() - ex).abs() - rb).clamp(min=0) / pv
            bad = (bf16_ulps(o1, o2) > 2) \
                & ((o1.float() - o2.float()).abs() > 1e-6)
            print(f"K9 {kv} T {t} offset {off}: error over sum(p|v|)/l "
                  f"{float(err.nan_to_num().max()):.3e}; beyond 2 ulps and "
                  f"1e-6 of the plain version {int(bad.sum())} of "
                  f"{bad.numel()}", flush=True)


def host(torch, dev, calls=200):
    """Host µs a K8 wrapper call: ``calls`` calls queued behind ~1 s of
    device work, so the host never waits for the device."""
    from paddle_tpu_torch.ops import paged_attention_cuda as k8

    pools, _, lengths, tbl, qg = phase2_inputs(torch, dev)
    for rep in range(2):
        for i in range(3):
            k8.paged_decode_attention(qg, *pools[0], lengths, 128 ** -0.5,
                                      256, tbl, impl="cuda")
        torch.cuda.synchronize()
        torch.cuda._sleep(int(2e9))
        t0 = time.perf_counter()
        for i in range(calls):
            k8.paged_decode_attention(qg, *pools[i % 4], lengths,
                                      128 ** -0.5, 256, tbl, impl="cuda")
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        print(f"host {1e6 * (t1 - t0) / calls:.1f} us a K8 wrapper call",
              flush=True)


def serve(torch, dev):
    """``chip_smoke``'s bf16 serving run (phase 3's workload, warm-up
    engine first) and its profiled decode window."""
    import numpy as np

    import chip_smoke as cs
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.observability import MetricsRegistry
    from paddle_tpu_torch.serving import Request, ServingEngine

    model = LlamaForCausalLM(LlamaConfig(**cs.SERVE_CFG), device=dev, seed=0)
    warm = ServingEngine(model, **cs.ENGINE, registry=MetricsRegistry())
    warm.submit(Request(np.arange(300) % cs.SERVE_CFG["vocab_size"], 8))
    warm.run()
    del warm
    prompts, olens = cs.serving_workload()
    out, _ = cs.serve_run(torch, model, prompts, olens, "bf16", {})
    print(f"serve: {out['tok_per_s']:.1f} tok/s, TPOT p50 "
          f"{out['tpot_p50_s'] * 1e3:.2f} ms", flush=True)


def ab(tree_a, tree_b):
    """``host`` then ``serve`` for A, B, B, A, each in its own process;
    prints the lines that carry the numbers."""
    keep = ("host ", "serve:", "profile bf16 decode window")
    rc = 0
    for tree in (tree_a, tree_b, tree_b, tree_a):
        for what in ("host", "serve"):
            r = subprocess.run([sys.executable, os.path.join(HERE, __file__),
                                what, tree], capture_output=True, text=True)
            rc |= r.returncode
            for line in r.stdout.splitlines():
                if line.startswith(keep):
                    print(f"{tree}: {line}", flush=True)
            if r.returncode:
                print(f"{tree} {what} failed:\n{r.stderr[-3000:]}",
                      flush=True)
    return rc


def main(argv):
    if not argv or argv[0] not in ("spans", "accuracy", "host", "serve",
                                   "ab"):
        print(__doc__, file=sys.stderr)
        return 2
    if argv[0] == "ab":
        return ab(*argv[1:3])
    use_tree(argv[1] if len(argv) > 1 else HERE)
    import torch

    if not torch.cuda.is_available():
        print("serving_probe: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda:0")
    {"spans": spans, "accuracy": accuracy, "host": host,
     "serve": serve}[argv[0]](torch, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
