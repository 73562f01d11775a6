#!/usr/bin/env python3
"""Measurements behind the flash kernels' wgmma instances on one NVIDIA card.

    python3 flash_probe.py times [TREE]  # the forward, dK/dV, dQ as built
    python3 flash_probe.py sweep    # the same for each tile variant
    python3 flash_probe.py ablate   # the same with one step taken out
    python3 flash_probe.py steps [TREE]        # times, then the steps
    python3 flash_probe.py ab TREE_A TREE_B    # steps: A, B, B, A

``times`` gives µs a launch of the forward (K1), dK/dV (K4) and dQ (K5)
at ``chip_smoke.py``'s shapes — Llama (B 16, L 2048, H 16/4, D 128,
causal; phase 5, with K6 there too) and BERT (B 64, L 512, H 12, D 64, no
mask; phase 5b) — by CUDA events over back-to-back launches and by device
time from the profiler, beside SDPA's forward at the same shapes.
``sweep`` builds every entry of ``VARIANTS`` (keys a forward ring stage,
the forward's, dK/dV's and dQ's stage counts: ``-D`` flags of
``csrc/flash_attention_fwd.cu`` and ``csrc/flash_attention_bwd.cu``),
all builds at once, then times each in turn, twice over, on one card:
the sweep that chose the defaults in the sources.  The forward's and
dK/dV's variants keep dQ's default and dQ's keep theirs, so each
kernel's choice is swept on its own.  ``ablate`` times copies of the
sources with one step of a kernel taken out (``ABLATIONS``; their
results are wrong, only their time counts), built side by side under
``ops/_build/ablate``: what each step costs.  ``steps`` runs ``times``
and then ``chip_smoke.py``'s Llama training step (phase 6) and its two
BERT steps (phase 8) from TREE (a checkout of this repository, another
commit unpacked with ``git archive`` say; default this one); ``ab``
runs ``steps`` for two trees in turns, each in its own process, so two
versions' kernels and steps are compared on one card within one call.
bf16, inputs random from fixed seeds.  Exits non-zero without a CUDA
card.
"""
import os
import shutil
import subprocess
import sys
import threading

#: (PTF_FWD_KEYS, PTF_FWD_STAGES, PTF_DKV_STAGES, PTF_DQ_STAGES); the
#: first is the default; then the forward's and dK/dV's variants, then
#: dQ's
MACROS = ("PTF_FWD_KEYS", "PTF_FWD_STAGES", "PTF_DKV_STAGES",
          "PTF_DQ_STAGES")
VARIANTS = ((64, 4, 3, 3), (64, 2, 2, 3), (64, 3, 3, 3), (64, 4, 2, 3),
            (64, 4, 3, 4), (64, 4, 3, 2))
SHAPES = (("Llama", dict(B=16, L=2048, H=16, HKV=4, D=128), True),
          ("BERT", dict(B=64, L=512, H=12, HKV=12, D=64), False))


#: shared memory a block may use on the H100 (dynamic; the barriers are
#: static, a few dozen bytes more)
SMEM_LIMIT = 232448 - 256


def smem_bytes(variant, d=128):
    """Dynamic shared memory of the forward, the dK/dV and the dQ blocks
    at head dim ``d`` under ``variant`` (the sources' FwdSmem, DkvSmem and
    DqSmem: 1024 bytes of alignment slack; a forward block's 128 q rows,
    and a stage's K and V tiles with their int32 segment ids; a dK/dV
    block's 64 keys of K and V, and a stage's q and dO tiles of 64 rows,
    the f32 p tile and the rows' lse, delta and segment ids, 1024-byte
    aligned; a dQ block's 128 rows of q and of dO and each consumer
    warpgroup's [64][64] bf16 dS tile, and a stage's 64-key K and V tiles
    with their segment ids)."""
    keys, fwd_stages, dkv_stages, dq_stages = variant
    fwd = 1024 + 128 * d * 2 + fwd_stages * (2 * keys * d * 2 + keys * 4)
    stage = -(-(2 * 64 * d * 2 + 64 * 64 * 4 + 3 * 64 * 4) // 1024)
    dkv = 1024 + 2 * 64 * d * 2 + dkv_stages * stage * 1024
    dq = 1024 + 2 * 128 * d * 2 + 2 * 64 * 64 * 2 \
        + dq_stages * (2 * 64 * d * 2 + 64 * 4)
    return fwd, dkv, dq


#: (name, source, text, replacement): one step of a kernel taken out
ABLATIONS = (
    ("K4 without its p/ds step", "flash_attention_bwd.cu",
     "      hop::fence_regs(x);\n      if (pside) {",
     "      hop::fence_regs(x);\n      if (pside) {\n"
     "        hop::mbar_arrive(&pready[s]);\n        return;\n      }\n"
     "      hop::mbar_wait(&pready[s], (t / S) & 1);\n      return;\n"
     "      if (pside) {"),
    ("K4 without its gradient products", "flash_attention_bwd.cu",
     "        hop::rs<D>(acc, af[kk], hop::desc_at(dt, kk * 2048), 1);",
     "        ;"),
    ("K4 without its score products", "flash_attention_bwd.cu",
     "      for (int kk = 0; kk < D / 16; ++kk)\n        hop::ss<BR>(",
     "      for (int kk = 0; kk < 0; ++kk)\n        hop::ss<BR>("),
    ("K1 without its softmax", "flash_attention_fwd.cu",
     "      hop::fence_regs(sc);\n      if (SEG",
     "      hop::fence_regs(sc);\n      c_lo = c_hi = 1.f;\n      return;\n"
     "      if (SEG"),
    ("K1 without its P.V", "flash_attention_fwd.cu",
     "        hop::rs<D>(o, pa[kk], hop::desc_at(dv, kk * 2048), 1);",
     "        ;"),
    ("K1 without its q.K^T", "flash_attention_fwd.cu",
     "      for (int kk = 0; kk < D / 16; ++kk)\n        hop::ss<BK>(",
     "      for (int kk = 0; kk < 0; ++kk)\n        hop::ss<BK>("),
    ("K5 without its p step (exp, masks)", "flash_attention_bwd.cu",
     "      hop::fence_regs(x);\n      if (!SEG && key0 + BK - 1 <= vis_min)",
     "      hop::fence_regs(x);\n      return;\n"
     "      if (!SEG && key0 + BK - 1 <= vis_min)"),
    ("K5 without its ds step", "flash_attention_bwd.cu",
     "      hop::fence_regs(dp);\n#pragma unroll",
     "      hop::fence_regs(dp);\n      return;\n#pragma unroll"),
    ("K5 without its dq product", "flash_attention_bwd.cu",
     "      for (int kk = 0; kk < BK / 16; ++kk)\n        hop::ss<D, 1>(",
     "      for (int kk = 0; kk < 0; ++kk)\n        hop::ss<D, 1>("),
    ("K5 without its score products (s and dp)", "flash_attention_bwd.cu",
     "      for (int kk = 0; kk < D / 16; ++kk)\n        hop::ss<BK>(",
     "      for (int kk = 0; kk < 0; ++kk)\n        hop::ss<BK>("),
)


def defines(variant):
    return tuple(f"-D{m}={x}" for m, x in zip(MACROS, variant))


def times(torch, dev, tag=""):
    """µs a launch of K1, K4 and K5 at both shapes and of K6 at the Llama
    shape (events, device time), and SDPA's forward; returns {(shape,
    kernel): device µs}."""
    import chip_smoke as cs
    from paddle_tpu_torch.ops import flash_attention_cuda as kfa
    from paddle_tpu_torch.ops import fused_rope_cuda as k6

    gen = torch.Generator(device=dev)
    gen.manual_seed(97)
    res = {}
    for name, cfg, causal in SHAPES:
        B, L, H, HKV, D = (cfg[k] for k in ("B", "L", "H", "HKV", "D"))
        q, k, v, do = cs.flash_case(torch, dev, gen, B, L, H, HKV, D)
        sc = D ** -0.5
        out, lse = kfa.flash_fwd(q, k, v, H, HKV, causal, sc)
        delta = kfa.flash_delta(do, out, H)
        calls = dict(
            fwd=(lambda i: kfa.flash_fwd(q, k, v, H, HKV, causal, sc),
                 "fwd_kernel"),
            dkv=(lambda i: kfa.flash_bwd_dkv(q, k, v, do, lse, delta, H, HKV,
                                             causal, sc), "dkv_kernel"),
            dq=(lambda i: kfa.flash_bwd_dq(q, k, v, do, lse, delta, H, HKV,
                                           causal, sc), "dq_kernel"))
        if causal:
            ang = torch.rand(L, D, generator=gen, device=dev) * 6.0
            cos, sin = (x.to(torch.bfloat16) for x in (ang.cos(), ang.sin()))
            calls["rope"] = (lambda i: k6.rope(q, k, cos, sin, H, HKV),
                             "rope_kernel")
        for kern, (fn, key) in calls.items():
            ev = cs.time_ms(torch, fn, 10)
            dv = cs.device_ms(torch, fn, key, 10)
            res[(name, kern)] = dv
            print(f"{tag}{name} {kern}: {ev * 1e3:.1f} us/launch (events), "
                  f"device {dv * 1e3 if dv else float('nan'):.1f} us",
                  flush=True)
        q4, k4, v4 = (x.view(B, L, -1, D).transpose(1, 2) for x in (q, k, v))
        lib = cs.time_ms(torch, lambda i: cs.sdpa(torch, q4, k4, v4, None)
                         if not causal else
                         torch.nn.functional.scaled_dot_product_attention(
                             q4, k4, v4, is_causal=True, enable_gqa=True), 10)
        print(f"{tag}{name} SDPA forward: {lib * 1e3:.1f} us", flush=True)
        del q, k, v, do, out, lse, delta
        torch.cuda.empty_cache()
    return res


def sweep(torch, dev):
    from paddle_tpu_torch.ops import _build

    names = ("flash_attention_fwd", "flash_attention_bwd")
    errors = {}

    def one(v):
        try:
            _build.build(names, defines(v))
        except RuntimeError as e:        # a variant that does not fit
            errors[v] = str(e)[-2000:]
    threads = [threading.Thread(target=one, args=(v,)) for v in VARIANTS]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for v, e in errors.items():
        print(f"variant {v} did not build:\n{e}", flush=True)
    table = {}
    for rep in range(2):
        for v in VARIANTS:
            if v in errors:
                continue
            _build.DEFINES = defines(v)
            _build._libs.clear()
            got = times(torch, dev, f"keys {v[0]}, stages {v[1]}/{v[2]}/"
                        f"{v[3]}: ")
            for key, us in got.items():
                table.setdefault((v, key), []).append(us)
    _build.DEFINES = ()
    _build._libs.clear()
    print("variant (keys, fwd/dkv/dq stages) | shape kernel | "
          "device us, both passes", flush=True)
    for (v, (shape, kern)), us in table.items():
        print(f"{v} | {shape} {kern} | " + ", ".join(
            f"{x * 1e3:.1f}" if x else "nan" for x in us), flush=True)


def ablate(torch, dev):
    """``times`` for each entry of ``ABLATIONS``, each in its own copy of
    the package (its libraries built in parallel first), after the
    package as it is."""
    from paddle_tpu_torch.ops import _build

    here = os.path.dirname(os.path.abspath(__file__))
    root = os.path.join(_build.BUILD_DIR, "ablate")
    shutil.rmtree(root, ignore_errors=True)
    trees = []
    for i, (name, src, text, repl) in enumerate((("as it is", None, "",
                                                  ""),) + ABLATIONS):
        tree = os.path.join(root, str(i))
        shutil.copytree(os.path.join(here, "paddle_tpu_torch"),
                        os.path.join(tree, "paddle_tpu_torch"),
                        ignore=shutil.ignore_patterns("_build"))
        for f in ("chip_smoke.py", "flash_probe.py"):
            shutil.copy(os.path.join(here, f), tree)
        if src:
            path = os.path.join(tree, "paddle_tpu_torch", "ops", "csrc", src)
            with open(path) as fh:
                code = fh.read()
            if text not in code:
                raise RuntimeError(f"ablation {name!r}: its text is not in "
                                   f"{src} any more")
            with open(path, "w") as fh:
                fh.write(code.replace(text, repl, 1))
        trees.append((name, tree))
    builds = [subprocess.Popen(
        [sys.executable, "-c", "from paddle_tpu_torch.ops import _build; "
         "_build.build(('flash_attention_fwd', 'flash_attention_bwd', "
         "'fused_rope'))"],
        cwd=tree) for _, tree in trees]
    if any(b.wait() for b in builds):
        raise RuntimeError("an ablation did not build")
    for name, tree in trees:
        r = subprocess.run([sys.executable, "flash_probe.py", "times"],
                           cwd=tree, capture_output=True, text=True)
        for line in r.stdout.splitlines():
            if "us" in line:
                print(f"{name}: {line}", flush=True)
    shutil.rmtree(root, ignore_errors=True)


def steps(torch, dev):
    """The kernels' times, then the Llama step (ms, and its device time)
    and the two BERT steps."""
    import chip_smoke as cs

    times(torch, dev)
    llama, _ = cs.phase_train(torch, dev)
    bert = cs.phase_bert(torch, dev)
    print(f"steps: Llama {llama['step_ms']:.2f} ms; BERT unmasked "
          f"{bert['unmasked'][0]['step_ms']:.2f}, padded "
          f"{bert['padded'][0]['step_ms']:.2f} ms", flush=True)


def ab(tree_a, tree_b):
    """``steps`` for A, B, B, A, each in its own process; prints the lines
    that carry the numbers."""
    keep = ("steps:", "profile train step: wall", "profile bert")
    rc = 0
    for tree in (tree_a, tree_b, tree_b, tree_a):
        r = subprocess.run([sys.executable, os.path.abspath(__file__),
                            "steps", tree], capture_output=True, text=True)
        rc |= r.returncode
        for line in r.stdout.splitlines():
            if line.startswith(keep) and ("wall" in line or "steps" in line) \
                    or "us/launch" in line:
                print(f"{tree}: {line}", flush=True)
        if r.returncode:
            print(f"{tree} failed:\n{r.stderr[-3000:]}", flush=True)
    return rc


def main(argv):
    if not argv or argv[0] not in ("times", "sweep", "ablate", "steps",
                                   "ab"):
        print(__doc__, file=sys.stderr)
        return 2
    if argv[0] == "ab":
        if len(argv) != 3:
            print(__doc__, file=sys.stderr)
            return 2
        return ab(*argv[1:3])
    if argv[0] in ("steps", "times") and len(argv) > 1:
        root = os.path.abspath(argv[1])       # import that tree's package
        sys.path.insert(0, root)
        os.chdir(root)
    import torch

    if not torch.cuda.is_available():
        print("flash_probe: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    import chip_smoke as cs
    print(f"card: {cs.card_line()}", flush=True)
    {"times": times, "sweep": sweep, "ablate": ablate,
     "steps": steps}[argv[0]](torch, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
