"""One rank of the port's tensor-parallel serving group
(tests/test_torch_serving_tp.py), and the case table both sides share.

    python tests/_torch_tp_worker.py RANK WORLD WORKDIR

Each rank joins a gloo group through a ``FileStore`` in WORKDIR (no
ports), builds a one-axis ``DeviceMesh`` ("mp") over it, loads the tiny
f32 Llama from ``WORKDIR/weights.npz`` and serves every case of
``CASES`` with ``ServingEngine(mesh=...)`` — SPMD: every rank submits the
same requests in the same order.  It writes ``WORKDIR/result_r{RANK}.json``:
each case's token streams, statuses and flight-recorder events (kind,
rid, slot, step; a fault injected on one rank only is left out), the
construction errors the engine raises under the mesh, and the local
shapes of the rank's shards.
Imports torch and the port only (never jax).  The test process runs the
same cases on one device with ``run_case(..., mesh=None)``.
"""
import datetime
import json
import os
import sys

import numpy as np

WORLD = 4
AXIS = "mp"

#: the reference matrix's geometry (tests/test_serving_tp.py:116-188):
#: batch 2, max_len 64; its "whole" cases prefill monolithically
#: (``prefill_chunk=None``)
SMALL = dict(batch_size=2, max_len=64, decode_chunk=16)
#: its paged cases (:189-198): batch 3, max_len 128, 16-token blocks
PAGED = dict(batch_size=3, max_len=128, decode_chunk=16, prefill_chunk=16,
             kv_block=16, max_live_tokens=3 * 128)


def workload(name):
    """``(prompts, max_new_tokens)`` of the reference's three TP
    workloads."""
    if name == "matrix":
        rng = np.random.default_rng(7)
        return ([rng.integers(0, 256, (p,)) for p in (5, 9, 6, 11)],
                [6, 4, 8, 5])
    if name == "q8":
        rng = np.random.default_rng(13)
        return [rng.integers(1, 200, (p,)) for p in (5, 9, 7)], [6, 4, 7]
    rng = np.random.default_rng(5)
    shared = rng.integers(1, 200, size=24).tolist()
    return ([shared + rng.integers(1, 200, size=int(k)).tolist()
             for k in (5, 9, 3, 12, 7)], [8, 6, 9, 5, 7])


#: name -> (workload, engine knobs, extras).  Extras: ``draft`` (the
#: 1-layer draft model), ``faults`` (a FaultPlan's kwargs, the same on
#: every rank), ``rank0_faults`` (a plan only rank 0 — and the single
#: device — runs), ``deadline`` ({request index: deadline_ms}).
CASES = {
    # the reference's matrix: mode x pipeline x chunking
    "greedy-pipe-whole": ("matrix", dict(SMALL, prefill_chunk=None), {}),
    "greedy-sync-chunk4": ("matrix", dict(SMALL, pipeline=False,
                                          prefill_chunk=4), {}),
    "spec-pipe-chunk4": ("matrix", dict(SMALL, mode="spec", spec_k=4,
                                        prefill_chunk=4), {}),
    "spec-sync-whole": ("matrix", dict(SMALL, mode="spec", spec_k=4,
                                       pipeline=False, prefill_chunk=None),
                        {}),
    # int8 KV, dense and paged (the scale leaf split on heads)
    "q8-dense": ("q8", dict(SMALL, kv_dtype="int8"), {}),
    "q8-paged": ("q8", dict(SMALL, kv_dtype="int8", kv_block=16,
                            max_live_tokens=2 * 64), {}),
    # paged pool with radix prefix hits
    "paged-greedy": ("shared", dict(PAGED), {}),
    "paged-spec": ("shared", dict(PAGED, mode="spec", spec_k=4), {}),
    # what the reference matrix does not reach
    "draft-paged": ("matrix", dict(SMALL, mode="spec", spec_k=3,
                                   prefill_chunk=16, kv_block=16,
                                   max_live_tokens=4 * 64),
                    dict(draft="model")),
    "adaptive-lookup": ("shared", dict(PAGED, mode="spec", spec_k=4),
                        dict(spec=dict(adaptive_window=2, k_min=1))),
    "tree-dense": ("matrix", dict(SMALL, mode="spec", spec_k=3,
                                  prefill_chunk=16),
                   dict(draft="model", spec=dict(tree="top2"))),
    "w8-paged": ("matrix", dict(SMALL, prefill_chunk=16, kv_block=16,
                                max_live_tokens=2 * 64, weight_dtype="int8"),
                 {}),
    "overlap-greedy": ("matrix", dict(SMALL, prefill_chunk=16,
                                      tp_overlap=2), {}),
    "overlap-spec-w8": ("matrix", dict(SMALL, mode="spec", spec_k=4,
                                       prefill_chunk=16, tp_overlap=2,
                                       weight_dtype="int8"), {}),
    "faults": ("matrix", dict(SMALL, prefill_chunk=16, retry_backoff=1e-4),
               dict(faults=dict(dispatch_error_steps=(2, 5),
                                poison={0: 3}))),
    # only rank 0 stalls: its clock alone decides the expiry
    "deadline": ("matrix", dict(SMALL, prefill_chunk=16),
                 dict(rank0_faults=dict(slow_steps={3: 1.6}),
                      deadline={0: 1500, 2: 1500})),
}

#: the cases the JAX single-device engine (pipeline=False) also serves
JAX_CASES = ("greedy-sync-chunk4", "spec-sync-whole")


def tiny_config(LlamaConfig, **kw):
    return LlamaConfig.tiny(**dict(dict(num_key_value_heads=4,
                                        dtype="float32"), **kw))


def build_models(state):
    """The target (``state``: the reference model's numpy weights) and the
    1-layer draft (seed 1), on the CPU."""
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM

    target = LlamaForCausalLM(tiny_config(LlamaConfig), device="cpu")
    target.load_numpy_state(state)
    draft = LlamaForCausalLM(tiny_config(LlamaConfig, num_hidden_layers=1),
                             device="cpu", seed=1)
    return target, draft


def run_case(name, models, rank=0, **kw):
    """Serve case ``name``: ``{"streams": {rid: tokens}, "status": {rid:
    status}, "events": [[kind, rid, slot, step], ...]}`` (rids as
    strings; an injected stall, which one rank alone may take, left out);
    ``kw`` adds engine knobs (``mesh``)."""
    from paddle_tpu_torch.serving import FaultPlan, Request, ServingEngine

    wl, knobs, extra = CASES[name]
    target, draft = models
    knobs = dict(knobs, instrument=False, **kw)
    spec = dict(extra.get("spec", {}))
    if extra.get("draft"):
        spec.update(source="draft_model", draft_model=draft)
    if spec:
        knobs["spec"] = spec
    plan = extra.get("faults") or (extra.get("rank0_faults") if rank == 0
                                   else None)
    if plan:
        knobs["faults"] = FaultPlan(**plan)
    eng = ServingEngine(target, **knobs)
    prompts, new = workload(wl)
    deadline = extra.get("deadline", {})
    reqs = [eng.submit(Request(p, n, deadline_ms=deadline.get(i)))
            for i, (p, n) in enumerate(zip(prompts, new))]
    eng.run()
    assert not eng.has_work
    return {"streams": {str(r.rid): list(map(int, r.output_ids))
                        for r in reqs},
            "status": {str(r.rid): r.status for r in reqs},
            "events": [[e["kind"], e["rid"], e["slot"], e["step"]]
                       for e in eng.recorder.events()
                       if not e.get("injected")]}


def construction_errors(models, mesh):
    """The message each refused construction raises under ``mesh``."""
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.serving import ServingEngine

    target, _ = models
    nkv2 = LlamaForCausalLM(LlamaConfig.tiny(dtype="float32"), device="cpu")
    draft2 = LlamaForCausalLM(LlamaConfig.tiny(num_hidden_layers=1,
                                               dtype="float32"),
                              device="cpu", seed=1)
    tries = {
        "indivisible": (nkv2, {}),
        "draft_indivisible": (target, dict(mode="spec", spec=dict(
            source="draft_model", draft_model=draft2))),
        "bad_axis": (target, dict(tp_axis="dp")),
        "tp_overlap": (target, dict(tp_overlap=1)),
    }
    out = {}
    for key, (model, kw) in tries.items():
        try:
            ServingEngine(model, mesh=mesh, **dict(SMALL, **kw))
            out[key] = None
        except ValueError as e:  # the test reads the message
            out[key] = f"{type(e).__name__}: {e}"
    return out


def shard_shapes(models, mesh):
    """The rank's local shapes under the mesh, and its gauge."""
    from paddle_tpu_torch.observability import MetricsRegistry
    from paddle_tpu_torch.serving import ServingEngine

    target, _ = models
    reg = MetricsRegistry()
    eng = ServingEngine(target, mesh=mesh, registry=reg,
                        **dict(SMALL, kv_dtype="int8", prefill_chunk=16))
    (kd, ks), _ = eng.kv_manager.caches[0]
    lp = eng._params["layers"][0]
    return {"wq": list(lp["wq"].shape), "wo": list(lp["wo"].shape),
            "down": list(lp["down"].shape), "embed":
            list(eng._params["embed"].shape), "cache": list(kd.shape),
            "scale": list(ks.shape), "cfg": list(eng._cfg[:3]),
            "mesh_devices": reg.get("serving_mesh_devices").labels(
                policy="continuous").value}


def main():
    rank, world, workdir = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(workdir, "store"), world),
        rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=120))
    mesh = init_device_mesh("cpu", (world,), mesh_dim_names=(AXIS,))
    with np.load(os.path.join(workdir, "weights.npz")) as z:
        state = {k: z[k] for k in z.files}
    models = build_models(state)
    out = {"cases": {n: run_case(n, models, rank, mesh=mesh)
                     for n in CASES},
           "errors": construction_errors(models, mesh),
           "shapes": shard_shapes(models, mesh)}
    tmp = os.path.join(workdir, f"result_r{rank}.tmp")
    with open(tmp, "w") as f:
        json.dump(out, f)
    os.replace(tmp, os.path.join(workdir, f"result_r{rank}.json"))
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
