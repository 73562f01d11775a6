"""Tensor-parallel serving in the port (``paddle_tpu_torch/serving/
sharding.py``, ``ServingEngine(mesh=...)``) against the reference's TP
contract (``tests/test_serving_tp.py``) on the CPU.

In-process: the port's rule table gives every leaf of the tiny decode
params (float, int8 weights, a draft) the spec the reference's
``match_partition_rules(llama_tp_rules())`` gives it; the rule-table and
error cases of the reference's file; each rank's shard is the reference
model's weights sliced, and the four shards concatenate back to the whole
exactly; on a one-rank gloo mesh the engine is bit for bit the
single-device one, a real out-of-memory error is not retried, and a mesh
whose process group is gone is refused.

One gloo group of four CPU ranks (``tests/_torch_tp_worker.py``, a
``FileStore`` in ``tmp_path``, a 120 s group timeout, one thread a rank)
serves the whole matrix at f32 on ``LlamaConfig.tiny(num_key_value_heads
=4)``: greedy and prompt-lookup spec, pipeline on and off, chunked and
monolithic (``prefill_chunk=None``) prefill, int8 KV dense and paged, the
paged pool with prefix hits, the draft model on the paged pool, the
adaptive ladder, the top-2 tree, int8 weights, ``tp_overlap=2``, an
identical ``FaultPlan`` on every rank, and a deadline only rank 0's
clock expires.  Every rank's streams and flight-recorder events (kind,
rid, slot, step) must be equal to each other's and to the port's
single-device engine; the ``pipeline=False`` greedy and spec cases also
equal the JAX single-device engine.
"""
import importlib.util
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models.llama import LlamaConfig as JConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JModel
from paddle_tpu.models.llama_decode import _decode_params_of as j_params_of
from paddle_tpu.models.llama_decode import (
    quantize_decode_weights as j_quantize,
)
from paddle_tpu.serving import Request as JRequest
from paddle_tpu.serving import ServingEngine as JEngine
from paddle_tpu.serving import sharding as jsh
from paddle_tpu_torch import interop
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.models.llama_decode import (
    _decode_params_of, quantize_decode_weights,
)
from paddle_tpu_torch.serving import Request, ServingEngine
from paddle_tpu_torch.serving import engine as engine_mod
from paddle_tpu_torch.serving.sharding import (
    kv_cache_pspec, kv_scale_pspec, llama_tp_rules, match_partition_rules,
    shard_decode_params,
)

# tiny shapes: torch's intra-op threads would only contend with the
# other test processes sharing this machine
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "_torch_tp_worker.py")
# the case table the ranks serve, loaded from the worker's file
_spec = importlib.util.spec_from_file_location("_torch_tp_worker", WORKER)
worker = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(worker)
#: the parent's wait for the whole group (each rank's collectives time
#: out after 120 s)
GROUP_TIMEOUT_S = 150


def _flat(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, path + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flat(v, path + (str(i),))
    else:
        yield "/".join(path), tree


def _spec_leaves(specs, params):
    """(path, spec) over the params' leaves (spec leaves are tuples)."""
    return {name: _at(specs, name) for name, _ in _flat(params)}


def _at(tree, name):
    for k in name.split("/"):
        tree = tree[int(k)] if isinstance(tree, (list, tuple)) else tree[k]
    return tree


@pytest.fixture(scope="module")
def models():
    """The reference tiny Llama (4 KV heads, f32, seed 0), the port's
    copy of it by name, and the reference's 1-layer draft with its
    copy."""
    paddle.seed(0)
    jm = JModel(JConfig.tiny(num_key_value_heads=4, dtype="float32"))
    jm.eval()
    state, _ = jm.functional_state()
    state = {k: np.asarray(v) for k, v in state.items()}
    tm = LlamaForCausalLM(LlamaConfig.tiny(num_key_value_heads=4,
                                           dtype="float32"), device="cpu")
    tm.load_numpy_state(state)
    paddle.seed(1)
    jd = JModel(JConfig.tiny(num_key_value_heads=4, num_hidden_layers=1,
                             dtype="float32"))
    jd.eval()
    td = LlamaForCausalLM(LlamaConfig.tiny(num_key_value_heads=4,
                                           num_hidden_layers=1,
                                           dtype="float32"), device="cpu")
    td.load_numpy_state({k: np.asarray(v)
                         for k, v in jd.functional_state()[0].items()})
    return dict(jax=jm, port=tm, jax_draft=jd, port_draft=td, state=state)


# ------------------------------------------------------------ the rules
@pytest.mark.parametrize("tree", ["float", "int8", "draft"])
def test_rules_match_the_reference(models, tree):
    """Every leaf gets the same split dimension from the port's table as
    from the reference's ``match_partition_rules(llama_tp_rules())``."""
    jm, tm = ((models["jax_draft"], models["port_draft"]) if tree == "draft"
              else (models["jax"], models["port"]))
    jp, _ = j_params_of(jm, 64)
    tp, _ = _decode_params_of(tm, 64)
    if tree == "int8":
        jp, tp = j_quantize(jp, "int8"), quantize_decode_weights(tp, "int8")
    jspecs = jsh.match_partition_rules(jsh.llama_tp_rules(), jp)
    tspecs = match_partition_rules(llama_tp_rules(), tp)
    jflat = {n: tuple(_at(jspecs, n)) for n, _ in _flat(jp)}
    tflat = _spec_leaves(tspecs, tp)
    assert set(jflat) == set(tflat)
    assert tflat == jflat
    if tree == "int8":
        assert tflat["layers/0/wq_scale"] == ("mp",)
        assert tflat["layers/0/down_scale"] == ()


def test_every_llama_param_matched(models):
    params, _ = _decode_params_of(models["port"], 64)
    specs = match_partition_rules(llama_tp_rules(), params)
    layer = specs["layers"][0]
    assert layer["wq"] == (None, "mp") and layer["gate"] == (None, "mp")
    assert layer["wo"] == ("mp", None) and layer["down"] == ("mp", None)
    assert specs["embed"] == () and specs["lm_head"] == ()
    assert layer["ln1"] == () and specs["_rope"] == ((), ())
    assert kv_cache_pspec() == (None, None, "mp", None)
    assert kv_scale_pspec("tp") == (None, None, "tp")


def test_scalars_short_circuit_to_replicated():
    specs = match_partition_rules(llama_tp_rules(),
                                  {"anything": torch.tensor(2.0),
                                   "one": torch.zeros((1, 1))})
    assert specs == {"anything": (), "one": ()}


def test_unmatched_nonscalar_raises():
    with pytest.raises(ValueError, match="no partition rule matched"):
        match_partition_rules(llama_tp_rules(),
                              {"mystery": torch.zeros((8, 8))})


def test_first_match_wins():
    rules = ((r"wq", (None, "mp")), (r".*", ()))
    specs = match_partition_rules(rules, {"wq": torch.zeros((4, 4)),
                                          "other": torch.zeros((4, 4))})
    assert specs == {"wq": (None, "mp"), "other": ()}


# -------------------------------------------------------------- shards
@pytest.mark.parametrize("quant", [False, True], ids=["float", "int8"])
def test_shards_concatenate_back_to_the_whole(models, quant):
    """The four ranks' shards, each the reference's weights carried by
    ``interop.decode_params_from_numpy`` and sliced, concatenate along
    their split dimension to the whole exactly; replicated leaves are the
    whole on every rank."""
    jp, _ = j_params_of(models["jax"], 64)
    if quant:
        jp = j_quantize(jp, "int8")
    whole = interop.decode_params_from_numpy(jp, device="cpu")
    shards = [shard_decode_params(whole, r, worker.WORLD)
              for r in range(worker.WORLD)]
    specs = shards[0][1]
    for name, leaf in _flat(whole):
        spec = _at(specs, name)
        parts = [_at(s, name) for s, _ in shards]
        dims = [d for d, ax in enumerate(spec) if ax is not None]
        if not dims:
            assert all(torch.equal(p, leaf) for p in parts), name
            continue
        (dim,) = dims
        assert all(p.shape[dim] * worker.WORLD == leaf.shape[dim]
                   and p.is_contiguous() for p in parts), name
        assert torch.equal(torch.cat(parts, dim=dim), leaf), name
    # the weights of the port's own copy of the model shard alike (its
    # rope tables are computed by torch, not carried)
    tp, _ = _decode_params_of(models["port"], 64)
    if quant:
        tp = quantize_decode_weights(tp, "int8")
    mine, _ = shard_decode_params(tp, 2, worker.WORLD)
    for name, leaf in _flat(shards[2][0]):
        if not name.startswith("_rope"):
            assert torch.equal(_at(mine, name), leaf), name


def test_indivisible_shard_raises(models):
    tp, _ = _decode_params_of(models["port"], 64)
    with pytest.raises(ValueError, match="not shardable 3-way"):
        shard_decode_params(tp, 0, 3)
    with pytest.raises(ValueError, match="rank 4 not in"):
        shard_decode_params(tp, 4, 4)


# ----------------------------------------------- one rank, in process
@pytest.fixture
def mesh1(tmp_path):
    """A one-rank gloo group (a FileStore, no ports) and its mesh; the
    group is destroyed afterwards."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    dist.init_process_group(
        "gloo", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0,
        world_size=1)
    try:
        yield init_device_mesh("cpu", (1,), mesh_dim_names=("mp",))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _serve(model, **kw):
    prompts, new = worker.workload("matrix")
    eng = ServingEngine(model, **dict(worker.SMALL, prefill_chunk=16, **kw))
    reqs = [eng.submit(Request(p, n)) for p, n in zip(prompts, new)]
    eng.run()
    return [list(r.output_ids) for r in reqs], eng


def test_one_rank_mesh_is_the_single_device_engine(models, mesh1,
                                                   monkeypatch):
    """At TP 1 the all-reduce is the identity: the streams are bit for
    bit the single-device engine's (greedy, and spec with int8 KV and
    tp_overlap).  A real out-of-memory error is not retried under TP; an
    injected fault, raised on every rank before any launch, is."""
    from paddle_tpu_torch.serving import FaultPlan

    tm = models["port"]
    assert _serve(tm, mesh=mesh1)[0] == _serve(tm)[0]
    spec = dict(mode="spec", spec_k=3, kv_dtype="int8")
    got, eng = _serve(tm, mesh=mesh1, tp_overlap=2, **spec)
    assert got == _serve(tm, **spec)[0]
    assert eng._pk.tp_overlap == 2 and eng._tp_n == 1
    monkeypatch.setattr(engine_mod, "_backoff_sleep", lambda s: None)
    got, eng = _serve(tm, mesh=mesh1,
                      faults=FaultPlan(dispatch_error_steps={2}))
    assert got == _serve(tm)[0] and eng._faults.stats["dispatch_errors"] == 1
    eng = ServingEngine(tm, mesh=mesh1, **dict(worker.SMALL,
                                               prefill_chunk=16))
    real, calls = eng._call_decode, []

    def oom(cur, dev_len):
        calls.append(1)
        if len(calls) == 2:
            raise torch.cuda.OutOfMemoryError("CUDA out of memory.")
        return real(cur, dev_len)
    eng._call_decode = oom
    eng.submit(Request(np.arange(1, 6), 6))
    with pytest.raises(torch.cuda.OutOfMemoryError):
        eng.run()
    assert len(calls) == 2


def test_mesh_without_a_process_group_raises(models, mesh1):
    import torch.distributed as dist

    dist.destroy_process_group()
    with pytest.raises(ValueError, match="no initialized process group"):
        ServingEngine(models["port"], mesh=mesh1, **worker.SMALL)
    with pytest.raises(TypeError, match="DeviceMesh"):
        ServingEngine(models["port"], mesh=object(), **worker.SMALL)


# ------------------------------------------- four ranks, one gloo group
def _jax_streams(models, name):
    wl, knobs, _ = worker.CASES[name]
    eng = JEngine(models["jax"], recorder=False, instrument=False, **knobs)
    prompts, new = worker.workload(wl)
    reqs = [eng.submit(JRequest(p, n)) for p, n in zip(prompts, new)]
    eng.run()
    return {str(r.rid): list(map(int, r.output_ids)) for r in reqs}


@pytest.fixture(scope="module")
def group(models, tmp_path_factory):
    """Start the four ranks, serve every case on one device meanwhile,
    join the ranks with a timeout (a stuck or failed rank fails the
    tests, never hangs them), then serve the JAX cases on the JAX
    engine."""
    d = tmp_path_factory.mktemp("tp_group")
    np.savez(d / "weights.npz", **models["state"])
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    procs = []
    for r in range(worker.WORLD):
        log = open(d / f"rank{r}.log", "w")
        procs.append((subprocess.Popen(
            [sys.executable, WORKER, str(r), str(worker.WORLD), str(d)],
            cwd=REPO, env=env,
            stdout=log, stderr=subprocess.STDOUT), log))
    t0 = time.monotonic()
    try:
        models_cpu = (models["port"], models["port_draft"])
        single = {n: worker.run_case(n, models_cpu) for n in worker.CASES}
        for p, _ in procs:
            p.wait(timeout=max(1.0, GROUP_TIMEOUT_S
                               - (time.monotonic() - t0)))
    except subprocess.TimeoutExpired:
        pytest.fail(f"the TP group did not finish in {GROUP_TIMEOUT_S} s")
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    bad = [r for r, (p, _) in enumerate(procs) if p.returncode != 0]
    if bad:
        tail = (d / f"rank{bad[0]}.log").read_text()[-3000:]
        pytest.fail(f"TP ranks {bad} failed:\n{tail}")
    ranks = [json.loads((d / f"result_r{r}.json").read_text())
             for r in range(worker.WORLD)]
    # after the join: XLA's threads would take the cores the ranks'
    # collectives wait on
    jax = {n: _jax_streams(models, n) for n in worker.JAX_CASES}
    return dict(ranks=ranks, single=single, jax=jax)


@pytest.mark.parametrize("name", list(worker.CASES))
def test_tp_group_matches_single_device(group, name):
    outs = [r["cases"][name] for r in group["ranks"]]
    assert all(o == outs[0] for o in outs[1:]), "the ranks disagree"
    single = group["single"][name]
    assert outs[0]["streams"] == single["streams"]
    assert outs[0]["status"] == single["status"]
    assert outs[0]["events"] == single["events"]
    if name in worker.JAX_CASES:
        assert outs[0]["streams"] == group["jax"][name]
    status = set(single["status"].values())
    if name == "faults":
        assert single["status"]["0"] == "poisoned" and "done" in status
    elif name == "deadline":
        # request 0 expires in its slot, request 2 in the queue
        assert single["status"]["0"] == single["status"]["2"] == "timed_out"
        assert 0 < len(single["streams"]["0"]) < 6
        assert single["streams"]["2"] == []
    else:
        assert status == {"done"}


def test_tp_group_refuses_what_does_not_shard(group):
    """Indivisible target or draft heads, a bad axis name and an invalid
    ``tp_overlap`` each raise at construction on every rank; nothing
    replicates silently."""
    for r in group["ranks"]:
        e = r["errors"]
        assert e["indivisible"].startswith("ValueError: heads not "
                                           "shardable 4-way along 'mp'")
        assert e["draft_indivisible"].startswith(
            "ValueError: draft heads not shardable 4-way")
        assert e["bad_axis"] == ("ValueError: mesh has no axis 'dp' "
                                 "(axes: ('mp',))")
        assert e["tp_overlap"].startswith("ValueError: ServingEngine: "
                                          "tp_overlap must be None or an "
                                          "int >= 2")


def test_tp_group_holds_the_rank_shards(group):
    """Each rank holds a quarter of the column-parallel outputs, of the
    row-parallel inputs and of the KV heads (int8 data and scale leaves),
    the embedding whole; ``serving_mesh_devices`` reads 4."""
    for r in group["ranks"]:
        s = r["shapes"]
        assert s["wq"] == [64, 16] and s["wo"] == [16, 64]
        assert s["down"] == [32, 64] and s["embed"] == [256, 64]
        assert s["cache"] == [2, 64, 1, 16] and s["scale"] == [2, 64, 1]
        assert s["cfg"] == [1, 1, 16] and s["mesh_devices"] == 4
