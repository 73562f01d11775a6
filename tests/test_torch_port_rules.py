"""Rules the port keeps: no JAX, no reference imports, the card by
default, no silent fallback, unported knobs refused loudly."""
import ast
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from paddle_tpu_torch.core.device import resolve_device, resolve_impl
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.ops import decode_attention as tda
from paddle_tpu_torch.serving import Request, ServingEngine

# tiny shapes: torch's intra-op threads would only contend with the
# other test processes sharing this machine
torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]


def test_import_pulls_in_neither_jax_nor_the_reference():
    # a subprocess: this test process already imported jax (conftest)
    code = ("import sys, paddle_tpu_torch, paddle_tpu_torch.serving, "
            "paddle_tpu_torch.interop, paddle_tpu_torch.ops._build, "
            "paddle_tpu_torch.static, paddle_tpu_torch.optimizer, "
            "paddle_tpu_torch.nn.functional, "
            "paddle_tpu_torch.ops.chunked_ce, "
            "paddle_tpu_torch.ops.flash_attention_cuda, "
            "paddle_tpu_torch.ops.fused_rope_cuda, "
            "paddle_tpu_torch.distributed.fleet\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'paddle_tpu' or "
            "m.startswith('paddle_tpu.'))\n"
            "assert not bad, bad\n"
            "assert 'triton' not in sys.modules\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_no_jax_or_reference_import_in_the_port_sources():
    files = sorted((ROOT / "paddle_tpu_torch").rglob("*.py"))
    files += [ROOT / "chip_smoke.py", ROOT / "serving_probe.py",
              ROOT / "flash_probe.py"]
    assert len(files) > 10
    for f in files:
        for mod in _imports(f):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "paddle_tpu"), (f, mod)


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tda.init_kv_cache(1, 16, 1, 16)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LlamaForCausalLM(LlamaConfig.tiny())
    assert resolve_device("cpu").type == "cpu"


def test_training_kernels_take_no_cpu_tensors():
    """The training path's wrappers launch their kernel or raise: a CPU
    tensor handed to one is refused, never run through a plain version."""
    from paddle_tpu_torch.ops import flash_attention_cuda as kfa
    from paddle_tpu_torch.ops import fused_rope_cuda as k6

    q = torch.zeros((1, 128, 4 * 64))
    k = torch.zeros((1, 128, 2 * 64))
    st = torch.zeros((1, 4, 128))
    rope = (torch.zeros((128, 128)),) * 4        # K10's tables, D 128
    for call in (lambda: kfa.flash_fwd(q, k, k, 4, 2, True, 1.0),
                 lambda: kfa.flash_delta(q, q, 4),
                 lambda: kfa.flash_bwd_dkv(q, k, k, q, st, st, 4, 2, True,
                                           1.0),
                 lambda: kfa.flash_bwd_dq(q, k, k, q, st, st, 4, 2, True,
                                          1.0),
                 lambda: k6.rope(q, k, st[0], st[0], 4, 2),
                 lambda: kfa.flash_fwd(q, k, k, 2, 1, True, 1.0,
                                       rope=rope),
                 lambda: kfa.flash_bwd_dkv(q, k, k, q, st, st, 2, 1, True,
                                           1.0, rope=rope),
                 lambda: kfa.flash_bwd_dq(q, k, k, q, st, st, 2, 1, True,
                                          1.0, rope=rope)):
        with pytest.raises(ValueError, match="needs CUDA tensors"):
            call()


@pytest.mark.parametrize("cc", [(8, 0), (9, 0), (10, 0)], ids=str)
def test_kernels_load_only_on_hopper(cc, monkeypatch):
    """``_build.load`` refuses any card but compute capability 9.0
    (``sm_90a``) with an error that names it, before building."""
    from paddle_tpu_torch.core import device
    from paddle_tpu_torch.ops import _build

    monkeypatch.setattr(device, "compute_capability", lambda dev=None: cc)
    monkeypatch.setattr(_build, "_libs", {})
    built = []

    def build(names):
        built.append(names)
        raise RuntimeError("built")

    monkeypatch.setattr(_build, "build", build)
    with pytest.raises(RuntimeError) as err:
        _build.load("fused_rope")
    if cc == (9, 0):
        assert str(err.value) == "built" and built == [("fused_rope",)]
    else:
        assert "sm_90a" in str(err.value) and not built
        assert f"{cc[0]}.{cc[1]}" in str(err.value)


def test_kernel_on_cpu_tensors_raises():
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        resolve_impl("cuda", "cpu", "x")
    q = torch.zeros((1, 4, 4, 16))
    kc = torch.zeros((1, 32, 2, 16))
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        tda.slot_prefill_attention(q, kc[:, :4], kc[:, :4], kc, kc.clone(),
                                   0, 0, chunk_size=32, impl="cuda")
    with pytest.raises(ValueError, match="unknown impl"):
        resolve_impl("pallas", "cpu", "x")


@pytest.fixture(scope="module")
def tiny():
    return LlamaForCausalLM(LlamaConfig.tiny(dtype="float32"), device="cpu")


@pytest.mark.parametrize("knob", [dict(prefill_only=True)],
                         ids=lambda kw: next(iter(kw)))
def test_unported_engine_knobs_raise(tiny, knob):
    with pytest.raises(NotImplementedError, match="not ported"):
        ServingEngine(tiny, batch_size=2, max_len=64, **knob)


@pytest.mark.parametrize("knob", [
    dict(recorder=True), dict(slo=()), dict(watchdog=5.0),
    dict(host_tier_bytes=1 << 20), dict(prefill_chunk=None),
], ids=lambda kw: next(iter(kw)))
def test_observability_tier_and_monolithic_knobs_are_ported(tiny, knob):
    """The request observability layer, the host KV tier and monolithic
    prefill are ported: each knob builds an engine that carries it and
    serves a request (the host tier on a paged pool, which it needs)."""
    extra = dict(kv_block=16) if "host_tier_bytes" in knob else {}
    eng = ServingEngine(tiny, batch_size=2, max_len=64, **knob, **extra)
    try:
        r = eng.submit(Request(np.arange(1, 6), 4))
        assert eng.drain() == {r.rid: "done"} and len(r.output_ids) == 4
    finally:
        eng.close()
    if "recorder" in knob:
        assert [t["phase"] for t in r.timeline()][-1] == "done"
    if "slo" in knob:
        assert eng.slo_tracker.snapshot()["classes"] == {
            "interactive": {"objectives": {}, "window_requests": 1,
                            "good": 1, "attainment": 1.0,
                            "burn_rate": 0.0}}
    if "watchdog" in knob:
        assert not eng._watchdog.is_alive
    if "host_tier_bytes" in knob:
        assert eng.kv_manager.host_tier.max_bytes == 1 << 20
    if "prefill_chunk" in knob:
        assert eng._pchunk is None and not eng._pf


@pytest.mark.parametrize("knob", [dict(mesh=object()), dict(tp_overlap=2)],
                         ids=lambda kw: next(iter(kw)))
def test_tp_knobs_are_ported(tiny, knob):
    """Tensor parallelism is ported: ``mesh=`` takes a ``DeviceMesh``
    (anything else is refused by type), and ``tp_overlap`` segments the
    row-parallel products, on one device too (the reference's ``_mm``),
    without changing a token (tests/test_torch_serving_tp.py runs the
    ranks)."""
    if "mesh" in knob:
        with pytest.raises(TypeError, match="DeviceMesh"):
            ServingEngine(tiny, batch_size=2, max_len=64, **knob)
        return
    outs = []
    for kw in (knob, {}):
        eng = ServingEngine(tiny, batch_size=2, max_len=64, **kw)
        assert eng._pk.tp_overlap == kw.get("tp_overlap")
        r = eng.submit(Request(np.arange(1, 6), 4))
        assert eng.drain() == {r.rid: "done"}
        outs.append(r.output_ids)
    assert outs[0] == outs[1]


@pytest.mark.parametrize("knob", [
    dict(spec={"source": "draft_model", "tree": "top2"}),
    dict(faults="plan"), dict(max_pending=4), dict(retry_attempts=5),
    dict(retry_backoff=0.5)], ids=lambda kw: next(iter(kw)))
def test_tree_and_reliability_knobs_are_accepted(tiny, knob):
    """Top-2 tree verification and the reliability knobs are ported: each
    builds an engine that carries it and serves a request."""
    from paddle_tpu_torch.serving import FaultPlan

    if "spec" in knob:
        # a draft model is needed for the tree to reach the engine:
        # without one the config falls back to prompt lookup
        knob = dict(mode="spec", spec=dict(knob["spec"], draft_model=tiny))
    if knob.get("faults") == "plan":
        knob = dict(faults=FaultPlan(dispatch_error_steps={1}))
    eng = ServingEngine(tiny, batch_size=2, max_len=64,
                        **{"retry_backoff": 1e-4, **knob})
    if "spec" in knob:
        assert eng._pk.spec_tree == "top2"
    if "faults" in knob:
        assert eng._faults is knob["faults"]
    assert eng._max_pending == knob.get("max_pending")
    assert eng._retry_attempts == knob.get("retry_attempts", 3)
    r = eng.submit(Request(np.arange(1, 6), 4))
    assert eng.drain() == {r.rid: "done"} and len(r.output_ids) == 4
    if "faults" in knob:
        assert knob["faults"].stats["dispatch_errors"] == 1


@pytest.mark.parametrize("knob", [
    dict(mode="spec"), dict(spec={"source": "prompt_lookup"}),
    dict(spec_k=4)], ids=lambda kw: next(iter(kw)))
def test_spec_knobs_are_accepted(tiny, knob):
    """Speculative decoding is ported: ``mode="spec"`` and ``spec=``
    build a spec engine; ``spec_k`` alone is the reference's default
    depth, which a greedy engine ignores."""
    if "spec" in knob:
        knob = dict(knob, mode="spec")
    eng = ServingEngine(tiny, batch_size=2, max_len=64, **knob)
    spec = knob.get("mode") == "spec"
    assert eng._pk.draft_source == ("prompt_lookup" if spec else None)
    assert eng._pk.spec_depth == (8 if spec else None)


def test_slo_class_is_accepted():
    """``Request(slo_class=)`` is ported: the class names the request's
    SLO objectives, and ``timeline()`` is empty before ``submit()``."""
    r = Request(np.arange(4), 2, slo_class="batch")
    assert r.slo_class == "batch" and r.timeline() == []
    assert Request(np.arange(4), 2).slo_class is None


@pytest.mark.parametrize("kw", [dict(deadline_ms=10), dict(priority=1)],
                         ids=str)
def test_reliability_request_knobs_are_accepted(kw):
    r = Request(np.arange(4), 2, **kw)
    assert r.deadline_ms == kw.get("deadline_ms")
    assert r.priority == kw.get("priority", 0) and r.preempts == 0


def test_reference_on_card_and_uncovered_geometry_raise(tiny):
    """On the card the engine never takes the plain versions; a geometry
    the kernels do not cover fails at construction with the gate's
    reason."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card to build a model on it")
    model = LlamaForCausalLM(LlamaConfig.tiny(dtype="float32"))
    with pytest.raises(ValueError, match="always runs the kernels"):
        ServingEngine(model, batch_size=2, max_len=64, attn_impl="reference")
    with pytest.raises(ValueError, match="multiple of 32"):
        ServingEngine(model, batch_size=2, max_len=64, decode_chunk=16,
                      prefill_chunk=16)
