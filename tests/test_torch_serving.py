"""The port's ServingEngine against the JAX package's, on the CPU.

The tiny f32 Llama (weights carried from the JAX model by name) serves a
shared-prefix workload at the geometry of ``tests/test_serving_paged.py``
(batch 3, max_len 128, 16-token chunks, 16-token KV blocks).  The JAX
engine runs both fused kernels (``attn_impl=prefill_impl="pallas"``,
interpret mode) with ``pipeline=False``: its pipelined loop gives
run-to-run different streams on this JAX build (ROADMAP queue C), so the
synchronous loop — byte-identical to the pipelined one by the
reference's own contract — is the oracle.  The port's streams must be
identical to it, dense and paged, with the same prefix-reuse count;
within the port, paged == dense, pipeline on == off and gang ==
continuous bit for bit, and the pool's accounting returns to zero after
drain.  The same holds with int8 KV caches (``kv_dtype="int8"``) and
int8 decode weights (``weight_dtype="int8"``), alone and together: token
for token against the JAX engine (``pipeline=False``), and within the
port int8 paged == dense and pipeline on == off.  The quantization
gauges read the values ``tests/test_serving_q8.py`` pins.  Each engine
configuration runs once per module (memoised).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models.llama import LlamaConfig as JConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JModel
from paddle_tpu.serving import Request as JRequest
from paddle_tpu.serving import ServingEngine as JEngine
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.observability import MetricsRegistry
from paddle_tpu_torch.serving import Request, ServingEngine
from paddle_tpu_torch.ops import paged_attention_cuda as k8
from paddle_tpu_torch.ops import prefill_attention_cuda as k9

# tiny shapes: torch's intra-op threads would only contend with the
# other test processes sharing this machine
torch.set_num_threads(1)

GEOM = dict(batch_size=3, max_len=128, decode_chunk=16, prefill_chunk=16,
            instrument=False)
PAGED = dict(kv_block=16, max_live_tokens=3 * 128)

_rng = np.random.default_rng(21)
_HEAD = _rng.integers(1, 200, size=36).tolist()
# five requests for three slots: the last two admit into retired slots,
# and the two shared-prefix followers find the leader's blocks registered
PROMPTS = [_HEAD + _rng.integers(1, 200, size=5).tolist(),
           _rng.integers(1, 200, size=9).tolist(),
           _rng.integers(1, 200, size=16).tolist(),
           _HEAD + _rng.integers(1, 200, size=11).tolist(),
           _HEAD[:32] + _rng.integers(1, 200, size=2).tolist()]
NEW = [7, 12, 5, 6, 4]

_MEMO = {}


@pytest.fixture(scope="module")
def models():
    paddle.seed(0)
    jm = JModel(JConfig.tiny(dtype="float32"))
    jm.eval()
    tm = LlamaForCausalLM(LlamaConfig.tiny(dtype="float32"), device="cpu")
    state, _ = jm.functional_state()
    tm.load_numpy_state({k: np.asarray(v) for k, v in state.items()})
    return jm, tm


def _run(E, R, model, key, **kw):
    if key not in _MEMO:
        eng = E(model, **kw)
        for p, n in zip(PROMPTS, NEW):
            eng.submit(R(p, n))
        done = eng.run()
        assert not eng.has_work
        _MEMO[key] = ({r.rid: list(r.output_ids) for r in done}, eng)
    return _MEMO[key]


def _jax(models, paged, **extra):
    kw = dict(GEOM, recorder=False, pipeline=False, attn_impl="pallas",
              prefill_impl="pallas", **(PAGED if paged else {}), **extra)
    key = ("jax", paged) + tuple(sorted(extra.items()))
    return _run(JEngine, JRequest, models[0], key, **kw)


def _port(models, paged, **extra):
    kw = dict(GEOM, **(PAGED if paged else {}), **extra)
    key = ("port", paged) + tuple(sorted(extra.items()))
    return _run(ServingEngine, Request, models[1], key, **kw)


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_streams_match_jax_engine(models, paged):
    jout, jeng = _jax(models, paged)
    tout, teng = _port(models, paged)
    assert tout == jout
    assert all(len(tout[i]) == n for i, n in enumerate(NEW))
    if paged:
        reuse = teng.stats()["prefix_reuse_tokens"]
        assert reuse > 0
        assert reuse == jeng.stats()["prefix_reuse_tokens"]


QUANT = {"kv8": dict(kv_dtype="int8"), "w8": dict(weight_dtype="int8"),
         "kv8-w8": dict(kv_dtype="int8", weight_dtype="int8")}


@pytest.mark.parametrize("paged,quant", [
    (False, "kv8"), (True, "kv8"), (True, "w8"), (True, "kv8-w8")],
    ids=["kv8-dense", "kv8-paged", "w8-paged", "kv8-w8-paged"])
def test_int8_streams_match_jax_engine(models, paged, quant):
    jout, jeng = _jax(models, paged, **QUANT[quant])
    tout, teng = _port(models, paged, **QUANT[quant])
    assert tout == jout
    assert all(len(tout[i]) == n for i, n in enumerate(NEW))
    if paged:
        assert teng.stats()["prefix_reuse_tokens"] \
            == jeng.stats()["prefix_reuse_tokens"] > 0
    k = teng.kv_manager.caches[0][0]
    assert isinstance(k, tuple) == ("kv8" in quant)
    if "kv8" in quant:
        assert k[0].dtype == torch.int8 and k[1].dtype == torch.float16
    assert teng._pk.kv_dtype == ("int8" if "kv8" in quant else None)
    assert teng._pk.weight_dtype == ("int8" if "w8" in quant else None)


def test_int8_paged_equals_dense(models):
    assert _port(models, True, **QUANT["kv8"])[0] \
        == _port(models, False, **QUANT["kv8"])[0]


@pytest.mark.parametrize("quant", ["kv8", "kv8-w8"])
def test_int8_pipeline_on_equals_off(models, quant):
    assert _port(models, True, pipeline=False, **QUANT[quant])[0] \
        == _port(models, True, **QUANT[quant])[0]


def test_quant_gauges_read_the_pinned_values(models):
    """``serving_kv_quant_mode`` / ``serving_hbm_gb_per_tok_q8`` as
    ``tests/test_serving_q8.py`` pins them (tiny model: 2 layers, 2 kv
    heads, head_dim 16 -> 2*2*2*18 = 144 bytes a token), and the weight
    gauges: one byte per projection element plus two per output
    channel."""
    reg = MetricsRegistry()
    eng = ServingEngine(models[1], batch_size=2, max_len=64, registry=reg,
                        kv_dtype="int8", weight_dtype="int8")
    lbl = dict(policy="continuous")
    kv = reg.get("serving_kv_quant_mode")
    assert kv.labels(mode="int8", **lbl).value == 1
    assert kv.labels(mode="off", **lbl).value == 0
    assert reg.get("serving_hbm_gb_per_tok_q8").labels(**lbl).value \
        == pytest.approx(144 / 1e9)
    wq = reg.get("serving_weight_quant_mode")
    assert wq.labels(mode="int8", **lbl).value == 1
    assert wq.labels(mode="off", **lbl).value == 0
    want = sum(lp[n].numel() + 2 * lp[n + "_scale"].numel()
               for lp in eng._params["layers"] for n in
               ("wq", "wk", "wv", "wo", "gate", "up", "down"))
    assert reg.get("serving_hbm_gb_per_tok_w8").labels(**lbl).value \
        == pytest.approx(want / 1e9)
    reg2 = MetricsRegistry()
    ServingEngine(models[1], batch_size=2, max_len=64, registry=reg2)
    for fam in ("serving_kv_quant_mode", "serving_weight_quant_mode"):
        assert reg2.get(fam).labels(mode="off", **lbl).value == 1
        assert reg2.get(fam).labels(mode="int8", **lbl).value == 0
    assert reg2.get("serving_hbm_gb_per_tok_q8").labels(**lbl).value == 0


def test_w8_leaves_the_model_params_alone(models):
    """The engine quantizes a fresh params dict: the model's cached
    decode params (views of its parameters) stay float."""
    from paddle_tpu_torch.models import llama_decode as tld

    _, eng = _port(models, True, **QUANT["w8"])
    cached, _ = tld._decode_params_of(models[1], GEOM["max_len"])
    assert cached["layers"][0]["wq"].dtype == torch.float32
    assert eng._params["layers"][0]["wq"].dtype == torch.int8


def test_paged_equals_dense(models):
    assert _port(models, True)[0] == _port(models, False)[0]


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_pipeline_on_equals_off(models, paged):
    assert _port(models, paged, pipeline=False)[0] == _port(models, paged)[0]


def test_gang_equals_continuous(models):
    assert _port(models, True, policy="gang")[0] == _port(models, True)[0]


def test_sync_every_matches(models):
    assert _port(models, True, sync_every=3)[0] == _port(models, True)[0]


def test_pool_accounting_returns_to_zero(models):
    _, eng = _port(models, True)
    kv = eng.kv_manager
    assert kv.live_tokens() == 0 and kv.outstanding() == 0
    assert kv.occupied() == 0
    # retired registered chains park evictable; nothing else stays used
    assert kv.blocks_used() == kv.evictable_count() > 0
    assert (kv.block_tables == kv.num_blocks).all()
    assert int(kv.refcnt.sum()) == 0


def test_metrics_and_plain_path_counters(models):
    """An instrumented CPU run posts the slice's families and runs only
    the plain versions (the kernel launch counters stay put)."""
    k8_before, k9_before = k8.launches, k9.launches
    reg = MetricsRegistry()
    eng = ServingEngine(models[1], **{**GEOM, **PAGED, "instrument": True},
                        registry=reg)
    for p, n in zip(PROMPTS, NEW):
        eng.submit(Request(p, n))
    assert eng.drain() == {i: "done" for i in range(len(NEW))}
    lbl = dict(policy="continuous")
    assert reg.get("serving_tokens_emitted_total").labels(**lbl).value \
        == sum(NEW)
    assert reg.get("serving_ttft_seconds").labels(**lbl).count == len(NEW)
    assert reg.get("serving_prefix_reuse_tokens_total").labels(**lbl) \
        .value == _port(models, True)[1].stats()["prefix_reuse_tokens"]
    assert reg.get("serving_decode_kernel").labels(
        policy="continuous", impl="reference").value == 1
    assert (k8.launches, k9.launches) == (k8_before, k9_before)


def test_eos_and_stream_callback(models):
    seen = []
    eng = ServingEngine(models[1], **GEOM)
    first = _port(models, False)[0][1]
    r = eng.submit(Request(PROMPTS[1], NEW[1], eos_token_id=first[2],
                           stream_cb=lambda req, ids: seen.extend(ids)))
    eng.run()
    assert r.output_ids == first[:3] and seen == first[:3]
    assert r.status == "done" and r.ttft is not None


def test_engine_on_cpu_refuses_the_kernels(models):
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        ServingEngine(models[1], **GEOM, attn_impl="cuda")
