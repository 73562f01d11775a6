"""Monolithic prefill (``prefill_chunk=None``) in the port against the
JAX package, on the CPU.

``serving_prefill_slot`` runs a whole ``[1, bucket]`` prompt against
fresh mini caches and copies the rows into a slot of the batch cache;
with the tiny f32 Llama's decode params carried from the JAX model, its
first token and finite flag equal the reference's, the inserted rows
match (f32 within 1e-4; int8 codes within one, scales within one f16
step) and the other slot's rows are untouched; the prompt-lookup
history row is rebuilt alike.  The monolithic engine's streams equal the
JAX engine's (``pipeline=False``, ROADMAP queue C) greedy, prompt-lookup
and with int8 KV, and within the port monolithic == chunked prefill bit
for bit over the parity matrix of ``tests/test_serving.py:330-345``
(greedy and spec, pipeline on and off).  The K8 gate covers every
bucket: a dense span shorter than its chunk is one chunk of the span
rounded up to the 32-key sub-tile.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.models import llama_decode as jld
from paddle_tpu.models.llama import LlamaConfig as JConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JModel
from paddle_tpu.ops.decode_attention import init_kv_cache as j_cache
from paddle_tpu.serving import Request as JRequest
from paddle_tpu.serving import ServingEngine as JEngine
from paddle_tpu.serving.program_key import ProgramKey as JKey
from paddle_tpu_torch.interop import decode_params_from_numpy
from paddle_tpu_torch.models import llama_decode as tld
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.observability import MetricsRegistry
from paddle_tpu_torch.ops import paged_attention_cuda as k8
from paddle_tpu_torch.ops.decode_attention import init_kv_cache
from paddle_tpu_torch.serving import Request, ServingEngine
from paddle_tpu_torch.serving.program_key import ProgramKey

torch.set_num_threads(1)

LMAX, C = 64, 16
TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(scope="module")
def models():
    paddle.seed(0)
    jm = JModel(JConfig.tiny(dtype="float32"))
    jm.eval()
    jparams, cfg = jld._decode_params_of(jm, LMAX)
    tree = {k: (np.asarray(v) if not isinstance(v, (list, tuple)) else
                [{n: np.asarray(x) for n, x in lp.items()} for lp in v]
                if k == "layers" else tuple(np.asarray(x) for x in v))
            for k, v in jparams.items()}
    tparams = decode_params_from_numpy(tree, device="cpu")
    tm = LlamaForCausalLM(LlamaConfig.tiny(dtype="float32"), device="cpu")
    state, _ = jm.functional_state()
    tm.load_numpy_state({k: np.asarray(v) for k, v in state.items()})
    return jparams, tparams, cfg, jm, tm


def _leaf_np(x):
    return (x[0].numpy(), x[1].numpy()) if isinstance(x, tuple) \
        else x.numpy()


@pytest.mark.parametrize("kv", ["float32", "int8"])
@pytest.mark.parametrize("plen,bucket", [(11, 16), (37, 64)],
                         ids=["T=chunk", "T>chunk"])
@pytest.mark.parametrize("hist", [False, True], ids=["greedy", "lookup"])
def test_prefill_slot_matches_jax(models, kv, plen, bucket, hist):
    jparams, tparams, cfg, _, _ = models
    nh, nkv, hd, _ = cfg
    n_layers = len(jparams["layers"])
    q8 = kv == "int8"
    jkey = JKey(kv_dtype="int8" if q8 else None)
    tkey = ProgramKey(kv_dtype="int8" if q8 else None)
    prompt = np.random.default_rng(plen).integers(1, 250, size=plen)
    tokens = np.zeros((1, bucket), np.int32)
    tokens[0, :plen] = prompt
    slot = 1
    jc = [j_cache(2, LMAX, nkv, hd, kv) for _ in range(n_layers)]
    tc = [init_kv_cache(2, LMAX, nkv, hd, kv, "cpu")
          for _ in range(n_layers)]
    jh = jhl = th = thl = None
    if hist:
        jh = jnp.full((2, LMAX), 5, jnp.int32)
        jhl = jnp.zeros((2,), jnp.int32)
        th = torch.full((2, LMAX), 5, dtype=torch.int32)
        thl = torch.zeros((2,), dtype=torch.int32)
    jf, jok, jc, jh, jhl = jld.serving_prefill_slot(
        jparams, cfg, jnp.asarray(tokens),
        jnp.asarray(np.array([plen], np.int32)), jc, jnp.int32(slot),
        hist=jh, hist_len=jhl, with_hist=hist, chunk_size=C,
        program_key=jkey)
    tf, tok, tc = tld.serving_prefill_slot(
        tparams, cfg, torch.from_numpy(tokens), plen, tc, slot,
        chunk_size=C, program_key=tkey, hist=th, hist_len=thl)
    assert int(tf[0]) == int(np.asarray(jf)[0])
    assert bool(tok[0]) and bool(np.asarray(jok)[0])
    for (tk, tv), (jk, jv) in zip(tc, jc):
        for t_leaf, j_leaf in ((tk, jk), (tv, jv)):
            got, ref = _leaf_np(t_leaf), j_leaf
            if q8:
                codes, scales = got
                assert np.abs(codes[slot].astype(np.int32) - np.asarray(
                    ref[0])[slot].astype(np.int32)).max() <= 1
                np.testing.assert_allclose(
                    scales[slot].astype(np.float32),
                    np.asarray(ref[1])[slot].astype(np.float32),
                    rtol=2 ** -10, atol=0)
                assert not codes[0].any() and not scales[0].any()
            else:
                np.testing.assert_allclose(got[slot], np.asarray(ref)[slot],
                                           **TOL)
                assert not got[0].any()     # the other slot untouched
    if hist:
        np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
        np.testing.assert_array_equal(thl.numpy(), np.asarray(jhl))
        assert int(thl[slot]) == plen + 1


GEOM = dict(batch_size=2, max_len=128, decode_chunk=16, instrument=False)
_rng = np.random.default_rng(33)
PROMPTS = [_rng.integers(1, 250, size=p).tolist() for p in (5, 21, 40, 13,
                                                            9)]
NEW = [6, 5, 7, 4, 8]


def _serve(E, R, model, **kw):
    eng = E(model, **kw)
    reqs = [eng.submit(R(np.asarray(p), n)) for p, n in zip(PROMPTS, NEW)]
    eng.run()
    assert not eng.has_work
    return [list(r.output_ids) for r in reqs]


@pytest.mark.parametrize("arm", ["greedy", "lookup", "kv8"])
def test_monolithic_streams_match_jax_engine(models, arm):
    jm, tm = models[3], models[4]
    extra = {"greedy": {}, "lookup": dict(mode="spec", spec_k=3),
             "kv8": dict(kv_dtype="int8")}[arm]
    kw = dict(GEOM, prefill_chunk=None, **extra)
    jout = _serve(JEngine, JRequest, jm, pipeline=False, recorder=False,
                  **kw)
    k8.plain_runs = 0
    tout = _serve(ServingEngine, Request, tm, pipeline=False, **kw)
    assert tout == jout
    assert [len(o) for o in tout] == NEW
    assert k8.plain_runs > 0           # the CPU runs K8's plain version
    tpipe = _serve(ServingEngine, Request, tm, pipeline=True, **kw)
    assert tpipe == tout


@pytest.mark.parametrize("pipeline", [False, True], ids=["sync", "pipe"])
@pytest.mark.parametrize("mode", ["greedy", "spec"])
def test_parity_matrix_vs_chunked(models, mode, pipeline):
    """Prompt lengths <, =, a multiple of and not a multiple of the chunk
    (P=8), greedy and spec, pipeline on and off: monolithic == chunked,
    bit for bit (``tests/test_serving.py:330-345``)."""
    tm = models[4]
    rng = np.random.default_rng(21)
    prompts = [rng.integers(0, 256, (p,)) for p in (5, 8, 16, 13)]
    news = [6, 5, 4, 7]
    kw = dict(batch_size=2, max_len=64, mode=mode, pipeline=pipeline,
              registry=MetricsRegistry())

    def run(**more):
        eng = ServingEngine(tm, **kw, **more)
        reqs = [eng.submit(Request(p, n)) for p, n in zip(prompts, news)]
        eng.run()
        return [list(r.output_ids) for r in reqs], eng

    mono, meng = run(prefill_chunk=None)
    chunk, _ = run(prefill_chunk=8, prefill_budget=2)
    assert chunk == mono
    kinds = [e["kind"] for e in meng.recorder.events()]
    assert "prefill_chunk" not in kinds and kinds.count("admit") == 4


def test_monolithic_knob_validation(models):
    tm = models[4]
    with pytest.raises(ValueError, match="requires chunked prefill"):
        ServingEngine(tm, batch_size=2, max_len=64, prefill_chunk=None,
                      kv_block=16)
    with pytest.raises(ValueError, match="requires chunked"):
        ServingEngine(tm, batch_size=2, max_len=64, prefill_chunk=None,
                      mode="spec", spec=dict(source="draft_model",
                                             draft_model=tm))


def test_k8_gate_covers_every_bucket():
    """A dense span shorter than the chunk (a monolithic prefill's mini
    cache, a small engine's batch cache) is read as one chunk of the span
    rounded up to the 32-key sub-tile; a paged pool's is not."""
    assert k8.kernel_chunk(256, 16, dense=True) == 32
    assert k8.kernel_chunk(256, 64, dense=True) == 64
    assert k8.kernel_chunk(256, 1024, dense=True) == 256
    assert k8.kernel_chunk(256, 64, dense=False) == 256
    for bucket in (16, 32, 64, 128, 256, 512, 1024):
        assert k8.fused_decode_supported(256, bucket, 128, dense=True) \
            is None, bucket
    assert "divide" in k8.fused_decode_supported(256, 64, 128)
    assert "divide" in k8.fused_decode_supported(256, 384, 128, dense=True)
