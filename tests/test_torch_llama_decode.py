"""The port's decode model functions against the JAX package.

The tiny f32 Llama is built by the JAX package, its weights carried
across (``decode_params_from_numpy`` for the decode pytree,
``LlamaForCausalLM.load_numpy_state`` for ``functional_state()``), and
the same prompt goes through ``serving_prefill_chunk`` and
``serving_decode_steps`` / ``_forward_step`` in both packages, paged and
dense.  JAX runs its fused kernels (interpret mode on the CPU), the
port its plain versions.  Logits agree to ``1e-4``; greedy tokens are
identical.  The same holds with int8 KV caches and int8 decode weights
(``quantize_decode_weights``, whose codes and scales are bitwise the
reference's); quantized params also cross from the JAX package bit for
bit through ``decode_params_from_numpy``.
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
from paddle_tpu.ops.decode_attention import init_kv_pool as j_pool
from paddle_tpu.serving.program_key import ProgramKey as JKey
from paddle_tpu_torch.interop import decode_params_from_numpy
from paddle_tpu_torch.models import llama_decode as tld
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.ops.decode_attention import init_kv_cache, init_kv_pool

# tiny shapes: torch's intra-op threads would only contend with the
# other test processes sharing this machine
torch.set_num_threads(1)

LMAX, P, C = 64, 16, 16
N_BLOCKS = 8
TOL = dict(atol=1e-4, rtol=1e-4)
_JKEY = JKey(attn_impl="pallas", prefill_impl="pallas")


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
    return jparams, tparams, cfg, jm


def _prompt(n, seed=1):
    return np.random.default_rng(seed).integers(1, 250, size=n)


def _quantized(models):
    """(JAX w8 params, the port's own quantization of its params)."""
    jparams, tparams, _, _ = models
    return (jld.quantize_decode_weights(jparams),
            tld.quantize_decode_weights(tparams))


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_prefill_then_decode_matches_jax(models, paged):
    _prefill_then_decode(models, paged)


@pytest.mark.parametrize("paged,kv8,w8", [
    (False, True, False), (True, True, False), (True, False, True),
    (True, True, True)], ids=["kv8-dense", "kv8-paged", "w8-paged",
                              "kv8-w8-paged"])
def test_int8_prefill_then_decode_matches_jax(models, paged, kv8, w8):
    _prefill_then_decode(models, paged, kv8, w8)


def _prefill_then_decode(models, paged, kv8=False, w8=False):
    jparams, tparams, cfg, _ = models
    if w8:
        jparams, tparams = _quantized(models)
    dt = "int8" if kv8 else "float32"
    jkey = _JKEY.replace(kv_dtype="int8" if kv8 else None,
                         weight_dtype="int8" if w8 else None)
    nh, nkv, hd, _ = cfg
    n_layers = len(jparams["layers"])
    prompt = _prompt(37)
    slot = 1
    if paged:
        table = np.full((2, LMAX // C), N_BLOCKS, np.int32)
        table[slot] = [5, 2, 7, 0]
        jc = [j_pool(N_BLOCKS, C, nkv, hd, dt) for _ in range(n_layers)]
        tc = [init_kv_pool(N_BLOCKS, C, nkv, hd, dt, "cpu")
              for _ in range(n_layers)]
        jt, tt = jnp.asarray(table), torch.from_numpy(table)
    else:
        jc = [j_cache(2, LMAX, nkv, hd, dt) for _ in range(n_layers)]
        tc = [init_kv_cache(2, LMAX, nkv, hd, dt, "cpu")
              for _ in range(n_layers)]
        jt = tt = None
    padded = np.zeros((48,), np.int32)
    padded[:prompt.size] = prompt
    jplen = jnp.asarray(np.array([prompt.size], np.int32))
    for off in range(0, prompt.size, P):
        chunk = padded[off:off + P][None, :]
        jf, jok, jc, _, _ = jld.serving_prefill_chunk(
            jparams, cfg, jnp.asarray(chunk), jnp.int32(off),
            jplen, jc, jnp.int32(slot),
            chunk_size=C, block_tables=jt, program_key=jkey)
        tf, tok, tc = tld.serving_prefill_chunk(
            tparams, cfg, torch.from_numpy(chunk), off, prompt.size, tc,
            slot, chunk_size=C, block_tables=tt)
        assert int(tf[0]) == int(np.asarray(jf)[0]) and bool(tok[0])
    # one decode step: logits, then four greedy tokens
    cur = np.array([0, int(tf[0])], np.int32)
    lengths = np.array([LMAX, prompt.size], np.int32)    # slot 0 parked
    jl, jc, _ = jld._forward_step(
        jparams, cfg, jnp.asarray(cur)[:, None], jc, jnp.asarray(lengths),
        chunk_size=C, block_tables=jt, attn_impl="pallas")
    tl, tc, _ = tld._forward_step(
        tparams, cfg, torch.from_numpy(cur)[:, None], tc,
        torch.from_numpy(lengths), chunk_size=C, block_tables=tt)
    np.testing.assert_allclose(tl.numpy()[slot], np.asarray(jl)[slot], **TOL)
    lengths[slot] += 1
    nxt = np.array([0, int(np.argmax(np.asarray(jl)[slot]))], np.int32)
    jtoks, jok, jc = jld.serving_decode_steps(
        jparams, cfg, jnp.asarray(nxt), jc, jnp.asarray(lengths), n_steps=4,
        chunk_size=C, block_tables=jt, program_key=jkey)
    ttoks, tok, _ = tld.serving_decode_steps(
        tparams, cfg, torch.from_numpy(nxt), tc, torch.from_numpy(lengths),
        n_steps=4, chunk_size=C, block_tables=tt)
    assert ttoks.numpy()[slot].tolist() == np.asarray(jtoks)[slot].tolist()
    assert bool(tok[slot])
    if kv8:                      # the appended caches, bitwise
        for (tk, _), (jk, _) in zip(tc, jc):
            np.testing.assert_array_equal(tk[0].numpy(), np.asarray(jk[0]))
            np.testing.assert_array_equal(tk[1].numpy(), np.asarray(jk[1]))


def test_quantize_decode_weights_matches_jax_bitwise(models):
    """Codes and f16 scales bitwise the reference's, the input params
    untouched; the reference's quantized tree crosses through
    ``decode_params_from_numpy`` bit for bit (int8 and f16 leaves)."""
    jq, tq = _quantized(models)
    _, tparams, _, _ = models
    assert tq is not tparams and tq["layers"][0] is not tparams["layers"][0]
    assert tparams["layers"][0]["wq"].dtype == torch.float32
    carried = decode_params_from_numpy(
        {"layers": [{n: np.asarray(x) for n, x in lp.items()}
                    for lp in jq["layers"]]}, device="cpu")
    for tl, jl, cl in zip(tq["layers"], jq["layers"], carried["layers"]):
        for name in tld.QUANT_WEIGHTS:
            assert tl[name].dtype == torch.int8
            assert tl[name + "_scale"].dtype == torch.float16
            for leaf in (name, name + "_scale"):
                np.testing.assert_array_equal(tl[leaf].numpy(),
                                              np.asarray(jl[leaf]))
                assert torch.equal(cl[leaf], tl[leaf])


def test_load_numpy_state_and_decode_greedy_match_jax(models):
    """Weights carried by name from ``functional_state()``: the port's
    own params extraction and RoPE tables agree with the reference's,
    and ``decode_greedy`` emits the same tokens."""
    jparams, _, _, jm = models
    state, _ = jm.functional_state()
    tm = LlamaForCausalLM(LlamaConfig.tiny(dtype="float32"), device="cpu")
    tm.load_numpy_state({k: np.asarray(v) for k, v in state.items()})
    tparams, _ = tld._decode_params_of(tm, LMAX)
    np.testing.assert_array_equal(tparams["layers"][1]["wq"].numpy(),
                                  np.asarray(jparams["layers"][1]["wq"]))
    np.testing.assert_allclose(tparams["_rope"][0].numpy(),
                               np.asarray(jparams["_rope"][0]), atol=1e-6)
    ids = np.stack([_prompt(12, 3), _prompt(12, 4)]).astype(np.int32)
    jout = np.asarray(jld.decode_greedy(jm, jnp.asarray(ids),
                                        max_new_tokens=6, max_len=LMAX))
    tout = tld.decode_greedy(tm, ids, max_new_tokens=6, max_len=LMAX)
    assert tout.numpy().tolist() == jout.tolist()


def test_model_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LlamaForCausalLM(LlamaConfig.tiny(dtype="float32"))


def test_seeded_init_is_reproducible():
    a = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu", seed=3)
    b = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu", seed=3)
    assert a.llama.embed_tokens.weight.dtype == torch.bfloat16
    for (na, pa), (nb, pb) in zip(a.named_parameters(),
                                  b.named_parameters()):
        assert na == nb and torch.equal(pa, pb)
    names = dict(a.named_parameters())
    assert names["llama.layers.0.self_attn.k_proj.weight"].shape == (64, 32)
    assert torch.all(names["llama.norm.weight"] == 1)
