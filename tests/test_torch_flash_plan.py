"""The Python around the flash kernels' wgmma instances and K6, on the CPU.

The kernels themselves run only on the card (``test_torch_kernels_cuda.py``
holds them against their plain versions there).  What runs here: which
instance a call takes (the flash kernels' by dtype and head_dim, K6's by
dtype, head_dim and alignment), how the wrappers count and report
launches, how the tile sweep names its builds (``_build`` digests with
``-D`` flags, the ptxas log of the library in use), the sweep's
shared-memory plan, and that every ablation of ``flash_probe.py`` still
finds its step.
"""
import re

import pytest
import torch

import flash_probe
from paddle_tpu_torch.ops import _build
from paddle_tpu_torch.ops import flash_attention_cuda as kfa
from paddle_tpu_torch.ops import fused_rope_cuda as k6

DTYPES = [torch.float32, torch.bfloat16, torch.float16]
FLASH_SOURCES = ("flash_attention_fwd", "flash_attention_bwd")


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("head_dim", kfa.HEAD_DIMS)
def test_instance_is_wgmma_for_bf16_at_64_and_128(dtype, head_dim):
    want = "wgmma" if dtype == torch.bfloat16 and head_dim in (64, 128) \
        else "simt"
    assert kfa.flash_instance(dtype, head_dim) == want


def test_every_forward_and_dkv_counter_has_a_wgmma_twin():
    """And dQ's: every bf16 head_dim 64/128 dQ goes to its wgmma
    instance too; K3 has none."""
    for kernel in ("fwd", "dkv", "dq"):
        for tag in ("", "_seg", "_rope"):
            assert kernel + tag + "_wgmma" in kfa.launches
    assert "delta_wgmma" not in kfa.launches
    assert set(kfa.launches) == {
        k + t + w for k in ("fwd", "dkv", "dq") for t in ("", "_seg", "_rope")
        for w in ("", "_wgmma")} | {"delta"}


@pytest.mark.parametrize("wgmma", [False, True])
@pytest.mark.parametrize("kernel", ["fwd", "fwd_seg", "dkv_rope", "dq",
                                    "dq_seg", "dq_rope"])
def test_a_launch_counts_its_kernel_and_its_instance(monkeypatch, kernel,
                                                    wgmma):
    counts = dict.fromkeys(kfa.launches, 0)
    monkeypatch.setattr(kfa, "launches", counts)
    kfa._ok("test", 0, kernel, wgmma)
    assert counts[kernel] == 1
    assert counts[kernel + "_wgmma"] == int(wgmma)
    assert sum(counts.values()) == 1 + int(wgmma)


@pytest.mark.parametrize("rc,why", [
    (-1, "shape the kernel does not take"), (-2, "TMA tensor map"),
    (-3, "too few registers"), (700, "CUDA error 700")])
def test_a_failed_launch_says_why_and_counts_nothing(monkeypatch, rc, why):
    counts = dict.fromkeys(kfa.launches, 0)
    monkeypatch.setattr(kfa, "launches", counts)
    with pytest.raises(RuntimeError, match=why):
        kfa._ok("flash_fwd", rc, "fwd", True)
    assert not any(counts.values())


@pytest.mark.parametrize("name", FLASH_SOURCES)
def test_a_tile_variant_builds_its_own_library(monkeypatch, name):
    monkeypatch.setattr(_build, "DEFINES", ())
    plain = _build._lib_path(name)
    variant = _build._lib_path(name, ("-DPTF_FWD_KEYS=64",))
    assert variant != plain
    assert _build._lib_path(name, ()) == plain
    monkeypatch.setattr(_build, "DEFINES", ("-DPTF_FWD_KEYS=64",))
    assert _build._lib_path(name) == variant


@pytest.mark.parametrize("name", FLASH_SOURCES)
def test_ptxas_report_is_the_log_of_the_library_in_use(monkeypatch, tmp_path,
                                                       name):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "DEFINES", ())
    _build._lib_path(name).with_suffix(".log").write_text("Used 168 "
                                                         "registers")
    assert _build.ptxas_report(name) == "Used 168 registers"
    monkeypatch.setattr(_build, "DEFINES", ("-DPTF_DKV_STAGES=3",))
    assert _build.ptxas_report(name) == ""


@pytest.mark.parametrize("variant", flash_probe.VARIANTS, ids=str)
@pytest.mark.parametrize("head_dim", [64, 128])
def test_every_sweep_variant_fits_shared_memory(variant, head_dim):
    fwd, dkv, dq = flash_probe.smem_bytes(variant, head_dim)
    assert 0 < fwd <= flash_probe.SMEM_LIMIT
    assert 0 < dkv <= flash_probe.SMEM_LIMIT
    assert 0 < dq <= flash_probe.SMEM_LIMIT
    keys, fwd_stages, dkv_stages, dq_stages = variant
    assert keys % 64 == 0 and fwd_stages >= 2 and dkv_stages >= 2
    assert dq_stages >= 2


def test_sweep_variants_are_distinct_and_the_default_comes_first():
    """The first variant is what the sources build when no ``-D`` flag is
    given (their ``#define`` defaults)."""
    assert len(set(flash_probe.VARIANTS)) == len(flash_probe.VARIANTS)
    text = "".join((_build._CSRC / f"{n}.cu").read_text()
                   for n in FLASH_SOURCES)
    macros = ("PTF_FWD_KEYS", "PTF_FWD_STAGES", "PTF_DKV_STAGES",
              "PTF_DQ_STAGES")
    assert flash_probe.MACROS == macros
    default = tuple(int(re.search(rf"#define {m} (\d+)", text)[1])
                    for m in macros)
    assert flash_probe.VARIANTS[0] == default
    assert flash_probe.defines(default) == tuple(
        f"-D{m}={x}" for m, x in zip(macros, default))


@pytest.mark.parametrize("ablation", flash_probe.ABLATIONS,
                         ids=[a[0] for a in flash_probe.ABLATIONS])
def test_every_ablation_finds_the_step_it_takes_out(ablation):
    name, src, text, repl = ablation
    assert (_build._CSRC / src).read_text().count(text) == 1
    assert repl != text


@pytest.mark.parametrize("argv", [[], ["bogus"], ["times"], ["sweep"],
                                  ["ablate"], ["steps"], ["ab"],
                                  ["ab", "."]])
def test_probe_needs_a_subcommand_and_a_card(argv, capsys):
    # on the CPU every call stops before measuring anything
    assert flash_probe.main(argv) == 2
    assert capsys.readouterr().err


@pytest.mark.parametrize("head_dim", [64, 128])
def test_dq_shared_memory_per_stage(head_dim):
    """dQ's plan: the block's q and dO tiles (128 rows each) and the two
    consumers' [64][64] bf16 dS tiles once, and per ring stage a 64-key K
    and V tile with their int32 segment ids; up to 4 stages fit at
    head_dim 128, 5 do not."""
    def dq(stages):
        return flash_probe.smem_bytes((64, 4, 3, stages), head_dim)[2]
    per_stage = 2 * 64 * head_dim * 2 + 64 * 4
    assert dq(3) == 1024 + 2 * 128 * head_dim * 2 + 2 * 8192 + 3 * per_stage
    assert dq(4) - dq(3) == per_stage
    assert dq(4) <= flash_probe.SMEM_LIMIT
    if head_dim == 128:
        assert dq(5) > flash_probe.SMEM_LIMIT


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("head_dim", [2, 8, 16, 24, 64, 96, 128, 256])
def test_rope_instance_is_vector_where_half_a_row_is_whole_chunks(dtype,
                                                                   head_dim):
    width = 16 // torch.empty((), dtype=dtype).element_size()
    aligned = [4096, 8192, 0, 16, 32, 1 << 20]
    want = "vector" if (head_dim // 2) % width == 0 else "scalar"
    assert k6.rope_instance(dtype, head_dim, aligned) == want


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("which", range(6))
def test_rope_instance_is_scalar_for_any_unaligned_pointer(dtype, which):
    ptrs = [4096, 8192, 0, 16, 32, 1 << 20]
    assert k6.rope_instance(dtype, 128, ptrs) == "vector"
    ptrs[which] += torch.empty((), dtype=dtype).element_size()
    assert k6.rope_instance(dtype, 128, ptrs) == "scalar"


def test_rope_refuses_cpu_tensors_before_choosing_or_counting():
    before = (k6.launches, k6.launches_vec)
    q = torch.zeros(1, 128, 256)
    with pytest.raises(ValueError, match="CUDA"):
        k6.rope(q, q, torch.zeros(128, 128), torch.zeros(128, 128), 2, 2)
    assert (k6.launches, k6.launches_vec) == before
