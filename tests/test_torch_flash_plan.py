"""The Python around the flash kernels' wgmma instances, on the CPU.

The kernels themselves run only on the card (``test_torch_kernels_cuda.py``
holds them against their plain versions there).  What runs here: which
instance a call takes, how the wrappers count and report launches, how the
tile sweep names its builds (``_build`` digests with ``-D`` flags, the
ptxas log of the library in use), the sweep's shared-memory plan, and
that every ablation of ``flash_probe.py`` still finds its step.
"""
import re

import pytest
import torch

import flash_probe
from paddle_tpu_torch.ops import _build
from paddle_tpu_torch.ops import flash_attention_cuda as kfa

DTYPES = [torch.float32, torch.bfloat16, torch.float16]
FLASH_SOURCES = ("flash_attention_fwd", "flash_attention_bwd")


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("head_dim", kfa.HEAD_DIMS)
def test_instance_is_wgmma_for_bf16_at_64_and_128(dtype, head_dim):
    want = "wgmma" if dtype == torch.bfloat16 and head_dim in (64, 128) \
        else "simt"
    assert kfa.flash_instance(dtype, head_dim) == want


def test_every_forward_and_dkv_counter_has_a_wgmma_twin():
    for kernel in ("fwd", "dkv"):
        for tag in ("", "_seg", "_rope"):
            assert kernel + tag + "_wgmma" in kfa.launches
    for kernel in ("delta", "dq", "dq_seg", "dq_rope"):
        assert kernel + "_wgmma" not in kfa.launches


@pytest.mark.parametrize("wgmma", [False, True])
@pytest.mark.parametrize("kernel", ["fwd", "fwd_seg", "dkv_rope"])
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
    fwd, dkv = flash_probe.smem_bytes(variant, head_dim)
    assert 0 < fwd <= flash_probe.SMEM_LIMIT
    assert 0 < dkv <= flash_probe.SMEM_LIMIT
    keys, fwd_stages, dkv_stages = variant
    assert keys % 64 == 0 and fwd_stages >= 2 and dkv_stages >= 2


def test_sweep_variants_are_distinct_and_the_default_comes_first():
    """The first variant is what the sources build when no ``-D`` flag is
    given (their ``#define`` defaults)."""
    assert len(set(flash_probe.VARIANTS)) == len(flash_probe.VARIANTS)
    text = "".join((_build._CSRC / f"{n}.cu").read_text()
                   for n in FLASH_SOURCES)
    default = tuple(int(re.search(rf"#define {m} (\d+)", text)[1])
                    for m in ("PTF_FWD_KEYS", "PTF_FWD_STAGES",
                              "PTF_DKV_STAGES"))
    assert flash_probe.VARIANTS[0] == default
    assert flash_probe.defines(default) == tuple(
        f"-D{m}={x}" for m, x in zip(("PTF_FWD_KEYS", "PTF_FWD_STAGES",
                                      "PTF_DKV_STAGES"), default))


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
