"""The pure Python around the serving kernels K8 and K9, on the CPU.

What the wrappers decide before a launch, without a card: which K9
instance a call takes (``prefill_instance``: the tensor-core one for bf16
queries over a bf16 cache, or an int8 cache fed bf16 rows, at head_dim
64/128; the CUDA-core one otherwise), how large K8's and the K9
tensor-core instance's merge workspaces and ticket arrays are, and that
one buffer is kept per device and size.  The kernels themselves are held
against their plain versions on the card (``test_torch_kernels_cuda.py``,
``chip_smoke.py``).
"""
import pytest
import torch

from paddle_tpu_torch.ops import paged_attention_cuda as k8
from paddle_tpu_torch.ops import prefill_attention_cuda as k9

BF, F32, F16, I8 = torch.bfloat16, torch.float32, torch.float16, torch.int8


@pytest.mark.parametrize("q_dt,new_dt,cache_dt,d,want", [
    (BF, BF, BF, 128, "mma"),          # the serving path, bf16 KV
    (BF, BF, I8, 128, "mma"),          # int8 KV, bf16 rows quantized
    (BF, BF, BF, 64, "mma"),
    (BF, F32, BF, 128, "mma"),         # rows rounded to the cache dtype
    (BF, F32, I8, 128, "simt"),        # f32 rows quantize from f32
    (BF, BF, BF, 256, "simt"),         # registers: no 256 instance
    (BF, BF, BF, 96, "simt"),
    (BF, BF, F32, 128, "simt"),
    (BF, BF, F16, 128, "simt"),
    (F32, F32, F32, 128, "simt"),      # phase 4's f32 parity
    (F32, F32, I8, 128, "simt"),
    (F16, F16, F16, 128, "simt"),
])
def test_prefill_instance_follows_dtypes_and_head_dim(q_dt, new_dt,
                                                      cache_dt, d, want):
    assert k9.prefill_instance(q_dt, new_dt, cache_dt, d) == want


def test_decode_workspace_numel():
    # the serving geometry: B 8, Hkv 4, G*T 4, D 128, lmax 2048 = 32 spans
    # of 64 keys, each with 4 partial rows; one ticket per (row, head)
    assert k8._SPLIT == 64
    assert k8.workspace_numel(8, 4, 4, 128, 2048) == (8 * 4 * 32 * 4, 8 * 4)
    # a span count rounds up; 17 query rows are two groups of 16
    assert k8.workspace_numel(2, 3, 17, 64, 100) == (2 * 3 * 2 * 17,
                                                     2 * 3 * 2)


def test_prefill_mma_workspace_numel():
    # T 256, G 4, Hkv 4: 16 row tiles of 64 a head, two CTAs a tile
    assert k9.mma_workspace_numel(4, 1024, 128) == (4 * 16 * 2 * 64, 4 * 16)
    # a ragged last tile still takes a whole one
    assert k9.mma_workspace_numel(2, 65, 64) == (2 * 2 * 2 * 64, 2 * 2)


def test_workspace_is_cached_per_size(monkeypatch):
    monkeypatch.setattr(k8, "_WORKSPACES", {})
    cpu = torch.device("cpu")
    n_rows, n_t = k8.workspace_numel(8, 4, 4, 128, 2048)
    acc, ml, tickets = k8.workspace(cpu, n_rows, 128, n_t)
    assert acc.numel() == n_rows * 128 and ml.numel() == n_rows * 2
    assert acc.dtype == ml.dtype == torch.float32
    assert tickets.dtype == torch.int32 and tickets.numel() == n_t
    assert not tickets.any()                 # the kernels leave them at 0
    again = k8.workspace(cpu, n_rows, 128, n_t)
    assert all(a is b for a, b in zip(again, (acc, ml, tickets)))
    n9, t9 = k9.mma_workspace_numel(4, 1024, 128)
    other = k8.workspace(cpu, n9, 128, t9)
    assert other[0].data_ptr() != acc.data_ptr()
    assert len(k8._WORKSPACES) == 2


def test_cpu_tensors_take_the_plain_versions_and_count_no_launch():
    """A CPU call runs the plain version: the launch counters of both
    instances stay where they were."""
    from paddle_tpu_torch.ops import decode_attention as tda

    gen = torch.Generator().manual_seed(0)
    kc, vc = tda.init_kv_cache(2, 64, 1, 64, "bfloat16", device="cpu")
    q = torch.randn(1, 32, 2, 64, generator=gen).to(BF)
    kn = torch.randn(1, 32, 1, 64, generator=gen).to(BF)
    before = (k9.launches, k9.launches_mma, k9.plain_runs)
    out, _, _ = tda.slot_prefill_attention(q, kn, kn, kc, vc, 1, 0,
                                           chunk_size=32)
    assert out.shape == q.shape and out.dtype == BF
    assert (k9.launches, k9.launches_mma) == before[:2]
    assert k9.plain_runs == before[2] + 1
