"""Tensor-parallel sharding for the serving hot path (Megatron over
``torch.distributed``).

Counterpart of ``paddle_tpu/serving/sharding.py``.  The reference made
mesh parallelism a PLACEMENT decision: a ``PartitionSpec`` per
parameter, and GSPMD inserted the collectives into re-jitted programs.
The port follows PyTorch's idiom instead: one process per rank, each
holding its own shard of every weight as a plain local tensor, and the
decode step (``models/llama_decode.py``) calls the one collective
Megatron needs itself — an all-reduce of the row-parallel partial
product before each residual add.  The kernels (K8, K9) then run
unchanged on local tensors at the shard's head count.  There is no
counterpart of ``TPPrograms`` / ``serving_tp_programs``: eager PyTorch
has no programs to re-jit, so the engine calls the same serving
functions with the rank's shards and its process group.

* ``match_partition_rules(rules, params)``: a regex -> spec table applied
  to the "/"-joined path of every leaf of the decode params dict
  (``layers/3/wq``, ``_rope/0``).  The first match wins; scalar and
  size-1 leaves replicate (``()``); an unmatched non-scalar raises —
  silent replication of a 30B weight is the out-of-memory this module
  exists to prevent.  A spec is a tuple with one entry a dimension:
  ``None`` (whole) or the tensor-parallel axis name (split N ways);
  ``()`` replicates.
* ``llama_tp_rules(axis)``: attention q/k/v and the MLP gate/up are
  COLUMN-parallel (output features split), the return projections
  wo/down ROW-parallel (input features split, so each rank holds exactly
  the rows its column-parallel producer computed and one all-reduce per
  projection rejoins them); embeddings, norms, ``lm_head`` and the rope
  tables replicate, so every rank computes the same logits and picks the
  same tokens — the host scheduler stays mesh-oblivious.
* ``kv_cache_pspec`` / ``kv_scale_pspec``: the KV cache ``[B, Lmax, Hkv,
  D]`` (or pool ``[N, C, Hkv, D]``) and its int8 scale leaf split on the
  head axis: each rank allocates and reads only its ``Hkv / N`` heads
  (``serving/kv_cache.py``).
* ``shard_decode_params(params, rank, n)``: this rank's shard, sliced
  where the weights live (a model too large for one card stays on the
  CPU) and only then moved to the rank's device.
* ``tp_coords(mesh, axis)``: ``(group, rank, n)`` of a
  ``torch.distributed.device_mesh.DeviceMesh`` dimension, validated.
"""
from __future__ import annotations

import re

import torch

__all__ = ["match_partition_rules", "llama_tp_rules", "kv_cache_pspec",
           "kv_scale_pspec", "shard_decode_params", "tp_coords"]


def _map(fn, tree, *rest, path=()):
    """``tree`` with every leaf replaced by ``fn("a/b/c", leaf, *others)``,
    where ``rest`` are trees of the same containers whose entries at the
    leaf's position ride along (a spec tree's tuple leaves included)."""
    if isinstance(tree, dict):
        return {k: _map(fn, v, *(r[k] for r in rest), path=path + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v, *(r[i] for r in rest),
                               path=path + (str(i),))
                          for i, v in enumerate(tree))
    return fn("/".join(path), tree, *rest)


def match_partition_rules(rules, params):
    """Map ``rules`` — an ordered ``(regex, spec)`` table — over a params
    tree, returning the matching spec tree (``re.search`` on each leaf's
    "/"-joined path; the FIRST matching rule wins).  Scalar and size-1
    leaves short-circuit to ``()``; a non-scalar leaf no rule matches
    raises ``ValueError``."""
    def spec_of(name, leaf):
        shape = tuple(getattr(leaf, "shape", ()))
        n = 1
        for s in shape:
            n *= int(s)
        if len(shape) == 0 or n == 1:
            return ()
        for rule, spec in rules:
            if re.search(rule, name):
                return spec
        raise ValueError(f"no partition rule matched param {name!r} "
                         f"with shape {shape}")
    return _map(spec_of, params)


def llama_tp_rules(axis="mp"):
    """Megatron-style tensor-parallel rules for the llama decode params
    (the module docstring has the column/row-parallel rationale)."""
    return (
        # int8 weight scales (quantize_decode_weights): a column-parallel
        # weight's [out] scale shards with its output features; a
        # row-parallel weight's scale multiplies the all-reduced product,
        # so every rank needs the whole vector — replicate
        (r"(^|/)(wq|wk|wv|gate|up)_scale$", (axis,)),
        (r"(^|/)(wo|down)_scale$", ()),
        # column-parallel: split output features across the ranks
        (r"(^|/)(wq|wk|wv|gate|up)$", (None, axis)),
        # row-parallel: split input features; an all-reduce rejoins them
        (r"(^|/)(wo|down)$", (axis, None)),
        # small + host-facing: replicate (keeps sampled tokens replicated)
        (r"(^|/)(embed|norm|lm_head|ln1|ln2)$", ()),
        (r"(^|/)_rope($|/)", ()),
    )


def kv_cache_pspec(axis="mp"):
    """KV cache ``[B, Lmax, Hkv, D]`` (pool ``[N, C, Hkv, D]``) split on
    the head axis."""
    return (None, None, axis, None)


def kv_scale_pspec(axis="mp"):
    """int8-cache scale leaf ``[B, Lmax, Hkv]`` / ``[N, C, Hkv]`` split on
    the head axis — the data spec minus ``D``, so each rank holds exactly
    the scales of its own heads."""
    return (None, None, axis)


def _tp_geometry_check(params, n, axis):
    """Every split dimension must divide by ``n``: fail loudly at engine
    construction rather than pad or drop rows."""
    specs = match_partition_rules(llama_tp_rules(axis), params)
    bad = []

    def chk(name, leaf, spec):
        for dim, ax in enumerate(spec):
            if ax is not None and int(leaf.shape[dim]) % n:
                bad.append(f"{name} dim {dim} ({leaf.shape[dim]} % {n} "
                           "!= 0)")
    _map(chk, params, specs)
    if bad:
        raise ValueError(
            f"model not shardable {n}-way along mesh axis {axis!r}: "
            + "; ".join(bad))
    return specs


def shard_decode_params(params, rank, n, axis="mp", device=None):
    """Rank ``rank`` of ``n``'s shard of the decode params under the
    llama TP rules (validated for divisibility).  Returns ``(shard,
    specs)``: every split leaf is narrowed to the rank's contiguous block
    where it lives, made contiguous there, and only then moved to
    ``device`` (default: where it lives); replicated leaves are moved
    whole.  A model too large for one card can therefore stay on the
    CPU, and each rank copies only its shard to its card.  Quantize
    BEFORE sharding: a row-parallel weight's per-output-channel scale
    reduces over the whole input axis."""
    rank, n = int(rank), int(n)
    if not 0 <= rank < n:
        raise ValueError(f"shard_decode_params: rank {rank} not in "
                         f"[0, {n})")
    specs = _tp_geometry_check(params, n, axis)

    def shard(name, x, spec):
        dev = x.device if device is None else torch.device(device)
        for dim, ax in enumerate(spec):
            if ax is not None:
                size = x.shape[dim] // n
                x = x.narrow(dim, rank * size, size).contiguous()
        return x.to(dev)
    return _map(shard, params, specs), specs


def tp_coords(mesh, axis="mp"):
    """``(group, rank, n)`` of ``mesh``'s dimension ``axis``: the process
    group every collective of the decode step runs over, this process's
    rank in it and its size.  ``mesh`` must be a
    ``torch.distributed.device_mesh.DeviceMesh`` whose dimension names
    hold ``axis``, over an initialized default process group."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    if not isinstance(mesh, DeviceMesh):
        raise TypeError(
            f"mesh must be a torch.distributed.device_mesh.DeviceMesh, got "
            f"{type(mesh).__name__}")
    names = tuple(mesh.mesh_dim_names or ())
    if axis not in names:
        raise ValueError(f"mesh has no axis {axis!r} (axes: {names})")
    if not dist.is_available() or not dist.is_initialized():
        raise ValueError(
            "mesh: torch.distributed has no initialized process group — "
            "call torch.distributed.init_process_group (every rank) "
            "before building the engine")
    return (mesh.get_group(axis), int(mesh.get_local_rank(axis)),
            int(mesh.size(names.index(axis))))
