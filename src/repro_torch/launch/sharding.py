"""Partition rules for params, optimizer state, batches and caches, and
their placement as DTensors: the port of `repro/launch/sharding.py`.

Baseline strategy (the reference's "what a production fleet runs"):
  * TP ("model"): attention heads / FFN hidden / MoE experts / vocab.
  * FSDP ("data"): the d_model-sized dim of every large weight (ZeRO-style)
    + batch data parallelism.
  * DP ("pod"): pure data parallelism across pods; params replicated,
    gradients all-reduced (where gradient compression applies,
    `runtime/compression.py`).

A spec is the reference's `PartitionSpec` as a tuple: one entry per
tensor dim, each a mesh axis name, a tuple of names or None, so a port
spec compares directly with `tuple(P(...))`. The rules are name-based
over the param tree's path and every leaf gets an explicit spec.

`to_placements(spec, mesh)` maps a spec to one DTensor placement per
mesh dim (`Shard(d)` where the mesh axis shards tensor dim d, else
`Replicate()`), `to_named` a spec tree to `NamedPlacement`s (the mesh
and its placements: the port's `NamedSharding`), `distribute_tree`
places a tree of full tensors as DTensors (`runtime/dtensor.py` holds
the helpers below the rules: blocks, collectives, `gather_tree`). Axis
order on a tensor dim shared by two mesh
axes: the reference tiles the dim row-major over the axes in the spec's
order, DTensor over the mesh dims in the mesh's order. The port keeps
the mesh's order. The two agree for ("data", "model") on a
("data", "model") or ("pod", "data", "model") mesh (the KV caches), not
for `fsdp_pod`'s ("data", "pod") on a ("pod", "data", "model") mesh,
where pod-major blocks land on other ranks; the bytes a rank holds are
the same either way. Place only legalized specs: DTensor takes uneven
shards, the reference replicates a dim its axes do not divide
(`legalize`), and `distribute_tree` raises on a dim that does not divide.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch.launch.mesh import axis_names, axis_sizes, dp_axes
from repro_torch.runtime.dtensor import (is_member, local_slice, mesh_device,
                                         wrap_local)


@dataclasses.dataclass(frozen=True)
class ShardingPolicy:
    """Hillclimb knobs for the §Perf iterations."""
    fsdp_embed: bool = True        # shard embedding d over "data"
    fsdp_weights: bool = True      # ZeRO weight sharding over "data";
                                   # False = replicate + grad all-reduce
                                   # (cheaper collectives when memory allows)
    fsdp_pod: bool = False         # extend FSDP over the pod axis (ZeRO-3)
    seq_shard_prefill: bool = False  # shard prefill sequence over "model"
    expert_axis: str = "model"     # mesh axis for MoE expert parallelism
    ssm_tp: bool = True            # TP-shard fused SSM projections (their
                                   # z/x/B/C/dt concat boundaries misalign
                                   # with shard boundaries -> re-layout
                                   # all-gathers; the §Perf hillclimb turns
                                   # this off)


@dataclasses.dataclass(frozen=True)
class NamedPlacement:
    """Where a leaf lives: a `DeviceMesh` and one DTensor placement per
    mesh dim (the port's `NamedSharding`)."""
    mesh: Any
    placements: tuple


def _map_with_path(fn, tree: dict, path: tuple = ()) -> dict:
    return {k: _map_with_path(fn, v, path + (k,)) if isinstance(v, dict)
            else fn(path + (k,), v) for k, v in tree.items()}


def _map(fn, tree: dict, *rest: dict) -> dict:
    return {k: _map(fn, v, *(r[k] for r in rest)) if isinstance(v, dict)
            else fn(v, *(r[k] for r in rest)) for k, v in tree.items()}


def _replicated(ndim: int) -> tuple:
    return (None,) * ndim


def _leaf_rule(path: str, ndim: int, policy: ShardingPolicy) -> tuple:
    """Spec of a parameter leaf (ignoring any leading stack axes: callers
    prepend Nones)."""
    fsdp = "data" if policy.fsdp_weights else None
    if fsdp and policy.fsdp_pod:
        fsdp = ("data", "pod")    # ZeRO-3 across pods too (legalized away
                                  # on single-pod meshes)
    tp = "model"
    name = path.split("/")[-1]
    parent = path.split("/")[-2] if "/" in path else ""

    # Embeddings: (vocab, d) — vocab over TP, d over FSDP.
    if name == "table":
        return (tp, fsdp if policy.fsdp_embed else None)
    # Norm scales / scalar-ish leaves: replicate.
    if name in ("scale", "A_log", "D", "dt_bias", "b", "conv_b"):
        return _replicated(ndim)
    # MoE stacked experts: (E, d_in, d_out).
    if parent == "moe" and name in ("w_gate", "w_up"):
        return (policy.expert_axis, fsdp, None)
    if parent == "moe" and name == "w_down":
        return (policy.expert_axis, None, fsdp)
    if parent == "router":
        return (fsdp, None)
    # SSM fused projections: TP only when ssm_tp (see policy docstring).
    if parent == "in_proj":
        return (fsdp, tp if policy.ssm_tp else None)
    if parent == "out_proj":
        return (tp if policy.ssm_tp else None, fsdp)
    # Projections whose OUTPUT is the TP dim.
    if parent in ("wq", "wk", "wv", "wuq", "wuk", "wuv", "w_gate", "w_up"):
        return (fsdp, tp)
    # Projections whose INPUT is the TP dim.
    if parent in ("wo", "w_down"):
        return (tp, fsdp)
    # Low-rank/latent projections (MLA down-projections), small dense maps.
    if parent in ("wdq", "wdkv", "wkr", "proj"):
        return (fsdp, None)
    if name == "conv_w":
        return (None, tp if policy.ssm_tp else None)
    return _replicated(ndim)


STACKS = ("blocks", "dec_blocks", "enc_blocks")


def param_specs(params_shape: dict, policy: ShardingPolicy = ShardingPolicy(),
                ) -> dict:
    """A params (shape-)tree -> its spec tree; the leaves of a stack
    (`blocks`, `enc_blocks`, `dec_blocks`) get a leading None for the
    layer axis."""

    def visit(names, leaf) -> tuple:
        ndim = len(leaf.shape)
        stacked = any(n in STACKS for n in names)
        spec = _leaf_rule("/".join(names), ndim - (1 if stacked else 0),
                          policy)
        if stacked:
            spec = (None,) + spec
        spec = spec[:ndim]
        return spec + (None,) * (ndim - len(spec))

    return _map_with_path(visit, params_shape)


def _dp_spec(mesh):
    dp = dp_axes(mesh)
    return dp if len(dp) > 1 else dp[0]


def _dp_size(mesh) -> int:
    sizes = axis_sizes(mesh)
    return math.prod(sizes[a] for a in dp_axes(mesh))


def batch_specs(batch_shape: dict, mesh) -> dict:
    """Specs of a train/prefill input batch: rows over the dp axes."""
    dp = _dp_spec(mesh)

    def visit(names, leaf) -> tuple:
        ndim = len(leaf.shape)
        if names[-1] == "mrope_positions":     # (3, B, S)
            return (None, dp, None)
        if leaf.shape[0] == 1:                 # un-shardable batch of 1
            return _replicated(ndim)
        return (dp,) + (None,) * (ndim - 1)

    return _map_with_path(visit, batch_shape)


def cache_specs(cache_shape: dict, mesh, batch: int) -> dict:
    """Specs of decode caches.

    KV-like leaves (stacked (G, B, S, ...)): batch over DP when divisible,
    cache length over "model" (decode attention reduces over S). SSM
    states: batch over DP, heads over "model".
    """
    dp = _dp_spec(mesh)
    dp_size = _dp_size(mesh)
    b_axis = dp if batch % dp_size == 0 and batch >= dp_size else None

    def visit(names, leaf) -> tuple:
        name = names[-1]
        ndim = len(leaf.shape)
        if name in ("k", "v", "enc_k", "enc_v",
                    "k_q", "k_s", "v_q", "v_s"):   # (G,B,S,KV,Dh|1)
            if b_axis is None:
                return (None, None, ("data", "model"), None, None)
            return (None, b_axis, "model", None, None)
        if name in ("c_kv", "k_rope"):             # (G,B,S,r)
            if b_axis is None:
                return (None, None, ("data", "model"), None)
            return (None, b_axis, "model", None)
        if name == "h":                            # (G,B,H,Pd,N)
            return (None, b_axis, "model", None, None)
        if name == "conv":                         # (G,B,K-1,convdim)
            return (None, b_axis, None, "model")
        return _replicated(ndim)

    return _map_with_path(visit, cache_shape)


def legalize(shapes: dict, specs: dict, mesh) -> dict:
    """Drop sharding on any dim the mesh axes do not divide evenly (e.g. a
    50280-token vocab over 16 model shards), and axes the mesh lacks (e.g.
    "pod" on a single-pod mesh): that dim is replicated."""
    sizes = axis_sizes(mesh)

    def visit(shape_leaf, spec: tuple) -> tuple:
        dims = shape_leaf.shape
        out = []
        for i, axis in enumerate(tuple(spec)
                                 + (None,) * (len(dims) - len(spec))):
            if axis is None:
                out.append(None)
                continue
            axes = axis if isinstance(axis, tuple) else (axis,)
            if any(a not in sizes for a in axes):
                axes = tuple(a for a in axes if a in sizes)
                if not axes:
                    out.append(None)
                    continue
                axis = axes if len(axes) > 1 else axes[0]
            size = math.prod(sizes[a] for a in axes)
            out.append(axis if dims[i] % size == 0 else None)
        return tuple(out)

    return _map(visit, shapes, specs)


def logits_spec(mesh, batch: int, vocab: int) -> tuple:
    dp = _dp_spec(mesh)
    v_axis = "model" if vocab % axis_sizes(mesh)["model"] == 0 else None
    if batch % _dp_size(mesh) == 0 and batch >= _dp_size(mesh):
        return (dp, None, v_axis)
    return (None, None, v_axis)


# ---------------------------------------------------------------------------
# Placement as DTensors
# ---------------------------------------------------------------------------
def to_placements(spec: tuple, mesh) -> tuple:
    """One placement per mesh dim: `Shard(d)` where the mesh axis appears
    in entry d of `spec`, else `Replicate()`. `ValueError` for an axis the
    mesh lacks (legalize first) or one mesh axis on two tensor dims."""
    from torch.distributed.tensor import Replicate, Shard
    names = axis_names(mesh)
    used = {}
    for d, axis in enumerate(spec):
        for a in (axis if isinstance(axis, tuple) else (axis,)):
            if a is None:
                continue
            if a not in names:
                raise ValueError(f"spec {spec} names axis {a!r}, which the "
                                 f"mesh {names} lacks: legalize it first")
            if a in used:
                raise ValueError(f"spec {spec} puts axis {a!r} on two "
                                 f"tensor dims")
            used[a] = d
    return tuple(Shard(used[a]) if a in used else Replicate()
                 for a in names)


def to_named(specs: dict, mesh) -> dict:
    """A spec tree -> a `NamedPlacement` tree on `mesh`."""
    return _map(lambda s: NamedPlacement(mesh, to_placements(s, mesh)),
                specs)


def distribute_tree(tree: dict, specs: dict, mesh) -> dict:
    """Place a tree of full tensors (the same on every rank, any device)
    on `mesh`: each leaf becomes a DTensor whose local tensor is a fresh
    copy of this rank's block on the mesh's device; no collective. On a
    rank outside the mesh the leaves are `meta` tensors of the full
    shapes: the rank holds no state."""
    if not is_member(mesh):
        return _map(lambda t, s: torch.empty(t.shape, dtype=t.dtype,
                                             device="meta"), tree, specs)
    device = mesh_device(mesh)

    def place(t, spec):
        pl = to_placements(spec, mesh)
        block = local_slice(t, pl, mesh)
        local = torch.empty(block.shape, dtype=t.dtype, device=device)
        local.copy_(block)
        return wrap_local(local, mesh, pl, t.shape)

    return _map(place, tree, specs)


def rule_bytes(shapes: dict, specs: dict, mesh) -> int:
    """Bytes of one rank's blocks of `shapes` under `specs` (legalized) on
    a mesh or mesh-like: each leaf's bytes over the product of the sizes
    of the axes that shard it."""
    sizes = axis_sizes(mesh)
    total = 0

    def leaf(t, spec):
        nonlocal total
        div = 1
        for axis in spec:
            for a in (axis if isinstance(axis, tuple) else (axis,)):
                if a is not None:
                    div *= sizes[a]
        total += t.numel() * t.element_size() // div

    _map(leaf, shapes, specs)
    return total
