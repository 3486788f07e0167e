"""Step builders: train / prefill / decode; the port of
`repro/launch/steps.py`.

`make_train_step` returns (params, opt_state, batch) -> (params,
opt_state, loss), the reference's signature; the batch may be numpy (the
data pipeline's) and is moved to the parameters' device. The gradient is
autograd's through `loss_fn`, the reference's `jax.value_and_grad`. The
step updates params and opt_state in place (`adamw_step_`), the memory
of the reference's jit with `donate_argnums=(0, 1)`: 32-layer
stablelm-3b with f32 masters does not fit on one card twice.

`make_sharded_train_step` is the same step over a model mesh, SPMD (one
process a card): params and moments are DTensors placed by the partition
rules (`launch/sharding.py`); the reference leaves the computation to
GSPMD, the port computes so:
  * the batch: the global batch enters whole; each rank takes its rows
    by `batch_specs` (rows over the dp axes) and, where a dp shard's rows
    divide by "model", its "model" share of them (a local slice);
    otherwise the "model" ranks compute the same rows;
  * the weights: each block group's are gathered to full weights at use,
    in their compute dtype, inside the group's checkpoint, so the
    backward pass gathers them again (ZeRO-3; `dtensor.GatherFn`); the
    leaves outside the stacks are gathered once a step;
  * the gradients: each rank's loss is scaled by its share of the global
    rows (the sum over ranks is the global mean), and each weight's
    gradient, a partial sum on every rank, is reduced in f32 to the
    leaf's own blocks (reduce-scatter over a sharded mesh dim, all-reduce
    over a replicated one);
  * AdamW on the local blocks (`adamw_step_` on DTensors).
Activations are not split over "model": that is tensor-parallel compute,
which this step does not do. On a mesh of one process every number is
`make_train_step`'s bit for bit.

`make_step_bundle` gives a train cell's step with the shapes (`meta`
tensors) and placements of its arguments; prefill and decode bundles and
`lower_cell` are ROADMAP item 11b-ii.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch

from repro_torch.configs import input_specs
from repro_torch.configs.base import ArchConfig, ShapeCell, shape_by_name
from repro_torch.launch import sharding as sh
from repro_torch.launch.mesh import axis_names, axis_sizes, dp_axes
from repro_torch.models import encdec
from repro_torch.models import transformer as tf
from repro_torch.optim.adamw import (AdamWConfig, adamw_init, adamw_step_,
                                     tree_get, tree_items, tree_map,
                                     tree_rebuild)
from repro_torch.runtime import dtensor as dt

_NOT_YET = ("prefill and decode bundles and lower_cell are ROADMAP item "
            "11b-ii (not ported yet); make_step_bundle builds train cells")


def model_module(cfg: ArchConfig):
    return encdec if cfg.family == "encdec" else tf


def make_loss_fn(cfg: ArchConfig, use_kernel: bool | None = None,
                 ) -> Callable:
    mod = model_module(cfg)
    return lambda params, batch: mod.loss_fn(params, cfg, batch,
                                             use_kernel=use_kernel)


def _to_device(batch: dict, device: torch.device) -> dict:
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def value_and_grad(loss_fn: Callable, params: dict, batch: dict):
    """(loss, gradient tree) of `loss_fn(params, batch)` by autograd; the
    parameters themselves are left as they were."""
    keys = [k for k, _ in tree_items(params)]
    with torch.enable_grad():
        live = {k: p.detach().requires_grad_() for k, p in tree_items(params)}
        loss = loss_fn(tree_rebuild(params, live), batch)
        grads = torch.autograd.grad(loss, [live[k] for k in keys])
    return loss.detach(), tree_rebuild(params, dict(zip(keys, grads)))


def make_train_step(cfg: ArchConfig, opt_cfg: AdamWConfig,
                    grad_accum: int = 1,
                    use_kernel: bool | None = None) -> Callable:
    """Train step with optional gradient accumulation, updating params
    and opt_state in place: the step's inputs are its outputs.

    grad_accum > 1 splits the global batch into `grad_accum` microbatches
    run one after another, their gradients summed in f32 and averaged,
    as the reference's scan. The loss is read to the host (the step's one
    read) before anything is written: a non-finite loss raises
    `FloatingPointError` and leaves params and opt_state as they were,
    so a runner may retry the step. The loss returned is that float.
    """
    loss_fn = make_loss_fn(cfg, use_kernel)

    def train_step(params, opt_state, batch):
        device = next(tree_items(params))[1].device
        batch = _to_device(batch, device)
        if grad_accum <= 1:
            loss, grads = value_and_grad(loss_fn, params, batch)
        else:
            for v in batch.values():
                assert v.shape[0] % grad_accum == 0, (v.shape[0], grad_accum)
            micro = [{k: v.chunk(grad_accum)[i] for k, v in batch.items()}
                     for i in range(grad_accum)]
            loss = torch.zeros((), dtype=torch.float32, device=device)
            grads = tree_map(lambda p: torch.zeros(p.shape,
                                                   dtype=torch.float32,
                                                   device=device), params)
            for mb in micro:
                loss_i, grads_i = value_and_grad(loss_fn, params, mb)
                loss = loss + loss_i
                grads = tree_map(lambda a, g: a + g, grads, grads_i)
            loss = loss / grad_accum
            grads = tree_map(lambda g: g / grad_accum, grads)
        loss = float(loss)
        if not math.isfinite(loss):
            raise FloatingPointError(f"non-finite loss {loss}: nothing "
                                     f"written")
        return params, adamw_step_(params, grads, opt_state, opt_cfg), loss

    return train_step


def make_prefill_step(cfg: ArchConfig) -> Callable:
    """(params, batch) -> f32 logits: the encoder-decoder's `forward`
    over {frames, tokens}, the decoder's over {tokens[, vision_embeds,
    mrope_positions]}."""
    mod = model_module(cfg)

    def prefill_step(params, batch):
        return mod.forward(params, cfg, batch)

    return prefill_step


def make_decode_step(cfg: ArchConfig) -> Callable:
    mod = model_module(cfg)

    def decode_step(params, cache, token, length):
        return mod.decode_step(params, cfg, cache, token, length)

    return decode_step


# ---------------------------------------------------------------------------
# The model mesh
# ---------------------------------------------------------------------------
def _stacked_view(placements: tuple) -> tuple:
    """Placements of one layer's view of a stacked leaf (the layer axis,
    never sharded, taken away)."""
    from torch.distributed.tensor import Shard
    return tuple(Shard(p.dim - 1) if p.is_shard() else p
                 for p in placements)


def _row_plan(batch: dict, mesh) -> tuple[dict, float]:
    """({key: (dim, start, stop)} of the rows this rank computes, its
    share of the global rows: its rows over the global rows times the
    number of ranks that compute the same rows, so the shares of the
    mesh's ranks sum to 1)."""
    specs = sh.legalize(batch, sh.batch_specs(batch, mesh), mesh)
    sizes = axis_sizes(mesh)
    coord = dict(zip(axis_names(mesh), mesh.get_coordinate()))
    dp = dp_axes(mesh)
    plan = {}
    for key, spec in specs.items():
        dim = 1 if key == "mrope_positions" else 0
        B = batch[key].shape[dim]
        start, n, blocks = 0, B, 1
        if spec[dim] is not None:               # rows over the dp axes
            index = 0
            for a in dp:
                index = index * sizes[a] + coord[a]
            blocks = math.prod(sizes[a] for a in dp)
            n = B // blocks
            start = index * n
        if n % sizes["model"] == 0:             # and over "model"
            n //= sizes["model"]
            start += coord["model"] * n
            blocks *= sizes["model"]
        plan[key] = (dim, start, start + n)
    return plan, n / (B * (mesh.size() // blocks))


def make_sharded_train_step(cfg: ArchConfig, opt_cfg: AdamWConfig, mesh,
                            pspecs: dict) -> Callable:
    """The train step over `mesh` (module docstring): (params, opt_state,
    batch) -> (params, opt_state, loss), params and opt_state DTensor
    trees placed by the legalized `pspecs` (`elastic.build`), updated in
    place; `batch` the global batch (numpy or tensors). The loss is the
    global mean, read to the host on every rank before anything is
    written: a non-finite one raises `FloatingPointError` and leaves the
    state as it was."""
    mod = model_module(cfg)
    placements = tree_map(lambda s: sh.to_placements(s, mesh), pspecs)

    def compute_dtypes(sub: dict) -> dict:
        """The dtypes `compute_params` casts a subtree's leaves to."""
        like = tree_map(lambda t: torch.empty(0, dtype=t.dtype,
                                              device="meta"), sub)
        return tree_map(lambda t: t.dtype, tf.compute_params(like, cfg))

    def gather(path: str, sub: dict) -> dict:
        head = path.split(".")[0]
        pl = tree_get(placements, path)
        if head in sh.STACKS:
            pl = tree_map(_stacked_view, pl)
        return tree_map(lambda t, d, p: dt.GatherFn.apply(t, d, p, mesh), sub,
                        compute_dtypes(sub), pl)

    def train_step(params, opt_state, batch):
        device = dt.mesh_device(mesh)
        plan, share = _row_plan(batch, mesh)
        local = {}
        for k, v in batch.items():
            dim, a, b = plan[k]
            local[k] = torch.as_tensor(v).narrow(dim, a, b - a).to(device)
        keys = [k for k, _ in tree_items(params)]
        flat = dict(tree_items(params))
        with torch.enable_grad():
            live = {k: flat[k].to_local().detach().requires_grad_()
                    for k in keys}
            loss = mod.loss_fn(tree_rebuild(params, live), cfg, local,
                               gather=gather)
            if share != 1:
                loss = loss * share
            grads = torch.autograd.grad(loss, [live[k] for k in keys])
        total = dt.mesh_all_reduce(loss.detach().clone(), mesh)
        value = float(total)
        if not math.isfinite(value):
            raise FloatingPointError(f"non-finite loss {value}: nothing "
                                     f"written")
        gtree = tree_rebuild(params, {
            k: dt.wrap_local(g, mesh, flat[k].placements, flat[k].shape)
            for k, g in zip(keys, grads)})
        return params, adamw_step_(params, gtree, opt_state, opt_cfg), value

    return train_step


@dataclasses.dataclass
class StepBundle:
    """Everything needed to run one (arch × shape × mesh) cell: the step,
    its arguments' shapes (`meta` tensors) and placements
    (`sharding.NamedPlacement` trees). `donate_argnums=(0, 1)`: the step
    updates those arguments in place."""
    fn: Callable
    args_shape: tuple
    in_shardings: tuple
    out_shardings: Any
    donate_argnums: tuple = ()


def params_shape_of(cfg: ArchConfig) -> dict:
    """The param tree on the `meta` device: shapes and dtypes only."""
    return model_module(cfg).init_params(cfg, device="meta")


def make_step_bundle(cfg: ArchConfig, shape: ShapeCell | str, mesh,
                     policy: sh.ShardingPolicy = sh.ShardingPolicy(),
                     opt_cfg: AdamWConfig = AdamWConfig()) -> StepBundle:
    """A train cell's bundle on `mesh` (a `DeviceMesh`; a mesh-like object
    gives the shapes and placements, and a step that cannot run). bf16
    params take bf16 moments, as the reference's. `NotImplementedError`
    for prefill and decode cells (ROADMAP 11b-ii)."""
    if isinstance(shape, str):
        shape = shape_by_name(shape)
    if shape.kind != "train":
        raise NotImplementedError(f"{shape.kind} cell {shape.name!r}: "
                                  f"{_NOT_YET}")
    specs = input_specs(cfg, shape)
    params_shape = params_shape_of(cfg)
    pspecs = sh.legalize(params_shape, sh.param_specs(params_shape, policy),
                         mesh)
    psh = sh.to_named(pspecs, mesh)
    if cfg.param_dtype == "bfloat16":
        opt_cfg = dataclasses.replace(opt_cfg, moment_dtype="bfloat16")
    opt_shape = adamw_init(params_shape, opt_cfg)
    scalar = sh.NamedPlacement(mesh, sh.to_placements((), mesh))
    osh = {"m": psh, "v": psh, "step": scalar}
    bsh = sh.to_named(sh.batch_specs(specs, mesh), mesh)
    return StepBundle(
        fn=make_sharded_train_step(cfg, opt_cfg, mesh, pspecs),
        args_shape=(params_shape, opt_shape, specs),
        in_shardings=(psh, osh, bsh), out_shardings=(psh, osh, scalar),
        donate_argnums=(0, 1))


def lower_cell(cfg: ArchConfig, shape: ShapeCell | str, mesh,
               policy: sh.ShardingPolicy = sh.ShardingPolicy()):
    """The reference lowers a cell for XLA; the port's counterpart is
    ROADMAP item 11b-ii: `NotImplementedError`."""
    raise NotImplementedError(f"lower_cell: {_NOT_YET}")
