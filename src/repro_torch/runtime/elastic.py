"""Elastic scaling: rebuild the mesh at a new size and reshard the state;
the port of `repro/runtime/elastic.py`.

On a real cluster this runs when the scheduler grows or shrinks the job,
or when Carbon Responder's DR schedule changes the chip budget: the fleet
coordinator calls `resize` when a training workload's power allocation
drops. The flow:

  1. snapshot the state to host memory (`dtensor.gather_tree`; a
     checkpoint does the same),
  2. build the new mesh from the surviving processes
     (`mesh_from_devices`),
  3. re-derive the placements from the same partition rules on it,
  4. place the snapshot's blocks on it (`sharding.distribute_tree`),
  5. build the sharded step for the new mesh
     (`launch/steps.make_sharded_train_step`).

SPMD, as every model mesh of the port: every process of the default
group calls `mesh_from_devices`, `build` and `resize` (creating a mesh is
collective over the group). A process outside the new mesh holds no
state afterwards: its `ElasticState` has `member=False`, trees of `meta`
tensors (the shapes alone) and no step. A process that joins the mesh
(a grow) receives the snapshot by a broadcast from the old mesh's first
rank.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch
import torch.distributed as dist

from repro_torch.configs.base import ArchConfig
from repro_torch.launch import sharding as sh
from repro_torch.launch.mesh import MODEL_AXES, model_mesh
from repro_torch.launch.steps import make_sharded_train_step
from repro_torch.optim.adamw import (AdamWConfig, tree_get, tree_items,
                                     tree_rebuild)
from repro_torch.runtime import dtensor as dt


def mesh_from_devices(devices, data: int, model: int,
                      device_type: str = "cuda"):
    """A (data, model) `("data", "model")` mesh over `devices`, ranks of
    the default group, row-major. `ValueError` when data x model is not
    the number of ranks given."""
    return model_mesh(devices, (data, model), MODEL_AXES, device_type)


@dataclasses.dataclass
class ElasticState:
    mesh: Any
    params: Any
    opt_state: Any
    step_fn: Callable | None
    member: bool = True


def _opt_specs(pspecs: dict) -> dict:
    return {"m": pspecs, "v": pspecs, "step": ()}


def build(cfg: ArchConfig, mesh, params: dict, opt_state: dict,
          opt_cfg: AdamWConfig = AdamWConfig(),
          policy: sh.ShardingPolicy = sh.ShardingPolicy()) -> ElasticState:
    """Place full `params` and `opt_state` (the same on every process,
    any device) on `mesh` by the legalized rules, with the sharded step.
    On a process outside the mesh: `member=False`, no state."""
    pspecs = sh.legalize(params, sh.param_specs(params, policy), mesh)
    placed = sh.distribute_tree(params, pspecs, mesh)
    opt = sh.distribute_tree(opt_state, _opt_specs(pspecs), mesh)
    if not dt.is_member(mesh):
        return ElasticState(mesh=mesh, params=placed, opt_state=opt,
                            step_fn=None, member=False)
    step = make_sharded_train_step(cfg, opt_cfg, mesh, pspecs)
    return ElasticState(mesh=mesh, params=placed, opt_state=opt,
                        step_fn=step)


def _broadcast(tree: dict | None, like: dict, src: int, device) -> dict:
    """The host tree `tree` of rank `src` on every process of the default
    group (`like` gives the shapes where `tree` is None)."""
    out = {}
    for key, t in tree_items(like):
        buf = (tree_get(tree, key).to(device) if tree is not None
               else torch.empty(t.shape, dtype=t.dtype, device=device))
        dist.broadcast(buf, src=src)
        out[key] = buf.cpu()
    return tree_rebuild(like, out)


def resize(state: ElasticState, cfg: ArchConfig, new_mesh,
           opt_cfg: AdamWConfig = AdamWConfig(),
           policy: sh.ShardingPolicy = sh.ShardingPolicy(),
           snapshot: tuple[dict, dict] | None = None) -> ElasticState:
    """Reshard live state onto `new_mesh` (grow or shrink); parameter and
    moment values are preserved exactly. The state is gathered to the
    host and placed on the new mesh; the returned state says whether
    this process is in it (`member`).

    `snapshot`, which the reference's `resize` lacks, saves a second
    gather of the whole state: a caller that already holds
    `dtensor.gather_tree` of (params, opt_state) at this step (to
    checkpoint or check it) passes it, and `resize` places it as it is."""
    if snapshot is None and state.member:
        snapshot = (dt.gather_tree(state.params),
                    dt.gather_tree(state.opt_state))
    old = [int(r) for r in state.mesh.mesh.flatten().tolist()]
    new = [int(r) for r in new_mesh.mesh.flatten().tolist()]
    if any(r not in old for r in new):
        device = dt.mesh_device(new_mesh)
        like = {"p": state.params, "o": state.opt_state}
        got = _broadcast(None if snapshot is None
                         else {"p": snapshot[0], "o": snapshot[1]},
                         like, old[0], device)
        snapshot = (got["p"], got["o"])
    if snapshot is None:            # outside both meshes
        return build(cfg, new_mesh, state.params, state.opt_state, opt_cfg,
                     policy)
    return build(cfg, new_mesh, snapshot[0], snapshot[1], opt_cfg, policy)
