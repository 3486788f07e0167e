"""AdamW with gradient clipping and a cosine schedule: the port of
`repro/optim/adamw.py`.

Trees are nested dicts of tensors, walked in sorted key order (the
reference's pytree order). The state is the reference's {m, v, step}:
moments in f32 or bf16 (`moment_dtype`), step an int32 scalar on the
parameters' device. Every scalar of the update (the learning rate, the
clip scale, the bias corrections) is a device tensor computed in f32 as
there, so a step reads nothing back to the host.

`adamw_update` and `apply_updates` are the reference's functions and
leave their inputs as they were. `adamw_step_` is the same update done in
place, the memory of the reference's donated jit step: each leaf's
moments and parameters are overwritten as soon as its update is known,
so no second copy of the parameters or moments exists.

`global_norm` and `adamw_step_` also take trees of DTensors (the sharded
train step's, `launch/steps.py`): params, moments and gradients share
placements, so each rank updates its own blocks (`to_local()` views)
element by element as the unsharded step does. The norm sums each
leaf's local squares in the unsharded leaf order, counts a leaf
replicated over a mesh axis once (on the rank at coordinate 0 of that
axis), and all-reduces the vector of per-leaf sums over the mesh; on
one rank every number is the unsharded one bit for bit.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Iterator

import torch

from repro_torch.runtime.dtensor import (is_dtensor, mesh_all_reduce,
                                         wrap_local)

_MOMENT_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    moment_dtype: str = "float32"


def tree_items(tree: dict, prefix: str = "") -> Iterator[tuple[str, object]]:
    """(dotted key, leaf) in sorted key order."""
    for k in sorted(tree):
        v = tree[k]
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            yield from tree_items(v, key + ".")
        else:
            yield key, v


def tree_rebuild(tree: dict, flat: dict, prefix: str = "") -> dict:
    """`tree`'s structure with the leaves of `flat` (dotted keys)."""
    return {k: tree_rebuild(v, flat, f"{prefix}{k}.") if isinstance(v, dict)
            else flat[f"{prefix}{k}"] for k, v in tree.items()}


def tree_get(tree: dict, key: str):
    """The subtree or leaf at dotted `key`."""
    for k in key.split("."):
        tree = tree[k]
    return tree


def tree_map(fn, tree: dict, *rest: dict) -> dict:
    return {k: tree_map(fn, v, *(r[k] for r in rest)) if isinstance(v, dict)
            else fn(v, *(r[k] for r in rest)) for k, v in tree.items()}


def cosine_schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warm-up, then a cosine to 0 at `total_steps`; step: f32."""
    warm = torch.clamp_max(step / max(cfg.warmup_steps, 1), 1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    return cfg.lr * warm * 0.5 * (1.0 + torch.cos(math.pi * prog))


def _local(t: torch.Tensor) -> torch.Tensor:
    return t.to_local() if is_dtensor(t) else t


def _counted_once(t) -> bool:
    """Whether this rank counts DTensor `t`'s block in a sum over the
    mesh: it sits at coordinate 0 of every axis `t` is replicated over."""
    coord = t.device_mesh.get_coordinate()
    return all(c == 0 for c, pl in zip(coord, t.placements)
               if pl.is_replicate())


def global_norm(tree: dict) -> torch.Tensor:
    leaves = [x for _, x in tree_items(tree)]
    if not any(is_dtensor(x) for x in leaves):
        return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                              for x in leaves))
    sums = torch.stack([
        torch.sum(torch.square(x.to_local().float())) if _counted_once(x)
        else torch.zeros((), dtype=torch.float32, device=x.device)
        for x in leaves])
    mesh_all_reduce(sums, leaves[0].device_mesh)
    return torch.sqrt(sum(sums.unbind(0)))


def adamw_init(params: dict, cfg: AdamWConfig) -> dict:
    mdtype = _MOMENT_DTYPES[cfg.moment_dtype]
    device = next(tree_items(params))[1].device

    def zeros(p):
        return torch.zeros(p.shape, dtype=mdtype, device=p.device)

    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def _scalars(grads: dict, step: torch.Tensor, cfg: AdamWConfig):
    """(lr, clip scale, 1 - b1^t, 1 - b2^t) at the new step t, in f32."""
    t = step.float()
    gnorm = global_norm(grads)
    clip = torch.full((), cfg.grad_clip, dtype=torch.float32,
                      device=gnorm.device)
    scale = torch.clamp_max(clip / torch.clamp_min(gnorm, 1e-12), 1.0)
    return (cosine_schedule(cfg, t), scale, 1 - torch.pow(cfg.b1, t),
            1 - torch.pow(cfg.b2, t))


def _leaf(g, m, v, p, cfg: AdamWConfig, lr, scale, bc1, bc2):
    """One leaf's update (in p's dtype) and its new f32 moments, rounded
    as the reference's expressions round, with few temporaries."""
    gf = g.float() * scale
    m_new = m.float() * cfg.b1
    m_new += gf * (1 - cfg.b1)
    v_new = v.float() * cfg.b2
    sq = gf * (1 - cfg.b2)
    sq *= gf
    del gf
    v_new += sq
    del sq
    delta = m_new / bc1
    den = v_new / bc2
    den.sqrt_().add_(cfg.eps)
    delta.div_(den)
    del den
    delta += cfg.weight_decay * p.float()
    return delta.mul_(-lr).to(p.dtype), m_new, v_new


def adamw_update(grads: dict, state: dict, params: dict, cfg: AdamWConfig,
                 ) -> tuple[dict, dict]:
    """-> (updates, new state), as the reference; nothing is written."""
    step = state["step"] + 1
    lr, scale, bc1, bc2 = _scalars(grads, step, cfg)
    out = tree_map(lambda g, m, v, p: _leaf(g, m, v, p, cfg, lr, scale, bc1,
                                            bc2),
                   grads, state["m"], state["v"], params)

    def pick(i, like):
        return tree_map(lambda t, x: t[i].to(x.dtype), out, like)

    return pick(0, params), {"m": pick(1, state["m"]),
                             "v": pick(2, state["v"]), "step": step}


def apply_updates(params: dict, updates: dict) -> dict:
    return tree_map(lambda p, u: p + u.to(p.dtype), params, updates)


@torch.no_grad()
def adamw_step_(params: dict, grads: dict, state: dict,
                cfg: AdamWConfig) -> dict:
    """`adamw_update` then `apply_updates`, in place: params, m and v are
    overwritten leaf by leaf. Returns the state with the new step."""
    step = _local(state["step"]) + 1
    lr, scale, bc1, bc2 = _scalars(grads, step, cfg)
    m_tree, v_tree = dict(tree_items(state["m"])), dict(tree_items(state["v"]))
    g_tree = dict(tree_items(grads))
    for key, p in tree_items(params):
        m, v, p = _local(m_tree[key]), _local(v_tree[key]), _local(p)
        upd, m_new, v_new = _leaf(_local(g_tree[key]), m, v, p, cfg, lr,
                                  scale, bc1, bc2)
        m.copy_(m_new)
        v.copy_(v_new)
        p.add_(upd)
    if is_dtensor(state["step"]):
        old = state["step"]
        step = wrap_local(step, old.device_mesh, old.placements, old.shape)
    return {"m": state["m"], "v": state["v"], "step": step}
