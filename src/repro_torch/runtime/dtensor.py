"""DTensor state on a model mesh, apart from the partition rules: this
rank's block of a full tensor and back, the collectives the sharded train
step runs, and the host snapshot of a state tree.

The optimizer (`optim/adamw.py`), the checkpoints (`runtime/checkpoint.py`)
and the elastic resize (`runtime/elastic.py`) work on DTensor trees
through these helpers; the rules that say where each leaf lives are
`launch/sharding.py`'s.

A rank's block: mesh dim 0 splits first, each block then over mesh dim 1,
and so on (DTensor's order; `local_slice`, `gather_full`).

The collectives (`gather_full`, `reduce_to`, `mesh_all_reduce`) are the
port's own, on `torch.distributed`'s c10d calls (`all_gather_into_tensor`,
`reduce_scatter_tensor`, `all_reduce`), which NCCL and gloo take on CUDA
tensors alike; DTensor's own redistribution (functional collectives)
crashed a gloo rank on CUDA tensors (torch 2.11, on the H100 machine).
`COMM` counts the bytes each process sent into them.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

#: Bytes this process handed to the gathers and to the gradient
#: reductions (each rank's own input), since the last reset.
COMM = {"gather_bytes": 0, "reduce_bytes": 0}

def mesh_device(mesh) -> torch.device:
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def is_member(mesh) -> bool:
    """Whether this process holds a coordinate of `mesh`."""
    return mesh.get_coordinate() is not None


def local_slice(full, placements: tuple, mesh):
    """This rank's block of `full` (a tensor or a numpy array) under
    `placements`: mesh dim 0 splits first, each block then over dim 1, and
    so on (DTensor's order). Raises on a dim that does not divide."""
    coord = mesh.get_coordinate()
    sizes = tuple(int(n) for n in mesh.mesh.shape)
    x = full
    for i, pl in enumerate(placements):
        if not pl.is_shard() or sizes[i] == 1:
            continue
        d, n = pl.dim, sizes[i]
        if x.shape[d] % n:
            raise ValueError(
                f"dim {d} of a {tuple(full.shape)} leaf does not divide "
                f"over {n} ranks: legalize the spec first")
        step = x.shape[d] // n
        index = [slice(None)] * len(x.shape)
        index[d] = slice(coord[i] * step, (coord[i] + 1) * step)
        x = x[tuple(index)]
    return x


def wrap_local(local: torch.Tensor, mesh, placements: tuple, shape):
    """A DTensor of global `shape` whose block on this rank is `local`
    (no collective)."""
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(local, mesh, placements, run_check=False,
                              shape=torch.Size(shape),
                              stride=torch.empty(shape,
                                                 device="meta").stride())


def is_dtensor(t) -> bool:
    if not dist.is_available():
        return False
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)


def _sizes(mesh) -> tuple:
    return tuple(int(n) for n in mesh.mesh.shape)


# torch 2.13 renames the c10d calls; the card's torch 2.11 has the old
# names only.
_ALL_GATHER = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor
_REDUCE_SCATTER = getattr(dist, "reduce_scatter_single", None) \
    or dist.reduce_scatter_tensor


def _all_gather(x: torch.Tensor, d: int, group, n: int) -> torch.Tensor:
    x = x.contiguous()
    buf = torch.empty(n * x.numel(), dtype=x.dtype, device=x.device)
    COMM["gather_bytes"] += x.numel() * x.element_size()
    _ALL_GATHER(buf, x.reshape(-1), group=group)
    shape = list(x.shape)
    shape[d] *= n
    return buf.view((n,) + tuple(x.shape)).movedim(0, d).reshape(shape)


def _reduce_scatter(x: torch.Tensor, d: int, group, n: int) -> torch.Tensor:
    shape = list(x.shape)
    shape[d] //= n
    blocks = x.unflatten(d, (n, shape[d])).movedim(d, 0).contiguous()
    out = torch.empty(blocks.numel() // n, dtype=x.dtype, device=x.device)
    COMM["reduce_bytes"] += blocks.numel() * blocks.element_size()
    _REDUCE_SCATTER(out, blocks.reshape(-1), group=group)
    return out.view(shape)


def gather_full(local: torch.Tensor, placements: tuple, mesh
                ) -> torch.Tensor:
    """The full tensor from every rank's block (the inverse of
    `local_slice`): all-gathers over each sharded mesh dim, last dim
    first. Collective over the mesh's ranks."""
    sizes = _sizes(mesh)
    for i in reversed(range(len(placements))):
        pl = placements[i]
        if pl.is_shard() and sizes[i] > 1:
            local = _all_gather(local, pl.dim, mesh.get_group(i), sizes[i])
    return local


def reduce_to(full: torch.Tensor, placements: tuple, mesh) -> torch.Tensor:
    """The sum over the mesh's ranks of `full` (each rank's partial sum),
    in this rank's block of `placements`: a reduce-scatter over each
    sharded mesh dim (dim 0 first, as `local_slice` cuts), an all-reduce
    over each replicated one. Collective over the mesh's ranks."""
    sizes = _sizes(mesh)
    out = full
    for i, pl in enumerate(placements):
        if sizes[i] == 1:
            continue
        if pl.is_shard():
            out = _reduce_scatter(out, pl.dim, mesh.get_group(i), sizes[i])
        else:
            if out is full:
                out = full.clone()
            COMM["reduce_bytes"] += out.numel() * out.element_size()
            dist.all_reduce(out, group=mesh.get_group(i))
    return out


def mesh_all_reduce(t: torch.Tensor, mesh) -> torch.Tensor:
    """Sum `t` in place over every rank of `mesh` (one all-reduce per mesh
    dim of more than one rank)."""
    for i, n in enumerate(_sizes(mesh)):
        if n > 1:
            dist.all_reduce(t, group=mesh.get_group(i))
    return t


class GatherFn(torch.autograd.Function):
    """ZeRO-3's gather at use: this rank's block of a weight, cast to the
    compute dtype, gathered to the full weight; the backward takes the
    full weight's gradient (this rank's partial sum), reduces it in f32
    to this rank's block (`reduce_to`) and returns it in the block's
    dtype. On a mesh of one rank it runs no collective and gives the bits
    of the unsharded model's cast and its gradient."""

    @staticmethod
    def forward(ctx, local, dtype, placements, mesh):
        ctx.placements, ctx.mesh, ctx.dtype = placements, mesh, local.dtype
        return gather_full(local.to(dtype), placements, mesh)

    @staticmethod
    def backward(ctx, grad):
        out = reduce_to(grad.float(), ctx.placements, ctx.mesh)
        return out.to(ctx.dtype), None, None, None


def gather_tree(tree: dict) -> dict:
    """Full host (CPU) tensors of a tree of DTensors (and plain tensors,
    copied to the host). Collective over the leaves' meshes: every rank of
    each mesh calls it."""

    def full(t):
        if is_dtensor(t):
            t = gather_full(t.to_local(), tuple(t.placements), t.device_mesh)
        return t.cpu()

    return {k: gather_tree(v) if isinstance(v, dict) else full(v)
            for k, v in tree.items()}


def state_bytes(tree: dict) -> int:
    """Bytes of this rank's blocks of a tree of DTensors."""
    total = 0
    for v in tree.values():
        if isinstance(v, dict):
            total += state_bytes(v)
        elif is_dtensor(v):
            loc = v.to_local()
            total += loc.numel() * loc.element_size()
        elif v.device.type != "meta":
            total += v.numel() * v.element_size()
    return total
