"""Meshes on `torch.distributed`: the port of the JAX package's
`launch/mesh.py`, its fleet part and its model part.

The (W, T) fleet solves are row-separable over workloads, so they shard
W over a mesh of processes, one per card. The port runs SPMD: every
process calls `api.solve(problem, policy, ctx=SolveContext(mesh=mesh))`
with the whole host fleet, pads it to a multiple of the mesh size
(`fleet_solver.pad_fleet`), solves its own contiguous row block
(`fleet_solver.row_block`) through the same engine and kernels as a
solo solve, and all-gathers the blocks (`engine.al_minimize_sharded`),
so that every process returns the same result.

A mesh is a `torch.distributed.device_mesh.DeviceMesh`: 1-D
`(FLEET_AXIS,)` of size n, or, for multi-region fleets, 2-D
`(REGION_AXIS, FLEET_AXIS)` of shape (R, n // R). W shards over every
axis of the mesh, region-major, as the JAX package's
`P((REGION_AXIS, FLEET_AXIS))`: a region-sorted fleet lands each
region's rows on one slice of the region axis. Nothing inside a solve's
objective makes a collective call, and nothing reads the region axis:
a 2-D mesh places rows and solves exactly as the 1-D mesh of the same
size. `regions` and `n_devices` mirror the JAX signature; `n_devices`
may only name the group's size.

The default process group must exist before a mesh is made (there is no
silent world of one): `torchrun` with `dist.init_process_group("nccl")`
on the cards, or the `gloo` backend with `device_type="cpu"` for the
CPU. A fleet mesh spans the whole group: every process takes a block.

The model meshes hold a model's training state as DTensors
(`launch/sharding.py`): `make_production_mesh` is (16, 16) `("data",
"model")` or (2, 16, 16) `("pod", "data", "model")` over a group of
exactly 256 or 512 processes, `make_test_mesh(data, model, pod)` the same
axes at any size that spans the group. `dp_axes` and `has_pod_axis` read
the axis names of a `DeviceMesh` or of any mesh-like object with `.shape`
(a dict of axis sizes) and `.axis_names`, as the JAX functions do, so the
partition rules run on shapes alone.
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist

#: Mesh axis name the fleet engine shards workloads over.
FLEET_AXIS = "fleet"

#: Mesh axis name of the region dimension of a 2-D fleet mesh.
REGION_AXIS = "region"

#: Axis names of a model mesh, single-pod and multi-pod.
MODEL_AXES = ("data", "model")
POD_AXES = ("pod", "data", "model")


def _require_group() -> None:
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "a mesh needs an initialized default process group: call "
            "torch.distributed.init_process_group (torchrun, or a store) "
            "on every process first")


def make_fleet_mesh(n_devices: int | None = None, *,
                    regions: int | None = None, device_type: str = "cuda"):
    """A `DeviceMesh` over the `n_devices` processes of the default group
    (default: all of them) for W-axis fleet sharding.

    Used by `repro_torch.core.api.solve(..., ctx=SolveContext(mesh=...))`:
    workloads, their multipliers and Adam moments shard over the mesh;
    the carbon trace and the solver's scalars are replicated.

    With `regions=R` the same processes form a 2-D `(REGION_AXIS,
    FLEET_AXIS)` mesh of shape (R, n // R) for multi-region fleets.
    `device_type` is "cuda" (a card per process; NCCL or gloo) or "cpu"
    (gloo). Raises `RuntimeError` without a default process group and
    `ValueError` when `n_devices` is not the group's size or `regions`
    does not divide it.
    """
    from torch.distributed.device_mesh import init_device_mesh
    _require_group()
    world = dist.get_world_size()
    n = world if n_devices is None else int(n_devices)
    if n != world:
        raise ValueError(
            f"a fleet mesh spans the process group: n_devices={n} but the "
            f"group has {world} processes (every process takes a row "
            f"block)")
    if regions is None:
        return init_device_mesh(device_type, (n,),
                                mesh_dim_names=(FLEET_AXIS,))
    if regions < 1 or n % regions:
        raise ValueError(
            f"regions={regions} must divide the device count {n}")
    return init_device_mesh(device_type, (regions, n // regions),
                            mesh_dim_names=(REGION_AXIS, FLEET_AXIS))


def _names(mesh) -> tuple[str, ...]:
    names = mesh.mesh_dim_names
    return tuple(names) if names is not None else ()


def fleet_axis(mesh) -> str:
    """Mesh axis the fleet solvers shard W over: `FLEET_AXIS` when
    present, else the sole (named) axis of a 1-D mesh."""
    names = _names(mesh)
    if FLEET_AXIS in names:
        return FLEET_AXIS
    if mesh.ndim == 1 and names:
        return names[0]
    raise ValueError(
        f"fleet sharding needs a {FLEET_AXIS!r} axis or a 1-D mesh; got "
        f"axes {names}")


def fleet_axes(mesh):
    """Axis name(s) the fleet solvers shard W over: the plain string of
    `fleet_axis` for 1-D meshes, `(REGION_AXIS, FLEET_AXIS)` for 2-D
    fleet meshes, where W shards over both axes."""
    names = _names(mesh)
    if REGION_AXIS in names and FLEET_AXIS in names:
        return (REGION_AXIS, FLEET_AXIS)
    return fleet_axis(mesh)


def fleet_device_count(mesh) -> int:
    """Number of processes the W axis shards over (the pad multiple)."""
    axes = fleet_axes(mesh)
    if isinstance(axes, str):
        axes = (axes,)
    names = _names(mesh)
    return math.prod(mesh.size(names.index(a)) for a in axes)


def fleet_ranks(mesh) -> list[int]:
    """The group's ranks in row-block order: the mesh's ranks flattened
    region-major. Block i of the padded fleet lives on rank
    `fleet_ranks(mesh)[i]`."""
    return [int(r) for r in mesh.mesh.flatten().tolist()]


def check_fleet_mesh(mesh, device: torch.device) -> None:
    """Refuse what the sharded solve cannot run: a `mesh` that is not a
    `DeviceMesh` (`TypeError`), no default process group (`RuntimeError`),
    a mesh on another device type than the solve's, one that leaves
    processes of the group out, or one with an axis W does not shard
    over (`ValueError`)."""
    from torch.distributed.device_mesh import DeviceMesh
    if not isinstance(mesh, DeviceMesh):
        raise TypeError(
            f"SolveContext.mesh must be a torch.distributed DeviceMesh "
            f"(launch.mesh.make_fleet_mesh); got {type(mesh).__name__}")
    _require_group()
    if mesh.device_type != device.type:
        raise ValueError(
            f"the mesh is on {mesh.device_type!r} devices but the solve "
            f"runs on {device.type!r}: make the mesh with "
            f"device_type={device.type!r} or solve on its device type")
    if mesh.size() != dist.get_world_size():
        raise ValueError(
            f"a fleet mesh spans the process group: the mesh has "
            f"{mesh.size()} processes, the group {dist.get_world_size()}")
    if fleet_device_count(mesh) != mesh.size():
        raise ValueError(
            f"W shards over every axis of a fleet mesh; axes "
            f"{_names(mesh)} of shape {tuple(mesh.shape)} would replicate "
            f"rows over some of them")


# ---------------------------------------------------------------------------
# Model meshes
# ---------------------------------------------------------------------------
def model_mesh(ranks, shape: tuple, names: tuple, device_type: str = "cuda"):
    """A `DeviceMesh` of `shape` with axes `names` over `ranks` of the
    default group, row-major. Creating it is collective over the default
    group: every process calls it, and a process outside `ranks` gets a
    mesh whose `get_coordinate()` is None. Raises `RuntimeError` without a
    default group and `ValueError` when the shape's size is not the
    number of ranks or a rank is not in the group."""
    from torch.distributed.device_mesh import DeviceMesh
    _require_group()
    ranks = [int(r) for r in ranks]
    if math.prod(shape) != len(ranks):
        raise ValueError(
            f"a mesh of shape {tuple(shape)} holds {math.prod(shape)} "
            f"processes; {len(ranks)} ranks were given")
    world = dist.get_world_size()
    if len(set(ranks)) != len(ranks) or not all(0 <= r < world
                                                 for r in ranks):
        raise ValueError(f"ranks {ranks} are not distinct ranks of the "
                         f"{world}-process group")
    return DeviceMesh(device_type, torch.tensor(ranks).reshape(shape),
                      mesh_dim_names=tuple(names))


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """(16, 16) `("data", "model")`, or with `multi_pod` (2, 16, 16)
    `("pod", "data", "model")`, over the whole default group, which must
    hold exactly 256 or 512 processes (`ValueError` otherwise; there is no
    silent world)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    _require_group()
    world = dist.get_world_size()
    if world != math.prod(shape):
        raise ValueError(
            f"make_production_mesh(multi_pod={multi_pod}) needs a group of "
            f"{math.prod(shape)} processes; the group has {world}")
    return model_mesh(range(world), shape,
                      POD_AXES if multi_pod else MODEL_AXES, device_type)


def make_test_mesh(data: int = 2, model: int = 2, pod: int = 1,
                   device_type: str = "cuda"):
    """A small model mesh over the whole default group: (data, model), or
    (pod, data, model) when pod > 1. `ValueError` when data x model x pod
    is not the group's size."""
    shape = (pod, data, model) if pod > 1 else (data, model)
    _require_group()
    world = dist.get_world_size()
    if math.prod(shape) != world:
        raise ValueError(
            f"make_test_mesh(data={data}, model={model}, pod={pod}) spans "
            f"{math.prod(shape)} processes; the group has {world}")
    return model_mesh(range(world), shape,
                      POD_AXES if pod > 1 else MODEL_AXES, device_type)


def axis_names(mesh) -> tuple[str, ...]:
    """The axis names of a `DeviceMesh` or of a mesh-like object
    (`.axis_names`, else the keys of its `.shape` dict)."""
    if hasattr(mesh, "mesh_dim_names"):
        return _names(mesh)
    if hasattr(mesh, "axis_names"):
        return tuple(mesh.axis_names)
    return tuple(mesh.shape)


def axis_sizes(mesh) -> dict[str, int]:
    """{axis name: size} of a `DeviceMesh` or a mesh-like object."""
    if hasattr(mesh, "mesh_dim_names"):
        return dict(zip(_names(mesh), (int(n) for n in mesh.mesh.shape)))
    return {a: int(mesh.shape[a]) for a in axis_names(mesh)}


def dp_axes(mesh) -> tuple[str, ...]:
    """Axes that shard the batch (pure data parallelism)."""
    return tuple(a for a in axis_names(mesh) if a in ("pod", "data"))


def has_pod_axis(mesh) -> bool:
    return "pod" in axis_names(mesh)
