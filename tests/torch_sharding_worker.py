"""Ranks of a gloo process group on the CPU, for the port's fleet-mesh
tests (`tests/test_torch_sharding.py`).

`Group(world, jobs)` spawns `world` processes (the spawn start method, a
`FileStore` under a fresh temporary directory, so that parallel test
workers never share a port or a store), each with one thread. Every
rank runs every job and returns what it saw, so the caller can hold the
ranks to each other and to an unsharded solve. This module imports the
port only: the spawned ranks load nothing of JAX.

A job is a dict: "fleet" (a `FleetProblem`), "policy" (a port policy),
"ctx" (`SolveContext` fields; the device is the CPU), "regions" (None
for a 1-D mesh, R for an (R, world // R) one), "warm_state" (a numpy
(x, lam_eq, lam_in, mu), the first solve's warm start) and "chain"
(`SolveContext` fields of a second solve warm from the first one's
sharded state, reported as "<name>/chain").
"""
from __future__ import annotations

import os
import pickle
import shutil
import tempfile
import time

import numpy as np


def _result(r) -> dict:
    """The host view of a `FleetSolveResult`."""
    st = r.state
    tel = r.extras.get("telemetry")
    return {
        "D": r.D, "carbon": r.carbon_reduction_pct,
        "penalty": r.total_penalty_pct, "iters": r.iters,
        "preservation": r.preservation_violation,
        "x": st.x.numpy(), "lam_eq": st.lam_eq.numpy(),
        "lam_in": st.lam_in.numpy(), "mu": float(st.mu),
        "extras": {k: v for k, v in r.extras.items()
                   if k in ("rho", "balanced", "fiscal_deficit")},
        "telemetry": None if tel is None else {
            k: np.asarray(getattr(tel, k)) for k in
            ("step", "objective", "grad_norm", "violation", "dx", "mu",
             "step_scale")}}


def _mesh_facts(world: int) -> dict:
    """The mesh helpers on this group (world even): a 1-D and a 2-D fleet
    mesh, and the refusals: regions that do not divide, a mesh short of
    the group, another device type, no fleet axis, rows replicated over
    an axis."""
    import torch
    from repro_torch.launch import mesh as tm
    facts = {}
    one = tm.make_fleet_mesh(device_type="cpu")
    facts["1d"] = (tm.fleet_axis(one), tm.fleet_axes(one),
                   tm.fleet_device_count(one), tuple(one.mesh_dim_names))
    two = tm.make_fleet_mesh(regions=2, device_type="cpu")
    facts["2d"] = (tm.fleet_axis(two), tm.fleet_axes(two),
                   tm.fleet_device_count(two), tuple(two.mesh.shape))
    for bad in (3, 0):
        try:
            tm.make_fleet_mesh(regions=bad, device_type="cpu")
            facts[f"regions={bad}"] = None
        except ValueError as e:
            facts[f"regions={bad}"] = str(e)
    try:
        tm.make_fleet_mesh(world + 1, device_type="cpu")
        facts["n_devices"] = None
    except ValueError as e:
        facts["n_devices"] = str(e)
    from torch.distributed.device_mesh import init_device_mesh
    for key, mesh, check in (
            ("device_type", one, lambda m: tm.check_fleet_mesh(
                m, torch.device("cuda"))),
            ("no fleet axis", init_device_mesh(
                "cpu", (2, world // 2), mesh_dim_names=("data", "model")),
             tm.fleet_axis),
            ("replicated", init_device_mesh(
                "cpu", (2, world // 2), mesh_dim_names=("data", "fleet")),
             lambda m: tm.check_fleet_mesh(m, torch.device("cpu")))):
        try:
            check(mesh)
            facts[key] = None
        except ValueError as e:
            facts[key] = str(e)
    return facts


def _rank(rank: int, world: int, store: str, jobs: list, out: str) -> None:
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    try:
        from repro_torch.core.api import SolveContext, solve
        from repro_torch.core.engine import EngineState
        from repro_torch.launch.mesh import make_fleet_mesh
        meshes = {}
        results = {"mesh": _mesh_facts(world)}
        for name, job in jobs:
            regions = job.get("regions")
            if regions not in meshes:
                meshes[regions] = make_fleet_mesh(regions=regions,
                                                  device_type="cpu")
            kw = dict(job.get("ctx", {}))
            if "warm_state" in job:
                kw["warm"] = EngineState(*(torch.as_tensor(a)
                                           for a in job["warm_state"]))
            t0 = time.perf_counter()
            first = solve(job["fleet"], job["policy"], ctx=SolveContext(
                device="cpu", mesh=meshes[regions], **kw))
            results[name] = dict(_result(first),
                                 wall=time.perf_counter() - t0)
            if "chain" in job:
                again = solve(job["fleet"], job["policy"], ctx=SolveContext(
                    device="cpu", mesh=meshes[regions], warm=first.state,
                    **job["chain"]))
                results[name + "/chain"] = _result(again)
        with open(os.path.join(out, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(results, f)
    finally:
        dist.destroy_process_group()


class Group:
    """`world` gloo ranks running `jobs` ((name, job) pairs), started at
    once: the caller works beside them until `results()`."""

    def __init__(self, world: int, jobs: list):
        import torch.multiprocessing as mp
        self.world = world
        self._tmp = tempfile.mkdtemp(prefix="fleet_mesh_")
        self._procs = mp.start_processes(
            _rank, args=(world, os.path.join(self._tmp, "store"), jobs,
                         self._tmp),
            nprocs=world, join=False, start_method="spawn")

    def results(self) -> list[dict]:
        """Wait for every rank (a rank's exception is raised here) and
        return each rank's results, rank 0 first."""
        try:
            while not self._procs.join():
                pass
            out = []
            for r in range(self.world):
                with open(os.path.join(self._tmp, f"rank{r}.pkl"),
                          "rb") as f:
                    out.append(pickle.load(f))
            return out
        finally:
            shutil.rmtree(self._tmp, ignore_errors=True)
