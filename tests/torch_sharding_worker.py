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

"kind" picks the entry point (`KINDS`; default "solve"):
  * "sweep": `api.sweep(fleet, policies)` ("warm_state" stacked);
  * "day": `api.solve_day(fleet, policy, stack, cold_steps=,
    warm_steps=)` and, with "chain", once more warm from its state
    ("<name>/chain");
  * "ensemble": `ensemble.evaluate_ensemble(fleet, policy, scenarios)`;
  * "stream": `RollingHorizonSolver(fleet, streams, mesh=...,
    events=, **solver)` through `run(ticks)` or `run_scanned(ticks)`
    ("scanned"), "events" (a path, optional) its tick ledger;
  * "refusals": what a mesh refuses, each message or None: the sharded
    ensemble lane warm, shifted or with mu reset (`_run_batched`), and a
    sharded day with telemetry or sanitize.
"""
from __future__ import annotations

import os
import pickle
import shutil
import tempfile

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


def _state(st) -> dict:
    return {"x": st.x.numpy(), "lam_eq": st.lam_eq.numpy(),
            "lam_in": st.lam_in.numpy(), "mu": st.mu.numpy()}


def _day_result(day) -> dict:
    return dict(_state(day.last.state), committed=day.committed,
                D=day.last.D, carbon=day.last.carbon_reduction_pct,
                penalty=day.last.total_penalty_pct,
                inner_steps=day.inner_steps)


def _ensemble_result(res) -> dict:
    return {"carbon": res.carbon_reduction_pct,
            "penalty": res.total_penalty_pct, "D": res.D,
            "penalties": res.penalties, "batched": res.batched}


def _stream_result(rep, solver) -> dict:
    return dict(_state(solver._state), committed=rep.committed,
                realized=rep.realized_carbon,
                reduction=rep.realized_reduction_pct,
                inner_steps=rep.total_inner_steps)


def _warm(job):
    import torch
    from repro_torch.core.engine import EngineState
    return EngineState(*(torch.as_tensor(a) for a in job["warm_state"]))


def _solve_job(name, job, mesh, results):
    from repro_torch.core.api import SolveContext, solve
    kw = dict(job.get("ctx", {}))
    if "warm_state" in job:
        kw["warm"] = _warm(job)
    first = solve(job["fleet"], job["policy"], ctx=SolveContext(
        device="cpu", mesh=mesh, **kw))
    results[name] = _result(first)
    if "chain" in job:
        again = solve(job["fleet"], job["policy"], ctx=SolveContext(
            device="cpu", mesh=mesh, warm=first.state, **job["chain"]))
        results[name + "/chain"] = _result(again)


def _sweep_job(name, job, mesh, results):
    from repro_torch.core.api import SolveContext, sweep
    kw = dict(job.get("ctx", {}))
    if "warm_state" in job:
        kw["warm"] = _warm(job)
    out = sweep(job["fleet"], job["policies"], ctx=SolveContext(
        device="cpu", mesh=mesh, **kw))
    results[name] = [dict(_result(r) if r.state is not None else {},
                          D=r.D, carbon=r.carbon_reduction_pct,
                          penalty=r.total_penalty_pct, iters=r.iters,
                          state=r.state is not None) for r in out]


def _day_job(name, job, mesh, results):
    from repro_torch.core.api import SolveContext, solve_day
    kw = dict(job.get("ctx", {}))
    steps = dict(cold_steps=job["cold_steps"], warm_steps=job["warm_steps"])
    first = solve_day(job["fleet"], job["policy"], job["stack"],
                      ctx=SolveContext(device="cpu", mesh=mesh, **kw),
                      **steps)
    results[name] = _day_result(first)
    if "chain" in job:
        day = solve_day(job["fleet"], job["policy"], job["stack"],
                        ctx=SolveContext(device="cpu", mesh=mesh,
                                         warm=first.last.state, **kw),
                        **steps)
        results[name + "/chain"] = _day_result(day)


def _ensemble_job(name, job, mesh, results):
    from repro_torch.core.api import SolveContext
    from repro_torch.core.ensemble import evaluate_ensemble
    res = evaluate_ensemble(job["fleet"], job["policy"], job["scenarios"],
                            ctx=SolveContext(device="cpu", mesh=mesh,
                                             **job.get("ctx", {})))
    results[name] = _ensemble_result(res)


def _stream_job(name, job, mesh, results):
    from repro_torch.core.streaming import RollingHorizonSolver
    solver = RollingHorizonSolver(job["fleet"], job["streams"], mesh=mesh,
                                  device="cpu", events=job.get("events"),
                                  **job["solver"])
    run = solver.run_scanned if job.get("scanned") else solver.run
    results[name] = _stream_result(run(job["ticks"]), solver)


def _refusals_job(name, job, mesh, results):
    import torch
    from repro_torch.core.api import CR1, SolveContext, cold_lanes, solve_day
    from repro_torch.core.ensemble import _run_batched
    from repro_torch.core.scenario import resolve_scenarios
    from repro_torch.obs.telemetry import TelemetryConfig
    p = job["fleet"]
    stack = resolve_scenarios(job["scenarios"], p)
    dev = torch.device("cpu")
    init = cold_lanes(stack.S, p.W, p.T, dev, 0, 10.0)
    calls = {
        "warm": lambda: _run_batched(CR1(), p, stack, steps=2,
                                     use_kernel=False, device=dev,
                                     init=init, mesh=mesh),
        "shift": lambda: _run_batched(CR1(), p, stack, steps=2,
                                      use_kernel=False, device=dev, shift=1,
                                      mesh=mesh),
        "reset_mu": lambda: _run_batched(CR1(), p, stack, steps=2,
                                         use_kernel=False, device=dev,
                                         reset_mu=True, mesh=mesh),
        "telemetry": lambda: solve_day(p, CR1(), job["stack"],
                                       ctx=SolveContext(
                                           device="cpu", mesh=mesh,
                                           telemetry=TelemetryConfig(2)),
                                       cold_steps=4),
        "sanitize": lambda: solve_day(p, CR1(), job["stack"],
                                      ctx=SolveContext(device="cpu",
                                                       mesh=mesh,
                                                       sanitize=True),
                                      cold_steps=4)}
    out = {}
    for key, call in calls.items():
        try:
            call()
            out[key] = None
        except (ValueError, NotImplementedError) as e:
            out[key] = (type(e).__name__, str(e))
    results[name] = out


#: Job kind -> its runner (name, job, mesh, results).
KINDS = {"solve": _solve_job, "sweep": _sweep_job, "day": _day_job,
         "ensemble": _ensemble_job, "stream": _stream_job,
         "refusals": _refusals_job}


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
        from repro_torch.launch.mesh import make_fleet_mesh
        meshes = {}
        results = {"mesh": _mesh_facts(world)}
        for name, job in jobs:
            regions = job.get("regions")
            if regions not in meshes:
                meshes[regions] = make_fleet_mesh(regions=regions,
                                                  device_type="cpu")
            KINDS[job.get("kind", "solve")](name, job, meshes[regions],
                                            results)
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
