#!/usr/bin/env python3
"""Where the time of the port's fused CR1/CR2 solves goes on the card.

    python3 scripts/port_profile.py          # one solve per policy
    python3 scripts/port_profile.py --day    # one rolling-horizon day
    python3 scripts/port_profile.py --lanes  # batched lanes vs their loops
    python3 scripts/port_profile.py --cr3    # CR3 and the SLSQP reference

Builds chip_smoke's fleet (paper fleet at num_samples=32, num_jobs=1000,
cloned to W = 10,000, T = 48) and warms up. Without `--day` it solves
CR1(1.45) and CR2(0.78) at their default steps under `torch.profiler`
(CPU and CUDA activities). With `--day` it profiles chip_smoke's
streaming day per policy (24 ticks of `ForecastStream.caiso(n_ticks=24,
horizon=48, seed=7)`, CR1 cold 600 / warm 150 steps, CR2 outer 6, cold
400 / warm 100 a round): one CUDA-graph replay of `api.solve_day` (the
graph captured before the window) and the same day run eagerly
(`api._day_impl`, launch by launch). With `--lanes` it profiles
chip_smoke's batched lanes, each beside its loop of `solve()` calls: the
CR1 sweep over lam in {1.0, 1.2, 1.45, 1.6, 2.2}, the CR2 sweep over
cap_frac in {0.70, 0.74, 0.78, 0.82}, the S = 16 ensembles of CR1(1.45)
and CR2(0.78), and the 4-stream CR1 streaming ensemble over 24 ticks
beside one solo controller. With `--cr3` it profiles 100 steps of one
CR3 best response (CR3(outer=1, clearing_iters=0), the generic engine)
through the dr_features kernel and through the plain path, and 20
iterations of `solve_slsqp` of CR1(1.45) on the paper's four-workload
problem in float64. For each it prints the wall time,
the device-busy time (the union of the traced kernel and copy
intervals), the device idle share 1 - busy / wall, al_step's launches
and mean device time per call, and the device time by kernel name, with
the card's name and power limit. If the trace holds no device events it
says so.
"""
from __future__ import annotations

import argparse
import dataclasses
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))


def _busy_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def _profile(torch, label, fn) -> None:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not dev:
        print(f"{label}: the trace holds no device events")
        return
    busy = _busy_us((e.time_range.start, e.time_range.end) for e in dev)
    calls = {}
    for kernel in ("al_step", "dr_features"):
        ts = [e.time_range.end - e.time_range.start for e in dev
              if f"{kernel}_kernel" in e.name]
        calls[kernel] = (f"{len(ts)} x {sum(ts) / len(ts):.2f} us" if ts
                         else "none")
    print(f"{label}: wall {wall_us / 1e3:.3f} ms (profiler on), device "
          f"busy {busy / 1e3:.3f} ms, idle share {1.0 - busy / wall_us:.4f}, "
          f"{len(dev)} device events; al_step {calls['al_step']}; "
          f"dr_features {calls['dr_features']}")
    by_name: dict[str, list[float]] = {}
    for e in dev:
        by_name.setdefault(e.name, []).append(
            e.time_range.end - e.time_range.start)
    top = sorted(by_name.items(), key=lambda kv: -sum(kv[1]))[:8]
    for name, ts in top:
        print(f"  {sum(ts) / 1e3:9.3f} ms  {len(ts):5d} x  {name[:90]}")


def _solves(torch, p) -> None:
    from repro_torch.core.api import CR1, CR2, SolveContext, solve
    for pol in (CR1(lam=1.45), CR2(cap_frac=0.78)):
        solve(p, pol, ctx=SolveContext(steps=8))
    for pol in (CR1(lam=1.45), CR2(cap_frac=0.78)):
        _profile(torch, pol.name, lambda: solve(p, pol))


def _days(torch, p) -> None:
    import numpy as np

    from repro_torch.core import api
    from repro_torch.core.carbon import ForecastStream
    stream = ForecastStream.caiso(n_ticks=24, horizon=48, seed=7)
    stack = np.stack([stream.forecast(t) for t in range(24)])
    window = dataclasses.replace(p, mci=stack[0])
    ctx = api.SolveContext()
    for name, cold, warm, outer in (("cr1", 600, 150, 1),
                                    ("cr2", 400, 100, 6)):
        pol = api.configured_policy(name, outer=outer)

        def replay():
            return api.solve_day(window, pol, stack, ctx=ctx,
                                 cold_steps=cold, warm_steps=warm)

        _, _, day, inputs = api._day_setup(window, pol, stack, ctx, cold,
                                           warm)

        def eager():
            with torch.no_grad():
                return api._day_impl(day, inputs)

        replay()                       # capture (and the warm-up day)
        _profile(torch, f"{name} day, one CUDA-graph replay", replay)
        _profile(torch, f"{name} day, eager (_day_impl)", eager)


def _lanes(torch, p) -> None:
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch.core import ensemble as ens
    from repro_torch.core import scenario as scen
    from repro_torch.core.api import CR1, CR2, SolveContext, solve, sweep
    from repro_torch.core.streaming import RollingHorizonSolver
    ctx = SolveContext()
    sweep(p, [CR1(), CR1(lam=2.0)], ctx=SolveContext(steps=8))   # warm-up
    for pols in ([CR1(lam=lam) for lam in cs.CR1_LAMS],
                 [CR2(cap_frac=c) for c in cs.CR2_CAPS]):
        name = f"{pols[0].name} sweep, {len(pols)} lanes"
        _profile(torch, f"{name}, batched", lambda: sweep(p, pols, ctx=ctx))
        _profile(torch, f"{name}, loop of solve()",
                 lambda: [solve(p, pl, ctx=ctx) for pl in pols])
    for pol, gens in ((CR1(lam=1.45), [scen.DuckPerturb(8, seed=0),
                                       scen.CambiumMix(8, seed=1)]),
                      (CR2(cap_frac=0.78), [scen.DuckPerturb(6, seed=0),
                                            scen.CambiumMix(6, seed=1),
                                            scen.FleetJitter(4, seed=2)])):
        stack = scen.resolve_scenarios(gens, p)
        for batched in (True, False):
            _profile(torch, f"{pol.name} ensemble, S = {stack.S}, "
                     f"{'batched' if batched else 'loop of solve()'}",
                     lambda: ens.evaluate_ensemble(p, pol, stack, ctx=ctx,
                                                   batched=batched))
    streams = scen.ForecastRegime(cs.STREAM_LANES, seed=0).streams(
        p, n_ticks=cs.DAY_TICKS)
    kw = dict(cold_steps=600, warm_steps=150)
    _profile(torch, f"cr1 streaming ensemble, {cs.STREAM_LANES} streams x "
             f"{cs.DAY_TICKS} ticks, batched",
             lambda: ens.run_streaming_ensemble(
                 p, CR1(lam=1.45), streams, n_ticks=cs.DAY_TICKS, **kw))
    _profile(torch, f"cr1 solo controller, one stream x {cs.DAY_TICKS} "
             f"ticks", lambda: RollingHorizonSolver(
                 p, streams[0], policy=CR1(lam=1.45), **kw).run(cs.DAY_TICKS))


def _cr3(torch, p) -> None:
    from repro_torch.core import policies, solver
    from repro_torch.core.api import CR3, SolveContext, solve
    from repro_torch.core.carbon import caiso_2021
    from repro_torch.core.fleetcache import cached_paper_fleet
    pol = CR3(outer=1, clearing_iters=0)
    solve(p, pol, ctx=SolveContext(steps=4))                      # warm-up
    for uk in (True, False):
        _profile(torch, f"cr3 best response, 100 steps, "
                 f"{'kernels' if uk else 'plain'}",
                 lambda: solve(p, pol, ctx=SolveContext(steps=100,
                                                        use_kernel=uk)))
    fleet = cached_paper_fleet(hours=48, num_samples=32, num_jobs=1000,
                               device="cuda")
    dr = policies.DRProblem(models=tuple(fleet[n] for n in (
        "RTS1", "RTS2", "AITraining", "DataPipeline")),
        mci=caiso_2021(48).mci)
    spec = policies.cr1_spec(dr, 1.45)
    solver.solve_slsqp(spec, maxiter=2)                           # warm-up
    _profile(torch, "solve_slsqp cr1, 20 iterations, float64",
             lambda: solver.solve_slsqp(spec, maxiter=20))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--day", action="store_true",
                      help="profile the 24-tick streaming day instead of "
                           "one solve per policy")
    mode.add_argument("--lanes", action="store_true",
                      help="profile the batched lanes (sweeps, ensembles, "
                           "the streaming ensemble) beside their loops")
    mode.add_argument("--cr3", action="store_true",
                      help="profile a CR3 best response (kernels and "
                           "plain) and the SLSQP reference")
    args = ap.parse_args()
    import torch

    from repro_torch.core.fleet_solver import synthetic_fleet
    from repro_torch.core.fleetcache import cached_paper_fleet

    if not torch.cuda.is_available():
        print("port_profile: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    fleet = cached_paper_fleet(hours=48, num_samples=32, num_jobs=1000,
                               device="cuda")
    p = synthetic_fleet(10_000, hours=48, seed=0, templates=fleet)
    mode = (_days if args.day else _lanes if args.lanes
            else _cr3 if args.cr3 else _solves)
    mode(torch, p)
    return 0


if __name__ == "__main__":
    sys.exit(main())
