#!/usr/bin/env python3
"""The paper's policy sweeps (Figs. 8-10) through the port, and the
Fig. 8 headline: CR1's carbon reduction over the best baseline's at a
matched penalty of 2 % and 4 %.

    python3 scripts/port_policy_sweep.py [--out var/BENCH_port_fig8.json]
        [--num-samples 160 --num-jobs 10000] [--device cpu]

The grids are `benchmarks/common.py`'s `policy_sweeps`: CR1 and CR2
through the SLSQP reference (`core/solver.py`, float64 on the device) at
250 iterations; CR3 through the fleet engine (`api.solve` of
`CR3(rho=0.02, tax_frac=t, clearing_iters=3)` on
`FleetProblem.from_problem`), scored per workload by `evaluate`; B1 and
B3 in closed form; B2 and B4 through SLSQP at 150 iterations. The
problem is the paper's four workloads (RTS1, RTS2, AITraining,
DataPipeline) over `caiso_2021(48)`, the penalty models calibrated on
this host at `--num-samples`/`--num-jobs` (the repository's default
160 / 10,000). The ratio takes, per policy, the setting whose penalty
lies nearest the target, as `benchmarks/paper_figs.py:fig8_pareto` does.

Runs on the CUDA card unless `--device cpu`; the record's `host` names
the device (and, on the card, its power limit) so that a CPU record is
never read as a card's. Imports no JAX.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

CR1_LAMS = (1.0, 1.2, 1.3, 1.4, 1.45, 1.5, 1.55, 1.6, 1.8, 2.2)
CR2_CAPS = (0.84, 0.82, 0.80, 0.78, 0.76, 0.74)
CR3_TAXES = (0.18, 0.20, 0.24, 0.30)
B2_LAMS = (1.0, 1.3, 1.6, 2.0)
B3_DEPTHS = (0.1, 0.2, 0.3, 0.4, 0.5, 0.6)
B4_LAMS = (0.02, 0.05, 0.1, 0.3)
PEN_TARGETS = (2.0, 4.0)
BASELINES = ("B1", "B2", "B3", "B4")
# The JAX package's record of the same ratios (jax 0.4.37 on a CPU).
STALE = {"pen2": 1.39, "pen4": 1.34, "source": "var/BENCH_fig8_pareto.json"}


def _host(torch, device):
    if device.type != "cuda":
        return {"device": "cpu", "torch": torch.__version__}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    return {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
            "torch": torch.__version__, "cuda": torch.version.cuda}


def _row(r, policy, hyper, wall):
    return {"policy": policy, "hyper": float(hyper), "name": r.name,
            "solver": r.solver, "nit": r.nit,
            "carbon_pct": r.carbon_reduction_pct,
            "penalty_pct": r.total_penalty_pct,
            "per_penalty": r.per_penalty.tolist(),
            "per_carbon": r.per_carbon.tolist(),
            "violations": {k: float(v) for k, v in r.violations.items()},
            "wall_s": wall}


def sweeps(problem, device, sync, log):
    """Every policy over its grid; one row each."""
    import numpy as np

    from repro_torch.core import baselines, policies, solver
    from repro_torch.core.api import CR3, SolveContext, solve
    from repro_torch.core.fleet_solver import FleetProblem

    p = problem
    rows = []

    def timed(fn):
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        return out, time.perf_counter() - t0

    def closed(D, name):
        spec = policies.PolicySpec(name=name, problem=p,
                                   objective=p.total_penalty,
                                   use_preservation=False)
        return solver.evaluate(spec, D, solver="closed", nit=0,
                               device=device)

    def slsqp(spec, maxiter):
        return solver.solve_slsqp(spec, maxiter=maxiter, device=device)

    grids = [("CR1", lam, lambda lam=lam: slsqp(
        policies.cr1_spec(p, lam), 250)) for lam in CR1_LAMS]
    grids += [("CR2", cap, lambda cap=cap: slsqp(
        policies.cr2_spec(p, cap, device=device), 250)) for cap in CR2_CAPS]
    fp = FleetProblem.from_problem(p)

    def cr3(tax):
        rf = solve(fp, CR3(rho=0.02, tax_frac=tax, clearing_iters=3),
                   ctx=SolveContext(device=device))
        spec = policies.PolicySpec(name=f"CR3(tax={tax:g})", problem=p,
                                   objective=p.total_penalty)
        return solver.evaluate(spec, rf.D, solver="fleet-engine",
                               nit=rf.iters, device=device)

    grids += [("CR3", tax, lambda tax=tax: cr3(tax)) for tax in CR3_TAXES]
    grids += [("B1", F, lambda F=F: closed(baselines.b1_adjustments(p, F),
                                          f"B1({F:.2f})"))
              for F in np.linspace(0.55, 0.9, 8)]
    grids += [("B2", lam, lambda lam=lam: slsqp(
        baselines.b2_spec(p, lam), 150)) for lam in B2_LAMS]
    grids += [("B3", d, lambda d=d: closed(baselines.b3_adjustments(
        p, d, max_cut=0.3), f"B3({d})")) for d in B3_DEPTHS]
    grids += [("B4", lam, lambda lam=lam: slsqp(
        baselines.b4_spec(p, lam), 150)) for lam in B4_LAMS]
    for policy, hyper, fn in grids:
        r, wall = timed(fn)
        log(f"{policy}({hyper:g}): carbon {r.carbon_reduction_pct:.4f} %, "
            f"penalty {r.total_penalty_pct:.4f} %, nit {r.nit}, "
            f"{wall:.3f} s")
        rows.append(_row(r, policy, hyper, wall))
    return rows


def ratios(rows):
    """CR1's carbon over the best baseline's, each at the setting whose
    penalty lies nearest the target (`benchmarks/paper_figs.py`)."""
    by = {}
    for r in rows:
        by.setdefault(r["policy"], []).append(r)

    def carbon_at(policy, target):
        cands = by.get(policy, ())
        if not cands:
            return 0.0
        best = min(cands, key=lambda r: abs(r["penalty_pct"] - target))
        return best["carbon_pct"]

    out = {}
    for t in PEN_TARGETS:
        cr1 = carbon_at("CR1", t)
        base = {b: carbon_at(b, t) for b in BASELINES}
        best = max(base, key=base.get)
        out[f"pen{t:g}"] = {"CR1": cr1, "best_baseline": best,
                            "best_baseline_carbon": base[best],
                            "baselines": base,
                            "ratio": cr1 / max(base[best], 1e-9)}
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="var/BENCH_port_fig8.json")
    ap.add_argument("--num-samples", type=int, default=160)
    ap.add_argument("--num-jobs", type=int, default=10_000)
    ap.add_argument("--device", default=None,
                    help="the CUDA device unless 'cpu'")
    args = ap.parse_args()
    import torch

    from repro_torch.core import policies
    from repro_torch.core.carbon import caiso_2021
    from repro_torch.core.fleetcache import cached_paper_fleet
    from repro_torch.kernels.dispatch import resolve_device

    device = resolve_device(args.device)
    host = _host(torch, device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize()

    def log(*a):
        print("[sweep]", *a, flush=True)

    log(f"host {host}")
    t0 = time.perf_counter()
    fleet = cached_paper_fleet(hours=48, num_samples=args.num_samples,
                               num_jobs=args.num_jobs, device=device)
    log(f"paper fleet calibrated in {time.perf_counter() - t0:.2f} s "
        f"(num_samples={args.num_samples}, num_jobs={args.num_jobs})")
    p = policies.DRProblem(
        models=tuple(fleet[n] for n in ("RTS1", "RTS2", "AITraining",
                                        "DataPipeline")),
        mci=caiso_2021(48).mci)
    t1 = time.perf_counter()
    rows = sweeps(p, device, sync, log)
    elapsed = time.perf_counter() - t1
    rat = ratios(rows)
    for key, v in rat.items():
        log(f"{key}: CR1 {v['CR1']:.4f} % against {v['best_baseline']} "
            f"{v['best_baseline_carbon']:.4f} %: ratio {v['ratio']:.4f} "
            f"(the JAX package's stale record: {STALE[key]})")
    record = {"benchmark": "port_fig8", "host": host,
              "script": "scripts/port_policy_sweep.py",
              "calibration": {"num_samples": args.num_samples,
                              "num_jobs": args.num_jobs},
              "elapsed_s": elapsed, "ratios": rat,
              "stale_jax_record": STALE, "rows": rows}
    out = ROOT / args.out
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(record, indent=1) + "\n")
    log(f"wrote {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
