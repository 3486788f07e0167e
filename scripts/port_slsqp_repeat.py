#!/usr/bin/env python3
"""Is the SLSQP reference repeatable on the card, and what moves it?

    python3 scripts/port_slsqp_repeat.py [--maxiter 250] [--out PATH]
    python3 scripts/port_slsqp_repeat.py --device cpu --maxiter 20  # rehearsal

Builds the paper's four-workload problem as chip_smoke.py does (RTS1,
RTS2, AITraining and DataPipeline of the paper fleet calibrated at
num_samples=32, num_jobs=1000, over `caiso_2021(48)`), calibrating the
fleet on the card itself (never read from a cache file), and then:

1. solves CR1(1.45) with `solve_slsqp` twice in this process, recording
   every iterate (scipy's callback), and reports the first iteration at
   which the two runs differ, if any;
2. evaluates, three times at x = 0 and at every 10th recorded iterate
   (up to the first differing one), the objective's value and gradient
   and every constraint's value and Jacobian (the very functions
   `solve_slsqp` hands scipy, `solver.slsqp_functions`), each run under
   a dispatch mode that hashes the output of every torch op, and names
   the first op whose output differs between repeats of one evaluation,
   if any;
3. calibrates the same fleet on the CPU, hashes both fleets' models, and
   solves CR1 on the CPU-calibrated fleet on the card: the reading a
   CPU-built cache file (`var/torch_fleet_*.npz` without a device suffix)
   gives a card run.

Prints the card's name and power limit, one line per part, and a JSON
summary on its last line (also written to `--out`). Exits 1 if the two
in-process runs differ.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

ORDER = ("RTS1", "RTS2", "AITraining", "DataPipeline")


def four_workloads(device):
    from repro_torch.core.carbon import caiso_2021
    from repro_torch.core.penalty import build_paper_fleet
    from repro_torch.core.policies import DRProblem
    fleet = build_paper_fleet(hours=48, num_samples=32, num_jobs=1000,
                              device=device)
    return DRProblem(models=tuple(fleet[n] for n in ORDER),
                     mci=caiso_2021(48).mci)


def models_hash(np, dr) -> str:
    h = hashlib.sha256()
    for m in dr.models:
        for a in (m.usage, m.jobs if m.jobs is not None else [],
                  [m.k, m.entitlement], m.params):
            h.update(np.asarray(a, np.float64).tobytes())
    return h.hexdigest()[:16]


def recorded_slsqp(np, spec, maxiter, device):
    from repro_torch.core.solver import solve_slsqp
    its = []
    res = solve_slsqp(spec, maxiter=maxiter, device=device,
                      callback=lambda xk: its.append(np.array(xk)))
    return res, its


def op_trace(torch, fn):
    """(op name, output hash) of every torch op `fn()` dispatches, and its
    result."""
    from torch.utils._python_dispatch import TorchDispatchMode

    log = []

    def digest(t):
        if isinstance(t, torch.Tensor):
            try:
                return hashlib.sha256(t.detach().contiguous().cpu().numpy()
                                      .tobytes()).hexdigest()[:12]
            except (RuntimeError, TypeError):
                return "-"
        return ""

    class Trace(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            outs = out if isinstance(out, (tuple, list)) else (out,)
            log.append((str(func), "/".join(digest(o) for o in outs)))
            return out

    with Trace():
        result = fn()
    return log, result


def first_op_difference(logs):
    """The first (index, op) at which the repeats' op logs disagree."""
    for i, ops in enumerate(zip(*logs)):
        if len(set(ops)) > 1:
            return i, ops[0][0]
    if len({len(log) for log in logs}) > 1:
        return min(len(log) for log in logs), "(op count)"
    return None


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--maxiter", type=int, default=250)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=str(ROOT / "var"
                                         / "port_slsqp_repeat.json"))
    args = ap.parse_args()
    import numpy as np
    import torch
    from repro_torch.core import policies
    from repro_torch.core.solver import slsqp_functions
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("port_slsqp_repeat: no CUDA device", file=sys.stderr)
        return 2
    smi = "cpu" if dev.type == "cpu" else subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(smi)
    dr = four_workloads(dev)
    spec = policies.cr1_spec(dr, 1.45)
    summary = {"device": smi, "maxiter": args.maxiter,
               "card_fleet_hash": models_hash(np, dr)}

    # 1. Two solves in this process.
    (a, its_a), (b, its_b) = (recorded_slsqp(np, spec, args.maxiter, dev)
                              for _ in range(2))
    first = next((i for i, (x, y) in enumerate(zip(its_a, its_b))
                  if not np.array_equal(x, y)), None)
    if first is None and len(its_a) != len(its_b):
        first = min(len(its_a), len(its_b))
    summary["runs"] = [{"nit": r.nit, "carbon_pct": r.carbon_reduction_pct,
                        "penalty_pct": r.total_penalty_pct}
                       for r in (a, b)]
    summary["iterates"] = [len(its_a), len(its_b)]
    summary["first_differing_iteration"] = first
    summary["plans_bitwise_equal"] = bool(np.array_equal(a.D, b.D))
    print(f"[repeat] two solves in one process: CR1 {a.carbon_reduction_pct!r}"
          f" / {a.total_penalty_pct!r} % and {b.carbon_reduction_pct!r} / "
          f"{b.total_penalty_pct!r} %, nit {a.nit} / {b.nit}; first "
          f"differing iterate: {first}")

    # 2. Repeated evaluations under the op trace.
    fun, cons = slsqp_functions(spec, dev)
    points = [np.zeros(dr.W * dr.T)] + its_a
    if first is not None:
        points = points[:first + 2]
    points = points[::10] + ([points[-1]] if (len(points) - 1) % 10 else [])
    calls = [("objective value+gradient", fun)]
    for j, c in enumerate(cons):
        calls += [(f"constraint {j} ({c['type']}) value", c["fun"]),
                  (f"constraint {j} ({c['type']}) jacobian", c["jac"])]
    diffs = []
    for k, x in enumerate(points):
        for what, fn in calls:
            logs, outs = zip(*(op_trace(torch, lambda: fn(x))
                               for _ in range(3)))
            flat = [np.concatenate([np.ravel(np.asarray(o, np.float64))
                                    for o in (out if isinstance(out, tuple)
                                              else (out,))]) for out in outs]
            same = all(np.array_equal(flat[0], f) for f in flat[1:])
            op = first_op_difference(logs)
            if not same or op is not None:
                diffs.append({"point": k, "call": what, "equal": same,
                              "first_op": None if op is None else list(op)})
    summary["evaluations"] = len(points) * len(calls) * 3
    summary["evaluation_differences"] = diffs[:20]
    print(f"[ops] {len(points)} points x {len(calls)} calls x 3 repeats: "
          f"{len(diffs)} differing (first: {diffs[0] if diffs else None})")

    # 3. The fleet calibrated on the CPU, solved on the card.
    dr_cpu = four_workloads(torch.device("cpu"))
    c = policies.cr1_spec(dr_cpu, 1.45)
    from repro_torch.core.solver import solve_slsqp
    r_cpu = solve_slsqp(c, maxiter=args.maxiter, device=dev)
    summary["cpu_fleet_hash"] = models_hash(np, dr_cpu)
    summary["cpu_fleet_on_card"] = {
        "carbon_pct": r_cpu.carbon_reduction_pct,
        "penalty_pct": r_cpu.total_penalty_pct, "nit": r_cpu.nit}
    gaps = {n: max(abs(m.k / w.k - 1.0), float(np.max(np.abs(
        np.asarray(m.params) - np.asarray(w.params)))))
        for n, m, w in zip(ORDER, dr_cpu.models, dr.models)}
    summary["cpu_vs_card_model_gaps"] = gaps
    print(f"[fleet] card-calibrated fleet {summary['card_fleet_hash']}, "
          f"CPU-calibrated {summary['cpu_fleet_hash']}; largest k / param "
          f"gap per model {gaps}; CR1 on the CPU-calibrated fleet (card) "
          f"{r_cpu.carbon_reduction_pct!r} / {r_cpu.total_penalty_pct!r} %")
    out = pathlib.Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(summary, indent=1))
    print(json.dumps(summary))
    return 0 if first is None and summary["plans_bitwise_equal"] else 1


if __name__ == "__main__":
    sys.exit(main())
