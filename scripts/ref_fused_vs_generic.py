#!/usr/bin/env python3
"""The JAX package's CR1/CR2 solves, fused (its al_step kernel in interpret
mode on the CPU) against its generic engine, at default steps.

    JAX_PLATFORMS=cpu PYTHONPATH=src \
        python3 scripts/ref_fused_vs_generic.py [W ...]

For each fleet size (default 1024 2048) prints carbon %, penalty % and the
batch day-preservation violation of both paths and their difference. A
reading of the reference: the port's PERF.md and ROADMAP cite it for the
reference's fused-vs-generic gap and its 3-round projection.
"""
from __future__ import annotations

import sys
import time


def main(argv: list[str]) -> int:
    from repro.core.api import CR1, CR2, SolveContext, solve
    from repro.core.fleet_solver import synthetic_fleet
    for W in [int(a) for a in argv] or [1024, 2048]:
        p = synthetic_fleet(W, hours=48, seed=0)
        for pol in (CR1(lam=1.45), CR2(cap_frac=0.78)):
            out = {}
            for use_kernel in (False, True):
                t0 = time.perf_counter()
                r = solve(p, pol, ctx=SolveContext(use_kernel=use_kernel))
                out[use_kernel] = r
                print(f"W={W} {pol.name} "
                      f"{'fused' if use_kernel else 'generic'}: carbon "
                      f"{r.carbon_reduction_pct:.4f} % penalty "
                      f"{r.total_penalty_pct:.4f} % preservation "
                      f"{r.preservation_violation:.3e} "
                      f"({time.perf_counter() - t0:.1f} s, CPU)", flush=True)
            dc = (out[True].carbon_reduction_pct
                  - out[False].carbon_reduction_pct)
            dp = out[True].total_penalty_pct - out[False].total_penalty_pct
            print(f"W={W} {pol.name} fused - generic: carbon {dc:+.4f} pp "
                  f"penalty {dp:+.4f} pp", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
