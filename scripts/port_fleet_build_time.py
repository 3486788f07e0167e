#!/usr/bin/env python3
"""Time the port's paper-fleet calibration on this host.

    python3 scripts/port_fleet_build_time.py [NUM_SAMPLES NUM_JOBS] [--cpu]

Runs `repro_torch.core.penalty.build_paper_fleet` (EDD simulations on the
host, features and the Lasso fit on the CUDA device, or the CPU with
--cpu) without the cache and prints the seconds it took. Defaults to the
full calibration, 160 samples and 10,000 jobs.
"""
from __future__ import annotations

import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))


def main(argv: list[str]) -> int:
    from repro_torch.core.penalty import build_paper_fleet
    device = "cpu" if "--cpu" in argv else None
    nums = [int(a) for a in argv if a != "--cpu"] or [160, 10_000]
    t0 = time.perf_counter()
    fleet = build_paper_fleet(hours=48, num_samples=nums[0],
                              num_jobs=nums[1], device=device)
    print(f"build_paper_fleet(num_samples={nums[0]}, num_jobs={nums[1]}) on "
          f"{device or 'cuda'}: {time.perf_counter() - t0:.2f} s; k = "
          + ", ".join(f"{n} {m.k:.6g}" for n, m in fleet.items()))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
