#!/usr/bin/env python3
"""Where the time of the port's fused CR1/CR2 solves goes on the card.

    python3 scripts/port_profile.py

Builds chip_smoke's fleet (paper fleet at num_samples=32, num_jobs=1000,
cloned to W = 10,000, T = 48), warms up, then solves CR1(1.45) and
CR2(0.78) at their default steps under `torch.profiler` (CPU and CUDA
activities). For each solve it prints the wall time, the device-busy time
(the union of the traced kernel and copy intervals), the device idle share
1 - busy / wall, and the device time by kernel name, with the card's name
and power limit. If the trace holds no device events it says so.
"""
from __future__ import annotations

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


def main() -> int:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.api import CR1, CR2, SolveContext, solve
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
    for pol in (CR1(lam=1.45), CR2(cap_frac=0.78)):
        solve(p, pol, ctx=SolveContext(steps=8))
    torch.cuda.synchronize()
    for pol in (CR1(lam=1.45), CR2(cap_frac=0.78)):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            solve(p, pol)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        if not dev:
            print(f"{pol.name}: the trace holds no device events")
            continue
        busy = _busy_us((e.time_range.start, e.time_range.end) for e in dev)
        print(f"{pol.name}: wall {wall_us / 1e3:.3f} ms (profiler on), device "
              f"busy {busy / 1e3:.3f} ms, idle share "
              f"{1.0 - busy / wall_us:.4f}, {len(dev)} device events")
        by_name: dict[str, list[float]] = {}
        for e in dev:
            by_name.setdefault(e.name, []).append(
                e.time_range.end - e.time_range.start)
        top = sorted(by_name.items(), key=lambda kv: -sum(kv[1]))[:8]
        for name, ts in top:
            print(f"  {sum(ts) / 1e3:9.3f} ms  {len(ts):5d} x  {name[:90]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
