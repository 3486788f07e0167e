"""DR-aware training driver: the port of `repro/launch/train.py`.

Runs a training loop on one device with
  * the AdamW train step (`launch/steps.py`), updating in place,
  * the fault-tolerant runner (checkpoint/restart, straggler watchdog),
  * an optional Carbon Responder throttle schedule, the DR enforcement
    path: a steps-per-hour budget scaled by the fleet coordinator's
    schedule.

    PYTHONPATH=src python -m repro_torch.launch.train --arch stablelm-3b \\
        --reduced --steps 200 --batch 8 --seq 128 --dr-lambda 1.45

runs on the card; `--device cpu` runs the plain path on the CPU.
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Any

import numpy as np

from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import ShapeCell
from repro_torch.data.pipeline import DataConfig, PrefetchingLoader
from repro_torch.kernels.dispatch import resolve_device
from repro_torch.launch.steps import make_train_step, model_module
from repro_torch.optim.adamw import AdamWConfig, adamw_init
from repro_torch.runtime.checkpoint import CheckpointManager
from repro_torch.runtime.ft import FailurePlan, FTConfig, FaultTolerantRunner


def hour_budgets(steps: int, throttle: np.ndarray) -> list[int]:
    """Each simulated hour's step budget: the base budget steps // hours
    scaled by that hour's throttle, at least one step, the last hour cut
    to the steps left."""
    base_budget = max(1, steps // len(throttle))
    budgets, done, hour = [], 0, 0
    while done < steps:
        budget = max(1, int(round(base_budget
                                  * throttle[hour % len(throttle)])))
        budget = min(budget, steps - done)
        budgets.append(budget)
        done += budget
        hour += 1
    return budgets


def train(cfg, shape: ShapeCell, steps: int, ckpt_dir: str,
          opt_cfg: AdamWConfig | None = None,
          throttle: np.ndarray | None = None,
          failure_plan: FailurePlan | None = None,
          seconds_per_hour: float = 5.0,
          log_every: int = 20, device=None) -> dict[str, Any]:
    """Returns a report dict with losses, events, throughput, the final
    state (`params`, `opt_state`), each checkpoint's timings and, under a
    throttle, each hour's step budget. The parameters are drawn from seed
    0 on `device` (the card by default). The step updates the state in
    place, as the reference's donated step: a failure before the first
    checkpoint retries the step from the state as it is."""
    opt_cfg = opt_cfg or AdamWConfig(total_steps=steps)
    mod = model_module(cfg)
    params = mod.init_params(cfg, seed=0, device=resolve_device(device))
    opt_state = adamw_init(params, opt_cfg)
    step_fn = make_train_step(cfg, opt_cfg)
    loader = PrefetchingLoader(cfg, shape, DataConfig())
    ckpt = CheckpointManager(ckpt_dir)
    ft_cfg = FTConfig(checkpoint_every=max(steps // 5, 10))
    runner = FaultTolerantRunner(step_fn, ckpt, ft_cfg, failure_plan)

    losses: list[float] = []
    budgets: list[int] = []
    t_start = time.time()
    if throttle is None:
        params, opt_state, losses = runner.run(
            params, opt_state, loader, num_steps=steps)
    else:
        # DR enforcement: each simulated "hour" gets a step budget scaled
        # by the CR throttle for that hour.
        budgets = hour_budgets(steps, throttle)
        done = 0
        for budget in budgets:
            params, opt_state, ls = runner.run(
                params, opt_state, loader, start_step=done,
                num_steps=budget)
            losses.extend(ls)
            done += budget
    loader.close()
    ckpt.wait()
    wall = time.time() - t_start
    return {
        "losses": losses,
        "final_loss": losses[-1] if losses else float("nan"),
        "steps": len(losses),
        "wall_s": wall,
        "steps_per_s": len(losses) / max(wall, 1e-9),
        "events": runner.events,
        "budgets": budgets,
        "checkpoints": ckpt.timings,
        "params": params,
        "opt_state": opt_state,
    }


def dr_throttle(arch: str, lam: float, device=None) -> np.ndarray:
    """The training job's hourly throttle under CR1(lam) over
    `caiso_2021(48)`, from `FleetCoordinator.plan`, as the reference's
    `main()` builds it."""
    from repro_torch.core.carbon import caiso_2021
    from repro_torch.core.fleet import FleetCoordinator, FleetJob
    from repro_torch.power.model import JobPowerModel
    job = FleetJob(name=arch, role="train",
                   power=JobPowerModel(name=arch, chips=256,
                                       t_compute_s=0.4, t_step_s=0.5))
    coord = FleetCoordinator([job], caiso_2021(48), lam=lam, device=device)
    schedules, result = coord.plan()
    throttle = schedules[arch].throttle
    print(f"DR plan: carbon ↓{result.carbon_reduction_pct:.2f}%, "
          f"penalty {result.total_penalty_pct:.2f}%; "
          f"mean throttle {throttle.mean():.3f}")
    return throttle


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="stablelm-3b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--d-model", type=int, default=256)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default="var/ckpt")
    ap.add_argument("--dr-lambda", type=float, default=None,
                    help="enable CR1 throttling with this λ")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args()

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg, layers=args.layers, d_model=args.d_model,
                      vocab=4096)
    shape = ShapeCell("cli", args.seq, args.batch, "train")
    throttle = (None if args.dr_lambda is None
                else dr_throttle(args.arch, args.dr_lambda, args.device))
    report = train(cfg, shape, args.steps, args.ckpt_dir, throttle=throttle,
                   device=args.device)
    report.pop("params")
    report.pop("opt_state")
    print(json.dumps({k: (v if not isinstance(v, list) else v[-5:])
                      for k, v in report.items()}, default=str, indent=1))


if __name__ == "__main__":
    main()
