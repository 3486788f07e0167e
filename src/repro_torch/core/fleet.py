"""FleetCoordinator: Carbon Responder as a first-class framework feature.

Maps LM jobs (arch × shape × chips) onto CR workloads, solves a DR policy
against the grid's carbon signal, and emits per-job hourly throttle
schedules that the training/serving drivers enforce (steps-per-hour
budgets / admission control), the datacenter-workload interface of
Fig. 2/3.

Workload typing (paper §III-B):
  train  -> "batch without SLOs" (AI-training penalty family)
  serve  -> "real-time" (Dynamo latency polynomials)
  data   -> "batch with SLOs" (pipeline penalty family)

The solves run on `device` (the CUDA device unless "cpu"): `plan`
through the SLSQP reference or `solve_adam` (`core/solver.py`),
`plan_streaming` through `RollingHorizonSolver`.
"""
from __future__ import annotations

import dataclasses
from typing import Literal, Sequence

import numpy as np
import torch

from repro_torch.core import penalty as pen
from repro_torch.core.carbon import CarbonSignal, ForecastStream
from repro_torch.core.policies import DRProblem, cr1_spec, cr2_spec
from repro_torch.core.solver import SolveResult, solve_adam, solve_slsqp
from repro_torch.power.model import JobPowerModel

Role = Literal["train", "serve", "data"]


@dataclasses.dataclass(frozen=True)
class FleetJob:
    name: str
    role: Role
    power: JobPowerModel
    # usage ripple: serving follows diurnal traffic, training is flat.
    diurnal_amplitude: float | None = None


@dataclasses.dataclass
class ThrottleSchedule:
    """Hourly throughput multipliers for one job."""
    name: str
    throttle: np.ndarray          # (T,) in (0, 1]
    power_cut_np: np.ndarray      # (T,) NP shed

    def at_hour(self, t: int) -> float:
        return float(self.throttle[t % len(self.throttle)])


def _usage_trace(job: FleetJob, hours: int) -> np.ndarray:
    base = job.power.power_np
    amp = job.diurnal_amplitude
    if amp is None:
        amp = 0.05 if job.role == "serve" else 0.01
    t = np.arange(hours)
    return base * (1.0 + amp * np.sin(2 * np.pi * (t - 15) / 24.0))


def _penalty_model(job: FleetJob, hours: int,
                   templates: dict[str, pen.PenaltyModel],
                   ) -> pen.PenaltyModel:
    usage = _usage_trace(job, hours)
    # Entitlement headroom above peak draw scales with the job's static
    # power share: a mostly-static job (low dynamic_fraction) cannot shed
    # load on request, so its NP contract books the full 15% cushion; a
    # fully dynamic job can ride out grid events by throttling and books
    # half that.
    headroom = 1.0 / max(job.power.dynamic_fraction, 0.5)
    entitlement = float(usage.max() * (1.0 + 0.075 * headroom))
    if job.role == "serve":
        base = templates["RTS1"]
        return dataclasses.replace(base, name=job.name, usage=usage,
                                   entitlement=entitlement)
    key = "AITraining" if job.role == "train" else "DataPipeline"
    base = templates[key]
    scale = usage.mean() / max(base.usage.mean(), 1e-9)
    jobs_per_hour = (base.jobs if base.jobs is not None
                     else np.ones(hours)) * scale
    return dataclasses.replace(base, name=job.name, usage=usage,
                               entitlement=entitlement,
                               jobs=jobs_per_hour[:hours])


class FleetCoordinator:
    """Coordinates the fleet's DR plan under one policy.

    `policy` is a `repro_torch.core.api` policy object (`CR1(lam=...)`,
    ...) or a `POLICY_REGISTRY` name; with a name, the legacy
    `lam`/`cap_frac` knobs configure the policy object
    (`api.configured_policy`). Unregistered names fall back to CR1.
    `device`: where the solves run (None = the CUDA device)."""

    def __init__(self, jobs: Sequence[FleetJob], signal: CarbonSignal,
                 policy="cr1", lam: float = 1.45,
                 cap_frac: float = 0.78, solver: str = "auto",
                 device: str | torch.device | None = None):
        self.jobs = list(jobs)
        self.signal = signal
        self.policy = policy
        self.lam = lam
        self.cap_frac = cap_frac
        self.solver = solver
        self.device = device

    def _policy_obj(self):
        """The configured policy as a policy object."""
        from repro_torch.core.api import CR1, POLICY_REGISTRY, configured_policy
        if isinstance(self.policy, str) and self.policy not in POLICY_REGISTRY:
            return CR1(lam=self.lam)     # unregistered-name fallback
        return configured_policy(self.policy, lam=self.lam,
                                 cap_frac=self.cap_frac)

    def _models(self, hours: int) -> tuple[pen.PenaltyModel, ...]:
        from repro_torch.core.fleetcache import cached_paper_fleet
        templates = cached_paper_fleet(hours=hours, device=self.device)
        return tuple(_penalty_model(j, hours, templates)
                     for j in self.jobs)

    def _dynamic_cap(self, usage: np.ndarray) -> np.ndarray:
        """(W, T) realizable curtailment cap: a job can only shed its
        dynamic power by throttling; cuts past that saturate at the idle
        floor (throttle 0, i.e. killing the job for the hour)."""
        dyn = np.asarray([j.power.dynamic_fraction for j in self.jobs])
        return 0.95 * dyn[:, None] * np.asarray(usage)

    @staticmethod
    def _schedule(job: FleetJob, cuts: np.ndarray,
                  usage: np.ndarray) -> ThrottleSchedule:
        """Hourly throttles enforcing `cuts` (NP) against `usage` (NP)."""
        cut_frac = np.clip(np.asarray(cuts) / np.maximum(usage, 1e-9),
                           -1, 1)
        throttle = np.asarray(
            [job.power.throttle_for_power_cut(max(c, 0.0))
             for c in cut_frac])
        return ThrottleSchedule(name=job.name, throttle=throttle,
                                power_cut_np=np.asarray(cuts))

    def plan(self) -> tuple[dict[str, ThrottleSchedule], SolveResult]:
        """Solve the DR problem and emit per-job throttle schedules."""
        hours = self.signal.hours
        models = self._models(hours)
        problem = DRProblem(models=models, mci=self.signal.mci)
        # Tighten the box to the realizable (dynamic-range) cap; CR2's
        # fairness targets are computed under the same tightened box so
        # its penalty-equality constraints remain attainable.
        upper = np.minimum(problem.bounds()[1],
                           self._dynamic_cap(problem.usage))
        pol = self._policy_obj()
        spec = (cr2_spec(problem, pol.cap_frac, upper=upper,
                         device=self.device)
                if pol.name == "cr2"
                else dataclasses.replace(
                    cr1_spec(problem, getattr(pol, "lam", self.lam)),
                    upper=upper))
        use_slsqp = (self.solver == "slsqp"
                     or (self.solver == "auto" and len(self.jobs) <= 8))
        result = (solve_slsqp(spec, device=self.device) if use_slsqp
                  else solve_adam(spec, device=self.device))
        schedules = {
            job.name: self._schedule(job, result.D[i], problem.usage[i])
            for i, job in enumerate(self.jobs)}
        return schedules, result

    def plan_streaming(self, n_ticks: int = 24,
                       stream: ForecastStream | None = None,
                       revision_sigma: float = 0.03, seed: int = 0,
                       cold_steps: int = 600, warm_steps: int = 150):
        """Online operation: rolling-horizon re-solves as forecasts revise.

        Instead of one day-ahead plan, run `n_ticks` hourly re-solves
        (warm-started, see `repro_torch.core.streaming`), committing one
        hour each tick. Returns `(schedules, report)`: per-job throttle
        schedules covering the `n_ticks` committed hours, and the
        `StreamingReport` with realized-vs-forecast carbon accounting.

        `stream` defaults to a revision-model stream whose realized series
        periodically extends this coordinator's carbon signal. As in
        `plan`, the solve box is tightened to each job's realizable
        dynamic-power range (`FleetProblem.upper`), so committed cuts are
        deliverable and the carbon ledger is honest."""
        from repro_torch.core.fleet_solver import from_models
        from repro_torch.core.streaming import RollingHorizonSolver
        hours = self.signal.hours
        fp = from_models(self._models(hours), self.signal.mci)
        fp = dataclasses.replace(fp, upper=self._dynamic_cap(fp.usage))
        if stream is None:
            stream = ForecastStream(
                actual=np.resize(self.signal.mci, n_ticks + hours),
                horizon=hours, revision_sigma=revision_sigma, seed=seed)
        solver = RollingHorizonSolver(
            fp, stream, policy=self._policy_obj(), cold_steps=cold_steps,
            warm_steps=warm_steps, device=self.device)
        report = solver.run(n_ticks)
        usage = np.asarray(fp.usage)
        ticks = np.arange(n_ticks) % hours
        schedules = {
            job.name: self._schedule(job, report.committed[i],
                                     usage[i, ticks])
            for i, job in enumerate(self.jobs)}
        return schedules, report
