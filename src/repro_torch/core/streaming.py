"""Rolling-horizon streaming DR: re-solve as MCI forecasts revise.

The paper plans against a static day-ahead marginal-carbon-intensity
trace. A deployed Carbon Responder runs online: every hour the forecast
provider re-issues the day-ahead horizon, the coordinator re-solves,
commits only the first hour of the new plan, and the window slides
forward. This module is that control loop:

  * `ForecastStream` (`repro_torch.core.carbon`) supplies the revised
    horizons: a persistence + lead-time-noise revision model, or replayed
    snapshots.
  * `RollingHorizonSolver` holds a `FleetProblem` template plus a
    `DRPolicy` and, per tick:
      1. slides the usage/jobs window one hour and swaps in the fresh
         `(T,)` forecast,
      2. warm-starts `api.solve(problem, policy, ctx=...)` from the
         previous tick's `EngineState`, shifted one hour along time, with
         the mu schedule restarted (multipliers carry over: they price
         per-workload constraints, not hours),
      3. commits hour 0 of the new plan and logs forecast vs realized
         carbon for the committed hour.

`step()` is one eager solve per tick. `run_scanned()` hands a whole day
to `api.solve_day`, which on the card is one CUDA-graph replay of the
day's tick loop (captured on the first day of each configuration). The
warm start lets each tick run with a fraction of the cold solve's inner
Adam steps.

Receding-horizon caveat: batch day-preservation is enforced over the
sliding window's 24 h blocks each re-solve; only committed hours are
binding, so small per-window residuals wash out as the window slides.

Multi-region problems take one stream per region: each tick installs
the stacked (R, T) forecast, and the ledger prices each region's
committed total on its own forecast and realized trace. Only hour 0 of
each plan commits, so no migration stage runs on a tick.

Observability, as in the JAX package: `events` writes a JSONL tick
ledger (`repro_torch.obs`, one `TickEvent` a tick and the solve's
`TelemetryEvent`s, all written on the host after the solve or the
replay), `telemetry` samples each solve's convergence, and
`guard_recompiles` runs every re-solve or day of a configuration already
seen under `analysis.recompile_guard(0)`: no graph capture, no kernel
build.

A port of the JAX package's `repro.core.streaming`. CR3, B1 and B3 run
tick by tick (`step`/`run`); `run_scanned` takes CR1/CR2 only, as
`api.solve_day`. Over a fleet mesh (`mesh=`, SPMD: every process builds
the same controller and steps it alike) each tick is a sharded `solve`
and `run_scanned` a sharded `solve_day`; the solver's state is then the
padded one, which the next tick or day takes as it is.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Callable, Sequence

import numpy as np
import torch

from repro_torch.analysis.recompile import recompile_guard
from repro_torch.core.api import (DRPolicy, SolveContext, configured_policy,
                                  solve, solve_day)
from repro_torch.core.carbon import ForecastStream
from repro_torch.core.engine import EngineState
from repro_torch.core.fleet_solver import (FleetProblem, FleetSolveResult,
                                           single_region_view)
from repro_torch.core.regional import region_totals
from repro_torch.kernels.dispatch import resolve_device
from repro_torch.obs.events import EventWriter, TelemetryEvent, TickEvent
from repro_torch.obs.telemetry import TelemetryConfig


def _rel_revision(prev: np.ndarray | None, cur: np.ndarray) -> float:
    """Relative forecast-revision magnitude between consecutive horizons:
    `‖cur[:-1] − prev[1:]‖₂ / ‖prev[1:]‖₂` over the re-forecast hours
    both horizons cover (0.0 for the first horizon seen)."""
    if prev is None:
        return 0.0
    tail = prev[..., 1:]
    return float(np.linalg.norm((cur[..., :-1] - tail).ravel())
                 / max(np.linalg.norm(tail.ravel()), 1e-12))


@dataclasses.dataclass(frozen=True)
class TickResult:
    """One committed hour of online operation.

    `plan` (the full-horizon solve: D matrix, engine state, ...) is only
    retained on the latest tick: older history entries drop it so a
    long-lived controller holds O(W) per tick, not O(W·T)."""
    tick: int
    committed: np.ndarray        # (W,) NP adjustments enforced this hour
    forecast_mci: float | np.ndarray   # hour-0 forecast ((R,) multi-region)
    realized_mci: float | np.ndarray   # actual MCI once the hour elapsed
    inner_steps: int             # engine iterations spent on this re-solve
    plan: FleetSolveResult | None
    committed_by_region: np.ndarray | None = None  # (R,) multi-region only

    @property
    def forecast_carbon(self) -> float:
        """kg CO2 the plan expected to eliminate this hour."""
        if np.ndim(self.forecast_mci):
            return float((self.committed_by_region
                          * np.asarray(self.forecast_mci)).sum())
        return float(self.committed.sum() * self.forecast_mci)

    @property
    def realized_carbon(self) -> float:
        """kg CO2 actually eliminated this hour."""
        if np.ndim(self.realized_mci):
            return float((self.committed_by_region
                          * np.asarray(self.realized_mci)).sum())
        return float(self.committed.sum() * self.realized_mci)


@dataclasses.dataclass(frozen=True)
class StreamingReport:
    """Aggregate of a rolling-horizon run."""
    ticks: tuple[TickResult, ...]
    committed: np.ndarray        # (W, n_ticks)
    realized_carbon: float       # kg CO2 eliminated, priced at actual MCI
    forecast_carbon: float       # same hours priced at solve-time forecasts
    realized_baseline: float     # no-DR carbon of the committed hours
    total_inner_steps: int

    @property
    def realized_reduction_pct(self) -> float:
        return 100.0 * self.realized_carbon / max(self.realized_baseline,
                                                  1e-12)

    @property
    def forecast_error_pct(self) -> float:
        """|forecast − realized| carbon for committed hours, % of realized."""
        return 100.0 * abs(self.forecast_carbon - self.realized_carbon) \
            / max(abs(self.realized_carbon), 1e-12)


class RollingHorizonSolver:
    """Online DR controller: warm-started re-solves over a sliding window.

    Args:
      problem: fleet template; `usage`/`jobs` (and `upper`) are treated as
        periodic traces that slide with the window (`np.roll` along time).
      stream: revised-forecast source; `stream.horizon` must equal
        `problem.T` (a sequence of one stream is accepted). A multi-region
        problem takes a sequence of `problem.R` streams (e.g.
        `ForecastStream.regional`); each tick then installs the stacked
        (R, T) forecast. The migration post-stage is not applied on a
        tick: only hour 0 of a plan commits.
      policy: a `DRPolicy` object (`CR1(lam=...)`, `CR2(...)`,
        `CR3(...)`, `B1(...)`, `B3(...)`) or a registry name; unknown
        names raise `ValueError` here.
      lam, cap_frac, rho, tax_frac, outer: configure the policy when it
        is given by name (`api.configured_policy`); ignored for a policy
        object.
      cold_steps: inner Adam steps for the tick-0 cold solve.
      warm_steps: inner steps for warm-started re-solves.
      use_kernel: as `SolveContext.use_kernel` (None: the kernels on
        CUDA, the plain path on the CPU).
      device: where the solves run (None: the CUDA device; "cpu" for the
        plain PyTorch path).
      donate: `SolveContext.donate` for `run_scanned`: the solver's state
        may alias the day graph's buffers (a later day of the same
        configuration, on any solver, overwrites it).
      adaptive_warm: scale each warm tick's budget by the forecast
        revision magnitude instead of spending `warm_steps` flat: the
        tick's relative revision (`_rel_revision`) maps linearly onto
        `[warm_steps_min, warm_steps]`, quantized to 4 levels and
        saturating at `revision_ref`.
      warm_steps_min: floor for adaptive budgets (default
        `warm_steps // 4`).
      revision_ref: relative revision magnitude that earns the full
        `warm_steps` (default 0.05).
      mesh: a fleet mesh (`launch.mesh.make_fleet_mesh`): every tick's
        re-solve and `run_scanned`'s day shard the fleet's rows over its
        processes (`SolveContext.mesh`); checked here
        (`launch.mesh.check_fleet_mesh`). Only the first of the fleet's
        ranks (`launch.mesh.fleet_ranks`) keeps `events`.
      guard_recompiles: enforce the warm-path claim at runtime. The
        first solve of each static configuration (a (steps, warm) tick,
        or a day of n ticks, cold or warm) may capture a graph or build
        a kernel; every later one runs inside
        `analysis.recompile_guard(0)` and raises `RecompileError` if it
        captures or builds (a drifted configuration turning one replay a
        day into a capture a day).
      events: JSONL tick ledger, a path or an open `obs.EventWriter`.
        Every `step()` / `run_scanned()` tick appends a `TickEvent`
        (forecast revision, steps spent, solve latency, per-region
        committed and realized carbon, migration credit, captures and
        builds, dispatches) and its convergence samples as
        `TelemetryEvent`s, written on the host after the solve or the
        replay, so a day stays one replay. Render it with
        `python -m repro_torch.obs.report <path>`.
      telemetry: `obs.TelemetryConfig`: each tick's solve records its
        convergence trace (CR1/CR2 on the generic engine, so
        `use_kernel=False` on the card; see `SolveContext.telemetry`).
        With `events` the samples land in the ledger; without, the trace
        is on `tick.plan.extras["telemetry"]`.

    CR3: the policy's `rho` is the configured price, so every window
    re-clears from it (clearing only ever lowers rho; carrying a lowered
    price forward would ratchet the fleet onto a depressed price after
    one transient tick). `last_rho` is the latest cleared price
    (`plan.extras["rho"]`, (R,) over regions); None for the policies that
    clear none.
    """

    def __init__(self, problem: FleetProblem,
                 stream: ForecastStream | Sequence[ForecastStream], *,
                 policy: str | DRPolicy = "cr1", lam: float = 1.45,
                 cap_frac: float = 0.78, rho: float = 0.02,
                 tax_frac: float = 0.2, cold_steps: int = 600,
                 warm_steps: int = 150, outer: int = 4,
                 use_kernel: bool | None = None,
                 device: str | torch.device | None = None,
                 mesh=None, donate: bool = False,
                 adaptive_warm: bool = False,
                 warm_steps_min: int | None = None,
                 revision_ref: float = 0.05,
                 guard_recompiles: bool = False,
                 events: EventWriter | str | None = None,
                 telemetry: TelemetryConfig | None = None):
        if mesh is not None:
            from repro_torch.launch.mesh import check_fleet_mesh, fleet_ranks
            check_fleet_mesh(mesh, resolve_device(device))
            # Every process steps the same controller: one tick ledger,
            # kept by the first of the fleet's ranks.
            if torch.distributed.get_rank() != fleet_ranks(mesh)[0]:
                events = None
        streams = (tuple(stream) if isinstance(stream, (list, tuple))
                   else (stream,))
        # R = 1 canonicalizes up front: the whole streaming path, the
        # ledger included, is then the single-region one bit for bit.
        problem = single_region_view(problem)
        if len(streams) != problem.R:
            raise ValueError(
                f"need {problem.R} forecast stream(s) for this problem "
                f"(R={problem.R}), got {len(streams)}")
        for st in streams:
            if st.horizon != problem.T:
                raise ValueError(f"stream horizon {st.horizon} != "
                                 f"problem.T {problem.T}")
        self.problem = problem
        self.streams = streams
        self.stream = streams[0]
        self.policy = configured_policy(policy, lam=lam, cap_frac=cap_frac,
                                        rho=rho, tax_frac=tax_frac,
                                        outer=outer)
        self.last_rho = getattr(self.policy, "rho", None)
        self.cold_steps = cold_steps
        self.warm_steps = warm_steps
        self.adaptive_warm = adaptive_warm
        self.warm_steps_min = max(1, warm_steps // 4) \
            if warm_steps_min is None else warm_steps_min
        if not 0 < self.warm_steps_min <= warm_steps:
            raise ValueError(
                f"warm_steps_min must be in (0, warm_steps={warm_steps}]; "
                f"got {self.warm_steps_min}")
        if revision_ref <= 0:
            raise ValueError(f"revision_ref must be > 0, got {revision_ref}")
        self.revision_ref = revision_ref
        self.use_kernel = use_kernel
        self.device = device
        self.mesh = mesh
        self.donate = donate
        self.guard_recompiles = guard_recompiles
        if events is None or isinstance(events, EventWriter):
            self.events = events
        else:
            self.events = EventWriter(
                events, tags={"policy": self.policy.name,
                              "cold_steps": cold_steps,
                              "warm_steps": warm_steps})
        self.telemetry = telemetry
        self._seen: set[tuple] = set()
        self._state: EngineState | None = None
        self._prev_forecast: np.ndarray | None = None
        self._tick = 0
        self._history: list[TickResult] = []

    # -- per-tick plumbing --------------------------------------------------
    @property
    def _n_ticks(self) -> int:
        return min(st.n_ticks for st in self.streams)

    def _forecast(self, tick: int) -> np.ndarray:
        """This tick's revised horizon: (T,), or (R, T) stacked over the
        per-region streams."""
        if not self.problem.is_multiregion:
            return self.stream.forecast(tick)
        return np.stack([st.forecast(tick) for st in self.streams])

    def _realized(self, tick: int) -> float | np.ndarray:
        if not self.problem.is_multiregion:
            return self.stream.realized(tick)
        return np.array([st.realized(tick) for st in self.streams])

    def _tick_result(self, tick: int, committed: np.ndarray,
                     mci_hat: np.ndarray, inner_steps: int,
                     plan: FleetSolveResult | None) -> TickResult:
        multi = self.problem.is_multiregion
        return TickResult(
            tick=tick, committed=committed,
            forecast_mci=(mci_hat[:, 0].copy() if multi
                          else float(mci_hat[0])),
            realized_mci=self._realized(tick), inner_steps=inner_steps,
            plan=plan, committed_by_region=(
                region_totals(self.problem.region, committed, self.problem.R)
                if multi else None))

    def _window_problem(self, tick: int, mci: np.ndarray) -> FleetProblem:
        """Slide usage/jobs (and any operational cap) to hours
        [tick, tick+T) and install `mci`. The migration topology is
        dropped: only hour 0 of each plan commits, so a migration stage
        on a tick would price hours that never run."""
        p = self.problem

        def roll(a):
            return None if a is None else np.roll(a, -tick, axis=1)

        return dataclasses.replace(p, mci=np.asarray(mci), topology=None,
                                   usage=roll(p.usage), jobs=roll(p.jobs),
                                   upper=roll(p.upper))

    def _ctx(self, **kw) -> SolveContext:
        return SolveContext(device=self.device, mesh=self.mesh,
                            donate=self.donate, use_kernel=self.use_kernel,
                            telemetry=self.telemetry, **kw)

    # -- guard and tick ledger ------------------------------------------------
    def _guard(self, key: tuple):
        """`recompile_guard(0)` around a re-solve or day of a static
        configuration already seen (`guard_recompiles=True`); the first
        of each `key`, and everything when the knob is off, runs
        unguarded."""
        if not self.guard_recompiles or key not in self._seen:
            self._seen.add(key)
            return contextlib.nullcontext()
        return recompile_guard(0, label=f"tick {self._tick} {key[0]}")

    def _measure(self):
        """Capture and build counters (measurement only) while the ledger
        is on: attributes compiles to ticks; nests inside `_guard`."""
        if self.events is None:
            return contextlib.nullcontext(None)
        return recompile_guard(None, label="tick ledger")

    def _emit_tick(self, out: TickResult, *, revision: float,
                   latency_s: float, recompiles: int, dispatches: int,
                   cold: bool, objective_proxy: float | None,
                   trace=None) -> None:
        """Append one `TickEvent` and the tick's `TelemetryEvent`s, on the
        host after the solve returned."""
        if self.events is None:
            return
        if out.committed_by_region is not None:
            per = np.asarray(out.committed_by_region, float)
            committed = (per * np.asarray(out.forecast_mci, float)).tolist()
            realized = (per * np.asarray(out.realized_mci, float)).tolist()
        else:
            tot = float(out.committed.sum())
            committed = [tot * float(out.forecast_mci)]
            realized = [tot * float(out.realized_mci)]
        plan = out.plan
        credit = 0.0
        if plan is not None and "migration" in plan.extras:
            credit = float(plan.extras["migration"].net_saved)
        self.events.write(TickEvent(
            tick=out.tick, revision=float(revision),
            warm_steps=int(out.inner_steps), cold=bool(cold),
            objective_proxy=objective_proxy, latency_s=float(latency_s),
            committed_carbon=committed, realized_carbon=realized,
            migration_credit=credit, recompiles=int(recompiles),
            dispatches=int(dispatches)))
        if trace is not None:
            for sample in trace.samples():
                self.events.write(TelemetryEvent(tick=out.tick, **sample))

    def _warm_budget(self, rel: float) -> int:
        """Inner steps for this warm tick: `warm_steps` flat, or scaled by
        the forecast revision magnitude `rel` under `adaptive_warm`."""
        if not self.adaptive_warm or self._prev_forecast is None:
            return self.warm_steps
        frac = min(1.0, rel / self.revision_ref)
        frac = round(3 * frac) / 3         # 4 budget levels
        return int(round(self.warm_steps_min
                         + (self.warm_steps - self.warm_steps_min) * frac))

    def _retire_plan(self) -> None:
        """Bound memory: the full plan lives on the latest tick only."""
        if self._history:
            self._history[-1] = dataclasses.replace(self._history[-1],
                                                    plan=None)

    def step(self) -> TickResult:
        """Ingest the next forecast revision, re-solve, commit hour 0."""
        tick = self._tick
        mci_hat = self._forecast(tick)
        warm = self._state
        rev = _rel_revision(self._prev_forecast, mci_hat)
        # Warm ticks shift the plan one hour and restart the mu schedule
        # at the policy's mu0: without the reset, mu compounds by
        # mu_growth^outer per tick and CR2's walls turn stiff within a
        # handful of ticks (multipliers still carry the constraint prices).
        steps = self.cold_steps if warm is None else self._warm_budget(rev)
        p_t = self._window_problem(tick, mci_hat)
        t0 = time.perf_counter()
        with self._guard(("tick", steps, warm is not None)), \
                self._measure() as stats:
            plan = solve(p_t, self.policy,
                         ctx=self._ctx(shift=0 if warm is None else 1,
                                       reset_mu=warm is not None, warm=warm,
                                       steps=steps))
        latency = time.perf_counter() - t0
        if "rho" in plan.extras:
            self.last_rho = plan.extras["rho"]
        self._state = plan.state
        self._prev_forecast = mci_hat
        self._tick = tick + 1
        out = self._tick_result(tick, np.asarray(plan.D[:, 0]), mci_hat,
                                plan.iters, plan)
        self._emit_tick(out, revision=rev, latency_s=latency,
                        recompiles=(stats.captures + stats.builds
                                    if stats else 0),
                        dispatches=1, cold=warm is None,
                        objective_proxy=float(plan.carbon_reduction_pct),
                        trace=plan.extras.get("telemetry"))
        self._retire_plan()
        self._history.append(out)
        return out

    def run(self, n_ticks: int | None = None,
            on_tick: Callable[[TickResult], None] | None = None,
            ) -> StreamingReport:
        """Run `n_ticks` hours (default: all the streams support)."""
        n = self._n_ticks - self._tick if n_ticks is None else n_ticks
        for _ in range(n):
            out = self.step()
            if on_tick is not None:
                on_tick(out)
        return self.report()

    def run_scanned(self, n_ticks: int | None = None) -> StreamingReport:
        """Run `n_ticks` hours as one `api.solve_day`: on the card one
        CUDA-graph replay of the whole day.

        Precomputes the (n_ticks, T) forecast-revision stack from the
        stream ((n_ticks, R, T) over regions). Matches the per-tick
        `run()` loop to < 0.01 pp realized carbon (CR1/CR2).
        Warm-continues from and updates the solver state, so
        `run_scanned(24)` per day and mixed `step()` / `run_scanned()`
        schedules both work. `adaptive_warm` is refused: a day's budget
        is part of its static configuration.
        """
        if self.adaptive_warm:
            raise ValueError(
                "run_scanned needs a flat warm budget: adaptive_warm picks "
                "each tick's step count from the forecast revision at run "
                "time, which one captured day cannot express; construct "
                "with adaptive_warm=False or use run()")
        t0 = self._tick
        n = self._n_ticks - t0 if n_ticks is None else n_ticks
        if n <= 0:
            raise ValueError(f"n_ticks must be >= 1, got {n}")
        mci_stack = np.stack([self._forecast(t0 + i) for i in range(n)])
        was_cold = self._state is None
        # Each tick's revision, walked over the stack before
        # _prev_forecast moves to the day's last horizon.
        prev, revs = self._prev_forecast, []
        for f in mci_stack:
            revs.append(_rel_revision(prev, f))
            prev = f
        t_start = time.perf_counter()
        with self._guard(("day", n, not was_cold)), \
                self._measure() as stats:
            day = solve_day(self._window_problem(t0, mci_stack[0]),
                            self.policy, mci_stack,
                            ctx=self._ctx(warm=self._state, shift=1,
                                          reset_mu=not was_cold),
                            cold_steps=self.cold_steps,
                            warm_steps=self.warm_steps)
        latency = time.perf_counter() - t_start
        self._state = day.last.state
        self._prev_forecast = mci_stack[-1]
        self._tick = t0 + n
        self._retire_plan()
        outs = [self._tick_result(
            t0 + i, day.committed[i], mci_stack[i], day.inner_steps[i],
            day.last if i == n - 1 else None) for i in range(n)]
        # One replay (or eager day) ran the whole day: its latency,
        # compiles and dispatch land on the day's first tick, the
        # objective proxy on its last (the only plan the day keeps).
        traces = day.last.extras.get("telemetry", ())
        for i, out in enumerate(outs):
            self._emit_tick(
                out, revision=revs[i], latency_s=latency if i == 0 else 0.0,
                recompiles=(stats.captures + stats.builds
                            if stats and i == 0 else 0),
                dispatches=1 if i == 0 else 0, cold=i == 0 and was_cold,
                objective_proxy=(float(day.last.carbon_reduction_pct)
                                 if i == n - 1 else None),
                trace=traces[i] if i < len(traces) else None)
        self._history.extend(outs)
        return self.report()

    def report(self) -> StreamingReport:
        ticks = tuple(self._history)
        if not ticks:
            raise RuntimeError("no ticks committed yet: call step()/run()")
        p = self.problem
        base_usage = np.asarray(p.usage)
        Tn = base_usage.shape[1]
        if p.is_multiregion:
            baseline = sum(float((np.asarray(t.realized_mci) * region_totals(
                p.region, base_usage[:, t.tick % Tn], p.R)).sum())
                for t in ticks)
        else:
            baseline = sum(t.realized_mci
                           * float(base_usage[:, t.tick % Tn].sum())
                           for t in ticks)
        return StreamingReport(
            ticks=ticks, committed=np.stack([t.committed for t in ticks],
                                            axis=1),
            realized_carbon=sum(t.realized_carbon for t in ticks),
            forecast_carbon=sum(t.forecast_carbon for t in ticks),
            realized_baseline=float(baseline),
            total_inner_steps=sum(t.inner_steps for t in ticks))
