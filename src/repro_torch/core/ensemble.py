"""Batched scenario-ensemble evaluation and risk reports.

A port of the JAX package's `repro.core.ensemble` on one device, single-
and multi-region. `repro_torch.core.scenario` materializes S grid/fleet
scenarios as a `ScenarioStack` (per-field overlays with a leading S
axis); this module evaluates a `DRPolicy` across the whole stack:

  * `evaluate_ensemble(problem, policy, scenarios, ctx=...)`, also
    `api.ensemble`. CR1/CR2 solve all S scenarios as one batched lane
    (`api._cr1_lanes` / `_cr2_lanes`): the overlaid fields lead with the
    scenario axis, the engine runs the S solves together, one `al_step`
    launch per k steps for all of them (the counterpart of the JAX
    package's one vmapped XLA call). Other policies and warm/donated/
    shifted contexts take an equivalent loop of `api.solve`.
  * `run_streaming_ensemble(problem, policy, streams, ...)`: S
    independent forecast streams through one batched controller. Each
    tick stacks the S revised forecasts and re-solves all S lanes as one
    batched run, each warm from its own previous state (shift and mu
    reset folded in), and commits hour 0 per scenario. A multi-region
    problem takes S groups of R streams, one per region; the scenario
    axis then carries (S, R, T) forecast stacks.
  * `EnsembleResult.report()` / `EnsembleReport`: quantiles and CVaR of
    carbon reduction and fleet penalty, per-workload penalty
    distributions and SLO-violation probabilities, fairness dispersion
    per scenario (Jain index, max/min share ratio), and
    `compare_policies` tables.

Multi-region stacks (`RegionalDivergence`'s (S, R, T) overlays, or
any generator over a multi-region base) ride the same batched lane: each
lane gathers its own (W, T) carbon rows along the region axis and takes
its per-region norms from its own one-scenario view, and the batched
lane then applies each scenario's migration post-stage exactly as the
loop lane's `solve()` does (`_apply_migration_credit`).
`SolveContext.coupled_migration` takes the loop lane.

Parity contract (the JAX package's): the batched lane matches the loop
of `api.solve` within 0.01 pp on every scenario.

Fleet meshes (`SolveContext.mesh`): `evaluate_ensemble` (and so
`compare_policies`) runs the batched lane on this process's row block
of the padded fleet, its stacked overlays padded with
`fleet_solver.PAD_FILLS` (`_pad_overlays`), each scenario normalized on
its whole fleet, and gathers the lanes; the lane is cold-only, as the
JAX package's. The loop lane passes the mesh to `api.solve`.
`run_streaming_ensemble` takes no mesh, in either package.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import numpy as np
import torch

from repro_torch.core.api import (CR1, CR2, SolveContext, _cr1_lanes,
                                  _cr2_lanes, _fleet_mesh, _shard,
                                  cold_lanes, resolve_policy, solve)
from repro_torch.core.engine import EngineState
from repro_torch.core.fleet_solver import (CR1_MU0, CR2_MU0, PAD_FILLS,
                                           FleetProblem,
                                           cr2_reference_fleet, device_view,
                                           fleet_penalties,
                                           single_region_view)
from repro_torch.core.metrics import jain_index, max_min_ratio
from repro_torch.core.regional import region_totals
from repro_torch.core.scenario import ScenarioStack, resolve_scenarios
from repro_torch.kernels.dispatch import resolve_device, resolve_use_kernel

__all__ = ["EnsembleReport", "EnsembleResult", "compare_policies",
           "comparison_table", "evaluate_ensemble",
           "run_streaming_ensemble", "StreamingEnsembleReport"]

f32 = torch.float32


# ---------------------------------------------------------------------------
# The batched lane (CR1/CR2): the scenario axis as the engine's lane axis
# ---------------------------------------------------------------------------
def _lane_view(p: FleetProblem, stack: ScenarioStack, device):
    """The fleet's device view with the stack's overlays (leading S) on
    `device`, and its S one-scenario views (each the device view of
    `stack.problem(p, s)`)."""
    over = stack.overlay_fields()
    view = dataclasses.replace(device_view(p, device), **{
        k: torch.as_tensor(np.asarray(v), dtype=f32, device=device)
        for k, v in over.items()})
    views = [dataclasses.replace(view, **{k: getattr(view, k)[s]
                                          for k in over})
             for s in range(stack.S)]
    return view, views


def _cr2_refs(policy, p: FleetProblem, stack: ScenarioStack,
              device) -> list:
    """Per-scenario CR2 fairness targets, as `solve()` computes them. They
    depend on usage, entitlement and jobs but never on the MCI, so an
    MCI-only ensemble (every streaming tick) computes them once."""
    def refs(q):
        return torch.as_tensor(cr2_reference_fleet(q, policy.cap_frac,
                                                    device), device=device)

    if not {"usage", "entitlement", "jobs"} & set(stack.overlay_fields()):
        return [refs(p)] * stack.S
    return [refs(q) for q in stack.problems(p)]


def _pad_overlays(over: dict, W: int, W_pad: int) -> dict:
    """Pad stacked per-workload overlays ((S, W, ...)) along their rows
    with `pad_fleet`'s inert fills (`fleet_solver.PAD_FILLS`, shared so
    that the conventions cannot drift); the MCI is not padded."""
    if W_pad == W:
        return over
    out = {}
    for k, v in over.items():
        v = np.asarray(v)
        out[k] = v if k == "mci" else np.concatenate(
            [v, np.full((v.shape[0], W_pad - W) + v.shape[2:], PAD_FILLS[k],
                        dtype=v.dtype)], axis=1)
    return out


def _run_batched(policy, p: FleetProblem, stack: ScenarioStack, *,
                 steps: int, use_kernel: bool, device,
                 init: EngineState | None = None, shift: int = 0,
                 reset_mu: bool = False, moment_dtype: str = "float32",
                 mesh=None):
    """All S scenario solves under `policy` (CR1/CR2) as one batched run.
    Returns (D (S, W, T), penalties (S, W), stacked state), tensors on
    `device`. `init` (a stacked `EngineState`, e.g. the previous
    streaming tick's) warm-starts every lane; `shift`/`reset_mu` fold the
    rolling-horizon tick entry into the same run.

    Over a fleet `mesh` the lanes run on this process's row block of the
    padded fleet and its padded overlays, each scenario normalized (CR2:
    targeted) on its whole fleet, and are gathered: D and the penalties
    cut to the fleet's W, the state padded. That lane is cold-only, as
    the JAX package's: `init`, `shift` or `reset_mu` raise
    `ValueError`."""
    S = stack.S
    view, views = _lane_view(p, stack, device)
    sh = None
    if mesh is not None:
        if init is not None or shift or reset_mu:
            raise ValueError(
                "the sharded ensemble lane is cold-only (no warm, shift or "
                "reset_mu); run the streaming ensemble without a mesh")
        sh = _shard(p, mesh, device)
        over = _pad_overlays(stack.overlay_fields(), p.W, sh.W_pad)
        view = dataclasses.replace(sh.view, **{
            k: torch.as_tensor(v, dtype=f32, device=device)[
                (slice(None),) if k == "mci" else (slice(None), sh.rows)]
            for k, v in over.items()})
    W = p.W if sh is None else sh.W_pad
    if type(policy) is CR1:
        if init is None:
            init = cold_lanes(S, W, p.T, device, 0, CR1_MU0)
        lams = torch.full((S,), policy.lam, dtype=f32, device=device)
        out = _cr1_lanes(view, views, lams, init, steps, use_kernel, shift,
                         reset_mu, moment_dtype, shard=sh)
    else:
        if init is None:
            init = cold_lanes(S, W, p.T, device, W, CR2_MU0)
        out = _cr2_lanes(view, views, _cr2_refs(policy, p, stack, device),
                         init, steps, policy.outer, use_kernel, shift,
                         reset_mu, moment_dtype, shard=sh)
    D, pens, states = out
    return D[:, :p.W], pens[:, :p.W], states


def _batched_capable(policy) -> bool:
    return type(policy) in (CR1, CR2)


# ---------------------------------------------------------------------------
# Ensemble results + the risk layer
# ---------------------------------------------------------------------------
def _quantiles(x: np.ndarray, qs: Sequence[float]) -> dict[str, float]:
    return {f"p{int(q)}": float(np.percentile(x, q)) for q in qs}


def _cvar(x: np.ndarray, alpha: float, worst: str) -> np.ndarray:
    """Mean of the worst `alpha` tail — `worst='low'` for quantities where
    small is bad (carbon reduction), `'high'` where large is bad
    (penalty)."""
    x = np.sort(np.asarray(x, float))
    k = max(1, int(np.ceil(alpha * x.shape[0])))
    tail = x[:k] if worst == "low" else x[-k:]
    return float(tail.mean())


@dataclasses.dataclass(frozen=True)
class EnsembleResult:
    """Per-scenario outcomes of one policy across a scenario stack."""

    policy: Any                          # the DRPolicy evaluated
    labels: tuple[str, ...]              # scenario labels, length S
    carbon_reduction_pct: np.ndarray     # (S,)
    total_penalty_pct: np.ndarray        # (S,)
    penalties: np.ndarray                # (S, W) raw per-workload penalties
    entitlement: np.ndarray              # (S, W) per-scenario entitlements
    preservation_violation: np.ndarray   # (S,)
    D: np.ndarray                        # (S, W, T) adjustment plans
    extras: tuple[dict, ...]             # per-scenario policy extras
    batched: bool                        # one batched run vs solve() loop

    @property
    def S(self) -> int:
        return int(self.carbon_reduction_pct.shape[0])

    def penalty_shares(self) -> np.ndarray:
        """(S, W) capacity-scaled penalty shares pen_i/E_i."""
        return np.maximum(self.penalties, 0.0) / self.entitlement

    def report(self, *, slo_frac: float = 0.05, cvar_alpha: float = 0.25,
               quantiles: Sequence[float] = (5, 25, 50, 75, 95),
               ) -> "EnsembleReport":
        """Distill the ensemble into risk metrics (see `EnsembleReport`)."""
        # p5/p50/p95 are always computed — `lines()`/`comparison_table`
        # render them regardless of the caller's quantile choice.
        quantiles = sorted({*quantiles, 5, 50, 95})
        car = self.carbon_reduction_pct
        pen = self.total_penalty_pct
        shares = self.penalty_shares()
        jain = jain_index(self.penalties, self.entitlement, axis=-1)
        mm = max_min_ratio(self.penalties, self.entitlement, axis=-1)
        viol = shares > slo_frac                   # (S, W)
        k = max(1, int(np.ceil(cvar_alpha * self.S)))
        worst = tuple(self.labels[i] for i in np.argsort(car)[:k])
        return EnsembleReport(
            policy=getattr(self.policy, "name", str(self.policy)),
            n_scenarios=self.S,
            carbon_quantiles=_quantiles(car, quantiles),
            carbon_mean=float(car.mean()),
            carbon_cvar=_cvar(car, cvar_alpha, "low"),
            penalty_quantiles=_quantiles(pen, quantiles),
            penalty_mean=float(pen.mean()),
            penalty_cvar=_cvar(pen, cvar_alpha, "high"),
            jain_quantiles=_quantiles(jain, quantiles),
            jain_min=float(jain.min()),
            maxmin_median=float(np.median(mm)),
            slo_frac=slo_frac, cvar_alpha=cvar_alpha,
            slo_violation_prob=float(viol.any(axis=1).mean()),
            workload_slo_prob=viol.mean(axis=0),
            workload_penalty_p95=np.percentile(shares, 95, axis=0),
            worst_scenarios=worst)


@dataclasses.dataclass(frozen=True)
class EnsembleReport:
    """Risk summary of a policy over S scenarios.

    CVaR_α is the expected outcome over the worst α-fraction of
    scenarios — lowest carbon reductions, highest penalties — the
    number an operator signs off on, not the median. SLO violation:
    a workload breaches when its capacity-scaled penalty share
    pen_i/E_i exceeds `slo_frac`; `slo_violation_prob` is the fraction
    of scenarios where ANY workload breaches."""

    policy: str
    n_scenarios: int
    carbon_quantiles: dict[str, float]   # carbon reduction, % of baseline
    carbon_mean: float
    carbon_cvar: float
    penalty_quantiles: dict[str, float]  # fleet penalty, % of entitlement
    penalty_mean: float
    penalty_cvar: float
    jain_quantiles: dict[str, float]     # fairness dispersion per scenario
    jain_min: float
    maxmin_median: float                 # median max/min share ratio
    slo_frac: float
    cvar_alpha: float
    slo_violation_prob: float
    workload_slo_prob: np.ndarray        # (W,) per-workload breach prob
    workload_penalty_p95: np.ndarray     # (W,) p95 penalty share
    worst_scenarios: tuple[str, ...]     # labels of the CVaR tail

    def lines(self) -> list[str]:
        cq, pq, jq = (self.carbon_quantiles, self.penalty_quantiles,
                      self.jain_quantiles)
        a = int(100 * self.cvar_alpha)
        return [
            f"policy {self.policy} over {self.n_scenarios} scenarios:",
            f"  carbon reduction : p50={cq['p50']:.2f}%  "
            f"[p5={cq['p5']:.2f}, p95={cq['p95']:.2f}]  "
            f"CVaR{a}={self.carbon_cvar:.2f}%",
            f"  fleet penalty    : p50={pq['p50']:.2f}%  "
            f"[p5={pq['p5']:.2f}, p95={pq['p95']:.2f}]  "
            f"CVaR{a}={self.penalty_cvar:.2f}%",
            f"  fairness (Jain)  : p50={jq['p50']:.3f}  "
            f"min={self.jain_min:.3f}  "
            f"max/min share p50="
            + (f"{self.maxmin_median:.1f}x" if self.maxmin_median < 9999.5
               else ">=10000x (saturated: some workload pays ~nothing)"),
            f"  SLO (> {100 * self.slo_frac:.0f}% of E_i) breach prob: "
            f"{100 * self.slo_violation_prob:.0f}% of scenarios",
            f"  worst scenarios  : {', '.join(self.worst_scenarios[:3])}",
        ]

    def as_dict(self) -> dict:
        """JSON-ready record (benchmark trajectory files)."""
        d = dataclasses.asdict(self)
        d["workload_slo_prob"] = np.asarray(
            self.workload_slo_prob).tolist()
        d["workload_penalty_p95"] = np.asarray(
            self.workload_penalty_p95).tolist()
        d["worst_scenarios"] = list(self.worst_scenarios)
        return d


def _stack_arrays(base: FleetProblem, stack: ScenarioStack):
    """Per-scenario (mci, usage, entitlement) with the S axis broadcast
    from the base where not overlaid."""
    S = stack.S
    mci = stack.mci if stack.mci is not None else np.broadcast_to(
        np.asarray(base.mci, float), (S,) + np.asarray(base.mci).shape)
    usage = stack.usage if stack.usage is not None else np.broadcast_to(
        np.asarray(base.usage, float), (S, base.W, base.T))
    ent = stack.entitlement if stack.entitlement is not None else \
        np.broadcast_to(np.asarray(base.entitlement, float), (S, base.W))
    return np.asarray(mci, float), np.asarray(usage, float), \
        np.asarray(ent, float)


def _result_from_stacks(base: FleetProblem, stack: ScenarioStack, policy,
                        D: np.ndarray, pens: np.ndarray, batched: bool,
                        ) -> EnsembleResult:
    """`fleet_solver._report`, vectorized over the scenario axis."""
    mci, usage, ent = _stack_arrays(base, stack)
    if mci.ndim == 3:                # multi-region: (S, R, T) MCI stacks
        wmci = mci[:, np.asarray(base.region), :]                # (S, W, T)
        carbon_base = (usage * wmci).sum(axis=(1, 2))            # (S,)
        car = (D * wmci).sum(axis=(1, 2))
    else:
        carbon_base = (usage.sum(axis=1) * mci).sum(axis=1)      # (S,)
        car = np.einsum("swt,st->s", D, mci)
    day_hours = min(base.day_hours, base.T)   # as `project_days`
    n_days = base.T // day_hours
    span = n_days * day_hours
    sums = D[:, :, :span].reshape(D.shape[0], base.W, n_days,
                                  day_hours).sum(-1)
    is_batch = np.asarray(base.is_batch, bool)
    viol = np.abs(sums[:, is_batch]).max(axis=(1, 2)) if is_batch.any() \
        else np.zeros(D.shape[0])
    labels = tuple(stack.label(s) for s in range(stack.S))
    return EnsembleResult(
        policy=policy, labels=labels,
        carbon_reduction_pct=100 * car / carbon_base,
        total_penalty_pct=100 * pens.sum(axis=1) / ent.sum(axis=1),
        penalties=pens, entitlement=ent, preservation_violation=viol,
        D=D, extras=tuple({} for _ in range(stack.S)), batched=batched)


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------
def evaluate_ensemble(problem: FleetProblem, policy, scenarios, *,
                      ctx: SolveContext | None = None,
                      batched: bool | None = None) -> EnsembleResult:
    """Evaluate `policy` on S scenarios of `problem`: the ensemble entry
    point (also `api.ensemble`).

    `scenarios` is a `ScenarioStack`, a scenario generator (or
    `SCENARIO_REGISTRY` name), or a sequence of those (concatenated).
    CR1/CR2 run all S scenarios as one batched lane on `ctx.device` (the
    card unless "cpu"), a multi-region fleet's with each scenario's
    migration post-stage after it; other policies (CR3, B1, B3, as in
    the JAX package) and warm, donated, shifted, mu-reset or coupled-
    migration contexts fall back to a loop of `api.solve` with the same
    semantics. `ctx.telemetry` also takes the loop, so each scenario's
    `ConvergenceTrace` rides its own entry of `result.extras`; the
    batched lane has no telemetry plumbing. `ctx.sanitize` raises
    (sanitize single scenarios through `api.solve`). `batched` forces
    the lane (True raises if there is no batched lane for the policy and
    context; False forces the loop, the parity hook). Over a fleet mesh
    (`ctx.mesh`) the batched lane shards the fleet's rows
    (`_run_batched`) and the loop lane's `solve()`s shard each scenario;
    every process returns the same result."""
    ctx = ctx or SolveContext()
    if ctx.sanitize:
        raise NotImplementedError(
            "SolveContext(sanitize=True) is a solo-solve debug lane — the "
            "batched ensemble lanes have no checked twins; sanitize "
            "single scenarios through solve()")
    problem = single_region_view(problem)
    policy = resolve_policy(policy)
    stack = resolve_scenarios(scenarios, problem)
    can_batch = (_batched_capable(policy) and ctx.warm is None
                 and not ctx.donate and not ctx.shift and not ctx.reset_mu
                 and not ctx.coupled_migration and ctx.telemetry is None)
    if batched is True and not can_batch:
        raise ValueError(
            f"no batched ensemble lane for policy "
            f"{getattr(policy, 'name', policy)!r} under this context "
            "(CR1/CR2, no warm/donate/shift/reset_mu/coupled_migration/"
            "telemetry)")
    device = resolve_device(ctx.device)
    use_kernel = resolve_use_kernel(ctx.use_kernel, device)
    mesh = _fleet_mesh(ctx, device)
    if batched is False or not can_batch:
        probs = list(stack.problems(problem))
        results = [solve(ps, policy,
                         ctx=dataclasses.replace(ctx, donate=False))
                   for ps in probs]
        _, _, ent = _stack_arrays(problem, stack)
        return EnsembleResult(
            policy=policy,
            labels=tuple(stack.label(s) for s in range(stack.S)),
            carbon_reduction_pct=np.asarray(
                [r.carbon_reduction_pct for r in results]),
            total_penalty_pct=np.asarray(
                [r.total_penalty_pct for r in results]),
            # per-workload penalties are not part of FleetSolveResult, so
            # they are evaluated once per scenario on the solved plans
            penalties=np.stack([
                fleet_penalties(ps, torch.as_tensor(r.D, dtype=f32,
                                                    device=device),
                                use_kernel).cpu().numpy()
                for ps, r in zip(probs, results)]),
            entitlement=ent,
            preservation_violation=np.asarray(
                [r.preservation_violation for r in results]),
            D=np.stack([r.D for r in results]),
            extras=tuple(r.extras for r in results), batched=False)
    D, pens, _ = _run_batched(policy, problem, stack,
                              steps=ctx.resolved_steps(policy),
                              use_kernel=use_kernel, device=device,
                              moment_dtype=ctx.moment_dtype, mesh=mesh)
    res = _result_from_stacks(problem, stack, policy, D.cpu().numpy(),
                              pens.cpu().numpy(), batched=True)
    return _apply_migration_credit(problem, stack, res, device)


def _apply_migration_credit(base: FleetProblem, stack: ScenarioStack,
                            res: EnsembleResult, device) -> EnsembleResult:
    """Each scenario's migration post-stage for the batched lane: what
    `api.solve` applies in the loop lane (`api._maybe_migrate`, the net
    saving credited on the scenario's own carbon base), so the two lanes
    agree on multi-region fleets with a topology of positive
    bandwidth."""
    if (base.topology is None or not base.is_multiregion
            or not np.any(np.asarray(base.topology.bandwidth) > 0.0)):
        return res
    from repro_torch.core.migration import fleet_migration
    car = res.carbon_reduction_pct.copy()
    extras = []
    for s, ps in enumerate(stack.problems(base)):
        plan = fleet_migration(ps, np.asarray(res.D[s]), device=device)
        wmci = np.asarray(ps.mci)[np.asarray(ps.region)]
        carbon_base = float((np.asarray(ps.usage) * wmci).sum())
        car[s] += 100.0 * plan.net_saved / carbon_base
        extras.append({"migration": plan})
    return dataclasses.replace(res, carbon_reduction_pct=car,
                               extras=tuple(extras))


def compare_policies(problem: FleetProblem, policies: Sequence, scenarios,
                     *, ctx: SolveContext | None = None,
                     **report_kw) -> dict[str, EnsembleReport]:
    """Risk reports for several policies on the SAME scenario stack —
    the policy-vs-policy comparison feeding `benchmarks/` and examples.
    Keys are registry names (duplicate families get `name#i` suffixes)."""
    stack = resolve_scenarios(scenarios, problem)
    out: dict[str, EnsembleReport] = {}
    for pl in policies:
        pl = resolve_policy(pl)
        rep = evaluate_ensemble(problem, pl, stack, ctx=ctx).report(
            **report_kw)
        key = rep.policy
        if key in out:
            key = f"{key}#{sum(k.split('#')[0] == rep.policy for k in out)}"
        out[key] = rep
    return out


def comparison_table(reports: dict[str, EnsembleReport]) -> list[str]:
    """Fixed-width policy-vs-policy table (one row per report)."""
    a = int(100 * next(iter(reports.values())).cvar_alpha) if reports else 0
    head = (f"{'policy':10s} {'carbon p50':>10s} {'carbon p5':>10s} "
            f"{f'CVaR{a}':>8s} {'pen p50':>8s} {'pen CVaR':>9s} "
            f"{'jain p50':>9s} {'SLO prob':>9s}")
    rows = [head, "-" * len(head)]
    for name, r in reports.items():
        rows.append(
            f"{name:10s} {r.carbon_quantiles['p50']:>9.2f}% "
            f"{r.carbon_quantiles['p5']:>9.2f}% {r.carbon_cvar:>7.2f}% "
            f"{r.penalty_quantiles['p50']:>7.2f}% "
            f"{r.penalty_cvar:>8.2f}% {r.jain_quantiles['p50']:>9.3f} "
            f"{100 * r.slo_violation_prob:>8.0f}%")
    return rows


# ---------------------------------------------------------------------------
# Rolling-horizon ensemble: S streams, one batched controller
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class StreamingEnsembleReport:
    """S rolling-horizon runs, batched: per-scenario committed plans and
    carbon ledgers (the streaming analogue of `EnsembleResult`)."""

    labels: tuple[str, ...]
    committed: np.ndarray          # (S, W, n_ticks)
    realized_carbon: np.ndarray    # (S,) kg CO2 eliminated at actual MCI
    forecast_carbon: np.ndarray    # (S,) same hours at solve-time forecast
    realized_baseline: np.ndarray  # (S,) no-DR carbon of committed hours
    total_inner_steps: int         # engine iterations per scenario lane
    batched: bool

    @property
    def S(self) -> int:
        return int(self.realized_carbon.shape[0])

    @property
    def n_ticks(self) -> int:
        return int(self.committed.shape[-1])

    @property
    def realized_reduction_pct(self) -> np.ndarray:
        return 100.0 * self.realized_carbon / np.maximum(
            self.realized_baseline, 1e-12)

    def risk(self, *, cvar_alpha: float = 0.25,
             quantiles: Sequence[float] = (5, 25, 50, 75, 95),
             ) -> dict[str, float]:
        red = self.realized_reduction_pct
        out = _quantiles(red, quantiles)
        out["mean"] = float(red.mean())
        out[f"cvar{int(100 * cvar_alpha)}"] = _cvar(red, cvar_alpha, "low")
        return out


def run_streaming_ensemble(problem: FleetProblem, policy, streams, *,
                           n_ticks: int | None = None,
                           cold_steps: int = 600, warm_steps: int = 150,
                           use_kernel: bool | None = None,
                           device: str | torch.device | None = None,
                           ) -> StreamingEnsembleReport:
    """Drive S independent forecast streams through batched warm-started
    rolling-horizon ticks.

    `streams` is a sequence of `ForecastStream`s (every horizon must equal
    `problem.T`) or a `scenario.ForecastRegime` (its `streams()` factory
    is called with `n_ticks`). Per tick the S revised forecasts stack
    into the scenario axis and the whole ensemble re-solves as one
    batched run on `device` (the card unless "cpu"), each lane warm from
    its own previous `EngineState` (shift and mu reset folded in): the
    `RollingHorizonSolver` loop over S streams at once. Policies without
    a batched lane fall back to S `RollingHorizonSolver` runs. Only hour
    0 of each plan commits, so no migration stage runs on a tick.

    A multi-region problem takes one stream per region per scenario: a
    sequence of R-tuples, as `ForecastRegime.streams` yields for a
    multi-region base. The scenario axis then carries (S, R, T) forecast
    stacks; each region's committed total is priced on its own trace."""
    from repro_torch.core.scenario import ForecastRegime
    from repro_torch.core.streaming import RollingHorizonSolver
    policy = resolve_policy(policy)
    problem = single_region_view(problem)
    multi = problem.is_multiregion
    R = problem.R
    if isinstance(streams, ForecastRegime):
        streams = streams.streams(problem, n_ticks=n_ticks or 1)
    groups = []
    for item in streams:
        g = tuple(item) if isinstance(item, (tuple, list)) else (item,)
        if len(g) != R:
            raise ValueError(
                f"need {R} stream(s) per scenario (one per region), "
                f"got {len(g)}")
        groups.append(g)
    if not groups:
        raise ValueError("run_streaming_ensemble needs >= 1 stream")
    for g in groups:
        for st in g:
            if st.horizon != problem.T:
                raise ValueError(
                    f"stream horizon {st.horizon} != problem.T {problem.T}")
    max_ticks = min(st.n_ticks for g in groups for st in g)
    n = max_ticks if n_ticks is None else n_ticks
    if not 0 < n <= max_ticks:
        raise ValueError(f"n_ticks {n} outside (0, {max_ticks}]")
    S = len(groups)
    labels = tuple(
        f"stream[sigma={g[0].revision_sigma:.3f},seed={g[0].seed}]"
        for g in groups)
    device = resolve_device(device)
    base_usage = np.asarray(problem.usage, float)
    if multi:
        # Per-region totals of the committed hours, exact in float64.
        onehot = np.zeros((problem.W, R))
        onehot[np.arange(problem.W), np.asarray(problem.region)] = 1.0
        usage_by_region = region_totals(problem.region, base_usage, R)

    if not _batched_capable(policy):
        reports = [RollingHorizonSolver(
            problem, g, policy=policy, cold_steps=cold_steps,
            warm_steps=warm_steps, use_kernel=use_kernel,
            device=device).run(n) for g in groups]
        return StreamingEnsembleReport(
            labels=labels,
            committed=np.stack([r.committed for r in reports]),
            realized_carbon=np.asarray(
                [r.realized_carbon for r in reports]),
            forecast_carbon=np.asarray(
                [r.forecast_carbon for r in reports]),
            realized_baseline=np.asarray(
                [r.realized_baseline for r in reports]),
            total_inner_steps=reports[0].total_inner_steps,
            batched=False)

    use_kernel = resolve_use_kernel(use_kernel, device)
    committed = np.zeros((S, problem.W, n))
    realized = np.zeros(S)
    forecast = np.zeros(S)
    baseline = np.zeros(S)
    states: EngineState | None = None
    total_steps = 0
    for t in range(n):
        mcis = np.stack([[st.forecast(t) for st in g] if multi
                         else g[0].forecast(t) for g in groups])

        def roll(a):
            return None if a is None else np.roll(a, -t, axis=1)

        p_t = dataclasses.replace(problem, usage=roll(problem.usage),
                                  jobs=roll(problem.jobs),
                                  upper=roll(problem.upper))
        steps = cold_steps if states is None else warm_steps
        D, _, states = _run_batched(
            policy, p_t, ScenarioStack(mci=mcis, labels=labels),
            steps=steps, use_kernel=use_kernel, device=device, init=states,
            shift=0 if t == 0 else 1, reset_mu=t > 0)
        committed[:, :, t] = D[:, :, 0].cpu().numpy()
        total_steps += steps * (policy.outer if type(policy) is CR2 else 1)
        hour = t % base_usage.shape[1]
        if multi:
            real_t = np.asarray([[st.realized(t) for st in g]
                                 for g in groups])                 # (S, R)
            by_reg = committed[:, :, t] @ onehot                   # (S, R)
            realized += (by_reg * real_t).sum(axis=1)
            forecast += (by_reg * mcis[:, :, 0]).sum(axis=1)
            baseline += (usage_by_region[:, hour] * real_t).sum(axis=1)
        else:
            real_t = np.asarray([g[0].realized(t) for g in groups])
            realized += committed[:, :, t].sum(axis=1) * real_t
            forecast += committed[:, :, t].sum(axis=1) * mcis[:, 0]
            baseline += real_t * base_usage[:, hour].sum()
    return StreamingEnsembleReport(
        labels=labels, committed=committed, realized_carbon=realized,
        forecast_carbon=forecast, realized_baseline=baseline,
        total_inner_steps=total_steps, batched=True)
