"""First-class DR policies and the fleet engine's single entry point.

Policies are frozen dataclasses (`CR1(lam=...)`, `CR2(cap_frac=...,
outer=...)`) whose fields are exactly their hyperparameters; each owns its
engine backend (objective and constraint pieces, fleet-global normalizers,
`EngineConfig`) over the shared projected-Adam + augmented-Lagrangian loop
(`repro_torch.core.engine.al_minimize`).

`solve(problem, policy, ctx=SolveContext(...))` is the entry point.
`SolveContext` bundles what is orthogonal to a policy: the device (CUDA
unless `device="cpu"`), warm starts, the streaming-tick shift and mu
reset, kernel dispatch and the step budget. With `use_kernel` (on by
default on CUDA) the inner loop is the fused `al_step` kernel and the
penalties go through the `dr_features` kernel.

`solve_day(problem, policy, mci_stack, ...)` solves a whole
rolling-horizon day (one re-solve per revised forecast, each warm from
the last, shifted an hour). Its tick loop (`_day_impl`) is plain tensor
code; on CUDA with the kernels the day is captured once per static
configuration and then runs as one CUDA-graph replay (`core/daygraph.py`),
the port's counterpart of the JAX package's one-dispatch `lax.scan`.

Two departures from the JAX package, both so that the checks the port
is held to hold at fleet scale (W = 10,000): the projection after every
step is the exact Euclidean one onto the box and the batch rows' day
preservation, where the JAX package takes 3 rounds of day-mean removal,
and the fused kernel takes autodiff's one half at hinge ties, as the
generic engine does (see `kernels/al_step/ref.py`).

`sweep(problem, policies)` solves a grid of policies, and `ensemble`
(`core/ensemble.py`) one policy over S scenarios. A uniform CR1 grid, a
CR2 grid sharing `outer`, and CR1/CR2 ensembles ride the batched lane:
the N solves advance together as one engine run over lane-stacked
tensors (`_cr1_lanes`, `_cr2_lanes`), one `al_step` launch per k steps
for all lanes, the port's counterpart of the JAX package's one vmapped
call. A CR3 grid sharing `outer` rides a lane of its own: every
clearing round re-solves all lanes in one engine run, and lanes that
have cleared keep their frozen plan and state. Everything else takes
the loop lane, a `solve()` per policy.

CR3 (`CR3`) is the fleet's selfish best responses, all W in one
generic-engine run per clearing round (its objective calls
`fleet_penalties`, and so the `dr_features` kernel, on every inner
step), and the coordinator's Eq.-6 fiscal clearing between rounds on
the host. B1 and B3 are closed forms scored once through
`fleet_penalties`.

Multi-region fleets (`mci` (R, T), a region per row) solve through
every entry point under every policy it takes: `solve`, `sweep` (cold
and warm from `stack_states`), `solve_day` (an (n_ticks, R, T)
forecast stack), the ensembles and the streaming controller. Each region
is priced on its own trace and normalized on its own reductions
(`core/regional.py`, sums over index tensors found once on the host, so
a captured day holds them), folded into operands the `al_step` kernel
already reads (a carbon row per fleet row, per lane in the lanes, and a
step multiplier per row), so the kernel stays region-blind. CR3 clears
one Eq.-6 market per region. A topology adds the migration post-stage
(`core/migration.py`), or with `SolveContext.coupled_migration` the
joint (curtailment, flow) refinement. R = 1 is canonicalized to the
single-region path, bit for bit.

Debug and observability lanes (`SolveContext.sanitize`, `.telemetry`):
CR1/CR2 solves and days record non-finite checks on a device flag read
once at the call boundary (`repro_torch.analysis.sanitize`), and the
generic engine samples a convergence trace into device buffers
(`repro_torch.obs.telemetry`); both leave the plan bitwise as it is.

Fleet meshes (`SolveContext.mesh`, a `DeviceMesh` from
`launch.mesh.make_fleet_mesh`): every fleet entry point shards the
fleet's rows over the processes of a `torch.distributed` group, SPMD.
Every process calls it with the whole fleet, pads it to a multiple of the
mesh size with inert rows (`fleet_solver.pad_fleet`), runs the engine
and the kernels on its own row block only, with the normalizers of the
whole unpadded fleet, and all-gathers the rows once, after the engine
run: each process returns the same result, `D` with the fleet's W rows
and `state` padded, so that a warm re-solve chains without padding
again. CR1, CR2 and CR3 `solve` gather in `engine.al_minimize_sharded`;
the CR1/CR2 sweep and ensemble lanes run their N lanes on the block
(rows on dim 1) and gather the lanes; CR3 sweeps and a stacked warm
state take the loop of sharded `solve`s. A sharded `solve_day` runs the
whole day on the block, each tick normalized on the whole fleet's rolled
window, and gathers the committed hours, the last plan and the state
after the day (on the card after the replay: the graph holds no
collective). B1 and B3 ignore the mesh.
"""
from __future__ import annotations

import dataclasses
import functools
import warnings
from typing import Any, ClassVar, Protocol, Sequence, runtime_checkable

import numpy as np
import torch

from repro_torch.analysis.sanitize import Sanitizer, checked, throw_code
from repro_torch.core.daygraph import DAY_GRAPHS
from repro_torch.core.engine import (EngineConfig, EngineState, al_minimize,
                                     al_minimize_sharded, gather_rows)
from repro_torch.core.fleet_solver import (CR1_MU0, CR2_MU0, CR3_MU0,
                                           FleetProblem,
                                           FleetSolveResult, RegionIndex,
                                           _bounds,
                                           _enter_tick, _mean_projection,
                                           _pad_state, _projection, _report,
                                           cr2_cap_plan, cr2_reference_fleet,
                                           cr2_reference_tensor, device_view,
                                           fleet_penalties, pad_fleet,
                                           row_block, single_region_view)
from repro_torch.core.regional import (CR1_NORM_FILLS, CR2_NORM_FILLS,
                                       cr1_norms, cr2_norms, cr3_reg_scale,
                                       pad_row_norms, region_totals,
                                       segment_sum)
from repro_torch.kernels.dispatch import resolve_device, resolve_use_kernel
from repro_torch.obs.telemetry import ConvergenceTrace, TelemetryConfig

Tensor = torch.Tensor
f32 = torch.float32

__all__ = ["B1", "B3", "CR1", "CR2", "CR3", "DRPolicy", "DayResult",
           "POLICY_REGISTRY", "SolveContext", "configured_policy",
           "ensemble", "resolve_policy", "solve", "solve_day",
           "stack_states", "sweep"]


@dataclasses.dataclass(frozen=True)
class SolveContext:
    """Execution concerns of a fleet solve, bundled once for every policy.

    Attributes:
      device: where the solve runs; None = the CUDA device (raises when
        there is none; pass "cpu" for the plain PyTorch path).
      shift: roll the warm plan this many hours first (the rolling-horizon
        window slide).
      reset_mu: restart the AL mu schedule at the policy's mu0 first
        (multipliers keep their prices).
      warm: a previous result's `.state` to warm-start from (cold when
        None); its tensors must live on `device`.
      use_kernel: None = auto (the kernels on CUDA, the plain path on the
        CPU). Covers the `dr_features` penalty kernel and the fused
        `al_step` inner loop.
      steps: inner Adam steps per multiplier round; None = the policy's
        `default_steps`.
      moment_dtype: storage dtype of the Adam moments, "float32" or
        "bfloat16"; x keeps a float32 master copy.
      donate: a later solve may invalidate this result's `state`, as in
        the JAX package. In the port that is `solve_day` on CUDA with the
        kernels: the returned state then aliases the day graph's static
        output buffers, which the graph's next replay overwrites; without
        `donate` the state is cloned. `solve` returns fresh tensors
        either way.
      mesh: a fleet mesh (`launch.mesh.make_fleet_mesh`, a
        `torch.distributed` `DeviceMesh` on this device's type): `solve`,
        `sweep`, `solve_day` and the ensembles shard the fleet's rows
        over its processes (see the module docstring); B1 and B3 ignore
        it. A sharded sweep's lanes carry no state (as the JAX
        package's); a sharded day refuses `sanitize` and `telemetry`.
      coupled_migration: move cross-region migration into the solve.
        After the base (per-region) solve, curtailment and interconnect
        flows refine jointly under the same engine (per-link caps in the
        projection, tolls in the objective, supply and ceiling limits as
        inequality residuals, total curtailment pinned to the base plan),
        then the flows take `core.migration`'s exact repair. The refined
        plan is kept only at equal total curtailment and when it beats
        the post-stage on fleet-wide carbon, so it never loses carbon.
        CR1/CR2 on multi-region fleets; everything else takes the
        post-stage.
      sanitize: run the solve with non-finite checks on the gradient,
        iterate and multipliers (`repro_torch.analysis.sanitize`), so a
        NaN or inf raises `SanitizeError` naming the first failing check
        instead of returning a NaN plan (and poisoning every warm
        re-solve chained after it). The checks are device reductions
        into one flag, read once after the solve (after the replay for a
        day). Debug lane: CR1/CR2 `solve` and `solve_day`; other
        policies, `sweep`, `ensemble`, `donate`, `coupled_migration`
        and `mesh` raise `NotImplementedError`. The plan is bitwise the
        unsanitized one.
      telemetry: in-solve convergence telemetry
        (`repro_torch.obs.TelemetryConfig`). CR1/CR2 on the generic
        engine sample (objective, grad norm, max violation, |Δx|, mu)
        every `telemetry.every` inner steps into device buffers; the
        trace lands in `result.extras["telemetry"]` as a
        `ConvergenceTrace` (`solve_day`: one per tick). Refused with
        `use_kernel` (the fused kernel's inner loop is opaque), which
        is on by default on the card: pass `use_kernel=False` there.
        Under a sweep or ensemble it forces the loop lane. The plan is
        bitwise the plan without it.
    """
    device: str | torch.device | None = None
    shift: int = 0
    reset_mu: bool = False
    warm: EngineState | None = None
    use_kernel: bool | None = None
    steps: int | None = None
    moment_dtype: str = "float32"
    donate: bool = False
    mesh: Any = None
    coupled_migration: bool = False
    sanitize: bool = False
    telemetry: TelemetryConfig | None = None

    def resolved_steps(self, policy: "DRPolicy") -> int:
        return self.steps if self.steps is not None else policy.default_steps


@runtime_checkable
class DRPolicy(Protocol):
    """A frozen hyperparameter record that solves a `FleetProblem` under a
    `SolveContext` into a `FleetSolveResult`."""

    name: ClassVar[str]
    default_steps: ClassVar[int]

    def solve(self, problem: FleetProblem,
              ctx: SolveContext) -> FleetSolveResult: ...


#: Policy name -> policy class; the one place string-typed configs resolve.
POLICY_REGISTRY: dict[str, type] = {}


def _register(cls):
    POLICY_REGISTRY[cls.name] = cls
    return cls


def resolve_policy(policy) -> DRPolicy:
    """Coerce a registry name, policy class, or policy object to an object;
    unknown names raise `ValueError`."""
    if isinstance(policy, str):
        try:
            return POLICY_REGISTRY[policy]()
        except KeyError:
            raise ValueError(
                f"unknown policy {policy!r}; registered policies: "
                f"{', '.join(sorted(POLICY_REGISTRY))}") from None
    if isinstance(policy, type):
        policy = policy()
    if not isinstance(policy, DRPolicy):
        raise TypeError(
            f"policy must be a DRPolicy (e.g. CR1(lam=1.45)) or a "
            f"registered name; got {type(policy).__name__}")
    return policy


def configured_policy(policy, *, lam: float = 1.45, cap_frac: float = 0.78,
                      rho: float = 0.02, tax_frac: float = 0.2,
                      outer: int = 4) -> DRPolicy:
    """`resolve_policy` with the legacy keyword knobs: registry names
    become objects configured from the matching knobs (CR1: `lam`; CR2:
    `cap_frac`/`outer`; CR3: `rho`/`tax_frac`/`outer`; `outer` defaults
    to 4, the JAX package's streaming-controller budget); other
    registered names get default hypers; policy objects pass through
    unchanged (the knobs are ignored)."""
    if not isinstance(policy, str):
        return resolve_policy(policy)
    if policy not in POLICY_REGISTRY:
        raise ValueError(
            f"unknown policy {policy!r}; registered policies: "
            f"{', '.join(sorted(POLICY_REGISTRY))}")
    by_name = {"cr1": lambda: CR1(lam=lam),
               "cr2": lambda: CR2(cap_frac=cap_frac, outer=outer),
               "cr3": lambda: CR3(rho=rho, tax_frac=tax_frac, outer=outer)}
    return by_name.get(policy, POLICY_REGISTRY[policy])()


def _require_sanitizable(policy, ctx: SolveContext) -> None:
    """`sanitize=True` covers the CR1/CR2 solo engine lanes; everything
    else fails loudly here rather than silently skipping the checks the
    caller asked for."""
    name = getattr(policy, "name", type(policy).__name__)
    if name not in ("cr1", "cr2"):
        raise NotImplementedError(
            f"SolveContext(sanitize=True) supports CR1/CR2 (the checked "
            f"engine lanes); policy {name!r} has no sanitized lane")
    for field, flag in (("mesh", ctx.mesh is not None),
                        ("donate", ctx.donate),
                        ("coupled_migration", ctx.coupled_migration)):
        if flag:
            raise NotImplementedError(
                f"SolveContext(sanitize=True) is a solo debug lane; "
                f"combining it with {field} is not supported — drop "
                f"{field} while sanitizing")


def _tel_every(ctx: SolveContext) -> int:
    """`EngineConfig.telemetry_every` for this context (0 = off)."""
    return 0 if ctx.telemetry is None else int(ctx.telemetry.every)


def _require_telemetry_ok(ctx: SolveContext, use_kernel: bool) -> None:
    """Telemetry needs the generic inner loop: the fused al_step kernel
    runs k steps per opaque call, so per-step samples cannot be taken.
    Fail loudly instead of silently dropping the trace."""
    if ctx.telemetry is not None and use_kernel:
        raise NotImplementedError(
            "SolveContext(telemetry=...) is incompatible with the fused "
            "al_step kernel (use_kernel=True): the kernel's inner loop "
            "is opaque to per-step telemetry — drop use_kernel (or the "
            "telemetry) for this solve")


def _solve_sanitized(impl, *args, sanitize: bool, **kwargs):
    """`impl(*args, **kwargs)`; with `sanitize`, its checked twin, whose
    flag is read (raising `SanitizeError`) before the outputs return."""
    if not sanitize:
        return impl(*args, **kwargs)
    san, out = checked(impl)(*args, **kwargs)
    san.throw()
    return out


def _trace_extras(out, telemetry_every: int) -> dict | None:
    """`{"telemetry": ConvergenceTrace}` from an impl's 4th output."""
    if not telemetry_every:
        return None
    return {"telemetry": ConvergenceTrace.from_aux(out[3])}


def _fleet_mesh(ctx: SolveContext, device: torch.device):
    """`ctx.mesh` checked against the solve's device
    (`launch.mesh.check_fleet_mesh`); None without one."""
    if ctx.mesh is None:
        return None
    from repro_torch.launch.mesh import check_fleet_mesh
    check_fleet_mesh(ctx.mesh, device)
    return ctx.mesh


@dataclasses.dataclass(frozen=True)
class _Shard:
    """One problem split over a fleet mesh, as this process sees it."""
    mesh: Any
    W: int                 #: the fleet's rows
    W_pad: int             #: padded to a multiple of the mesh size
    rows: slice            #: this process's block of the padded rows
    view: FleetProblem     #: the device view of that block
    region: np.ndarray | None   #: the padded fleet's host region ids

    def block_rows(self, a: Tensor, fill: float = 0.0) -> Tensor:
        """This block's rows of a (W, ...) tensor of the fleet, the pad
        rows filled with `fill`."""
        pad = torch.full((self.W_pad - self.W,) + tuple(a.shape[1:]), fill,
                         dtype=a.dtype, device=a.device)
        return torch.cat([a, pad])[self.rows]

    def warm(self, warm: EngineState | None, T: int, device, *,
             eq: bool = False, ineq: bool = False,
             mu0: float = EngineConfig.mu0) -> EngineState:
        """The padded global start: `warm` padded, or a cold state with a
        multiplier a row for the equalities (`eq`) or inequalities
        (`ineq`)."""
        if warm is not None:
            return _pad_state(warm, self.W_pad)
        return EngineState.cold(
            torch.zeros((self.W_pad, T), dtype=f32, device=device),
            n_eq=self.W_pad if eq else 0, n_in=self.W_pad if ineq else 0,
            mu0=mu0)


def block_norms(norms, W_pad: int, rows: slice, fills):
    """The whole fleet's norms on the block `rows` of the padded fleet:
    a multi-region fleet's per-row twins ((W,) or (W, 1)) padded with
    `fills` (`pad_row_norms`) and cut; single-region scalars as they
    are. Tensor ops only, so a captured day holds it."""
    if norms[0].dim() == 0:
        return norms
    return tuple(a[rows] for a in pad_row_norms(norms, W_pad, fills))


def _shard(p: FleetProblem, mesh, device: torch.device) -> _Shard:
    """Pad `p` for `mesh` and take this process's row block."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import fleet_ranks
    ranks = fleet_ranks(mesh)
    pp, W = pad_fleet(p, len(ranks))
    i, n = ranks.index(dist.get_rank()), pp.W // len(ranks)
    return _Shard(mesh, W, pp.W, slice(i * n, (i + 1) * n),
                  device_view(row_block(pp, i, len(ranks)), device),
                  None if pp.region is None else np.asarray(pp.region))


def _al_run(shard: _Shard | None, objective, project, state0: EngineState,
            **pieces):
    """A solve's engine run: `al_minimize` on the whole view, or, over a
    fleet mesh, `al_minimize_sharded` on this process's block."""
    if shard is None:
        return al_minimize(objective, project, state0.x, init=state0,
                           **pieces)
    return al_minimize_sharded(objective, project, state0, mesh=shard.mesh,
                               rows=shard.rows, true_rows=shard.W, **pieces)


def _impl_out(p: FleetProblem, shard: _Shard | None, D: Tensor, aux: dict,
              use_kernel: bool, telemetry_every: int = 0):
    """(D, penalties, state) of an engine run, and the telemetry dict 4th
    with `telemetry_every`; over a fleet mesh the block's penalties (one
    `fleet_penalties` call on the block view `p`) are gathered, along
    the rows' dim (1 with lanes)."""
    with torch.no_grad():
        if shard is None:
            pens = fleet_penalties(p, D, use_kernel)
        else:
            dim = D.dim() - 2
            blk = D[(slice(None),) * dim + (shard.rows,)]
            pens = gather_rows(shard.mesh,
                               fleet_penalties(p, blk, use_kernel), dim)
    out = (D, pens, aux["state"])
    return out + (aux["telemetry"],) if telemetry_every else out


def solve(problem: FleetProblem, policy, *,
          ctx: SolveContext | None = None) -> FleetSolveResult:
    """Solve `problem` under `policy`, the single fleet entry point."""
    if not isinstance(problem, FleetProblem):
        raise TypeError(f"solve() takes a FleetProblem; got "
                        f"{type(problem).__name__}")
    ctx = ctx or SolveContext()
    policy = resolve_policy(policy)
    if ctx.sanitize:
        _require_sanitizable(policy, ctx)
    problem = single_region_view(problem)
    return _migrate(problem, policy, policy.solve(problem, ctx), ctx)


def sweep(problem: FleetProblem, policies: Sequence, *,
          ctx: SolveContext | None = None) -> list[FleetSolveResult]:
    """Solve `problem` under every policy in `policies`; results come back
    in `policies` order.

    A grid from one family with uniform static knobs (`[CR1(lam=l) for l
    in grid]`, or CR2s or CR3s sharing `outer`) rides the batched lane:
    one engine run over lane-stacked tensors (for CR1/CR2 one `al_step`
    launch per k steps for the whole grid; for CR3 one run per clearing
    round). Mixed families, `ctx.donate`, `shift` and
    `reset_mu` take the loop lane, a `solve()` per policy, where a shared
    `warm` state is reused read-only by every policy (so `donate` is
    dropped for more than one policy). A *stacked* warm state (leading
    axis len(policies), `stack_states([r.state for r in results])`)
    warm-starts each lane from its own slice: a refinement sweep of a
    Pareto front at a fraction of the cold budget, single- or
    multi-region. A topology's migration stage follows each solve, as in
    `solve`. `ctx.telemetry` takes the loop lane (each solve carries its
    own trace); `ctx.sanitize` raises (sanitize solves one at a time).
    Over a fleet mesh (`ctx.mesh`) the CR1/CR2 lanes run on this
    process's row block and are gathered (their results carry no state,
    as the JAX package's); CR3 grids and a stacked warm state take the
    loop of sharded `solve`s."""
    ctx = ctx or SolveContext()
    if ctx.sanitize:
        raise NotImplementedError(
            "SolveContext(sanitize=True) is a solo-solve debug lane — the "
            "batched sweep lanes have no checked twins (and a silent "
            "fallback would skip the guards you asked for); sanitize "
            "policies one at a time through solve()")
    problem = single_region_view(problem)
    pols = [resolve_policy(pl) for pl in policies]
    return [_migrate(problem, pl, r, ctx)
            for pl, r in zip(pols, _sweep(problem, pols, ctx))]


def _sweep(problem: FleetProblem, pols: list,
           ctx: SolveContext) -> list[FleetSolveResult]:
    """`sweep`'s solves, before the migration stage."""
    if not pols:
        return []
    fam = type(pols[0])
    stacked = _stacked_warm(ctx.warm, len(pols))
    warm_ok = ctx.warm is None or (stacked and ctx.mesh is None
                                   and fam in (CR1, CR2))
    batched = (all(type(pl) is fam for pl in pols)
               and fam in (CR1, CR2, CR3) and fam._sweep_uniform(pols)
               and warm_ok and not ctx.donate
               and not ctx.shift and not ctx.reset_mu
               and ctx.telemetry is None)
    if batched:
        return fam._sweep_family(problem, pols, ctx)
    if ctx.donate and len(pols) > 1:
        ctx = dataclasses.replace(ctx, donate=False)
    if stacked:
        return [pl.solve(problem, dataclasses.replace(
            ctx, warm=ctx.warm.lane(i))) for i, pl in enumerate(pols)]
    return [pl.solve(problem, ctx) for pl in pols]


def stack_states(states: Sequence[EngineState]) -> EngineState:
    """Stack per-lane `EngineState`s (`[r.state for r in sweep(...)]`)
    along a new leading axis: the warm start of a refinement sweep
    (`ctx.warm=stack_states(...)`). Shapes must agree across lanes; a
    mismatch raises here, naming the lane."""
    states = list(states)
    if not states:
        raise ValueError("stack_states needs at least one EngineState")
    names = ("x", "lam_eq", "lam_in", "mu")

    def shapes(st):
        return [tuple(getattr(st, n).shape) for n in names]

    ref = shapes(states[0])
    for i, st in enumerate(states[1:], 1):
        if shapes(st) != ref:
            raise ValueError(
                f"stack_states: state {i} has leaf shapes {shapes(st)}, but "
                f"state 0 has {ref}: all lanes must come from solves of the "
                f"same fleet")
    return EngineState(*(torch.stack([getattr(st, n) for st in states])
                         for n in names))


def _stacked_warm(warm, n: int) -> bool:
    """True when `warm` is a lane-stacked EngineState for an n-policy
    sweep."""
    return isinstance(warm, EngineState) and warm.lanes == n


def ensemble(problem: FleetProblem, policy, scenarios, *,
             ctx: SolveContext | None = None, batched: bool | None = None):
    """Evaluate `policy` across S scenarios of `problem`
    (`core.ensemble.evaluate_ensemble`): CR1/CR2 solve all S as one
    batched lane, other policies and contexts loop over `solve()`.
    Returns an `EnsembleResult`; `.report()` is its risk summary.
    `ctx.sanitize` raises, as in `evaluate_ensemble`."""
    from repro_torch.core.ensemble import evaluate_ensemble
    return evaluate_ensemble(problem, policy, scenarios, ctx=ctx,
                             batched=batched)


def _cold_x(p: FleetProblem, device: torch.device) -> Tensor:
    return torch.zeros(p.usage.shape, dtype=f32, device=device)


def cold_lanes(n: int, W: int, T: int, device: torch.device, n_eq: int,
               mu0: float) -> EngineState:
    """n lane-stacked cold states of a (W, T) fleet (`EngineState.cold`
    each)."""
    kw = dict(dtype=f32, device=device)
    return EngineState(x=torch.zeros((n, W, T), **kw),
                       lam_eq=torch.zeros((n, n_eq), **kw),
                       lam_in=torch.zeros((n, 0), **kw),
                       mu=torch.full((n,), mu0, **kw))


# ---------------------------------------------------------------------------
# Lanes: N solves as one engine run (sweeps, ensembles)
# ---------------------------------------------------------------------------
def lane_norms(norms_of, lanes, shard: _Shard | None = None,
               fills=None) -> tuple[Tensor, ...]:
    """`norms_of(*args)` for each lane's args, as `solve()` computes it
    (once per distinct args, by identity: a sweep's lanes share their
    problem), stacked to (N,) tensors. Over a fleet mesh the args are
    the whole fleet's and each lane's norms are cut to the block
    (`block_norms` with `fills`)."""
    memo, rows = {}, []
    for args in lanes:
        key = tuple(map(id, args))
        if key not in memo:
            nm = norms_of(*args)
            memo[key] = nm if shard is None else block_norms(
                nm, shard.W_pad, shard.rows, fills)
        rows.append(memo[key])
    return tuple(torch.stack(col) for col in zip(*rows))


def lane_rows(p: FleetProblem) -> Tensor:
    """Each fleet row's carbon trace of a multi-region view, gathered
    along the region axis: (W, T) for a shared (R, T) `mci`, (N, W, T)
    for a lane-leading (N, R, T) overlay (each lane its own rows)."""
    return p.mci[..., p.region, :]


def _plan_carbon(D: Tensor, mci: Tensor) -> Tensor:
    """(N, W) carbon of each lane's rows, mci (T,) shared or (N, T)."""
    return torch.matmul(D, mci[..., None])[..., 0]


def _cr1_lanes(p: FleetProblem, views, lams: Tensor, state0: EngineState,
               steps: int, use_kernel: bool, shift: int, reset_mu: bool,
               moment_dtype: str, *, shard: _Shard | None = None):
    """N CR1 solves as one engine run -> (D (N, W, T), penalties (N, W),
    stacked state). `p` is a device view whose fields may lead with the
    lane axis; `views` are its one-lane problems (the normalizers are
    each lane's own); `lams` (N,) and `state0` is lane-stacked. Over a
    fleet mesh (`shard`), `p` is this process's block of the padded
    lanes, `views` the whole fleet's (their norms cut to the block),
    `state0` the padded global state, and the outputs are gathered."""
    state0 = _enter_tick(state0, shift, reset_mu, CR1_MU0)
    pen_norm, car_norm, step_scale = lane_norms(
        cr1_norms, [(v,) for v in views], shard, CR1_NORM_FILLS)
    lo, hi = _bounds(p)
    cfg = _cr1_cfg(steps, moment_dtype)
    if p.region is not None:
        # Per-row norms (N, W), step scales (N, W, 1).
        coef0, step = lams[:, None] * pen_norm, step_scale
        wmci = lane_rows(p)

        def objective(D: Tensor, _) -> Tensor:
            return ((coef0 * fleet_penalties(p, D, use_kernel)).sum()
                    - (car_norm[..., None] * D * wmci).sum())
    else:
        coef0, step = lams * pen_norm, step_scale[:, None, None]

        def objective(D: Tensor, _) -> Tensor:
            return ((coef0[:, None] * fleet_penalties(p, D, use_kernel)).sum()
                    - (car_norm[:, None] * _plan_carbon(D, p.mci)).sum())

    fused = _al_fused_inner(p, "cr1", cfg, car_norm=car_norm,
                            step_scale=step_scale,
                            coef0=coef0) if use_kernel else None
    D, aux = _al_run(shard, objective, _projection(p, lo, hi), state0,
                     step_scale=step, cfg=cfg, fused_inner=fused)
    return _impl_out(p, shard, D, aux, use_kernel)


def _cr2_lanes(p: FleetProblem, views, refs: Sequence[Tensor],
               state0: EngineState, steps: int, outer: int, use_kernel: bool,
               shift: int, reset_mu: bool, moment_dtype: str, *,
               shard: _Shard | None = None):
    """N CR2 solves as one engine run, as `_cr1_lanes` (mesh included);
    `refs` holds each lane's (W,) fairness targets of the whole fleet,
    padded with 0 and cut to the block over a fleet mesh."""
    state0 = _enter_tick(state0, shift, reset_mu, CR2_MU0)
    car_norm, scale, step_scale = lane_norms(
        cr2_norms, list(zip(views, refs)), shard, CR2_NORM_FILLS)
    R = torch.stack([r if shard is None else shard.block_rows(r)
                     for r in refs])
    lo, hi = _bounds(p)
    cfg = _cr2_cfg(steps, outer, moment_dtype)
    if p.region is not None:
        # Per-row norms (N, W), step scales (N, W, 1).
        lane_scale, step = scale, step_scale
        wmci = lane_rows(p)

        def objective(D: Tensor, _) -> Tensor:
            return -(car_norm[..., None] * D * wmci).sum()
    else:
        lane_scale, step = scale[:, None], step_scale[:, None, None]

        def objective(D: Tensor, _) -> Tensor:
            return -(car_norm[:, None] * _plan_carbon(D, p.mci)).sum()

    def eq(D: Tensor, _) -> Tensor:
        return (fleet_penalties(p, D, use_kernel) - R) / lane_scale

    fused = _al_fused_inner(p, "cr2", cfg, car_norm=car_norm,
                            step_scale=step_scale, scale=scale,
                            refs=R) if use_kernel else None
    D, aux = _al_run(shard, objective, _projection(p, lo, hi), state0,
                     eq_residual=eq, step_scale=step, cfg=cfg,
                     fused_inner=fused)
    return _impl_out(p, shard, D, aux, use_kernel)


def _lane_results(p: FleetProblem, out, iters: int,
                  sharded: bool = False) -> list[FleetSolveResult]:
    """One `FleetSolveResult` per lane of a lanes run's (D, pens, state),
    each with its lane of the state; a sharded run's padded rows cut to
    the fleet's W, its lanes without a state (as the JAX package's)."""
    D, pens, state = out
    D, pens = D[:, :p.W].cpu().numpy(), pens[:, :p.W].cpu().numpy()
    return [_report(p, D[i], pens[i], iters=iters,
                    state=None if sharded else state.lane(i))
            for i in range(D.shape[0])]


# ---------------------------------------------------------------------------
# Fused AL inner loop (al_step kernel): the CR1/CR2 hot path
# ---------------------------------------------------------------------------
def _al_fused_inner(p: FleetProblem, mode: str, cfg: EngineConfig, *,
                    car_norm, step_scale, coef0=0.0, scale=None,
                    refs=None):
    """Pack this fleet's penalty parameters into the `al_step` layout and
    return the chunked dispatcher (`kernels.al_step.ops.make_fused_inner`)
    as the engine's `fused_inner` hook. `p` is a device view. For N
    lanes the normalizers, coef0 and scale are (N,) tensors and refs
    (N, W), and each lane gets its own carbon row (N, 1, T).

    A multi-region view hands over per-row norms ((W,), or (N, W) with
    lanes) and folds them into operands the kernel already reads, as the
    JAX package does, so the kernel stays region-blind: the carbon term
    becomes a row per fleet row, `-car_w · mci[region]` (W, T), or
    (N, W, T) with lanes (an ensemble's lanes each price on their own
    (R, T) trace); CR1's
    per-row weight `coef0 = lam · pen_w` folds into `k` (the gradient is
    linear in k) with coef0 = 1; CR2's residual scale folds `1/scale_w`
    into `k` and `refs` (h and coef·dpen are unchanged) with scale = 1;
    the per-row step scale rides rowp column 11."""
    from repro_torch.kernels.al_step.ops import make_fused_inner, pack_rows
    lo, hi = _bounds(p)
    k = p.k
    if p.region is not None:
        cvec = -car_norm[..., None] * lane_rows(p)
        if mode == "cr1":
            k, coef0 = k * coef0, 1.0
        else:
            inv_w = 1.0 / scale
            k, refs, scale = k * inv_w, refs * inv_w, 1.0
    elif car_norm.dim() == 0:
        cvec = (-car_norm * p.mci)[None, :]
    else:
        cvec = (-car_norm[:, None] * p.mci)[:, None, :]
    row_base = pack_rows(p.rts_coeffs, p.betas, k, p.x2_kind, p.is_batch,
                         refs=refs)
    return make_fused_inner(p.usage, p.jobs, lo, hi, row_base, cvec,
                            mode=mode, cfg=cfg, step_scale=step_scale,
                            coef0=coef0, scale=scale, day_hours=p.day_hours)


# ---------------------------------------------------------------------------
# CR1: Efficient DR (unconstrained trade-off objective)
# ---------------------------------------------------------------------------
def _cr1_pieces(p: FleetProblem, use_kernel: bool, norms):
    lo, hi = _bounds(p)
    pen_norm, car_norm, step_scale = norms
    if p.region is not None:
        wmci = p.mci[p.region]

        def objective(D: Tensor, lam) -> Tensor:
            return ((lam * pen_norm
                     * fleet_penalties(p, D, use_kernel)).sum()
                    - (car_norm[:, None] * D * wmci).sum())
    else:
        def objective(D: Tensor, lam) -> Tensor:
            return (lam * pen_norm * fleet_penalties(p, D, use_kernel).sum()
                    - car_norm * (D @ p.mci).sum())

    return objective, _projection(p, lo, hi), step_scale


def _cr1_cfg(steps: int, moment_dtype: str = "float32",
             telemetry_every: int = 0) -> EngineConfig:
    return EngineConfig(inner_steps=steps, outer_steps=1,
                        moment_dtype=moment_dtype,
                        telemetry_every=telemetry_every)


def _cr1_impl(p: FleetProblem, lam, state0: EngineState, steps: int,
              use_kernel: bool, shift: int, reset_mu: bool,
              moment_dtype: str, sanitizer: Sanitizer | None = None,
              telemetry_every: int = 0, *, norms=None,
              shard: _Shard | None = None):
    """One CR1 solve on the device view `p` -> (D, penalties, state), and
    the engine's telemetry dict 4th with `telemetry_every`. `lam` is a
    float or a 0-d float32 tensor (a day's static buffer); `sanitizer`
    records the engine's checks. Over a fleet mesh (`shard`), `p` is this
    process's block view, `norms` the whole fleet's cut to the block
    (`block_norms`), `state0` the padded global state, and the
    outputs are global; without one the norms are `p`'s own."""
    state0 = _enter_tick(state0, shift, reset_mu, CR1_MU0)
    norms = cr1_norms(p) if norms is None else norms
    objective, project, step_scale = _cr1_pieces(p, use_kernel, norms)
    cfg = _cr1_cfg(steps, moment_dtype, telemetry_every)
    fused = _al_fused_inner(p, "cr1", cfg, car_norm=norms[1],
                            step_scale=step_scale,
                            coef0=lam * norms[0]) if use_kernel else None
    D, aux = _al_run(shard, objective, project, state0, hyper=lam,
                     step_scale=step_scale, cfg=cfg, fused_inner=fused,
                     sanitizer=sanitizer)
    return _impl_out(p, shard, D, aux, use_kernel, telemetry_every)


@_register
@dataclasses.dataclass(frozen=True)
class CR1:
    """Efficient DR (paper Eq. 3): maximize the λ-weighted penalty/carbon
    trade-off over the whole fleet, unconstrained but for the box and batch
    day-preservation, both handled by projection."""

    lam: float = 1.45

    name: ClassVar[str] = "cr1"
    default_steps: ClassVar[int] = 600
    mu0: ClassVar[float] = CR1_MU0

    def solve(self, p: FleetProblem,
              ctx: SolveContext = SolveContext()) -> FleetSolveResult:
        device = resolve_device(ctx.device)
        use_kernel = resolve_use_kernel(ctx.use_kernel, device)
        _require_telemetry_ok(ctx, use_kernel)
        steps = ctx.resolved_steps(self)
        tel = _tel_every(ctx)
        mesh = _fleet_mesh(ctx, device)
        if mesh is None:
            warm = ctx.warm or EngineState.cold(_cold_x(p, device))
            out = _solve_sanitized(
                _cr1_impl, device_view(p, device), self.lam, warm, steps,
                use_kernel, ctx.shift, ctx.reset_mu, ctx.moment_dtype,
                sanitize=ctx.sanitize, telemetry_every=tel)
        else:
            sh = _shard(p, mesh, device)
            norms = block_norms(cr1_norms(device_view(p, device)),
                                sh.W_pad, sh.rows, CR1_NORM_FILLS)
            out = _cr1_impl(
                sh.view, self.lam, sh.warm(ctx.warm, p.T, device), steps,
                use_kernel, ctx.shift, ctx.reset_mu, ctx.moment_dtype,
                telemetry_every=tel, norms=norms, shard=sh)
        D, pens, state = out[:3]
        return _report(p, D[:p.W].cpu().numpy(), pens[:p.W].cpu().numpy(),
                       iters=steps, state=state,
                       extras=_trace_extras(out, tel))

    # -- the batched sweep lane ---------------------------------------------
    @classmethod
    def _sweep_uniform(cls, policies: Sequence["CR1"]) -> bool:
        return True          # lam is the only knob, and it is per lane

    @classmethod
    def _sweep_family(cls, p: FleetProblem, policies: Sequence["CR1"],
                      ctx: SolveContext) -> list[FleetSolveResult]:
        device = resolve_device(ctx.device)
        use_kernel = resolve_use_kernel(ctx.use_kernel, device)
        steps = ctx.resolved_steps(cls)
        n = len(policies)
        lams = torch.tensor([pl.lam for pl in policies], dtype=f32,
                            device=device)
        pv = device_view(p, device)
        mesh = _fleet_mesh(ctx, device)
        if mesh is None:
            init = ctx.warm or cold_lanes(n, p.W, p.T, device, 0, CR1_MU0)
            return _lane_results(p, _cr1_lanes(
                pv, [pv] * n, lams, init, steps, use_kernel, 0, False,
                ctx.moment_dtype), steps)
        sh = _shard(p, mesh, device)
        return _lane_results(p, _cr1_lanes(
            sh.view, [pv] * n, lams,
            cold_lanes(n, sh.W_pad, p.T, device, 0, CR1_MU0), steps,
            use_kernel, 0, False, ctx.moment_dtype, shard=sh), steps,
            sharded=True)


# ---------------------------------------------------------------------------
# CR2: Fair-Centralized DR (per-workload penalty-equality targets)
# ---------------------------------------------------------------------------
def _cr2_pieces(p: FleetProblem, refs: Tensor, use_kernel: bool, norms):
    lo, hi = _bounds(p)
    car_norm, scale, step_scale = norms
    if p.region is not None:
        wmci = p.mci[p.region]

        def objective(D: Tensor, _) -> Tensor:
            return -(car_norm[:, None] * D * wmci).sum()
    else:
        def objective(D: Tensor, _) -> Tensor:
            return -car_norm * (D @ p.mci).sum()

    def eq(D: Tensor, _) -> Tensor:
        return (fleet_penalties(p, D, use_kernel) - refs) / scale

    return objective, eq, _projection(p, lo, hi), step_scale


def _cr2_cfg(steps: int, outer: int, moment_dtype: str = "float32",
             telemetry_every: int = 0) -> EngineConfig:
    return EngineConfig(inner_steps=steps, outer_steps=outer, mu0=CR2_MU0,
                        mu_growth=2.0, moment_dtype=moment_dtype,
                        telemetry_every=telemetry_every)


def _cr2_impl(p: FleetProblem, refs: Tensor, state0: EngineState,
              steps: int, outer: int, use_kernel: bool, shift: int,
              reset_mu: bool, moment_dtype: str,
              sanitizer: Sanitizer | None = None, telemetry_every: int = 0,
              *, norms=None, shard: _Shard | None = None):
    """One CR2 solve on the device view `p` -> (D, penalties, state), and
    the telemetry dict 4th with `telemetry_every` (as `_cr1_impl`, mesh
    included). Over a fleet mesh `refs` are the block's fairness targets
    of the whole fleet (0 on pad rows, whose residuals are then
    identically 0)."""
    state0 = _enter_tick(state0, shift, reset_mu, CR2_MU0)
    norms = cr2_norms(p, refs) if norms is None else norms
    objective, eq, project, step_scale = _cr2_pieces(p, refs, use_kernel,
                                                     norms)
    cfg = _cr2_cfg(steps, outer, moment_dtype, telemetry_every)
    fused = _al_fused_inner(p, "cr2", cfg, car_norm=norms[0],
                            step_scale=step_scale, scale=norms[1],
                            refs=refs) if use_kernel else None
    D, aux = _al_run(shard, objective, project, state0, eq_residual=eq,
                     step_scale=step_scale, cfg=cfg, fused_inner=fused,
                     sanitizer=sanitizer)
    return _impl_out(p, shard, D, aux, use_kernel, telemetry_every)


@_register
@dataclasses.dataclass(frozen=True)
class CR2:
    """Fair-Centralized DR (paper Eq. 4): min −carbon s.t.
    C_i(d_i) = C_i(cap_frac·E_i) for every workload: one equality
    multiplier per workload, `outer` AL multiplier rounds."""

    cap_frac: float = 0.78
    outer: int = 6

    name: ClassVar[str] = "cr2"
    default_steps: ClassVar[int] = 400
    mu0: ClassVar[float] = CR2_MU0

    def solve(self, p: FleetProblem,
              ctx: SolveContext = SolveContext()) -> FleetSolveResult:
        device = resolve_device(ctx.device)
        use_kernel = resolve_use_kernel(ctx.use_kernel, device)
        _require_telemetry_ok(ctx, use_kernel)
        steps = ctx.resolved_steps(self)
        tel = _tel_every(ctx)
        # The fairness targets use the kernel wherever the device has it,
        # whatever `use_kernel` says, as the JAX package's auto dispatch.
        refs = torch.as_tensor(cr2_reference_fleet(p, self.cap_frac, device),
                               device=device)
        mesh = _fleet_mesh(ctx, device)
        if mesh is None:
            warm = ctx.warm or EngineState.cold(_cold_x(p, device), n_eq=p.W,
                                                mu0=CR2_MU0)
            out = _solve_sanitized(
                _cr2_impl, device_view(p, device), refs, warm, steps,
                self.outer, use_kernel, ctx.shift, ctx.reset_mu,
                ctx.moment_dtype, sanitize=ctx.sanitize, telemetry_every=tel)
        else:
            # The whole fleet's norms and targets, cut to this block.
            sh = _shard(p, mesh, device)
            norms = block_norms(cr2_norms(device_view(p, device), refs),
                                sh.W_pad, sh.rows, CR2_NORM_FILLS)
            out = _cr2_impl(
                sh.view, sh.block_rows(refs),
                sh.warm(ctx.warm, p.T, device, eq=True, mu0=CR2_MU0), steps,
                self.outer, use_kernel, ctx.shift, ctx.reset_mu,
                ctx.moment_dtype, telemetry_every=tel, norms=norms,
                shard=sh)
        D, pens, state = out[:3]
        return _report(p, D[:p.W].cpu().numpy(), pens[:p.W].cpu().numpy(),
                       iters=steps * self.outer, state=state,
                       extras=_trace_extras(out, tel))

    # -- the batched sweep lane ---------------------------------------------
    @classmethod
    def _sweep_uniform(cls, policies: Sequence["CR2"]) -> bool:
        # `outer` shapes the engine run: one run needs one value.
        return len({pl.outer for pl in policies}) == 1

    @classmethod
    def _sweep_family(cls, p: FleetProblem, policies: Sequence["CR2"],
                      ctx: SolveContext) -> list[FleetSolveResult]:
        device = resolve_device(ctx.device)
        use_kernel = resolve_use_kernel(ctx.use_kernel, device)
        steps = ctx.resolved_steps(cls)
        outer = policies[0].outer
        n = len(policies)
        # Each lane's targets as `solve()` computes them.
        refs = [torch.as_tensor(cr2_reference_fleet(p, pl.cap_frac, device),
                                device=device) for pl in policies]
        pv = device_view(p, device)
        mesh = _fleet_mesh(ctx, device)
        if mesh is None:
            init = ctx.warm or cold_lanes(n, p.W, p.T, device, p.W, CR2_MU0)
            return _lane_results(p, _cr2_lanes(
                pv, [pv] * n, refs, init, steps, outer, use_kernel, 0,
                False, ctx.moment_dtype), steps * outer)
        # Per-lane norms of the whole fleet; targets padded with 0 (pad
        # residuals are identically 0) and cut, in `_cr2_lanes`.
        sh = _shard(p, mesh, device)
        return _lane_results(p, _cr2_lanes(
            sh.view, [pv] * n, refs,
            cold_lanes(n, sh.W_pad, p.T, device, sh.W_pad, CR2_MU0), steps,
            outer, use_kernel, 0, False, ctx.moment_dtype, shard=sh),
            steps * outer, sharded=True)


# ---------------------------------------------------------------------------
# CR3: Fair-Decentralized DR (taxes and rebates, Eqs. 5-8)
# ---------------------------------------------------------------------------
def _lane_col(v, D: Tensor):
    """A per-lane hyper (N,) as a column against D's (N, W) rows; a
    scalar passes through."""
    if isinstance(v, Tensor) and v.dim() == 1 and D.dim() == 3:
        return v[:, None]
    return v


def _cr3_pieces(p: FleetProblem, use_kernel: bool, reg_scale):
    """Best-response pieces for the whole fleet (`p` a device view).

    Everything here is row-separable; `reg_scale` is the regularizer
    normalizer 1e-3/(W·T). On a multi-region view it is the per-row
    (W, 1) tensor 1e-3/(W_region·T) and rho an (R,) tensor, so each
    region's market is its standalone single-region market. Numerics,
    as the JAX package validates them against the per-workload SLSQP
    reference:
      * a tiny quadratic regularizer: a selfish workload takes the
        minimal adjustment satisfying its allowance (without it any deep
        feasible point is an equally optimal best response with wildly
        overpaid rebates);
      * the day-tangent gradient transform: Adam's per-coordinate
        normalization would otherwise emit near-uniform steps on batch
        rows that the day projection then annihilates;
      * a gentle mu schedule (`_cr3_cfg`): the KKT multipliers are
        O(1e-3), so a stiff wall makes projected Adam bounce.
    With lanes, D is (N, W, T) and the hyper (rho, tax) holds (N,)
    tensors; rho multiplies each lane's own carbon rows."""
    lo, hi = _bounds(p)
    usage, E, mci = p.usage, p.entitlement, p.mci
    tau = 0.02 * E
    if p.region is not None:
        region, wmci = p.region, mci[p.region]

        def objective(D: Tensor, hyper) -> Tensor:
            reg = (reg_scale * (D / E[:, None]) ** 2).sum()
            return (fleet_penalties(p, D, use_kernel) / E).sum() + reg

        def ineq(D: Tensor, hyper) -> Tensor:
            rho_, tax_ = hyper
            rebate = rho_[region] * (D * wmci).sum(-1)
            peak = tau * torch.logsumexp((usage - D) / tau[:, None], dim=-1)
            return ((1.0 - tax_) * E + rebate - peak) / E
    else:
        def objective(D: Tensor, hyper) -> Tensor:
            reg = reg_scale * ((D / E[:, None]) ** 2).sum()
            return (fleet_penalties(p, D, use_kernel) / E).sum() + reg

        def ineq(D: Tensor, hyper) -> Tensor:
            rho_, tax_ = (_lane_col(h, D) for h in hyper)
            rebate = rho_ * (D @ mci)
            peak = tau * torch.logsumexp((usage - D) / tau[:, None],
                                         dim=-1)
            return ((1.0 - tax_) * E + rebate - peak) / E

    W, T = usage.shape[-2:]
    day_hours = min(p.day_hours, T)   # as `project_days`
    span = (T // day_hours) * day_hours
    is_batch = p.is_batch[:, None, None]

    def day_tangent(g: Tensor) -> Tensor:
        lead = tuple(g.shape[:-2])
        Gd = g[..., :span].reshape(lead + (W, span // day_hours, day_hours))
        Gd = torch.where(is_batch, Gd - Gd.mean(dim=-1, keepdim=True), Gd)
        return torch.cat([Gd.reshape(lead + (W, span)), g[..., span:]],
                         dim=-1)

    step_scale = torch.clamp(hi - lo, min=1e-6).mean(dim=-1, keepdim=True)
    return (objective, ineq, _mean_projection(p, lo, hi), step_scale,
            day_tangent)


def _cr3_cfg(steps: int, outer: int) -> EngineConfig:
    return EngineConfig(inner_steps=steps, outer_steps=outer, lr=0.005,
                        mu0=CR3_MU0, mu_growth=2.0, beta2=0.99)


def _cr3_impl(p: FleetProblem, rho, tax_frac, reg_scale: float,
              state0: EngineState, steps: int, outer: int, use_kernel: bool,
              shift: int = 0, reset_mu: bool = False, *,
              shard: _Shard | None = None):
    """All W selfish problems in one AL solve on the device view `p`.
    Each workload i minimizes its own penalty s.t. the peak-allowance
    inequality (Eq. 5/8)

        max_t (U_i − d_i) ≤ E_i − T_i + ρ·⟨mci, d_i⟩,   T_i = tax_frac·E_i

    (a smooth max, as `policies.cr3_workload_spec`). Objective, residual
    and projection are row-separable, so this one engine run is the W
    best responses. -> (D, penalties, state). Over a fleet mesh
    (`shard`), `p` is this process's block view: the allowance
    inequality, its multipliers and the step scale live with their rows;
    rho, the tax and a single-region `reg_scale` are replicated, a
    multi-region one is the block's rows; the outputs are global, and the
    Eq.-6 fiscal sums stay in `CR3.solve`, on the gathered plan."""
    state0 = _enter_tick(state0, shift, reset_mu, CR3_MU0)
    objective, ineq, project, step_scale, day_tangent = _cr3_pieces(
        p, use_kernel, reg_scale)
    D, aux = _al_run(shard, objective, project, state0,
                     hyper=(rho, tax_frac), ineq_residual=ineq,
                     step_scale=step_scale, grad_transform=day_tangent,
                     cfg=_cr3_cfg(steps, outer))
    return _impl_out(p, shard, D, aux, use_kernel)


def _cr3_unbalanced_warn(clearing_iters: int, deficit: float, rho: float,
                         caller: str) -> None:
    warnings.warn(
        f"{caller}: fiscal clearing did not converge in "
        f"{clearing_iters} iterations — rebates exceed taxes by "
        f"{deficit:.4g} at rho={rho:.4g} (Eq. 6 unmet)",
        RuntimeWarning, stacklevel=3)


def _next_rho(rho, paid, collected):
    """The coordinator's price cut when rebates exceed taxes."""
    return rho * np.maximum(0.5, 0.9 * collected / np.maximum(paid, 1e-9))


@_register
@dataclasses.dataclass(frozen=True)
class CR3:
    """Fair-Decentralized DR: the W selfish best responses in one engine
    run, and the coordinator's fiscal-balance clearing (Eqs. 5-8).

    The coordinator lowers the carbon price ρ until rebates are covered
    by taxes (Eq. 6, `policies.cr3_fiscal_balance`): it reads the rebates
    paid on the host once a round. Each clearing round warm-starts from
    the previous round's engine state with the mu schedule restarted
    (the allowance multipliers track the shrinking ρ); `ctx.warm` seeds
    round 0 the same way for rolling-horizon re-solves. CR3 has no fused
    kernel mode: its objective goes through `fleet_penalties`, and so
    the `dr_features` kernel on the card, on every inner step.

    If `clearing_iters` is exhausted with rebates still exceeding taxes,
    `result.extras` carries `balanced=False` and the remaining
    `fiscal_deficit` (rebates − taxes, NP·kgCO2/MWh), and a
    `RuntimeWarning` is emitted: `extras["rho"]` is then not
    market-clearing. A multi-region fleet clears one market per region
    (`_solve_multiregion`; `extras["rho"]` is then (R,))."""

    rho: float = 0.02
    tax_frac: float = 0.2
    outer: int = 3
    clearing_iters: int = 8

    name: ClassVar[str] = "cr3"
    default_steps: ClassVar[int] = 600
    mu0: ClassVar[float] = CR3_MU0

    def solve(self, p: FleetProblem,
              ctx: SolveContext = SolveContext()) -> FleetSolveResult:
        p = single_region_view(p)
        if p.is_multiregion:
            return self._solve_multiregion(p, ctx)
        device = resolve_device(ctx.device)
        use_kernel = resolve_use_kernel(ctx.use_kernel, device)
        steps = ctx.resolved_steps(self)
        mci = np.asarray(p.mci)
        collected = self.tax_frac * float(np.asarray(p.entitlement).sum())
        rho_cur = float(self.rho)
        # The regularizer's normalizer takes the fleet's W, padded or not.
        reg_scale = 1e-3 / (p.W * p.T)
        mesh = _fleet_mesh(ctx, device)
        if mesh is None:
            pv = device_view(p, device)
            state = ctx.warm or EngineState.cold(_cold_x(p, device),
                                                 n_in=p.W, mu0=CR3_MU0)
            impl = functools.partial(_cr3_impl, pv)
        else:
            sh = _shard(p, mesh, device)
            state = sh.warm(ctx.warm, p.T, device, ineq=True, mu0=CR3_MU0)
            impl = functools.partial(_cr3_impl, sh.view, shard=sh)

        def best_response(st, shift_, reset_):
            D, pens, st = impl(rho_cur, self.tax_frac, reg_scale, st, steps,
                               self.outer, use_kernel, shift_, reset_)
            return D[:p.W].cpu().numpy(), pens[:p.W], st

        D, pens, state = best_response(state, ctx.shift, ctx.reset_mu)
        rounds = 1
        paid = rho_cur * float((D @ mci).sum())
        for _ in range(self.clearing_iters):
            if paid <= collected + 1e-9:
                break
            rho_cur = float(_next_rho(rho_cur, paid, collected))
            # Carry the primal and the allowance multipliers; restart the
            # mu schedule so every round keeps the gentle wall.
            D, pens, state = best_response(state, 0, True)
            rounds += 1
            paid = rho_cur * float((D @ mci).sum())
        balanced = paid <= collected + 1e-9
        deficit = 0.0 if balanced else paid - collected
        if not balanced:
            _cr3_unbalanced_warn(self.clearing_iters, deficit, rho_cur,
                                 "CR3.solve")
        return _report(p, D, pens.cpu().numpy(),
                       iters=steps * self.outer * rounds, state=state,
                       extras={"rho": rho_cur, "balanced": balanced,
                               "fiscal_deficit": deficit})

    def _solve_multiregion(self, p: FleetProblem,
                           ctx: SolveContext) -> FleetSolveResult:
        """Per-region fiscal clearing: each region runs its own Eq.-6
        market (its taxes cover its rebates at its own price rho_r), so
        `extras["rho"]` is (R,). Every round re-solves the whole fleet in
        one engine run, but the rows of regions that have cleared keep
        their frozen plan, penalties, iterate and allowance multipliers:
        each region follows its standalone single-region trajectory."""
        device = resolve_device(ctx.device)
        use_kernel = resolve_use_kernel(ctx.use_kernel, device)
        steps = ctx.resolved_steps(self)
        region, R = np.asarray(p.region), p.R
        wmci = np.asarray(p.mci)[region]
        collected = self.tax_frac * region_totals(region, p.entitlement, R)
        rho_cur = np.full(R, float(self.rho))
        pv = device_view(p, device)
        reg_scale = cr3_reg_scale(pv)
        mesh = _fleet_mesh(ctx, device)
        if mesh is None:
            state = ctx.warm or EngineState.cold(_cold_x(p, device),
                                                 n_in=p.W, mu0=CR3_MU0)
            impl, region_state = functools.partial(_cr3_impl, pv), region
        else:
            # The whole fleet's per-region scale, cut to this block (pad
            # rows 1); the state's pad rows sit in region 0 (PAD_FILLS).
            sh = _shard(p, mesh, device)
            reg_scale = sh.block_rows(reg_scale, 1.0)
            state = sh.warm(ctx.warm, p.T, device, ineq=True, mu0=CR3_MU0)
            impl, region_state = (functools.partial(_cr3_impl, sh.view,
                                                    shard=sh), sh.region)

        def best_response(st, shift_, reset_):
            rho_t = torch.tensor(rho_cur, dtype=f32, device=device)
            D, pens, st = impl(rho_t, self.tax_frac, reg_scale, st, steps,
                               self.outer, use_kernel, shift_, reset_)
            return D[:p.W].cpu().numpy(), pens[:p.W].cpu().numpy(), st

        def paid_of(D):
            return rho_cur * region_totals(region, (D * wmci).sum(1), R)

        D, pens, state = best_response(state, ctx.shift, ctx.reset_mu)
        rounds = 1
        paid = paid_of(D)
        for _ in range(self.clearing_iters):
            active = paid > collected + 1e-9
            if not active.any():
                break
            rho_cur = np.where(active, _next_rho(rho_cur, paid, collected),
                               rho_cur)
            Dn, pens_n, new = best_response(state, 0, True)
            row = active[region]
            D = np.where(row[:, None], Dn, D)
            pens = np.where(row, pens_n, pens)
            # mu restarts every round; CR3 has no equality multipliers, so
            # only x and the allowance multipliers freeze per row.
            mask = torch.as_tensor(active[region_state], device=device)
            state = EngineState(
                x=torch.where(mask[:, None], new.x, state.x),
                lam_eq=new.lam_eq,
                lam_in=torch.where(mask, new.lam_in, state.lam_in),
                mu=new.mu)
            rounds += 1
            paid = paid_of(D)
        balanced = paid <= collected + 1e-9
        deficit = np.where(balanced, 0.0, paid - collected)
        if not balanced.all():
            worst = int(np.argmax(deficit))
            _cr3_unbalanced_warn(self.clearing_iters, float(deficit.sum()),
                                 float(rho_cur[worst]),
                                 "CR3.solve (multi-region)")
        return _report(p, D, pens, iters=steps * self.outer * rounds,
                       state=state,
                       extras={"rho": rho_cur,
                               "balanced": bool(balanced.all()),
                               "fiscal_deficit": float(deficit.sum())})

    # -- the sweep lane -----------------------------------------------------
    @classmethod
    def _sweep_uniform(cls, policies: Sequence["CR3"]) -> bool:
        # `outer` shapes the engine run; per-lane rho/tax are tensors and
        # per-lane clearing_iters ride the host's lockstep loop.
        return len({pl.outer for pl in policies}) == 1

    @classmethod
    def _sweep_family(cls, p: FleetProblem, policies: Sequence["CR3"],
                      ctx: SolveContext) -> list[FleetSolveResult]:
        if p.is_multiregion or ctx.mesh is not None:
            # Multi-region clearing tracks an (R,) price per lane, and a
            # fleet mesh shards one solve: solve per policy, as the JAX
            # package does.
            return [pl.solve(p, ctx) for pl in policies]
        device = resolve_device(ctx.device)
        use_kernel = resolve_use_kernel(ctx.use_kernel, device)
        steps = ctx.resolved_steps(cls)
        outer = policies[0].outer
        n = len(policies)
        mci = np.asarray(p.mci)
        pv = device_view(p, device)
        reg_scale = 1e-3 / (p.W * p.T)
        states = dataclasses.replace(
            cold_lanes(n, p.W, p.T, device, 0, CR3_MU0),
            lam_in=torch.zeros((n, p.W), dtype=f32, device=device))
        rho_cur = np.asarray([pl.rho for pl in policies], float)
        taxes = np.asarray([pl.tax_frac for pl in policies], float)
        iters_cap = np.asarray([pl.clearing_iters for pl in policies])
        collected = taxes * float(np.asarray(p.entitlement).sum())
        tax_t = torch.tensor(taxes, dtype=f32, device=device)

        def rounds_all(st, reset_mu):
            rho_t = torch.tensor(rho_cur, dtype=f32, device=device)
            return _cr3_impl(pv, rho_t, tax_t, reg_scale, st, steps, outer,
                             use_kernel, 0, reset_mu)

        Ds, pens, states = rounds_all(states, False)
        D_out, pens_out = Ds.cpu().numpy(), pens.cpu().numpy()
        rounds = np.ones(n, int)
        paid = rho_cur * np.einsum("nwt,t->n", D_out, mci)
        while True:
            active = (paid > collected + 1e-9) & (rounds - 1 < iters_cap)
            if not active.any():
                break
            rho_cur = np.where(active, _next_rho(rho_cur, paid, collected),
                               rho_cur)
            # Every lane re-solves in the one run, but lanes that have
            # cleared keep their frozen plan, penalties and state, so each
            # lane follows its solo `solve()` trajectory.
            Ds, pens, new = rounds_all(states, True)
            D_out = np.where(active[:, None, None], Ds.cpu().numpy(), D_out)
            pens_out = np.where(active[:, None], pens.cpu().numpy(),
                                pens_out)
            act = torch.as_tensor(active, device=device)
            states = EngineState(*(
                torch.where(act.reshape((n,) + (1,) * (a.dim() - 1)), a, b)
                for a, b in ((new.x, states.x), (new.lam_eq, states.lam_eq),
                             (new.lam_in, states.lam_in),
                             (new.mu, states.mu))))
            rounds = rounds + active
            paid = np.where(active,
                            rho_cur * np.einsum("nwt,t->n", D_out, mci),
                            paid)
        balanced = paid <= collected + 1e-9
        deficit = np.where(balanced, 0.0, paid - collected)
        out = []
        for i, pl in enumerate(policies):
            if not balanced[i]:
                _cr3_unbalanced_warn(pl.clearing_iters, float(deficit[i]),
                                     float(rho_cur[i]), "CR3 sweep")
            out.append(_report(
                p, D_out[i], pens_out[i],
                iters=steps * outer * int(rounds[i]), state=states.lane(i),
                extras={"rho": float(rho_cur[i]),
                        "balanced": bool(balanced[i]),
                        "fiscal_deficit": float(deficit[i])}))
        return out


# ---------------------------------------------------------------------------
# Baselines: closed-form prior-work policies as DRPolicy values
# ---------------------------------------------------------------------------
def _closed_form(p: FleetProblem, D: np.ndarray,
                 ctx: SolveContext) -> FleetSolveResult:
    """Score a closed-form plan: its penalties in one `fleet_penalties`
    call (one `dr_features` launch on the card)."""
    device = resolve_device(ctx.device)
    pens = fleet_penalties(p, torch.as_tensor(D, dtype=f32, device=device),
                           resolve_use_kernel(ctx.use_kernel, device))
    return _report(p, D, pens.cpu().numpy(), iters=0)


@_register
@dataclasses.dataclass(frozen=True)
class B1:
    """Proportional Power Capping (paper §V-B, eBuff-style): cap every
    workload at L_i = F·E_i, d = max(U − L, 0), the fleet-array form of
    `baselines.b1_adjustments`. Closed form: of `ctx`, only the device
    and `use_kernel` matter (no engine state to warm)."""

    F: float = 0.75

    name: ClassVar[str] = "b1"
    default_steps: ClassVar[int] = 0

    def solve(self, p: FleetProblem,
              ctx: SolveContext = SolveContext()) -> FleetSolveResult:
        D = np.maximum(np.asarray(p.usage)
                       - self.F * np.asarray(p.entitlement)[:, None], 0.0)
        return _closed_form(p, D, ctx)


@_register
@dataclasses.dataclass(frozen=True)
class B3:
    """Prioritized Power Capping (paper §V-B, Dynamo): curtail RTS
    workloads only, lowest priority (= last RTS row) first, each up to
    `max_cut` depth, the fleet-array form of `baselines.b3_adjustments`
    with row order as the priority order. Closed form like `B1`."""

    depth: float = 0.3
    max_cut: float = 0.2

    name: ClassVar[str] = "b3"
    default_steps: ClassVar[int] = 0

    def solve(self, p: FleetProblem,
              ctx: SolveContext = SolveContext()) -> FleetSolveResult:
        usage = np.asarray(p.usage)
        D = np.zeros_like(usage)
        remaining = float(self.depth)
        rts_rows = [i for i in range(p.W) if not bool(p.is_batch[i])]
        for i in reversed(rts_rows):
            if remaining <= 0:
                break
            c = min(remaining, self.max_cut)
            L = (1.0 - c) * float(p.entitlement[i])
            D[i] = np.maximum(usage[i] - L, 0.0)
            remaining -= c
        return _closed_form(p, D, ctx)


# ---------------------------------------------------------------------------
# Migration stages of a multi-region fleet (`core/migration.py`)
# ---------------------------------------------------------------------------
def _migrate(p: FleetProblem, policy, res: FleetSolveResult,
             ctx: SolveContext) -> FleetSolveResult:
    """The migration stage after a solve: the coupled refinement when
    `ctx.coupled_migration` asks for it, else the post-stage."""
    if ctx.coupled_migration:
        return _coupled_migrate(p, policy, res, ctx)
    return _maybe_migrate(p, res, ctx)


def _credit(p: FleetProblem, res: FleetSolveResult, plan,
            **extras) -> FleetSolveResult:
    """`res` with the plan's net saving credited into its carbon reduction
    and the plan in `extras["migration"]`."""
    wmci = np.asarray(p.mci)[np.asarray(p.region)]
    carbon_base = float((np.asarray(p.usage) * wmci).sum())
    return dataclasses.replace(
        res, carbon_reduction_pct=res.carbon_reduction_pct
        + 100.0 * plan.net_saved / carbon_base,
        extras={**res.extras, "migration": plan, **extras})


def _maybe_migrate(p: FleetProblem, res: FleetSolveResult,
                   ctx: SolveContext) -> FleetSolveResult:
    """The post-stage (`migration.fleet_migration`): on a multi-region
    fleet whose topology has a positive bandwidth, move batch load along
    the network and credit the net carbon saved. The committed plan D is
    unchanged, so total curtailment and every penalty stay as solved."""
    if (p.topology is None or not p.is_multiregion
            or not np.any(np.asarray(p.topology.bandwidth) > 0.0)):
        return res
    from repro_torch.core.migration import fleet_migration
    return _credit(p, res, fleet_migration(p, np.asarray(res.D),
                                           device=ctx.device))


def _coupled_impl(p: FleetProblem, D0: Tensor, hyper, refs, fr: Tensor,
                  to: Tensor, bw: Tensor, cost: Tensor, ceil: Tensor, *,
                  mode: str, steps: int, outer: int, use_kernel: bool,
                  has_ceiling: bool):
    """The joint (curtailment, interconnect flow) refinement on the device
    view `p`. The primal is z = [D (W, T); y (L, T)] over the L links of
    positive bandwidth; one engine run minimizes the policy objective on
    D less the normalized, toll-adjusted value of the flows, with link
    caps in the projection, per-region supply (batch load left running
    >= outflow) and ceiling (headroom >= inflow) as inequality residuals,
    and the total curtailment pinned to the base plan D0 as an equality
    residual (CR2 keeps its per-row fairness equalities beside it). The
    region sums couple rows, so this is the generic engine (the penalties
    through `dr_features` on the card). Returns (D, y, penalties),
    eps-feasible; the caller repairs y exactly."""
    W, T = p.usage.shape
    L = bw.shape[0]
    mci, region, usage = p.mci, p.region, p.usage
    R = mci.shape[0]
    isb = p.is_batch[:, None]
    zero = torch.zeros((), dtype=f32, device=usage.device)
    margin = mci[fr] - mci[to] - cost[:, None]            # (L, T)
    flow_norm = 100.0 / (usage * mci[region]).sum()
    if mode == "cr1":
        obj_D, project_D, step_D = _cr1_pieces(p, use_kernel, cr1_norms(p))
        eq_D = None
    else:
        obj_D, eq_D, project_D, step_D = _cr2_pieces(
            p, refs, use_kernel, cr2_norms(p, refs))

    def movable_of(D):
        return segment_sum(torch.where(isb, torch.maximum(usage - D, zero),
                                       zero), region, R)

    sscale = torch.clamp(movable_of(D0).max(), min=1.0)
    curt_scale = torch.clamp(D0.abs().sum(), min=1.0)
    D0_sum = D0.sum()
    bwcol = bw[:, None]

    def objective(z: Tensor, hyp) -> Tensor:
        return obj_D(z[:W], hyp) - flow_norm * (z[W:] * margin).sum()

    def project(z: Tensor) -> Tensor:
        return torch.cat([project_D(z[:W]),
                          torch.minimum(torch.clamp(z[W:], min=0.0), bwcol)])

    def eq(z: Tensor, hyp) -> Tensor:
        curt = ((z[:W].sum() - D0_sum) / curt_scale)[None]
        return curt if eq_D is None else torch.cat([eq_D(z[:W], hyp), curt])

    def ineq(z: Tensor, hyp) -> Tensor:
        D, y = z[:W], z[W:]
        res = ((movable_of(D) - segment_sum(y, fr, R)) / sscale).reshape(-1)
        if has_ceiling:
            load = segment_sum(usage - D, region, R)
            inflow = segment_sum(y, to, R)
            res = torch.cat([res, ((ceil - load - inflow)
                                   / sscale).reshape(-1)])
        return res

    step = torch.cat([torch.as_tensor(step_D, dtype=f32,
                                      device=usage.device).expand(W, 1),
                      (0.1 * sscale).expand(L, 1)])
    cfg = EngineConfig(inner_steps=steps, outer_steps=outer, mu0=10.0,
                       mu_growth=3.0)
    z0 = torch.cat([D0, torch.zeros((L, T), dtype=f32, device=usage.device)])
    z, _ = al_minimize(objective, project, z0, hyper=hyper, eq_residual=eq,
                       ineq_residual=ineq, step_scale=step, cfg=cfg)
    with torch.no_grad():
        return z[:W], z[W:], fleet_penalties(p, z[:W], use_kernel)


def _coupled_migrate(p: FleetProblem, policy, res: FleetSolveResult,
                     ctx: SolveContext) -> FleetSolveResult:
    """In-loop coupled migration (`SolveContext.coupled_migration`):
    refine (D, flows) jointly from the base solve's plan, repair the flows
    exactly, and keep the refined plan only when it preserves total
    curtailment (1e-3 relative) and beats the post-stage on fleet-wide
    carbon; otherwise the post-stage result is returned."""
    from repro_torch.core.migration import (MigrationPlan, _repair,
                                            positive_links,
                                            region_aggregates)
    if (p.topology is None or not p.is_multiregion
            or type(policy) not in (CR1, CR2)):
        return _maybe_migrate(p, res, ctx)
    fr, to, bw, cost = positive_links(p.topology)
    if fr.size == 0:
        return _maybe_migrate(p, res, ctx)
    post = _maybe_migrate(p, res, ctx)
    device = resolve_device(ctx.device)
    use_kernel = resolve_use_kernel(ctx.use_kernel, device)
    steps = ctx.resolved_steps(policy)
    R, T = p.R, p.T
    mci = np.asarray(p.mci, float)
    ceiling = p.topology.ceiling
    ceil = (np.zeros((R, T)) if ceiling is None else np.broadcast_to(
        np.asarray(ceiling, float).reshape(R, -1), (R, T)))
    if type(policy) is CR1:
        hyper, refs, mode, outer = policy.lam, None, "cr1", 4
    else:
        refs = torch.as_tensor(cr2_reference_fleet(p, policy.cap_frac,
                                                   device), device=device)
        hyper, mode, outer = None, "cr2", max(4, policy.outer)

    def t(a, dtype=f32):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    D0 = np.asarray(res.D, float)
    D_f, y_l, pens = _coupled_impl(
        device_view(p, device), t(D0), hyper, refs, t(fr, torch.int64),
        t(to, torch.int64), t(bw), t(cost), t(ceil), mode=mode, steps=steps,
        outer=outer, use_kernel=use_kernel, has_ceiling=ceiling is not None)
    D_f = D_f.cpu().numpy().astype(float)
    tot0 = float(D0.sum())
    if abs(float(D_f.sum()) - tot0) > 1e-3 * max(abs(tot0), 1.0):
        return post
    # The exact repair against the refined plan's aggregates, the
    # projection the post-stage validates with.
    cost_f = np.asarray(p.topology.cost, float)
    bw_f = np.asarray(p.topology.bandwidth, float).copy()
    np.fill_diagonal(bw_f, 0.0)
    cap = np.broadcast_to(bw_f[:, :, None], (R, R, T))
    grad = mci[:, None, :] - mci[None, :, :]
    movable, headroom = region_aggregates(p, D_f)
    y = np.zeros((R, R, T))
    y[fr, to] = y_l.cpu().numpy().astype(float)
    y = _repair(y, grad - cost_f[:, :, None], cap, movable, headroom)
    plan = MigrationPlan(
        y=y, carbon_saved=float((y * grad).sum()),
        migration_cost=float((y * cost_f[:, :, None]).sum()),
        moved_total=float(y.sum()))
    cand = _report(p, D_f, pens.cpu().numpy(),
                   iters=res.iters + steps * outer, state=res.state,
                   extras=dict(res.extras))
    cand = _credit(p, cand, plan, coupled_migration=True)
    if cand.carbon_reduction_pct <= post.carbon_reduction_pct:
        return post
    return cand


# ---------------------------------------------------------------------------
# A whole rolling-horizon day: one CUDA-graph replay on the card
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class DayResult:
    """Result of `solve_day`.

    committed: (n_ticks, W), hour 0 of every tick's plan (the hours the
      controller commits).
    last: the final tick's full `FleetSolveResult`; its `.state` warm-starts
      the next day (`ctx.warm`).
    inner_steps: engine iterations per tick (the cold budget first unless
      the day itself was warm-started)."""
    committed: np.ndarray
    last: FleetSolveResult
    inner_steps: tuple[int, ...]


@dataclasses.dataclass(frozen=True)
class _Day:
    """A day's static configuration: what its tick loop's code depends on
    beyond the tensors it is given. One CUDA graph each."""
    policy: str
    outer: int
    W: int
    T: int
    R: int
    # Rows per region of a multi-region fleet (() single-region): the
    # captured sums gather index tensors of these lengths.
    region_counts: tuple[int, ...]
    n_ticks: int
    first_steps: int
    warm_steps: int
    first_shift: int
    first_reset: bool
    warm: bool
    moment_dtype: str
    day_hours: int
    max_curtail_frac: float
    has_upper: bool
    use_kernel: bool
    device: str
    # A sanitized day has its own graph: its function also returns the
    # sanitizer's flag. Telemetry days run eagerly (no kernels).
    sanitize: bool = False
    telemetry_every: int = 0
    # Over a fleet mesh: this process's block of the padded rows
    # (start, stop) and the padded W; () and 0 without one. A sharded
    # day is a graph of its own.
    rows: tuple[int, ...] = ()
    W_pad: int = 0

    @property
    def block(self) -> slice:
        return slice(*self.rows)


_FLEET_BUFFERS = ("usage", "entitlement", "k", "rts_coeffs", "betas",
                  "x2_kind", "jobs", "is_batch", "upper", "region")


def _day_setup(problem: FleetProblem, policy, mci_stack,
               ctx: SolveContext, cold_steps: int | None,
               warm_steps: int | None):
    """Validate a day and lay it out: returns (problem, mci_stack, day,
    inputs) with the problem (R = 1 canonicalized), the float32
    (n_ticks, T) or (n_ticks, R, T) stack, the static `_Day` and the
    day's tensors on its device (the fleet's fields with a multi-region
    fleet's region ids and region-sorted rows, the stack, CR1's lam or
    CR2's float64 cap plan in float32, and a warm state, cloned). Over a
    fleet mesh (checked here) the inputs also hold this process's block
    of the padded fleet ("blk_" fields) and the warm state is padded and
    cut to the block."""
    if ctx.sanitize:
        _require_sanitizable(policy, ctx)
    if not isinstance(problem, FleetProblem):
        raise TypeError(f"solve_day() takes a FleetProblem; got "
                        f"{type(problem).__name__}")
    problem = single_region_view(problem)
    stack = np.asarray(mci_stack, np.float32)
    if (not problem.is_multiregion and stack.ndim == 3
            and stack.shape[1] == 1):
        stack = stack[:, 0]          # degenerate R = 1 stack, canonicalized
    want = np.asarray(problem.mci).shape
    if stack.ndim != len(want) + 1 or stack.shape[1:] != want:
        raise ValueError(f"mci_stack must be (n_ticks,) + {want} (one "
                         f"forecast per tick); got shape {stack.shape}")
    if stack.shape[0] < 1:
        raise ValueError("mci_stack holds no tick")
    if not isinstance(policy, (CR1, CR2)):
        raise NotImplementedError(
            f"solve_day supports CR1/CR2 (pure scannable engine "
            f"backends); {policy.name} needs host-side control flow — "
            f"use the per-tick solve()/step() loop")
    device = resolve_device(ctx.device)
    use_kernel = resolve_use_kernel(ctx.use_kernel, device)
    _require_telemetry_ok(ctx, use_kernel)
    mesh = _fleet_mesh(ctx, device)
    if mesh is not None and ctx.telemetry is not None:
        raise NotImplementedError(
            "SolveContext(telemetry=...) on solve_day is a solo-lane "
            "feature: the sharded day has no telemetry plumbing; drop the "
            "mesh (or the telemetry) for this day")
    if cold_steps is None:
        cold_steps = ctx.resolved_steps(policy)
    if warm_steps is None:
        warm_steps = max(1, cold_steps // 4)
    warm = ctx.warm is not None
    view = device_view(problem, device)
    index = view.region_index
    sh = None if mesh is None else _shard(problem, mesh, device)
    shard_kw = {} if sh is None else dict(
        rows=(sh.rows.start, sh.rows.stop), W_pad=sh.W_pad)
    day = _Day(policy=policy.name,
               outer=policy.outer if isinstance(policy, CR2) else 1,
               W=problem.W, T=problem.T, R=problem.R,
               region_counts=() if index is None else index.counts,
               n_ticks=stack.shape[0],
               first_steps=warm_steps if warm else cold_steps,
               warm_steps=warm_steps,
               first_shift=(ctx.shift or 1) if warm else 0, first_reset=warm,
               warm=warm, moment_dtype=ctx.moment_dtype,
               day_hours=problem.day_hours,
               max_curtail_frac=float(problem.max_curtail_frac),
               has_upper=problem.upper is not None, use_kernel=use_kernel,
               device=str(device), sanitize=ctx.sanitize,
               telemetry_every=_tel_every(ctx), **shard_kw)
    inputs = {n: getattr(view, n) for n in _FLEET_BUFFERS
              if getattr(view, n) is not None}
    if sh is not None:
        inputs.update({"blk_" + n: getattr(sh.view, n)
                       for n in _FLEET_BUFFERS
                       if getattr(sh.view, n) is not None})
    if index is not None:
        inputs["region_order"] = index.order
    inputs["mci"] = torch.as_tensor(stack, device=device)
    if isinstance(policy, CR1):
        inputs["lam"] = torch.full((), policy.lam, dtype=f32, device=device)
    else:
        inputs["cap_plan"] = torch.as_tensor(
            cr2_cap_plan(problem, policy.cap_frac), dtype=f32, device=device)
    if warm:
        W_st, st = day.W, ctx.warm
        if sh is not None:
            # The padded state of a sharded result, or a state padded here.
            W_st = sh.W_pad
            if st.x.dim() == 2 and st.x.shape[0] == day.W:
                st = _pad_state(st, W_st)
        shapes = {"x": (W_st, day.T), "lam_in": (0,), "mu": (),
                  "lam_eq": (W_st,) if isinstance(policy, CR2) else (0,)}
        for name, shape in shapes.items():
            t = getattr(st, name)
            if tuple(t.shape) != shape:
                raise ValueError(f"ctx.warm.{name} has shape "
                                 f"{tuple(t.shape)}; a {policy.name} day at "
                                 f"W = {W_st}, T = {day.T} takes {shape}")
            if sh is not None and t.dim() and t.shape[0] == W_st:
                t = t[sh.rows]
            inputs[name] = t.detach().to(device, f32).clone()
    return problem, stack, day, inputs


def _day_impl(day: _Day, inputs: dict[str, Tensor]):
    """The day's tick loop, plain code on the tensors of `inputs`: tick 0
    with its own budget, shift and mu reset, then for every later tick
    roll usage, jobs, `upper` (and CR2's cap plan) an hour, install the
    tick's forecast ((T,), or (R, T) over regions), shift the plan
    (`EngineState.shifted`), reset mu and re-solve warm. A multi-region
    tick recomputes its per-region norms from the rolled window, its
    per-row carbon rows and step scales among them, on the device. The
    same on the CPU and on the card, where `solve_day` captures it.
    Returns (committed (n_ticks, W), D, penalties, x, lam_eq, lam_in, mu)
    of the last tick; then, for a sanitized day, the sanitizer's flag
    (zeroed here, so every replay starts clean), and with telemetry the
    list of each tick's telemetry dict.

    A sharded day (`day.rows`) rolls the whole fleet's window beside its
    block's and normalizes each tick on the whole fleet (its norms and
    CR2's targets by the same functions as the unsharded day, cut to the
    block), but solves the block only: its outputs are the block's rows
    (committed (n_ticks, rows)), and nothing here is collective."""
    index = (RegionIndex(inputs["region_order"], day.region_counts)
             if day.region_counts else None)

    def fleet(prefix, region_index=None):
        return FleetProblem(
            **{n: inputs.get(prefix + n) for n in _FLEET_BUFFERS},
            mci=inputs["mci"][0], day_hours=day.day_hours,
            max_curtail_frac=day.max_curtail_frac, region_index=region_index)

    p = fleet("", index)
    blk = fleet("blk_") if day.rows else None
    n = day.W if blk is None else blk.W
    if day.warm:
        state = EngineState(x=inputs["x"], lam_eq=inputs["lam_eq"],
                            lam_in=inputs["lam_in"], mu=inputs["mu"])
    else:
        x0 = torch.zeros((n, day.T), dtype=f32, device=p.usage.device)
        state = (EngineState.cold(x0) if day.policy == "cr1" else
                 EngineState.cold(x0, n_eq=n, mu0=CR2_MU0))
    san = Sanitizer(p.usage.device) if day.sanitize else None
    tels = []

    def tick_solve(p_t, b_t, cap, st, steps, shift, reset_mu):
        if day.policy == "cr1":
            if b_t is None:
                kw = {}
            else:
                p_t, kw = b_t, dict(norms=block_norms(
                    cr1_norms(p_t), day.W_pad, day.block, CR1_NORM_FILLS))
            out = _cr1_impl(p_t, inputs["lam"], st, steps, day.use_kernel,
                            shift, reset_mu, day.moment_dtype, san,
                            day.telemetry_every, **kw)
        else:
            refs, kw = cr2_reference_tensor(p_t, cap), {}
            if b_t is not None:
                kw = dict(norms=block_norms(cr2_norms(p_t, refs), day.W_pad,
                                            day.block, CR2_NORM_FILLS))
                pad = torch.zeros(day.W_pad - day.W, dtype=refs.dtype,
                                  device=refs.device)
                p_t, refs = b_t, torch.cat([refs, pad])[day.block]
            out = _cr2_impl(p_t, refs, st, steps, day.outer, day.use_kernel,
                            shift, reset_mu, day.moment_dtype, san,
                            day.telemetry_every, **kw)
        tels.extend(out[3:])
        return out[:3]

    def roll(a):
        return None if a is None else torch.roll(a, -1, dims=1)

    def slide(q, tick):
        if q is None:
            return None
        return dataclasses.replace(q, usage=roll(q.usage), jobs=roll(q.jobs),
                                   upper=roll(q.upper),
                                   mci=inputs["mci"][tick])

    cap = inputs.get("cap_plan")
    D, pens, state = tick_solve(p, blk, cap, state, day.first_steps,
                                day.first_shift, day.first_reset)
    committed = [D[:, 0]]
    for tick in range(1, day.n_ticks):
        p, blk = slide(p, tick), slide(blk, tick)
        cap = roll(cap)
        D, pens, state = tick_solve(p, blk, cap, state, day.warm_steps, 1,
                                    True)
        committed.append(D[:, 0])
    out = (torch.stack(committed), D, pens, state.x, state.lam_eq,
           state.lam_in, state.mu)
    if san is not None:
        out += (san.code,)
    return out + (tels,) if day.telemetry_every else out


def solve_day(problem: FleetProblem, policy, mci_stack, *,
              ctx: SolveContext | None = None, cold_steps: int | None = None,
              warm_steps: int | None = None) -> DayResult:
    """Solve a whole rolling-horizon day.

    `mci_stack` is the (n_ticks, T) forecast-revision stack: row i is the
    forecast the controller sees at tick i; a multi-region fleet's is
    (n_ticks, R, T), one (R, T) forecast per tick, each tick's
    per-region norms recomputed from its window. As in the JAX package,
    no migration stage runs on a tick (only hour 0 commits). Tick 0
    solves with `cold_steps` (the policy's default when None) from
    `ctx.warm` or a cold state; every later tick rolls the window an
    hour, shifts the plan, resets mu and re-solves with `warm_steps`
    (default `cold_steps // 4`). A warm-started day runs every tick at
    `warm_steps`, its first shifted `ctx.shift or 1` hours.

    `ctx.sanitize` runs every tick with the engine's non-finite checks
    and reads their flag once after the day (after the replay on the
    card: a sanitized day is a graph of its own, and its flag restarts
    at 0 on every replay), raising `SanitizeError` for a NaN in any
    tick. `ctx.telemetry` (generic engine only) puts one
    `ConvergenceTrace` per tick in `result.last.extras["telemetry"]`.

    On CUDA with the kernels (`use_kernel`, on by default there) the day
    is one CUDA-graph replay (`core/daygraph.py`): captured on the first
    day of each static configuration (policy and `outer`, W, T, R and
    the rows per region, n_ticks, the step budgets, the first tick's
    shift and reset, `moment_dtype`,
    `day_hours`, `max_curtail_frac`, whether `upper` is given), replayed
    after that with the day's data (fleet, forecasts, warm state, lam or
    the cap plan) copied into its buffers. A failed capture raises.
    Elsewhere, and with `use_kernel=False`, the tick loop runs eagerly.
    CR1/CR2 only. Returns `DayResult`; `result.last.state` warm-starts
    the next day.

    Over a fleet mesh (`ctx.mesh`) every process runs the whole day on
    its own row block (its graph keyed on the block as well), each tick
    normalized on the whole fleet's window, and the committed hours, the
    last plan, its penalties and the state are all-gathered once after
    the day: every process returns the same result, the state padded
    (as a sharded `solve`'s, so that the next day chains). `sanitize`
    and `telemetry` are refused there, as in the JAX package.
    """
    ctx = ctx or SolveContext()
    policy = resolve_policy(policy)
    problem, stack, day, inputs = _day_setup(problem, policy, mci_stack, ctx,
                                             cold_steps, warm_steps)
    graph = day.device.startswith("cuda") and day.use_kernel
    if graph:
        out = DAY_GRAPHS.run(day, functools.partial(_day_impl, day), inputs)
    else:
        with torch.no_grad():
            out = _day_impl(day, inputs)
    if day.sanitize:
        throw_code(out[7])
    if day.rows:
        # The blocks gathered outside the day (fresh tensors, so nothing
        # aliases the graph): committed along its rows, the rest by row.
        mesh = ctx.mesh
        committed, *rest = out[:7]
        n = committed.shape[1]
        out = (gather_rows(mesh, committed, 1),) + tuple(
            gather_rows(mesh, t) if t.dim() and t.shape[0] == n else t
            for t in rest)
        out = (out[0][:, :day.W], out[1][:day.W], out[2][:day.W]) + out[3:]
    elif graph and not ctx.donate:
        out = out[:3] + tuple(t.clone() for t in out[3:7]) + out[7:]
    committed, D, pens = (t.cpu().numpy() for t in out[:3])
    state = EngineState(*out[3:7])
    mult = day.outer if isinstance(policy, CR2) else 1
    n = day.n_ticks
    iters = (day.first_steps * mult,) + (day.warm_steps * mult,) * (n - 1)

    def rolled(a):
        return None if a is None else np.roll(np.asarray(a), -(n - 1), axis=1)

    p_last = dataclasses.replace(problem, mci=stack[-1],
                                 usage=rolled(problem.usage),
                                 jobs=rolled(problem.jobs),
                                 upper=rolled(problem.upper))
    extras = ({"telemetry": tuple(ConvergenceTrace.from_aux(t)
                                  for t in out[-1])}
              if day.telemetry_every else None)
    last = _report(p_last, D, pens, iters=iters[-1], state=state,
                   extras=extras)
    return DayResult(committed=committed, last=last, inner_steps=iters)
