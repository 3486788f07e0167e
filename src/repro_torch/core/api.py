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

Two departures from the JAX package, both so that the checks the port
is held to hold at fleet scale (W = 10,000): the projection after every
step is the exact Euclidean one onto the box and the batch rows' day
preservation, where the JAX package takes 3 rounds of day-mean removal,
and the fused kernel takes autodiff's one half at hinge ties, as the
generic engine does (see `kernels/al_step/ref.py`).

Ported so far: CR1 and CR2 on single-region fleets. Meshes, donation,
sweeps, ensembles, CR3, the baselines and migration are not.
"""
from __future__ import annotations

import dataclasses
from typing import ClassVar, Protocol, runtime_checkable

import torch

from repro_torch.core.engine import EngineConfig, EngineState, al_minimize
from repro_torch.core.fleet_solver import (CR1_MU0, CR2_MU0, FleetProblem,
                                           FleetSolveResult, _bounds,
                                           _enter_tick, _projection, _report,
                                           cr2_reference_fleet, device_view,
                                           fleet_penalties,
                                           single_region_view)
from repro_torch.core.regional import cr1_norms, cr2_norms
from repro_torch.kernels.dispatch import resolve_device, resolve_use_kernel

Tensor = torch.Tensor
f32 = torch.float32

__all__ = ["CR1", "CR2", "DRPolicy", "POLICY_REGISTRY", "SolveContext",
           "resolve_policy", "solve"]


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
    """
    device: str | torch.device | None = None
    shift: int = 0
    reset_mu: bool = False
    warm: EngineState | None = None
    use_kernel: bool | None = None
    steps: int | None = None
    moment_dtype: str = "float32"

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
    """Coerce a registry name, policy class, or policy object to an object."""
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


def solve(problem: FleetProblem, policy, *,
          ctx: SolveContext | None = None) -> FleetSolveResult:
    """Solve `problem` under `policy`, the single fleet entry point."""
    if not isinstance(problem, FleetProblem):
        raise TypeError(f"solve() takes a FleetProblem; got "
                        f"{type(problem).__name__}")
    problem = single_region_view(problem)
    return resolve_policy(policy).solve(problem, ctx or SolveContext())


def _cold_x(p: FleetProblem, device: torch.device) -> Tensor:
    return torch.zeros(p.usage.shape, dtype=f32, device=device)


# ---------------------------------------------------------------------------
# Fused AL inner loop (al_step kernel): the CR1/CR2 hot path
# ---------------------------------------------------------------------------
def _al_fused_inner(p: FleetProblem, mode: str, cfg: EngineConfig, *,
                    car_norm, step_scale, coef0=0.0, scale=None,
                    refs=None):
    """Pack this fleet's penalty parameters into the `al_step` layout and
    return the chunked dispatcher (`kernels.al_step.ops.make_fused_inner`)
    as the engine's `fused_inner` hook. `p` is a device view."""
    from repro_torch.kernels.al_step.ops import make_fused_inner, pack_rows
    lo, hi = _bounds(p)
    cvec = (-car_norm * p.mci)[None, :]
    row_base = pack_rows(p.rts_coeffs, p.betas, p.k, p.x2_kind, p.is_batch,
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

    def objective(D: Tensor, lam) -> Tensor:
        return (lam * pen_norm * fleet_penalties(p, D, use_kernel).sum()
                - car_norm * (D @ p.mci).sum())

    return objective, _projection(p, lo, hi), step_scale


def _cr1_cfg(steps: int, moment_dtype: str = "float32") -> EngineConfig:
    return EngineConfig(inner_steps=steps, outer_steps=1,
                        moment_dtype=moment_dtype)


def _cr1_impl(p: FleetProblem, lam: float, state0: EngineState,
              ctx: SolveContext, steps: int, use_kernel: bool):
    """One CR1 solve on the device view `p` -> (D, penalties, state)."""
    state0 = _enter_tick(state0, ctx.shift, ctx.reset_mu, CR1_MU0)
    norms = cr1_norms(p)
    objective, project, step_scale = _cr1_pieces(p, use_kernel, norms)
    cfg = _cr1_cfg(steps, ctx.moment_dtype)
    fused = _al_fused_inner(p, "cr1", cfg, car_norm=norms[1],
                            step_scale=step_scale,
                            coef0=lam * norms[0]) if use_kernel else None
    D, aux = al_minimize(objective, project, state0.x, hyper=lam,
                         step_scale=step_scale, init=state0, cfg=cfg,
                         fused_inner=fused)
    with torch.no_grad():
        return D, fleet_penalties(p, D, use_kernel), aux["state"]


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
        steps = ctx.resolved_steps(self)
        warm = ctx.warm or EngineState.cold(_cold_x(p, device))
        D, pens, state = _cr1_impl(device_view(p, device), self.lam, warm,
                                   ctx, steps, use_kernel)
        return _report(p, D.cpu().numpy(), pens.cpu().numpy(), iters=steps,
                       state=state)


# ---------------------------------------------------------------------------
# CR2: Fair-Centralized DR (per-workload penalty-equality targets)
# ---------------------------------------------------------------------------
def _cr2_pieces(p: FleetProblem, refs: Tensor, use_kernel: bool, norms):
    lo, hi = _bounds(p)
    car_norm, scale, step_scale = norms

    def objective(D: Tensor, _) -> Tensor:
        return -car_norm * (D @ p.mci).sum()

    def eq(D: Tensor, _) -> Tensor:
        return (fleet_penalties(p, D, use_kernel) - refs) / scale

    return objective, eq, _projection(p, lo, hi), step_scale


def _cr2_cfg(steps: int, outer: int,
             moment_dtype: str = "float32") -> EngineConfig:
    return EngineConfig(inner_steps=steps, outer_steps=outer, mu0=CR2_MU0,
                        mu_growth=2.0, moment_dtype=moment_dtype)


def _cr2_impl(p: FleetProblem, refs: Tensor, state0: EngineState,
              ctx: SolveContext, steps: int, outer: int, use_kernel: bool):
    """One CR2 solve on the device view `p` -> (D, penalties, state)."""
    state0 = _enter_tick(state0, ctx.shift, ctx.reset_mu, CR2_MU0)
    norms = cr2_norms(p, refs)
    objective, eq, project, step_scale = _cr2_pieces(p, refs, use_kernel,
                                                     norms)
    cfg = _cr2_cfg(steps, outer, ctx.moment_dtype)
    fused = _al_fused_inner(p, "cr2", cfg, car_norm=norms[0],
                            step_scale=step_scale, scale=norms[1],
                            refs=refs) if use_kernel else None
    D, aux = al_minimize(objective, project, state0.x, eq_residual=eq,
                         step_scale=step_scale, init=state0, cfg=cfg,
                         fused_inner=fused)
    with torch.no_grad():
        return D, fleet_penalties(p, D, use_kernel), aux["state"]


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
        steps = ctx.resolved_steps(self)
        # The fairness targets use the kernel wherever the device has it,
        # whatever `use_kernel` says, as the JAX package's auto dispatch.
        refs = torch.as_tensor(cr2_reference_fleet(p, self.cap_frac, device),
                               device=device)
        warm = ctx.warm or EngineState.cold(_cold_x(p, device), n_eq=p.W,
                                            mu0=CR2_MU0)
        D, pens, state = _cr2_impl(device_view(p, device), refs, warm, ctx,
                                   steps, self.outer, use_kernel)
        return _report(p, D.cpu().numpy(), pens.cpu().numpy(),
                       iters=steps * self.outer, state=state)
