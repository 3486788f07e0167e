"""DR optimization solvers over a `PolicySpec`.

Two interchangeable backends:

  * `solve_slsqp`: scipy's Sequential Least Squares Programming, the
    paper's solver (§VI-A), with exact gradients. SLSQP runs on the host;
    the objective, its gradient and every constraint's value and Jacobian
    are computed by torch in float64 on the chosen device (the CUDA
    device unless `device="cpu"`), one copy to and one from the device
    per call. This is the paper-faithful validation reference for small
    instances (4 workloads × 48 hours).

  * `solve_adam`: the fleet engine (`core/engine.py`, `al_minimize`)
    on the spec, float32 projected Adam on an augmented Lagrangian, with
    3 alternations of the box clip and the day-mean preservation
    projection after every step.

Both report with `evaluate`, which scores the plan with the unsmoothed
models in float32 (as the JAX package reports), so numbers compare
across solvers. `FleetProblem.from_problem` / `to_problem` convert to and
from the fleet representation, so every fleet policy can be held
against this reference.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from repro_torch.core.engine import EngineConfig, al_minimize
from repro_torch.core.policies import DRProblem, PolicySpec
from repro_torch.kernels.dispatch import resolve_device

Tensor = torch.Tensor
f64 = torch.float64


@dataclasses.dataclass(frozen=True)
class SolveResult:
    """Outcome of one policy solve, reported with unsmoothed models."""

    name: str
    solver: str
    D: np.ndarray                    # (W, T)
    objective: float
    carbon_reduction: float          # kg CO2 eliminated (Σ⟨mci, d_i⟩)
    carbon_reduction_pct: float      # % of baseline operational carbon
    total_penalty: float             # NP capacity-equivalent
    total_penalty_pct: float         # % of Σ entitlements
    per_penalty: np.ndarray          # (W,)
    per_carbon: np.ndarray           # (W,)
    peak: float
    violations: dict[str, float]
    nit: int


def _np(t: Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def evaluate(spec: PolicySpec, D: np.ndarray, solver: str, nit: int,
             objective: float | None = None,
             device: str | torch.device | None = None) -> SolveResult:
    """Final reporting with smooth=0 (the true, kinked models), in
    float32 on `device` (None = the CUDA device)."""
    p = spec.problem
    device = resolve_device(device)
    Dt = torch.as_tensor(np.asarray(D), dtype=torch.float32, device=device)
    with torch.no_grad():
        per_pen = _np(p.penalties(Dt, smooth=0.0))
        per_car = _np(p.carbon_reduction_per_workload(Dt))
        peak = float(p.peak(Dt))
        lower, upper = p.bounds()
        if spec.lower is not None:
            lower = spec.lower
        if spec.upper is not None:
            upper = spec.upper
        viol = {
            "capacity": max(0.0, peak - p.capacity_limit),
            "box": float(np.maximum(np.maximum(D - upper, lower - D),
                                    0.0).max()),
        }
        if spec.use_preservation and p.preservation != "none":
            res = _np(p.preservation_residual(Dt))
            if not res.size:
                viol["preservation"] = 0.0
            elif p.preservation == "equality":
                viol["preservation"] = float(np.abs(res).max())
            else:
                viol["preservation"] = float(np.maximum(-res, 0.0).max())
        for j, g in enumerate(spec.ineq_constraints):
            viol[f"ineq{j}"] = max(0.0, -float(_np(g(Dt)).min()))
        for j, h in enumerate(spec.eq_constraints):
            viol[f"eq{j}"] = float(np.abs(_np(h(Dt))).max())
        if objective is None:
            objective = float(spec.objective(Dt))
    total_pen = float(per_pen.sum())
    car = float(per_car.sum())
    return SolveResult(
        name=spec.name, solver=solver, D=np.asarray(D),
        objective=float(objective), carbon_reduction=car,
        carbon_reduction_pct=100.0 * car / p.total_carbon_baseline,
        total_penalty=total_pen,
        total_penalty_pct=100.0 * total_pen / float(p.entitlements.sum()),
        per_penalty=per_pen, per_carbon=per_car, peak=peak,
        violations=viol, nit=nit)


def _spec_bounds(spec: PolicySpec) -> tuple[np.ndarray, np.ndarray]:
    p = spec.problem
    lower, upper = p.bounds()
    if spec.lower is not None:
        lower = spec.lower
    if spec.upper is not None:
        upper = spec.upper
    free = np.ones(p.W, bool) if spec.free is None else spec.free
    lower = np.where(free[:, None], lower, 0.0)
    upper = np.where(free[:, None], upper, 0.0)
    return lower, upper


# ---------------------------------------------------------------------------
# scipy SLSQP (paper-faithful), float64 on the device
# ---------------------------------------------------------------------------
def slsqp_functions(spec: PolicySpec, device: torch.device):
    """The functions `solve_slsqp` hands scipy, on flat float64 numpy
    iterates: `fun(x) -> (value, gradient)` and the constraint dicts
    (`fun` and `jac`, the Jacobian by `torch.func.jacrev`), each computed
    by torch in float64 on `device`."""
    p = spec.problem
    W, T = p.W, p.T

    def on_device(x: np.ndarray) -> Tensor:
        return torch.as_tensor(np.asarray(x, np.float64), device=device)

    def make_con(fn: Callable[[Tensor], Tensor], kind: str) -> dict:
        def flat(x: Tensor) -> Tensor:
            return torch.atleast_1d(fn(x.reshape(W, T))).reshape(-1)

        jac = torch.func.jacrev(flat)
        return {"type": kind,
                "fun": lambda x: _np(flat(on_device(x))),
                "jac": lambda x: _np(jac(on_device(x)))}

    cons = []
    if spec.use_preservation and p.preservation != "none":
        kind = "eq" if p.preservation == "equality" else "ineq"
        cons.append(make_con(p.preservation_residual, kind))
    for g in spec.ineq_constraints:
        cons.append(make_con(g, "ineq"))
    for h in spec.eq_constraints:
        cons.append(make_con(h, "eq"))

    def fun(x: np.ndarray) -> tuple[float, np.ndarray]:
        xt = on_device(x).requires_grad_(True)
        v = spec.objective(xt.reshape(W, T))
        (g,) = torch.autograd.grad(v, xt)
        out = _np(torch.cat([v.detach().reshape(1), g]))
        return float(out[0]), out[1:]

    return fun, cons


def solve_slsqp(spec: PolicySpec, x0: np.ndarray | None = None,
                maxiter: int = 300, ftol: float = 1e-8,
                device: str | torch.device | None = None,
                callback: Callable[[np.ndarray], None] | None = None,
                ) -> SolveResult:
    """Solve `spec` with scipy's SLSQP on the host, its functions and
    exact derivatives in float64 torch on `device` (None = the CUDA
    device; "cpu" for the plain path; `slsqp_functions`). `callback(xk)`
    is scipy's, called with the flat iterate after every iteration.
    Reports with `evaluate`."""
    import scipy.optimize as sopt

    device = resolve_device(device)
    p = spec.problem
    W, T = p.W, p.T
    lower, upper = _spec_bounds(spec)
    fun, cons = slsqp_functions(spec, device)
    x_init = (np.zeros(W * T) if x0 is None
              else np.asarray(x0, np.float64).ravel())
    bounds = list(zip(lower.ravel(), upper.ravel()))
    res = sopt.minimize(fun, x_init, jac=True, method="SLSQP",
                        bounds=bounds, constraints=cons, callback=callback,
                        options={"maxiter": maxiter, "ftol": ftol})
    return evaluate(spec, res.x.reshape(W, T), solver="slsqp",
                    nit=int(res.nit), device=device)


# ---------------------------------------------------------------------------
# Augmented-Lagrangian projected Adam (the fleet engine on a spec)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class AdamALConfig:
    inner_steps: int = 400
    outer_steps: int = 8
    lr: float = 0.05
    mu0: float = 10.0          # initial quadratic weight
    mu_growth: float = 2.0
    seed: int = 0


def solve_adam(spec: PolicySpec, cfg: AdamALConfig = AdamALConfig(),
               x0: np.ndarray | None = None,
               device: str | torch.device | None = None) -> SolveResult:
    """Solve `spec` with the engine's projected Adam in float32 on
    `device` (None = the CUDA device)."""
    device = resolve_device(device)
    p = spec.problem
    W, T = p.W, p.T
    lower, upper = _spec_bounds(spec)
    lo = torch.as_tensor(lower, dtype=torch.float32, device=device)
    hi = torch.as_tensor(upper, dtype=torch.float32, device=device)
    # Scale step sizes to the problem's magnitude.
    scale = float(np.maximum(upper - lower, 1e-6).mean())

    eqs = list(spec.eq_constraints)
    preservation_eq = spec.use_preservation and p.preservation == "equality"
    ineqs = list(spec.ineq_constraints)
    if spec.use_preservation and p.preservation == "inequality":
        ineqs.append(p.preservation_residual)

    def project(D: Tensor) -> Tensor:
        D = torch.clamp(D, lo, hi)
        if preservation_eq:
            # Alternate the two projections; both are cheap and the pair
            # converges fast (the residuals are reported in the result).
            for _ in range(3):
                D = torch.clamp(p.project_preservation(D), lo, hi)
        return D

    def stacked(fns):
        if not fns:
            return None
        return lambda D, _: torch.cat([torch.atleast_1d(f(D)).reshape(-1)
                                       for f in fns])

    D0 = (torch.zeros((W, T), dtype=torch.float32, device=device)
          if x0 is None else torch.as_tensor(x0, dtype=torch.float32,
                                             device=device))
    D, _ = al_minimize(lambda D, _: spec.objective(D), project, D0,
                       eq_residual=stacked(eqs),
                       ineq_residual=stacked(ineqs), step_scale=scale,
                       cfg=EngineConfig(inner_steps=cfg.inner_steps,
                                        outer_steps=cfg.outer_steps,
                                        lr=cfg.lr, mu0=cfg.mu0,
                                        mu_growth=cfg.mu_growth))
    return evaluate(spec, _np(D).astype(np.float64), solver="adam-al",
                    nit=cfg.inner_steps * cfg.outer_steps, device=device)


# ---------------------------------------------------------------------------
# CR3 driver: decentralized solves + fiscal-balance clearing (Eqs. 5-8)
# ---------------------------------------------------------------------------
def solve_cr3(p: DRProblem, rho: float, tax_frac: float = 0.2,
              solver: str = "slsqp", clearing_iters: int = 8,
              device: str | torch.device | None = None,
              ) -> tuple[SolveResult, float]:
    """Each workload solves its own problem at carbon price ρ; the
    coordinator lowers ρ until taxes cover rebates (Eq. 6). Returns the
    fleet result assembled from the decentralized solutions and the
    market-clearing ρ."""
    from repro_torch.core.policies import cr3_fiscal_balance, cr3_workload_spec

    def solve_all(rho_: float) -> np.ndarray:
        D = np.zeros((p.W, p.T))
        for i in range(p.W):
            s = cr3_workload_spec(p, i, rho_, tax_frac)
            r = (solve_slsqp(s, device=device) if solver == "slsqp"
                 else solve_adam(s, device=device))
            D[i] = r.D[i]
        return D

    rho_cur = rho
    D = solve_all(rho_cur)
    for _ in range(clearing_iters):
        paid, collected = cr3_fiscal_balance(p, D, rho_cur, tax_frac)
        if paid <= collected + 1e-9:
            break
        rho_cur *= max(0.5, 0.9 * collected / max(paid, 1e-9))
        D = solve_all(rho_cur)

    # Report as a fleet outcome.
    spec = PolicySpec(name=f"CR3(ρ={rho:g})", problem=p,
                      objective=lambda D_: p.total_penalty(D_))
    return evaluate(spec, D, solver=solver, nit=clearing_iters,
                    device=device), rho_cur
