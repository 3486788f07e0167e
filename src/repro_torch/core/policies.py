"""Datacenter DR policies (paper §V): CR1/CR2/CR3 + shared constraints.

A policy takes a `DRProblem` (workload penalty models + carbon signal +
datacenter constraints) and produces an hourly adjustment matrix
D = [d_1 … d_W] (W, T), positive = curtail. Policies differ in objective
and fairness treatment; all share (§V-C):

  * total capacity:  max_t Σ_i (U_it − d_it) ≤ buffer · Σ_i E_i   (Eq. 10)
  * batch preservation: Σ_{t∈day} d_it = 0 for batch workloads (deferred
    work completes within the day, §III-B; the equality is the default,
    the inequality of Eq. 11 an option);
  * curtailment ≤ half the entitlement (§VI-A, idle-power floor), and
    boosts bounded by the entitlement: U−d ≤ E.

This is the per-workload form the SLSQP reference (`core/solver.py`)
solves; `FleetProblem.from_problem` / `to_problem` convert to and from
the fleet form. Model fields are numpy; every term takes a tensor D and
computes in D's dtype on D's device (float64 under SLSQP, float32
elsewhere). `project_preservation` removes the day mean, as the JAX
package does, not the exact box-and-day projection of the fleet engine.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable

import numpy as np
import torch

from repro_torch.core.penalty import PenaltyModel
from repro_torch.kernels.dispatch import resolve_device

Tensor = torch.Tensor


def _like(a, D: Tensor) -> Tensor:
    """A problem constant in D's dtype, on D's device."""
    return torch.as_tensor(np.asarray(a), dtype=D.dtype, device=D.device)


@dataclasses.dataclass(frozen=True)
class DRProblem:
    """A demand-response instance over W workloads × T hours."""

    models: tuple[PenaltyModel, ...]
    mci: np.ndarray                    # (T,) marginal carbon intensity
    capacity_buffer: float = 1.2       # Eq. 10
    max_curtail_frac: float = 0.5      # of entitlement (§VI-A)
    day_hours: int = 24
    preservation: str = "equality"     # "equality" | "inequality" | "none"
    smooth: float = 0.25               # softplus temperature for solvers
    rts_boost: bool = False            # allow d<0 for real-time workloads?

    # ---- cached views ------------------------------------------------------
    @functools.cached_property
    def W(self) -> int:
        return len(self.models)

    @functools.cached_property
    def T(self) -> int:
        return int(self.mci.shape[0])

    @functools.cached_property
    def usage(self) -> np.ndarray:      # (W, T)
        return np.stack([m.usage for m in self.models])

    @functools.cached_property
    def entitlements(self) -> np.ndarray:  # (W,)
        return np.asarray([m.entitlement for m in self.models])

    @functools.cached_property
    def batch_mask(self) -> np.ndarray:    # (W,) True where batch
        return np.asarray([m.kind != "realtime" for m in self.models])

    @functools.cached_property
    def names(self) -> tuple[str, ...]:
        return tuple(m.name for m in self.models)

    @property
    def num_days(self) -> int:
        return max(1, self.T // self.day_hours)

    # ---- objective terms ---------------------------------------------------
    def penalties(self, D: Tensor, smooth: float | None = None) -> Tensor:
        """(W,) calibrated per-workload penalties C_i(d_i)."""
        s = self.smooth if smooth is None else smooth
        return torch.stack([m.penalty(D[i], smooth=s)
                            for i, m in enumerate(self.models)])

    def total_penalty(self, D: Tensor, smooth: float | None = None) -> Tensor:
        return self.penalties(D, smooth).sum()

    def carbon_reduction_per_workload(self, D: Tensor) -> Tensor:
        """(W,) ⟨mci, d_i⟩, kg CO2 eliminated per workload."""
        return D @ _like(self.mci, D)

    def carbon_reduction(self, D: Tensor) -> Tensor:
        return self.carbon_reduction_per_workload(D).sum()

    def peak(self, D: Tensor) -> Tensor:
        """Post-DR datacenter peak power max_t Σ_i (U − d)."""
        return (_like(self.usage, D) - D).sum(dim=0).max()

    def soft_peak(self, D: Tensor, tau: float = 0.05) -> Tensor:
        """Smooth max for gradient-based solvers."""
        tot = (_like(self.usage, D) - D).sum(dim=0)
        scale = tau * float(self.usage.sum(axis=0).max())
        return scale * torch.logsumexp(tot / scale, dim=0)

    @property
    def capacity_limit(self) -> float:
        return float(self.capacity_buffer * self.entitlements.sum())

    @property
    def total_carbon_baseline(self) -> float:
        """Operational carbon without DR (normalization for reporting)."""
        return float((self.usage.sum(axis=0) * self.mci).sum())

    # ---- constraint machinery ---------------------------------------------
    def bounds(self) -> tuple[np.ndarray, np.ndarray]:
        """(lower, upper) box bounds for D, shape (W, T).

        Curtailment is capped at half the entitlement (§VI-A) and at
        usage; boosts go up to the entitlement (U−d ≤ E). Real-time
        workloads are curtail-only by default: their latency model rewards
        extra power linearly, and the paper's own CR1 trace (Fig. 7) shows
        RTS services only ever shedding load.
        """
        U, E = self.usage, self.entitlements[:, None]
        upper = np.minimum(self.max_curtail_frac * E, U)
        lower = -(E - U)          # boost until usage hits entitlement
        if not self.rts_boost:
            lower = np.where(self.batch_mask[:, None], lower, 0.0)
        return lower, upper

    def day_sums(self, D: Tensor) -> Tensor:
        """(W, n_days) per-day adjustment sums (preservation residuals)."""
        n = self.num_days
        Dd = D[:, : n * self.day_hours].reshape(self.W, n, self.day_hours)
        return Dd.sum(dim=-1)

    def preservation_residual(self, D: Tensor) -> Tensor:
        """(n_batch * n_days,) equality residuals (zero when preserved)."""
        idx = np.nonzero(self.batch_mask)[0]
        return self.day_sums(D)[torch.as_tensor(idx, device=D.device)
                                ].reshape(-1)

    def project_preservation(self, D: Tensor) -> Tensor:
        """Projection of batch rows onto Σ_{t∈day} d = 0 (day-mean
        removal; exact for the equality alone, not for the box)."""
        n = self.num_days
        span = n * self.day_hours
        Dday = D[:, :span].reshape(self.W, n, self.day_hours)
        mean = Dday.mean(dim=-1, keepdim=True)
        mask = torch.as_tensor(self.batch_mask, device=D.device)[:, None,
                                                                  None]
        Dday = torch.where(mask, Dday - mean, Dday)
        return torch.cat([Dday.reshape(self.W, span), D[:, span:]], dim=1)


@dataclasses.dataclass(frozen=True)
class PolicySpec:
    """Solver-agnostic optimization spec produced by each policy.

    objective(D) is minimized subject to:
      eq(D) == 0 for each eq constraint, ineq(D) >= 0 for each,
      lower <= D <= upper elementwise, D[~free] == 0,
      plus the problem's preservation constraint (unless disabled).
    """

    name: str
    problem: DRProblem
    objective: Callable[[Tensor], Tensor]
    eq_constraints: tuple[Callable[[Tensor], Tensor], ...] = ()
    ineq_constraints: tuple[Callable[[Tensor], Tensor], ...] = ()
    free: np.ndarray | None = None      # (W,) bool; None = all free
    lower: np.ndarray | None = None     # override problem bounds
    upper: np.ndarray | None = None
    use_preservation: bool = True


def _capacity_ineq(p: DRProblem) -> Callable[[Tensor], Tensor]:
    def g(D: Tensor) -> Tensor:
        return p.capacity_limit - p.soft_peak(D)
    return g


# ---------------------------------------------------------------------------
# CR1 — Efficient DR (Eq. 3): min λ C(D) + CF(D); CF change = −carbon_red.
# Both terms are normalized (penalty by total entitlement, carbon by the
# no-DR baseline footprint) so λ is unit-free: it trades "% capacity-
# equivalent performance loss" against "% operational carbon".
# ---------------------------------------------------------------------------
def cr1_spec(p: DRProblem, lam: float) -> PolicySpec:
    pen_norm = 100.0 / float(p.entitlements.sum())
    car_norm = 100.0 / p.total_carbon_baseline

    def obj(D: Tensor) -> Tensor:
        return (lam * pen_norm * p.total_penalty(D)
                - car_norm * p.carbon_reduction(D))
    return PolicySpec(name=f"CR1(λ={lam:g})", problem=p, objective=obj,
                      ineq_constraints=(_capacity_ineq(p),))


# ---------------------------------------------------------------------------
# CR2 — Fair & Centralized (Eq. 4): min CF s.t. C_i(d_i) = C_i(cap%).
# ---------------------------------------------------------------------------
def cr2_reference_losses(p: DRProblem, cap_frac: float,
                         upper: np.ndarray | None = None,
                         device: str | torch.device | None = None,
                         ) -> np.ndarray:
    """C_i under a hypothetical equal power cap at cap_frac·E (the
    fairness reference: CR2 'does not actually cap power'). `upper`
    (optional, (W, T)) clips the reference curtailments to a tightened
    box so the equality targets stay attainable under the same bounds the
    solver gets. The penalties are taken in float32 on `device` (None =
    the CUDA device), as the JAX package takes them."""
    device = resolve_device(device)
    refs = []
    for i, m in enumerate(p.models):
        d_cap = m.cap_curtailment(cap_frac)
        if upper is not None:
            d_cap = np.minimum(d_cap, upper[i])
        d = torch.as_tensor(d_cap, dtype=torch.float32, device=device)
        refs.append(float(m.penalty(d, smooth=0.0)))
    return np.asarray(refs)


def cr2_spec(p: DRProblem, cap_frac: float, upper: np.ndarray | None = None,
             device: str | torch.device | None = None) -> PolicySpec:
    refs = cr2_reference_losses(p, cap_frac, upper, device)
    scale = float(np.maximum(refs, 1e-3).mean())
    car_norm = 100.0 / p.total_carbon_baseline

    def obj(D: Tensor) -> Tensor:
        return -car_norm * p.carbon_reduction(D)

    def eq(D: Tensor) -> Tensor:
        return (p.penalties(D) - _like(refs, D)) / scale

    return PolicySpec(name=f"CR2(cap={cap_frac:g})", problem=p,
                      objective=obj, eq_constraints=(eq,),
                      ineq_constraints=(_capacity_ineq(p),), upper=upper)


# ---------------------------------------------------------------------------
# CR3 — Fair & Decentralized (Eqs. 5–8): taxes and rebates.
# ---------------------------------------------------------------------------
def cr3_workload_spec(p: DRProblem, i: int, rho: float,
                      tax_frac: float = 0.2) -> PolicySpec:
    """Workload i's selfish problem: min C_i(d_i) s.t.
    max_t(U_i − d_i) ≤ E_i − T_i + P_i(d_i),  P_i = ρ·⟨mci, d_i⟩,
    T_i = tax_frac·E_i (Eq. 8). Box/preservation as usual."""
    m = p.models[i]
    E = float(m.entitlement)
    T_i = tax_frac * E
    # The JAX package makes these two constants when the spec is built,
    # where its default float32 holds, so even its float64 solve prices
    # rebates and peaks with float32-rounded values; both packages solve
    # the same problem.
    mci = np.asarray(p.mci, np.float32)
    usage = np.asarray(m.usage, np.float32)

    def obj(D: Tensor) -> Tensor:
        return p.penalties(D)[i]

    def ineq(D: Tensor) -> Tensor:
        d = D[i]
        rebate = rho * (d @ _like(mci, D))
        # Smooth max over hours for solver friendliness.
        tau = 0.02 * E
        peak_i = tau * torch.logsumexp((_like(usage, D) - d) / tau, dim=0)
        return (E - T_i + rebate) - peak_i

    free = np.zeros(p.W, dtype=bool)
    free[i] = True
    return PolicySpec(name=f"CR3[w{i}](ρ={rho:g})", problem=p, objective=obj,
                      ineq_constraints=(ineq,), free=free)


def cr3_fiscal_balance(p: DRProblem, D: np.ndarray, rho: float,
                       tax_frac: float = 0.2) -> tuple[float, float]:
    """(Σ P_i, Σ T_i): Eq. 6 requires ΣP ≤ ΣT."""
    rebates = rho * (np.asarray(D) @ p.mci)
    taxes = tax_frac * p.entitlements
    return float(rebates.sum()), float(taxes.sum())
