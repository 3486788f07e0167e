"""Baseline DR policies (paper §V-B): B1–B4, adapted from prior work.

B1 — Proportional Power Capping  [eBuff-style, simple]  (closed form)
B2 — Performant Power Capping    [eBuff]                (optimization)
B3 — Prioritized Power Capping   [Dynamo]               (closed form)
B4 — Load Shaping                [Google CAC]           (optimization)

The closed forms are numpy; the optimization specs are `PolicySpec`s for
`core/solver.py`, their terms computed in D's dtype on D's device.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from repro_torch.core.policies import DRProblem, PolicySpec, _capacity_ineq

Tensor = torch.Tensor


# ---------------------------------------------------------------------------
# B1 — Proportional Power Capping (Eq. 9): L_i = F·E_i, d = max(U − L, 0).
# Analyzed WITHOUT batch preservation (§VI-C: with it, a capping-only
# policy cannot adjust at all, the yellow-star point).
# ---------------------------------------------------------------------------
def b1_adjustments(p: DRProblem, F: float) -> np.ndarray:
    L = F * p.entitlements[:, None]
    return np.maximum(p.usage - L, 0.0)


# ---------------------------------------------------------------------------
# B2 — Performant Power Capping: min λC(D) + peak(D), capping only (d ≥ 0).
# Batch preservation + d ≥ 0 together freeze batch rows, so B2 ends up
# capping only real-time workloads (§VI-D's finding).
# ---------------------------------------------------------------------------
def b2_spec(p: DRProblem, lam: float) -> PolicySpec:
    pen_norm = 100.0 / float(p.entitlements.sum())
    peak_norm = 100.0 / float(p.usage.sum(axis=0).max())

    def obj(D: Tensor) -> Tensor:
        return (lam * pen_norm * p.total_penalty(D)
                + peak_norm * p.soft_peak(D))

    lower = np.zeros_like(p.usage)  # capping: no boosts
    return PolicySpec(name=f"B2(λ={lam:g})", problem=p, objective=obj,
                      ineq_constraints=(_capacity_ineq(p),), lower=lower)


# ---------------------------------------------------------------------------
# B3 — Prioritized Power Capping (Dynamo): curtail RTS only, lowest priority
# first, each up to a maximum cut depth.
# ---------------------------------------------------------------------------
def b3_adjustments(p: DRProblem, depth: float, max_cut: float = 0.2,
                   priority: Sequence[str] | None = None) -> np.ndarray:
    """`depth` ∈ [0, n_rts·max_cut]: aggregate cut progression. The lowest
    priority RTS workload is capped first (cap L = (1−c)·E, Eq. 9), up to
    `max_cut`, then the next."""
    if priority is None:  # highest → lowest priority
        priority = [m.name for m in p.models if m.kind == "realtime"]
    order = list(reversed(priority))  # curtail lowest priority first
    D = np.zeros_like(p.usage)
    remaining = depth
    for name in order:
        if remaining <= 0:
            break
        i = p.names.index(name)
        c = min(remaining, max_cut)
        L = (1.0 - c) * p.entitlements[i]
        D[i] = np.maximum(p.usage[i] - L, 0.0)
        remaining -= c
    return D


# ---------------------------------------------------------------------------
# B4 — Load Shaping (Google): protect RTS, shift batch only, keep SLOs.
# min CF(D) + λ·peak(D)  s.t. batch SLOs (C_i ≈ 0 for SLO'd batch).
# ---------------------------------------------------------------------------
def b4_spec(p: DRProblem, lam: float, slo_eps: float = 1e-2) -> PolicySpec:
    free = np.asarray([m.kind != "realtime" for m in p.models])
    car_norm = 100.0 / p.total_carbon_baseline
    peak_norm = 100.0 / float(p.usage.sum(axis=0).max())

    def obj(D: Tensor) -> Tensor:
        return (-car_norm * p.carbon_reduction(D)
                + lam * peak_norm * p.soft_peak(D))

    ineqs = [_capacity_ineq(p)]
    for i, m in enumerate(p.models):
        if m.kind == "batch_slo":
            # SLO guard: penalty stays within slo_eps of zero.
            def g(D: Tensor, i=i) -> Tensor:
                return (float(slo_eps * p.entitlements[i])
                        - p.penalties(D)[i])
            ineqs.append(g)

    return PolicySpec(name=f"B4(λ={lam:g})", problem=p, objective=obj,
                      ineq_constraints=tuple(ineqs), free=free)
