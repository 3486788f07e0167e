"""Engineered penalty-model features (paper Table IV), on tensors.

All features are functions of the hourly adjustment vector d (positive =
curtail) built from positive-part cumulative sums, the queue integral of
deferred work. Shapes: d, usage, jobs are (T,) for one workload or (W, T)
batched; every function maps to one value per workload.

The positive part is `torch.maximum(x, 0)`, whose autograd gives 0.5 at
an exact tie, as JAX's `jnp.maximum` does (`relu` would give 0 and
`clamp` 1). The generic engine differentiates through these features from
the cold start D = 0, which sits on every tie.

`repro_torch.kernels.dr_features` computes the same quantities for large
fleets; its plain version `dr_features_ref` is built from this module.
"""
from __future__ import annotations

import torch

Tensor = torch.Tensor


def _pos(x: Tensor, smooth: float = 0.0) -> Tensor:
    """Positive part; softplus-smoothed when smooth > 0."""
    if smooth > 0.0:
        return smooth * torch.logaddexp(x / smooth, torch.zeros_like(x))
    return torch.maximum(x, torch.zeros_like(x))


def jobs_rate(d: Tensor, usage: Tensor, jobs: Tensor) -> Tensor:
    """J·d/U, the hourly rate of deferred jobs. The one expression for it:
    the `dr_features` backward takes its hinge indicators from running
    sums of this rate, so they agree with the forward's bit for bit."""
    return jobs * d / usage


def squared_rate(d: Tensor, usage: Tensor, jobs: Tensor) -> Tensor:
    """J·d·|d|/U, the hourly rate of the convexity feature (as
    `jobs_rate`)."""
    return jobs * d * torch.abs(d) / usage


def waiting_time_jobs(d: Tensor, usage: Tensor, jobs: Tensor,
                      smooth: float = 0.0) -> Tensor:
    """Σ_t ( Σ_{t'<=t} J_{t'} · d_{t'}/U_{t'} )⁺   [job·hour]."""
    return _pos(torch.cumsum(jobs_rate(d, usage, jobs), dim=-1),
                smooth).sum(dim=-1)


def waiting_time_power(d: Tensor, smooth: float = 0.0) -> Tensor:
    """Σ_t ( Σ_{t'<=t} d_{t'} )⁺   [NP·hour]."""
    return _pos(torch.cumsum(d, dim=-1), smooth).sum(dim=-1)


def waiting_time_squared(d: Tensor, usage: Tensor, jobs: Tensor,
                         smooth: float = 0.0) -> Tensor:
    """Σ_t ( Σ_{t'<=t} J_{t'} · d_{t'}·|d_{t'}|/U_{t'} )⁺ — the convexity
    feature; signed d·|d| so that boosts relieve the queue integral."""
    return _pos(torch.cumsum(squared_rate(d, usage, jobs), dim=-1),
                smooth).sum(dim=-1)


def num_jobs_delayed(d: Tensor, usage: Tensor, jobs: Tensor,
                     smooth: float = 0.0) -> Tensor:
    """Σ_{t'} J_{t'} · d_{t'}⁺ / U_{t'} — non-cumulative affected jobs."""
    return (jobs * _pos(d, smooth) / usage).sum(dim=-1)


def total_tardiness(d: Tensor, usage: Tensor, jobs: Tensor, slo_hours: int,
                    smooth: float = 0.0) -> Tensor:
    """Σ_t ( Σ_{t'<=t-SLO} J_{t'} · d_{t'}/U_{t'} )⁺ — overdue queue hours."""
    cum = torch.cumsum(jobs_rate(d, usage, jobs), dim=-1)
    T = cum.shape[-1]
    if slo_hours >= T:
        return torch.zeros(cum.shape[:-1], dtype=cum.dtype, device=cum.device)
    return _pos(cum[..., : T - slo_hours], smooth).sum(dim=-1)


FEATURE_NAMES = (
    "waiting_time_jobs",
    "waiting_time_power",
    "waiting_time_squared",
    "num_jobs_delayed",
    "total_tardiness",
)


def feature_matrix(d: Tensor, usage: Tensor, jobs: Tensor,
                   slo_hours: int = 4, smooth: float = 0.0,
                   include_tardiness: bool = True) -> Tensor:
    """Stack Table-IV features -> (..., F). F = 5 with tardiness, else 4."""
    feats = [
        waiting_time_jobs(d, usage, jobs, smooth),
        waiting_time_power(d, smooth),
        waiting_time_squared(d, usage, jobs, smooth),
        num_jobs_delayed(d, usage, jobs, smooth),
    ]
    if include_tardiness:
        feats.append(total_tardiness(d, usage, jobs, slo_hours, smooth))
    return torch.stack(feats, dim=-1)


# Selections published in Table IV: (x1, x2) for each batch family.
SELECTED = {
    "AITraining": ("waiting_time_power", "num_jobs_delayed"),
    "DataPipeline": ("waiting_time_power", "waiting_time_squared"),
}


def named_feature(name: str, d: Tensor, usage: Tensor, jobs: Tensor,
                  slo_hours: int = 4, smooth: float = 0.0) -> Tensor:
    """One Table-IV feature by name."""
    if name == "waiting_time_power":
        return waiting_time_power(d, smooth)
    if name == "total_tardiness":
        return total_tardiness(d, usage, jobs, slo_hours, smooth)
    fn = {"waiting_time_jobs": waiting_time_jobs,
          "waiting_time_squared": waiting_time_squared,
          "num_jobs_delayed": num_jobs_delayed}[name]
    return fn(d, usage, jobs, smooth)


def selected_features(workload: str, d: Tensor, usage: Tensor, jobs: Tensor,
                      slo_hours: int = 4, smooth: float = 0.0) -> Tensor:
    """(x1, x2) per Table IV's published selection -> (..., 2)."""
    return torch.stack([named_feature(n, d, usage, jobs, slo_hours, smooth)
                        for n in SELECTED[workload]], dim=-1)
