"""Workload performance-penalty models (paper §IV), on tensors.

Two families:

  * Real-time (RTS1/RTS2): the cubic latency-degradation polynomials
    published in the paper (Eq. 1), with δ the power cut as a fraction
    of usage:
        f_RTS1(δ) = 6.3δ³ − 13δ² + 51.6δ
        f_RTS2(δ) = −4δ³ − 3.5δ² + 42.5δ

  * Batch (AI training / data pipeline): Lasso-learned models over the
    Table-IV features, trained against the EDD simulator (Eq. 2):
        C_i(d) = ( k_i (β₀ + β₁ x₁ + β₂ x₂) )⁺

  The weights k_i convert workload-specific loss into equivalent NP
  capacity by calibration: the penalty of a 15 % capacity cap equals the
  entitlement lost (0.15·E_i).

Model fields are numpy, as in the JAX package; the losses take a float32
tensor `d` and compute on its device, so policies optimize through them
with autograd.
"""
from __future__ import annotations

import dataclasses
import zlib

import numpy as np
import torch

from repro_torch.core import features as feat
from repro_torch.core.lasso import LassoFit, fit_lasso_cv
from repro_torch.kernels.dispatch import resolve_device
from repro_torch.sched.edd import EDDScheduler, mixed_curtailments
from repro_torch.sched.traces import JobTrace, ServiceTrace, make_job_trace

Tensor = torch.Tensor

# Published Dynamo-fit coefficients (paper Eq. 1): a3, a2, a1.
RTS_COEFFS = {
    "RTS1": (6.3, -13.0, 51.6),
    "RTS2": (-4.0, -3.5, 42.5),
}
CALIBRATION_CAP = 0.15  # §IV: "capping 15% capacity"


@dataclasses.dataclass(frozen=True)
class PenaltyModel:
    """A calibrated penalty model C_i(d) for one workload.

    Attributes:
      name: workload name.
      kind: "realtime" | "batch_slo" | "batch_noslo".
      usage: (T,) baseline hourly usage U_i (NP).
      entitlement: capacity entitlement E_i (NP).
      k: calibration weight (NP per unit of raw performance loss).
      params: RTS: (a3, a2, a1); batch: (β0, β1, β2).
      jobs: (T,) hourly job counts (batch only).
      slo_hours: representative SLO lag for the tardiness feature.
      feature_names: which Table-IV features are x1, x2 (batch only).
    """

    name: str
    kind: str
    usage: np.ndarray
    entitlement: float
    k: float
    params: tuple[float, ...]
    jobs: np.ndarray | None = None
    slo_hours: int = 4
    feature_names: tuple[str, str] | None = None

    def _const(self, a: np.ndarray, like: Tensor) -> Tensor:
        """A model constant in `like`'s dtype (float32 on the fleet paths,
        float64 in the SLSQP reference) and on its device."""
        return torch.as_tensor(a, dtype=like.dtype, device=like.device)

    def raw_loss(self, d: Tensor, smooth: float = 0.0) -> Tensor:
        """Workload-specific performance loss (latency-%·hours for RTS;
        waiting/tardiness hours for batch). Differentiable in d."""
        if self.kind == "realtime":
            a3, a2, a1 = self.params
            delta = d / self._const(self.usage, d)
            return (a3 * delta**3 + a2 * delta**2 + a1 * delta).sum(dim=-1)
        b0, b1, b2 = self.params
        x = self._batch_features(d, smooth)
        return b0 + b1 * x[..., 0] + b2 * x[..., 1]

    def _batch_features(self, d: Tensor, smooth: float = 0.0) -> Tensor:
        if self.feature_names is None or self.jobs is None:
            raise ValueError(f"{self.name}: batch model without features")
        usage, jobs = self._const(self.usage, d), self._const(self.jobs, d)
        return torch.stack([
            feat.named_feature(n, d, usage, jobs, self.slo_hours, smooth)
            for n in self.feature_names], dim=-1)

    def penalty(self, d: Tensor, smooth: float = 0.0) -> Tensor:
        """C_i(d) in equivalent-NP-capacity units. Batch models take the
        positive part (Eq. 2); RTS is signed (boost improves service)."""
        raw = self.raw_loss(d, smooth)
        if self.kind == "realtime":
            return self.k * raw
        if smooth > 0.0:
            z = self.k * raw / smooth
            return smooth * torch.logaddexp(z, torch.zeros_like(z))
        return torch.maximum(self.k * raw, torch.zeros_like(raw))

    def cap_curtailment(self, cap_frac: float) -> np.ndarray:
        """Curtailment from capping power at cap_frac·E (Eq. 9): any usage
        above L = cap_frac·E is cut."""
        return np.maximum(self.usage - cap_frac * self.entitlement, 0.0)

    def calibration_curtailment(self, cap: float = CALIBRATION_CAP
                                ) -> np.ndarray:
        """Uniform loss of `cap` of capacity, the k-calibration reference:
        d_t = cap·E, clipped to half of usage (the idle-power floor)."""
        d = np.full_like(self.usage, cap * self.entitlement)
        return np.minimum(d, 0.5 * self.usage)


def calibrate_k(raw_loss_at_cap: float, entitlement: float,
                cap: float = CALIBRATION_CAP) -> float:
    """k_i = capacity loss / performance loss at a (1-cap)·E power cap."""
    if raw_loss_at_cap <= 1e-12:
        return 0.0
    return (cap * entitlement) / raw_loss_at_cap


def _f32(a: np.ndarray, device) -> Tensor:
    return torch.as_tensor(a, dtype=torch.float32, device=device)


def build_rts_model(name: str, trace: ServiceTrace,
                    device: str | torch.device | None = None) -> PenaltyModel:
    """Penalty model for a real-time service from published coefficients."""
    device = resolve_device(device)
    coeffs = RTS_COEFFS[name if name in RTS_COEFFS else "RTS1"]
    model = PenaltyModel(name=name, kind="realtime", usage=trace.usage,
                         entitlement=trace.entitlement, k=1.0, params=coeffs)
    d_cap = model.calibration_curtailment()
    raw = float(model.raw_loss(_f32(d_cap, device)))
    return dataclasses.replace(model, k=calibrate_k(raw, trace.entitlement))


@dataclasses.dataclass(frozen=True)
class BatchTrainingData:
    """Simulator-generated supervised data for the Lasso fit."""

    X: np.ndarray          # (N, F) Table-IV features
    y: np.ndarray          # (N,) waiting time (no-SLO) or tardiness (SLO)
    baseline: float        # outcome with d = 0
    feature_names: tuple[str, ...]


def generate_batch_training_data(
        trace: ServiceTrace, jobs: JobTrace, num_samples: int,
        seed: int = 0, device: str | torch.device | None = None,
) -> BatchTrainingData:
    """Run the EDD simulator under sampled curtailments (paper §IV-A2)."""
    device = resolve_device(device)
    sched = EDDScheduler(horizon_slack=4)
    with_slo = trace.kind == "batch_slo"
    ds = mixed_curtailments(trace.usage, num_samples, seed=seed)
    base = sched.run(jobs, trace.usage)
    y0 = base.total_tardiness if with_slo else base.total_waiting
    names = tuple(n for n in feat.FEATURE_NAMES
                  if with_slo or n != "total_tardiness")
    X = feat.feature_matrix(
        _f32(ds, device), _f32(trace.usage, device),
        _f32(jobs.jobs_per_hour(trace.hours), device), slo_hours=4,
        include_tardiness=with_slo).cpu().numpy()
    y = np.zeros(num_samples)
    for n in range(num_samples):
        res = sched.run(jobs, trace.usage - ds[n])
        out = res.total_tardiness if with_slo else res.total_waiting
        y[n] = out - y0
    return BatchTrainingData(X=X, y=y, baseline=y0, feature_names=names)


def build_batch_model(name: str, trace: ServiceTrace, jobs: JobTrace,
                      num_samples: int = 160, seed: int = 0,
                      use_published_selection: bool = True,
                      device: str | torch.device | None = None,
                      ) -> tuple[PenaltyModel, LassoFit, BatchTrainingData]:
    """Fit the Lasso penalty model for a batch service and calibrate k.

    Returns (model, fit, data). `use_published_selection` restricts the
    model to the paper's published (x1, x2) pair after the full-Lasso fit.
    """
    device = resolve_device(device)
    data = generate_batch_training_data(trace, jobs, num_samples, seed,
                                        device=device)
    fit = fit_lasso_cv(data.X, data.y, seed=seed, device=device)
    key = "DataPipeline" if trace.kind == "batch_slo" else "AITraining"
    if use_published_selection:
        sel_names = feat.SELECTED[key]
    else:
        sel = fit.selected[:2] if len(fit.selected) >= 2 else (0, 1)
        sel_names = tuple(data.feature_names[i] for i in sel)
    # Refit least squares on the two selected features for the deployed
    # model (the paper's Eq. 2 has exactly β0, β1, β2).
    idx = [data.feature_names.index(n) for n in sel_names]
    X2 = data.X[:, idx]
    A = np.concatenate([np.ones((X2.shape[0], 1)), X2], axis=1)
    beta, *_ = np.linalg.lstsq(A, data.y, rcond=None)
    model = PenaltyModel(
        name=name, kind=trace.kind, usage=trace.usage,
        entitlement=trace.entitlement, k=1.0,
        params=(float(beta[0]), float(beta[1]), float(beta[2])),
        jobs=jobs.jobs_per_hour(trace.hours), slo_hours=4,
        feature_names=sel_names)
    raw_t = model.raw_loss(_f32(model.calibration_curtailment(), device))
    raw = float(torch.maximum(raw_t, torch.zeros_like(raw_t)))
    k = calibrate_k(raw, trace.entitlement)
    return dataclasses.replace(model, k=k), fit, data


def name_hash(name: str) -> int:
    """A string hash that is the same in every process."""
    return zlib.crc32(name.encode())


def build_paper_fleet(hours: int = 48, total_power: float = 100.0,
                      num_samples: int = 160, num_jobs: int = 10_000,
                      seed: int = 0, device: str | torch.device | None = None,
                      ) -> dict[str, PenaltyModel]:
    """The paper's four-service fleet (Table II) with calibrated models.

    Each batch service's job trace is seeded with `seed + name_hash(name)
    % 97`. The JAX package takes Python's `hash`, which changes with the
    process's string-hash seed, so its fleet differs from run to run.
    """
    from repro_torch.sched.traces import fleet_power_traces
    device = resolve_device(device)
    traces = fleet_power_traces(hours=hours, total_power=total_power,
                                seed=seed)
    out: dict[str, PenaltyModel] = {}
    for name in ("RTS1", "RTS2"):
        out[name] = build_rts_model(name, traces[name], device=device)
    for name, kind, n in (("AITraining", "batch_noslo", 303),
                          ("DataPipeline", "batch_slo", 162)):
        jobs = make_job_trace(
            kind, hours=hours,
            total_power=1.05 * float(np.mean(traces[name].usage)),
            num_jobs=num_jobs, seed=seed + name_hash(name) % 97)
        model, _, _ = build_batch_model(name, traces[name], jobs,
                                        num_samples=min(num_samples, n),
                                        seed=seed, device=device)
        out[name] = model
    return out
