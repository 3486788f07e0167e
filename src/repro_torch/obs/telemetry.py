"""In-solve convergence telemetry: the knob and the host-side trace view.

The samples are taken inside the generic AL loop
(`repro_torch.core.engine.al_minimize`, `EngineConfig.telemetry_every`):
every k-th inner step writes its scalars into preallocated device
buffers, with no host read while the solve runs, and the buffers come
back as `aux["telemetry"]`. This module is the host-side half:
`TelemetryConfig` is the knob (`SolveContext(telemetry=...)`) and
`ConvergenceTrace` the numpy view of one solve's trace that lands in
`result.extras["telemetry"]`, made with one device-to-host copy at the
end of the solve.

Import-light: nothing of `repro_torch.core` (and no torch at module
scope), so the report CLI can load traces without the engine.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np

__all__ = ["TelemetryConfig", "ConvergenceTrace"]

#: The float leaves of the engine's telemetry dict, in copy order.
_FLOATS = ("objective", "grad_sq", "violation", "dx", "mu")


@dataclasses.dataclass(frozen=True)
class TelemetryConfig:
    """Knobs for in-solve convergence telemetry.

    Attributes:
      every: sample the trace every `every` inner steps (>= 1), counted
        over all rounds from 1; a solve keeps
        `outer * inner // every` samples.
    """
    every: int = 10

    def __post_init__(self) -> None:
        if int(self.every) < 1:
            raise ValueError(
                f"TelemetryConfig.every must be >= 1, got {self.every}")


def _to_host(tel: dict) -> dict:
    """The telemetry dict as numpy: device tensors come over in one copy
    (the float leaves and `step_scale` concatenated), numpy passes."""
    leaves = [tel[k] for k in _FLOATS] + [tel["step_scale"]]
    if not all(hasattr(v, "detach") for v in leaves):
        return {k: np.asarray(v) for k, v in tel.items()}
    import torch

    n = leaves[0].shape[-1]
    flat = torch.cat([v.detach().reshape(-1).float() for v in leaves])
    host = flat.cpu().numpy()
    out = {k: host[i * n:(i + 1) * n] for i, k in enumerate(_FLOATS)}
    out["step_scale"] = host[len(_FLOATS) * n:]
    out["step"] = np.asarray(tel["step"])
    return out


@dataclasses.dataclass(frozen=True)
class ConvergenceTrace:
    """One solve's convergence trace (host numpy arrays, one row a sample).

    All arrays have shape `(n_samples,)`. `objective` is the augmented
    Lagrangian at the pre-step iterate (multiplier and penalty terms
    included), `grad_norm` the l2 norm of the (transformed) gradient,
    `violation` the worst constraint residual at the post-step iterate
    (0 for unconstrained solves), `dx` the mean |Δx| of the step, `mu`
    the penalty weight of the sample's round.
    """
    step: np.ndarray
    objective: np.ndarray
    grad_norm: np.ndarray
    violation: np.ndarray
    dx: np.ndarray
    mu: np.ndarray
    step_scale: float

    @classmethod
    def from_aux(cls, tel: dict) -> "ConvergenceTrace":
        """Build from the engine's `aux["telemetry"]` dict (one solve)."""
        tel = _to_host(tel)
        g2 = np.asarray(tel["grad_sq"], dtype=np.float64)
        return cls(
            step=np.asarray(tel["step"]),
            objective=np.asarray(tel["objective"]),
            grad_norm=np.sqrt(np.maximum(g2, 0.0)),
            violation=np.asarray(tel["violation"]),
            dx=np.asarray(tel["dx"]),
            mu=np.asarray(tel["mu"]),
            step_scale=float(np.asarray(tel["step_scale"]).mean()),
        )

    @classmethod
    def split(cls, tel: dict) -> tuple["ConvergenceTrace", ...]:
        """Split a stacked telemetry dict (leading lane or tick axis) into
        one trace per entry."""
        leaves = {k: np.asarray(v.cpu() if hasattr(v, "cpu") else v)
                  for k, v in tel.items()}
        n = leaves["step"].shape[0]
        return tuple(
            cls.from_aux({k: v[i] for k, v in leaves.items()})
            for i in range(n))

    @property
    def n_samples(self) -> int:
        return int(self.step.shape[0])

    def samples(self) -> Iterator[dict]:
        """Yield one JSON-able dict per sample (for the event ledger)."""
        for i in range(self.n_samples):
            yield {
                "step": int(self.step[i]),
                "objective": float(self.objective[i]),
                "grad_norm": float(self.grad_norm[i]),
                "violation": float(self.violation[i]),
                "dx": float(self.dx[i]),
                "mu": float(self.mu[i]),
            }

    def summary(self) -> dict:
        """Condensed first/last view (for logs and reports)."""
        if not self.n_samples:
            return {"n_samples": 0}
        return {
            "n_samples": self.n_samples,
            "first_objective": float(self.objective[0]),
            "last_objective": float(self.objective[-1]),
            "last_grad_norm": float(self.grad_norm[-1]),
            "last_violation": float(self.violation[-1]),
            "step_scale": self.step_scale,
        }
