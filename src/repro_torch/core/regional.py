"""CR1/CR2 fleet-global normalizers (single-region part).

The JAX package's `repro.core.regional` also holds the per-region
(segment-summed) twins of these reductions for multi-region fleets; those
are not ported yet and raise `NotImplementedError`.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.fleet_solver import FleetProblem, _bounds

f32 = torch.float32


def _single_region(p: FleetProblem) -> None:
    if np.ndim(p.mci) == 2:
        raise NotImplementedError(
            "per-region normalizers (mci (R, T)) are not ported yet")


def cr1_norms(p: FleetProblem):
    """(pen_norm, car_norm, step_scale): CR1's fleet-global reductions,
    as 0-d float32 tensors on the device of `p`'s tensors."""
    _single_region(p)
    lo, hi = _bounds(p)
    dev = lo.device
    mci = torch.as_tensor(p.mci, dtype=f32, device=dev)
    usage = torch.as_tensor(p.usage, dtype=f32, device=dev)
    ent = torch.as_tensor(p.entitlement, dtype=f32, device=dev)
    return (100.0 / ent.sum(),
            100.0 / (usage.sum(0) * mci).sum(),
            torch.clamp(hi - lo, min=1e-6).mean())


def cr2_norms(p: FleetProblem, refs: torch.Tensor):
    """(car_norm, scale, step_scale): CR2's fleet-global reductions (the
    carbon normalizer, the equality-residual scale, the step scale)."""
    _single_region(p)
    lo, hi = _bounds(p)
    dev = lo.device
    mci = torch.as_tensor(p.mci, dtype=f32, device=dev)
    usage = torch.as_tensor(p.usage, dtype=f32, device=dev)
    return (100.0 / (usage.sum(0) * mci).sum(),
            torch.clamp(refs.mean(), min=1e-3),
            torch.clamp(hi - lo, min=1e-6).mean())
