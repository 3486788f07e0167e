"""Device dispatch and autograd for the fleet DR feature kernel.

`dr_features` is a `torch.autograd.Function`: its forward is the CUDA
kernel for a CUDA tensor and the plain version for a CPU tensor; its
backward is closed form in torch ops, the port of the JAX package's
custom VJP (`repro/kernels/dr_features/ops.py:35`). Each feature is
Σ_t max(cumsum(r), 0) for a per-hour rate r, so ∂/∂d is a reversed
cumsum of the active-hinge indicator (strict `>`) times ∂r/∂d. Gradients
flow to `d` only: usage and jobs are problem constants on every path.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.dr_features.kernel import dr_features_cuda
from repro_torch.kernels.dr_features.ref import dr_features_ref


def _revcum(x: torch.Tensor) -> torch.Tensor:
    return torch.flip(torch.cumsum(torch.flip(x, (1,)), dim=1), (1,))


class DrFeatures(torch.autograd.Function):
    """(W, T) d, usage, jobs -> (W, 4) Table-IV features."""

    @staticmethod
    def forward(ctx, d, usage, jobs):
        ctx.save_for_backward(d, usage, jobs)
        if d.device.type == "cuda":
            return dr_features_cuda(d, usage, jobs)
        if d.device.type == "cpu":
            return dr_features_ref(d, usage, jobs)
        raise ValueError(f"dr_features runs on cuda or cpu; got {d.device}")

    @staticmethod
    def backward(ctx, ct):
        d, usage, jobs = ctx.saved_tensors
        ju = jobs / usage
        a0 = (torch.cumsum(ju * d, dim=1) > 0).to(d.dtype)       # wait_jobs
        a1 = (torch.cumsum(d, dim=1) > 0).to(d.dtype)            # wait_power
        a2 = (torch.cumsum(ju * d * torch.abs(d), dim=1) > 0).to(d.dtype)
        d_ct = (ct[:, 0:1] * ju * _revcum(a0)
                + ct[:, 1:2] * _revcum(a1)
                + ct[:, 2:3] * 2.0 * ju * torch.abs(d) * _revcum(a2)
                + ct[:, 3:4] * ju * (d > 0).to(d.dtype))
        return d_ct, None, None


def dr_features(d: torch.Tensor, usage: torch.Tensor,
                jobs: torch.Tensor) -> torch.Tensor:
    """(W, T) fleet adjustment/usage/job matrices -> (W, 4) features."""
    return DrFeatures.apply(d, usage, jobs)
