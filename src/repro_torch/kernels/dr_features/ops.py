"""Device dispatch and autograd for the fleet DR feature kernel.

`dr_features` is a `torch.autograd.Function`: its forward is the CUDA
kernel for a CUDA tensor and the plain version for a CPU tensor; its
backward is closed form in torch ops, the port of the JAX package's
custom VJP (`repro/kernels/dr_features/ops.py:35`). Each feature is
Σ_t max(cumsum(r), 0) for a per-hour rate r, so ∂/∂d is a reversed
cumsum of the active-hinge indicator (strict `>`) times ∂r/∂d.

The indicators come from running sums of the rates as
`repro_torch.core.features` forms them (`jobs_rate`, `squared_rate`),
and the products are taken in the order autograd takes them on the
plain path. Off the ties the gradient is then the plain path's bit for
bit: a preserved batch row's running sum returns to about 0 at every
day's end, where rounding decides the hinge, and CR3's clearing rounds
follow that decision. At an exact tie the indicator is 0, as in the JAX
custom VJP, where the plain path's `torch.maximum` gives one half.
Gradients flow to `d` only: usage and jobs are problem constants on
every path.
"""
from __future__ import annotations

import torch

from repro_torch.core import features as feat
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
        jd, ad = jobs * d, torch.abs(d)
        a0 = torch.cumsum(feat.jobs_rate(d, usage, jobs), dim=1) > 0
        a1 = torch.cumsum(d, dim=1) > 0
        a2 = torch.cumsum(feat.squared_rate(d, usage, jobs), dim=1) > 0
        c0, c1, c2, c3 = (ct[:, i:i + 1].expand_as(d) for i in range(4))
        g2 = _revcum(c2 * a2) / usage
        # Summed last feature first, as autograd's engine accumulates them.
        d_ct = (c3 / usage * jobs * (d > 0)                # njobs_delayed
                + g2 * jd * torch.sgn(d) + g2 * ad * jobs  # wait_sq
                + _revcum(c1 * a1)                         # wait_power
                + _revcum(c0 * a0) / usage * jobs)         # wait_jobs
        return d_ct, None, None


def dr_features(d: torch.Tensor, usage: torch.Tensor,
                jobs: torch.Tensor) -> torch.Tensor:
    """(W, T) fleet adjustment/usage/job matrices -> (W, 4) features."""
    return DrFeatures.apply(d, usage, jobs)
