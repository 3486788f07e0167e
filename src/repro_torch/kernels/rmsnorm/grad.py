"""Closed-form backward of RMSNorm, in torch ops.

For y = x̂·s with x̂ = x·rstd and rstd = 1/sqrt(mean(x²) + eps), row by
row:

    dx = rstd · (s·dy − x̂ · mean(x̂ · s·dy))
    ds = Σ_rows dy · x̂

in f32, from the saved input and scale (no saved activation beyond x).
rstd comes from the plain version's mean (summed in f64, rounded once), so
x̂ is the forward's. The JAX package has no backward kernel: its models
differentiate the jnp rmsnorm; this is that derivative, written out.
"""
from __future__ import annotations

import torch


def rmsnorm_bwd(x: torch.Tensor, scale: torch.Tensor, dy: torch.Tensor,
                eps: float = 1e-6) -> tuple[torch.Tensor, torch.Tensor]:
    """x, dy: (..., d); scale: (d,) -> (dx in x's dtype, ds in scale's)."""
    xf = x.float()
    var = torch.mean(xf.double() * xf.double(), dim=-1, keepdim=True).float()
    rstd = torch.rsqrt(var + eps)
    xhat = xf * rstd
    dyf = dy.float()
    sdy = dyf * scale.float()
    dx = rstd * (sdy - xhat * torch.mean(xhat * sdy, dim=-1, keepdim=True))
    ds = (dyf * xhat).reshape(-1, x.shape[-1]).sum(dim=0)
    return dx.to(x.dtype), ds.to(scale.dtype)
