"""Device dispatch for RMSNorm over any leading batch dims.

A CUDA tensor goes through the hand-written kernel, a CPU tensor through
the plain version; `use_kernel=False` asks for the plain version on the
card (the comparisons in `chip_smoke.py` do). Nothing falls back from one
to the other.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.rmsnorm.kernel import rmsnorm_cuda
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6,
            use_kernel: bool | None = None) -> torch.Tensor:
    """x: (..., d); scale: (d,) -> x's shape and dtype."""
    if use_kernel is None:
        use_kernel = x.device.type == "cuda"
    if not use_kernel:
        return rmsnorm_ref(x, scale, eps)
    shape = x.shape
    out = rmsnorm_cuda(x.reshape(-1, shape[-1]).contiguous(),
                       scale.float().contiguous(), eps)
    return out.reshape(shape)
