"""Device dispatch for RMSNorm over any leading batch dims.

A CUDA tensor goes through the hand-written kernel, a CPU tensor through
the plain version; `use_kernel=False` asks for the plain version on the
card (the comparisons in `chip_smoke.py` do). Nothing falls back from one
to the other. Under autograd the kernel runs inside `RMSNormFn`, whose
backward is the closed form of `grad.py`; the plain version is
differentiated by autograd.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.rmsnorm.grad import rmsnorm_bwd
from repro_torch.kernels.rmsnorm.kernel import rmsnorm_cuda
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref


def _kernel(x: torch.Tensor, scale: torch.Tensor, eps: float):
    shape = x.shape
    out = rmsnorm_cuda(x.reshape(-1, shape[-1]).contiguous(),
                       scale.float().contiguous(), eps)
    return out.reshape(shape)


class RMSNormFn(torch.autograd.Function):
    """The kernel forward; the closed-form backward (`grad.rmsnorm_bwd`)."""

    @staticmethod
    def forward(ctx, x, scale, eps):
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        return _kernel(x, scale, eps)

    @staticmethod
    def backward(ctx, dy):
        x, scale = ctx.saved_tensors
        dx, ds = rmsnorm_bwd(x, scale, dy, ctx.eps)
        return dx, ds, None


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6,
            use_kernel: bool | None = None) -> torch.Tensor:
    """x: (..., d); scale: (d,) -> x's shape and dtype."""
    if use_kernel is None:
        use_kernel = x.device.type == "cuda"
    if not use_kernel:
        return rmsnorm_ref(x, scale, eps)
    if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad):
        return RMSNormFn.apply(x, scale, eps)
    return _kernel(x, scale, eps)
