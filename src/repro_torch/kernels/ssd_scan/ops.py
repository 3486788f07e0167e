"""Device dispatch for the SSD inter-chunk scan.

A CUDA tensor goes through the hand-written kernel, a CPU tensor through
the plain version; `use_kernel=False` asks for the plain version on the
card (the comparisons in `chip_smoke.py` do). Both take the same float32
contiguous operands and return contiguous outputs, so what follows them
(the products of `ssd_chunked`) sees the same layouts. Nothing falls back
from one to the other. Under autograd the kernel runs inside
`SSDScanFn`, whose backward is the hand-written backward kernel; the
plain version is differentiated by autograd.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.ssd_scan.kernel import (ssd_scan_bwd_cuda,
                                                 ssd_scan_cuda)
from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref


class SSDScanFn(torch.autograd.Function):
    """The kernel forward; the backward kernel (`ssd_scan_bwd_cuda`). Saves
    the decays and the h_prev the forward wrote, nothing more. A gradient
    autograd does not pass (h_last unused, as in `ssm_apply`) stays None
    and the kernel reads it as zeros."""

    @staticmethod
    def forward(ctx, states, chunk_decay, h0):
        h_prev, h_last = ssd_scan_cuda(states, chunk_decay, h0)
        ctx.save_for_backward(chunk_decay, h_prev)
        ctx.has_h0 = h0 is not None
        ctx.set_materialize_grads(False)
        return h_prev, h_last

    @staticmethod
    def backward(ctx, g_prev, g_last):
        chunk_decay, h_prev = ctx.saved_tensors
        dstates, ddecay, dh0 = ssd_scan_bwd_cuda(
            None if g_prev is None else g_prev.contiguous(),
            None if g_last is None else g_last.contiguous(),
            chunk_decay, h_prev, ctx.has_h0)
        return dstates, ddecay, dh0


def ssd_scan(states: torch.Tensor, chunk_decay: torch.Tensor,
             h0: torch.Tensor | None = None,
             use_kernel: bool | None = None
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """states (B, NC, H, P, N), chunk_decay (B, NC, H), h0 (B, H, P, N) or
    None -> (h_prev (B, NC, H, P, N), h_last (B, H, P, N)), float32."""
    if use_kernel is None:
        use_kernel = states.device.type == "cuda"
    args = (states.float().contiguous(), chunk_decay.float().contiguous(),
            None if h0 is None else h0.float().contiguous())
    if not use_kernel:
        return ssd_scan_ref(*args)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in args):
        return SSDScanFn.apply(*args)
    return ssd_scan_cuda(*args)
