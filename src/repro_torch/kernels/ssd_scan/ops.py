"""Device dispatch for the SSD inter-chunk scan.

A CUDA tensor goes through the hand-written kernel, a CPU tensor through
the plain version; `use_kernel=False` asks for the plain version on the
card (the comparisons in `chip_smoke.py` do). Both take the same float32
contiguous operands and return contiguous outputs, so what follows them
(the products of `ssd_chunked`) sees the same layouts. Nothing falls back
from one to the other.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.ssd_scan.kernel import ssd_scan_cuda
from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref


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
    return ssd_scan_cuda(*args) if use_kernel else ssd_scan_ref(*args)
