"""Plain PyTorch version of the SSD inter-chunk scan kernel (the port of
the JAX package's oracle `repro/kernels/ssd_scan/ref.py`)."""
from __future__ import annotations

import torch


def ssd_scan_ref(states: torch.Tensor, chunk_decay: torch.Tensor,
                 h0: torch.Tensor | None = None
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """states: (B, NC, H, P, N) per-chunk contributions; chunk_decay:
    (B, NC, H) per-chunk carry decays; h0: optional (B, H, P, N) state
    before the first chunk (zeros if None). In float32:
    h_c = decay_c · h_{c-1} + S_c. Returns (h_prev (B, NC, H, P, N), the
    state BEFORE each chunk; h_last (B, H, P, N))."""
    B, NC, H, P, N = states.shape
    states = states.float()
    dec = chunk_decay.float()[..., None, None]
    h = (torch.zeros((B, H, P, N), dtype=torch.float32,
                     device=states.device) if h0 is None else h0.float())
    h_prev = torch.empty_like(states)
    for c in range(NC):
        h_prev[:, c] = h
        h = h * dec[:, c] + states[:, c]
    return h_prev, h
