"""Plain PyTorch versions of the SSD inter-chunk scan kernel (the port of
the JAX package's oracle `repro/kernels/ssd_scan/ref.py`) and of its
backward kernel."""
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


def ssd_scan_bwd_ref(g_prev: torch.Tensor | None, g_last: torch.Tensor | None,
                     chunk_decay: torch.Tensor, h_prev: torch.Tensor,
                     has_h0: bool
                     ) -> tuple[torch.Tensor, torch.Tensor,
                                torch.Tensor | None]:
    """The backward of `ssd_scan_ref`: the same recurrence run in reverse.
    g_prev (B, NC, H, P, N) and g_last (B, H, P, N) are the gradients of
    h_prev and h_last (None: zeros); chunk_decay (B, NC, H) and h_prev are
    the forward's. With a = g_last, for c = NC-1 ... 0:

        dstates[c] = a
        ddecay[c]  = Σ_{P,N} a · h_prev[c]
        a          = g_prev[c] + decay[c] · a

    and dh0 = a at the end (None unless `has_h0`). In float32, the product
    and the sum rounded separately, as autograd through `ssd_scan_ref`
    forms them. Returns (dstates, ddecay, dh0)."""
    B, NC, H, P, N = h_prev.shape
    dec = chunk_decay.float()[..., None, None]
    a = (torch.zeros((B, H, P, N), dtype=torch.float32,
                     device=h_prev.device) if g_last is None
         else g_last.float())
    dstates = torch.empty_like(h_prev, dtype=torch.float32)
    ddecay = torch.empty((B, NC, H), dtype=torch.float32,
                         device=h_prev.device)
    for c in range(NC - 1, -1, -1):
        dstates[:, c] = a
        ddecay[:, c] = (a * h_prev[:, c]).sum(dim=(-2, -1))
        a = a * dec[:, c]
        if g_prev is not None:
            a = g_prev[:, c].float() + a
    return dstates, ddecay, (a if has_h0 else None)
