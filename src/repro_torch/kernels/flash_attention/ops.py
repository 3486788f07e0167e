"""Device dispatch for flash attention in the model's layout.

A CUDA tensor goes through the hand-written kernel, a CPU tensor through
the plain version; `use_kernel=False` asks for the plain version on the
card (the comparisons in `chip_smoke.py` do). Nothing falls back from one
to the other.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
from repro_torch.kernels.flash_attention.ref import attention_ref


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, q_offset: int = 0,
                    use_kernel: bool | None = None) -> torch.Tensor:
    """q: (B, Sq, H, Dh); k/v: (B, Skv, KV, Dh/Dv) -> (B, Sq, H, Dv)."""
    if use_kernel is None:
        use_kernel = q.device.type == "cuda"
    if not use_kernel:
        return attention_ref(q, k, v, causal=causal, q_offset=q_offset)
    return flash_attention_cuda(q.contiguous(), k.contiguous(),
                                v.contiguous(), causal=causal,
                                q_offset=q_offset)
