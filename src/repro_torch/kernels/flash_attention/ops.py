"""Device dispatch for flash attention in the model's layout.

A CUDA tensor goes through the hand-written kernel, a CPU tensor through
the plain version; `use_kernel=False` asks for the plain version on the
card (the comparisons in `chip_smoke.py` do). Nothing falls back from one
to the other. Under autograd the kernel runs inside `FlashAttentionFn`,
which has it write each query row's log-sum-exp and whose backward is the
closed form of `grad.py`; the plain version is differentiated by
autograd. Outside autograd (serving) the kernel gets no buffer.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.grad import attention_bwd
from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
from repro_torch.kernels.flash_attention.ref import attention_ref


class FlashAttentionFn(torch.autograd.Function):
    """The kernel forward with its log-sum-exp; the closed-form backward
    (`grad.attention_bwd`)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, q_offset):
        out, lse = flash_attention_cuda(q, k, v, causal=causal,
                                        q_offset=q_offset, with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.q_offset = causal, q_offset
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = attention_bwd(q, k, v, out, lse, dout,
                                   causal=ctx.causal, q_offset=ctx.q_offset)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, q_offset: int = 0,
                    use_kernel: bool | None = None) -> torch.Tensor:
    """q: (B, Sq, H, Dh); k/v: (B, Skv, KV, Dh/Dv) -> (B, Sq, H, Dv)."""
    if use_kernel is None:
        use_kernel = q.device.type == "cuda"
    if not use_kernel:
        return attention_ref(q, k, v, causal=causal, q_offset=q_offset)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FlashAttentionFn.apply(q, k, v, causal, q_offset)
    return flash_attention_cuda(q, k, v, causal=causal, q_offset=q_offset)
