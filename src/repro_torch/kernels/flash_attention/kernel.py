"""Launcher of the hand-written Hopper kernel `csrc/flash_attention.cu`.

Replaces the Pallas TPU kernel `_fa_kernel`
(`src/repro/kernels/flash_attention/kernel.py:28`): FA2-style forward
attention with an online softmax over kv blocks, causal masking against
`q_offset` with the blocks above the diagonal skipped, GQA, `Dv != Dh`
and masked tails. It reads the model's (B, S, heads, D) layout in place,
so neither the transposes nor the padding copies of the TPU wrapper
remain. bfloat16 runs its products on the tensor cores, float32 on the
CUDA cores. `flash_attention_cuda.launches` counts the launches.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import build

DTYPES = (torch.float32, torch.bfloat16)  # index = the C dtype code
# Head widths the kernel takes: Dh (q, k) up to 192 and Dv (v, out) up to
# 128, MLA's 128 + 64 and 128 (the TPU kernel takes up to 256).
MAX_DH, MAX_DV = 192, 128


@functools.cache
def _launch_fn():
    lib = build.load("flash_attention")
    fn = lib.flash_attention_launch
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p] * 4 + [i] * 10 + [ctypes.c_float, i, p, p]
    fn.restype = ctypes.c_int
    return lib, fn


def bf16_blocks_per_sm(Dh: int, Dv: int) -> int:
    """Blocks of the bfloat16 kernel that share one SM at these head
    widths, as the CUDA occupancy calculator reports it."""
    lib, _ = _launch_fn()
    fn = lib.flash_attention_bf16_blocks_per_sm
    fn.argtypes = [ctypes.c_int, ctypes.c_int]
    fn.restype = ctypes.c_int
    n = fn(Dh, Dv)
    if n < 0:
        build.check(lib, -n, "flash_attention occupancy")
    return n


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, q_offset: int = 0,
                         with_lse: bool = False):
    """q (B, Sq, H, Dh), k (B, Skv, KV, Dh), v (B, Skv, KV, Dv): contiguous
    CUDA tensors of one dtype (float32 or bfloat16), H % KV == 0,
    Dh <= 192 and Dv <= 128 -> (B, Sq, H, Dv), on the current stream. `with_lse`
    also returns each query row's f32 log-sum-exp of its scaled scores,
    (B, H, Sq), which the backward reads; the output is the same bits
    with or without it."""
    build.refuse_dtensors("flash_attention_cuda", q=q, k=k, v=v)
    if q.device.type != "cuda":
        raise ValueError(
            f"flash_attention_cuda needs CUDA tensors; got {q.device}")
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k and v must be (B, S, heads, D)")
    if q.dtype not in DTYPES:
        raise ValueError(f"q must be float32 or bfloat16; got {q.dtype}")
    B, Sq, H, Dh = q.shape
    Skv, KV, Dv = k.shape[1], k.shape[2], v.shape[-1]
    if KV < 1 or H % KV:
        raise ValueError(f"H = {H} query heads need a multiple of KV = {KV}")
    if not (0 < Dh <= MAX_DH and 0 < Dv <= MAX_DV):
        raise ValueError(f"head dims must be Dh in 1..{MAX_DH} and Dv in "
                         f"1..{MAX_DV}; got Dh = {Dh}, Dv = {Dv}")
    build.check_operand("q", q, q.dtype, (B, Sq, H, Dh), q.device)
    build.check_operand("k", k, q.dtype, (B, Skv, KV, Dh), q.device)
    build.check_operand("v", v, q.dtype, (B, Skv, KV, Dv), q.device)
    out = torch.empty((B, Sq, H, Dv), dtype=q.dtype, device=q.device)
    lse = (torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    if out.numel() == 0:
        return (out, lse) if with_lse else out
    per_vec = 16 // q.element_size()        # 16-byte loads of whole rows
    vec = int(Dh % per_vec == 0 and Dv % per_vec == 0
              and all(t.data_ptr() % 16 == 0 for t in (q, k, v)))
    lib, fn = _launch_fn()
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 B, Sq, Skv, H, KV, Dh, Dv, int(q_offset), int(bool(causal)),
                 vec, 1.0 / math.sqrt(Dh), DTYPES.index(q.dtype),
                 torch.cuda.current_stream(q.device).cuda_stream,
                 None if lse is None else lse.data_ptr())
    build.check(lib, err, "flash_attention")
    flash_attention_cuda.launches += 1
    return (out, lse) if with_lse else out


flash_attention_cuda.launches = 0
