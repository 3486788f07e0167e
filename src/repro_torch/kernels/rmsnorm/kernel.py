"""Launcher of the hand-written Hopper kernel `csrc/rmsnorm.cu`.

Replaces the Pallas TPU kernel `_rmsnorm_kernel`
(`src/repro/kernels/rmsnorm/kernel.py:20`). The kernel is bound by bytes
(each row read and written once, the scale once per block); a warp (or a
group of warps, for wide rows) holds one row in registers, so there is no
row tile to pad. `rmsnorm_cuda.launches` counts the launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

DTYPES = (torch.float32, torch.bfloat16)  # index = the C dtype code
# A row lives in the registers of at most 8 warps, 16 load units a lane: a
# unit is a 16-byte vector (8 bf16, 4 f32), or one element where the row is
# no whole number of aligned vectors.
MAX_UNITS = 8 * 32 * 16


@functools.cache
def _launch_fn():
    lib = build.load("rmsnorm")
    fn = lib.rmsnorm_launch
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, p, i, i, ctypes.c_float, i, i, p]
    fn.restype = ctypes.c_int
    return lib, fn


def rmsnorm_cuda(x: torch.Tensor, scale: torch.Tensor,
                 eps: float = 1e-6) -> torch.Tensor:
    """(N, d) float32 or bfloat16 CUDA rows, (d,) float32 scale -> (N, d)
    in x's dtype, on the current stream. Raises on anything the kernel
    does not take."""
    build.refuse_dtensors("rmsnorm_cuda", x=x, scale=scale)
    if x.device.type != "cuda":
        raise ValueError(f"rmsnorm_cuda needs CUDA tensors; got {x.device}")
    if x.dim() != 2:
        raise ValueError(f"x must be (N, d); got shape {tuple(x.shape)}")
    if x.dtype not in DTYPES:
        raise ValueError(f"x must be float32 or bfloat16; got {x.dtype}")
    N, d = x.shape
    build.check_operand("x", x, x.dtype, (N, d), x.device)
    build.check_operand("scale", scale, torch.float32, (d,), x.device)
    out = torch.empty_like(x)
    if N == 0 or d == 0:
        return out
    vec = 16 // x.element_size()
    vectorised = int(d % vec == 0 and x.data_ptr() % 16 == 0
                     and out.data_ptr() % 16 == 0)
    if (d // vec if vectorised else d) > MAX_UNITS:
        raise ValueError(f"rmsnorm_cuda takes rows of at most {MAX_UNITS} "
                         f"load units ({MAX_UNITS * vec} {x.dtype} elements "
                         f"when 16-byte aligned); got d = {d}")
    lib, fn = _launch_fn()
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), scale.data_ptr(), out.data_ptr(), N, d, eps,
                 DTYPES.index(x.dtype), vectorised,
                 torch.cuda.current_stream(x.device).cuda_stream)
    build.check(lib, err, "rmsnorm")
    rmsnorm_cuda.launches += 1
    return out


rmsnorm_cuda.launches = 0
