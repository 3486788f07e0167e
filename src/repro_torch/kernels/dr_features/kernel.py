"""Launcher of the hand-written Hopper kernel `csrc/dr_features.cu`.

Replaces the Pallas TPU kernel `_features_kernel`
(`src/repro/kernels/dr_features/kernel.py:26`). The kernel is bound by
bytes (it reads d, usage and jobs once and writes (W, 4)); a group of
8 lanes holds one row, each lane a run of ceil(T / 8) consecutive
hours, so a warp carries 4 rows and there is no padding copy
(`csrc/row_scan.cuh`). `dr_features_cuda.launches` counts the launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build


@functools.cache
def _launch_fn():
    lib = build.load("dr_features")
    fn = lib.dr_features_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, fn


def dr_features_cuda(d: torch.Tensor, usage: torch.Tensor,
                     jobs: torch.Tensor) -> torch.Tensor:
    """(W, T) f32 CUDA tensors -> (W, 4) f32 features, on the current
    stream. Raises on anything the kernel does not take."""
    build.refuse_dtensors("dr_features_cuda", d=d, usage=usage, jobs=jobs)
    if d.device.type != "cuda":
        raise ValueError(
            f"dr_features_cuda needs CUDA tensors; got {d.device}")
    if d.dim() != 2:
        raise ValueError(f"d must be (W, T); got shape {tuple(d.shape)}")
    W, T = d.shape
    build.check_hours(T)
    for name, t in (("d", d), ("usage", usage), ("jobs", jobs)):
        build.check_operand(name, t, torch.float32, (W, T), d.device)
    out = torch.empty((W, 4), dtype=torch.float32, device=d.device)
    if W == 0:
        return out
    lib, fn = _launch_fn()
    with torch.cuda.device(d.device):
        err = fn(d.data_ptr(), usage.data_ptr(), jobs.data_ptr(),
                 out.data_ptr(), W, T,
                 torch.cuda.current_stream(d.device).cuda_stream)
    build.check(lib, err, "dr_features")
    dr_features_cuda.launches += 1
    return out


dr_features_cuda.launches = 0
