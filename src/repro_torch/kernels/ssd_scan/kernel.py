"""Launcher of the hand-written Hopper kernel `csrc/ssd_scan.cu`.

Replaces the Pallas TPU kernel `_ssd_scan_kernel`
(`src/repro/kernels/ssd_scan/kernel.py:24`): the Mamba-2 inter-chunk
recurrence h_c = decay_c · h_{c-1} + S_c, returning the state before each
chunk and the last state. The kernel is bound by bytes (states read once,
h_prev and h_last written once); each thread carries a float4 of the
(P, N) state in registers across the chunk loop, or one float where a
(b, c, h) row is no whole number of 16-byte vectors (then no row is
16-byte aligned, and the kernel runs scalar). `ssd_scan_cuda.launches`
counts the launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

MAX_GRID_YZ = 65535          # H and B are the grid's y and z extents


@functools.cache
def _launch_fn():
    lib = build.load("ssd_scan")
    fn = lib.ssd_scan_launch
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p] * 5 + [i] * 5 + [p]
    fn.restype = ctypes.c_int
    return lib, fn


def ssd_scan_cuda(states: torch.Tensor, chunk_decay: torch.Tensor,
                  h0: torch.Tensor | None = None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """states (B, NC, H, P, N), chunk_decay (B, NC, H) and h0 (B, H, P, N)
    or None: contiguous float32 CUDA tensors -> (h_prev (B, NC, H, P, N),
    h_last (B, H, P, N)) float32, on the current stream. Raises on
    anything the kernel does not take."""
    if states.device.type != "cuda":
        raise ValueError(
            f"ssd_scan_cuda needs CUDA tensors; got {states.device}")
    if states.dim() != 5:
        raise ValueError(f"states must be (B, NC, H, P, N); got shape "
                         f"{tuple(states.shape)}")
    B, NC, H, P, N = states.shape
    if B > MAX_GRID_YZ or H > MAX_GRID_YZ:
        raise ValueError(f"B and H must be <= {MAX_GRID_YZ}; got {B}, {H}")
    dev, f32 = states.device, torch.float32
    build.check_operand("states", states, f32, (B, NC, H, P, N), dev)
    build.check_operand("chunk_decay", chunk_decay, f32, (B, NC, H), dev)
    if h0 is not None:
        build.check_operand("h0", h0, f32, (B, H, P, N), dev)
    h_prev = torch.empty_like(states)
    h_last = torch.empty((B, H, P, N), dtype=f32, device=dev)
    if h_last.numel() == 0:
        return h_prev, h_last
    PN = P * N
    ptrs = [t.data_ptr() for t in (states, h_prev, h_last)]
    if h0 is not None:
        ptrs.append(h0.data_ptr())
    vectorised = int(PN % 4 == 0 and all(p % 16 == 0 for p in ptrs))
    lib, fn = _launch_fn()
    with torch.cuda.device(dev):
        err = fn(states.data_ptr(), chunk_decay.data_ptr(),
                 None if h0 is None else h0.data_ptr(), h_prev.data_ptr(),
                 h_last.data_ptr(), B, NC, H, PN, vectorised,
                 torch.cuda.current_stream(dev).cuda_stream)
    build.check(lib, err, "ssd_scan")
    ssd_scan_cuda.launches += 1
    return h_prev, h_last


ssd_scan_cuda.launches = 0
