"""Launcher of the hand-written Hopper kernel `csrc/ssd_scan.cu`.

Replaces the Pallas TPU kernel `_ssd_scan_kernel`
(`src/repro/kernels/ssd_scan/kernel.py:24`): the Mamba-2 inter-chunk
recurrence h_c = decay_c · h_{c-1} + S_c, returning the state before each
chunk and the last state. The kernel is bound by bytes (states read once,
h_prev and h_last written once); each thread carries a float4 of the
(P, N) state in registers across the chunk loop, or one float where a
(b, c, h) row is no whole number of 16-byte vectors (then no row is
16-byte aligned, and the kernel runs scalar). `ssd_scan_bwd_cuda`
launches the backward kernel of the same source: the recurrence in
reverse, on the same grid and with the same vectorised/scalar switch.
The JAX package has no backward kernel (its model differentiates its
inline `lax.scan`, `src/repro/models/ssm.py:129`). Each wrapper's
`.launches` counts its launches.
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


@functools.cache
def _bwd_fns():
    lib = build.load("ssd_scan")
    fn, blocks = lib.ssd_scan_bwd_launch, lib.ssd_scan_blocks
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p] * 7 + [i] * 5 + [p]
    fn.restype = ctypes.c_int
    blocks.argtypes = [i, i]
    blocks.restype = ctypes.c_int
    return lib, fn, blocks


def bwd_blocks(PN: int, vectorised: bool) -> int:
    """Blocks of the backward's grid along P·N: the leading extent of its
    partial sums of the decay gradient."""
    return _bwd_fns()[2](PN, int(vectorised))


def _check_dims(t: torch.Tensor, name: str):
    if t.device.type != "cuda":
        raise ValueError(f"ssd_scan_cuda needs CUDA tensors; got {t.device}")
    if t.dim() != 5:
        raise ValueError(f"{name} must be (B, NC, H, P, N); got shape "
                         f"{tuple(t.shape)}")
    B, NC, H, P, N = t.shape
    if B > MAX_GRID_YZ or H > MAX_GRID_YZ:
        raise ValueError(f"B and H must be <= {MAX_GRID_YZ}; got {B}, {H}")
    return B, NC, H, P, N


def ssd_scan_cuda(states: torch.Tensor, chunk_decay: torch.Tensor,
                  h0: torch.Tensor | None = None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """states (B, NC, H, P, N), chunk_decay (B, NC, H) and h0 (B, H, P, N)
    or None: contiguous float32 CUDA tensors -> (h_prev (B, NC, H, P, N),
    h_last (B, H, P, N)) float32, on the current stream. Raises on
    anything the kernel does not take."""
    build.refuse_dtensors("ssd_scan_cuda", states=states,
                          chunk_decay=chunk_decay, h0=h0)
    B, NC, H, P, N = _check_dims(states, "states")
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


def ssd_scan_bwd_cuda(g_prev: torch.Tensor | None,
                      g_last: torch.Tensor | None, chunk_decay: torch.Tensor,
                      h_prev: torch.Tensor, has_h0: bool
                      ) -> tuple[torch.Tensor, torch.Tensor,
                                 torch.Tensor | None]:
    """The backward of `ssd_scan_cuda`: g_prev (B, NC, H, P, N) and g_last
    (B, H, P, N), the gradients of h_prev and h_last, or None for zeros;
    the forward's chunk_decay (B, NC, H) and h_prev: contiguous float32
    CUDA tensors -> (dstates (B, NC, H, P, N), ddecay (B, NC, H), dh0 (B,
    H, P, N) where `has_h0`, else None), float32, on the current stream.
    dstates and dh0 are bitwise `ssd_scan_bwd_ref`'s; ddecay sums the
    same f32 products in double. Raises on anything the kernel does not
    take."""
    build.refuse_dtensors("ssd_scan_bwd_cuda", g_prev=g_prev, g_last=g_last,
                          chunk_decay=chunk_decay, h_prev=h_prev)
    B, NC, H, P, N = _check_dims(h_prev, "h_prev")
    dev, f32 = h_prev.device, torch.float32
    build.check_operand("h_prev", h_prev, f32, (B, NC, H, P, N), dev)
    build.check_operand("chunk_decay", chunk_decay, f32, (B, NC, H), dev)
    if g_prev is not None:
        build.check_operand("g_prev", g_prev, f32, (B, NC, H, P, N), dev)
    if g_last is not None:
        build.check_operand("g_last", g_last, f32, (B, H, P, N), dev)
    dstates = torch.empty_like(h_prev)
    dh0 = torch.empty((B, H, P, N), dtype=f32, device=dev) if has_h0 \
        else None
    if B * H * P * N == 0:
        return dstates, torch.zeros((B, NC, H), dtype=f32, device=dev), dh0
    PN = P * N
    ptrs = [t.data_ptr() for t in (g_prev, g_last, h_prev, dstates, dh0)
            if t is not None]
    vectorised = int(PN % 4 == 0 and all(p % 16 == 0 for p in ptrs))
    lib, fn, _ = _bwd_fns()
    partial = torch.empty((bwd_blocks(PN, vectorised), B, NC, H),
                          dtype=torch.float64, device=dev)

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(dev):
        err = fn(ptr(g_prev), ptr(g_last), chunk_decay.data_ptr(),
                 h_prev.data_ptr(), dstates.data_ptr(), ptr(dh0),
                 partial.data_ptr(), B, NC, H, PN, vectorised,
                 torch.cuda.current_stream(dev).cuda_stream)
    build.check(lib, err, "ssd_scan")
    ssd_scan_bwd_cuda.launches += 1
    return dstates, partial.sum(dim=0).float(), dh0


ssd_scan_bwd_cuda.launches = 0
