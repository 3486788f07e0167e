"""Launcher of the hand-written Hopper kernel `csrc/al_step.cu`.

Replaces the Pallas TPU kernel `_al_step_kernel`
(`src/repro/kernels/al_step/kernel.py:41`): `k_steps` fused projected-
Adam steps of the CR1/CR2 augmented Lagrangian, with x and the Adam
moments held in registers between steps (hinge ties and the exact day
projection as in `ref.al_step_ref`). A group of 8 lanes holds one
row, each lane a run of ceil(T / 8) consecutive hours, so a warp
carries 4 rows; a warp runs each row kind's code where it holds a row of
that kind (`ops.make_fused_inner` orders the rows by kind, so one warp
runs both), and the days of all of a warp's rows are projected in one
pass loop (`csrc/row_scan.cuh`, `csrc/al_step.cu`). There is no padding
copy.
`scal` stays on the device and the kernel reads it, so mu and t0 never
sync the host. `al_step_cuda.launches` counts the launches.

Lanes: with x of shape (N, W, T) one launch runs N independent solves'
steps (`blockIdx.y` is the lane). x, m, v, rowp (N, W, 12) and scal
(N, 8) are per lane; usage, jobs, lo and hi are (W, T), shared by every
lane, or (N, W, T); cvec is (1, T) or (W, T) shared, or (N, 1, T) or
(N, W, T). A lane computes bit for bit what a one-lane call on its
slices computes.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.al_step.ref import MODES

_MOMENT_DTYPES = (torch.float32, torch.bfloat16)


@functools.cache
def _launch_fn():
    lib = build.load("al_step")
    fn = lib.al_step_lanes_launch
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = ([p] * 9 + [i] + [p] * 4 + [i] * 5 + [f] * 5 + [i] * 7
                   + [p])
    fn.restype = ctypes.c_int
    return lib, fn


def al_step_cuda(x, m, v, usage, jobs, lo, hi, rowp, cvec, scal, *,
                 mode: str, k_steps: int, beta1: float = 0.9,
                 beta2: float = 0.999, eps: float = 1e-8,
                 day_hours: int = 24):
    """`k_steps` fused AL inner steps on CUDA tensors; returns new
    (x, m, v). Same arguments and semantics as `ref.al_step_ref`, with
    an optional leading lane axis (the module docstring)."""
    build.refuse_dtensors("al_step_cuda", x=x, m=m, v=v, usage=usage,
                          jobs=jobs, lo=lo, hi=hi, rowp=rowp, cvec=cvec,
                          scal=scal)
    if mode not in MODES:
        raise ValueError(f"mode must be cr1|cr2, got {mode!r}")
    if x.device.type != "cuda":
        raise ValueError(f"al_step_cuda needs CUDA tensors; got {x.device}")
    if x.dim() not in (2, 3):
        raise ValueError(f"x must be (W, T) or (N, W, T); got shape "
                         f"{tuple(x.shape)}")
    lead = tuple(x.shape[:-2])
    N = lead[0] if lead else 1
    W, T = x.shape[-2:]
    build.check_hours(T)
    if m.dtype not in _MOMENT_DTYPES or v.dtype != m.dtype:
        raise ValueError(f"moments must both be float32 or bfloat16; got "
                         f"{m.dtype}, {v.dtype}")
    if k_steps < 1 or day_hours < 1:
        raise ValueError("k_steps and day_hours must be >= 1")
    day_hours = min(day_hours, T)  # a horizon under a day is one day
    dev = x.device
    build.check_operand("x", x, torch.float32, lead + (W, T), dev)
    build.check_operand("m", m, m.dtype, lead + (W, T), dev)
    build.check_operand("v", v, m.dtype, lead + (W, T), dev)
    build.check_operand("rowp", rowp, torch.float32, lead + (W, 12), dev)
    build.check_operand("scal", scal, torch.float32, (N, 8), dev)
    strides = []        # lane strides of usage, jobs, lo, hi, cvec
    for name, t in (("usage", usage), ("jobs", jobs), ("lo", lo),
                    ("hi", hi)):
        own = lead and t.dim() == 3
        build.check_operand(name, t, torch.float32,
                            (lead if own else ()) + (W, T), dev)
        strides.append(W * T if own else 0)
    cvec_rows = 1 if cvec.shape[-2] == 1 else W
    own = lead and cvec.dim() == 3
    build.check_operand("cvec", cvec, torch.float32,
                        (lead if own else ()) + (cvec_rows, T), dev)
    cvec_stride = 0 if cvec_rows == 1 else T
    strides.append(cvec_rows * T if own else 0)
    x_out = torch.empty_like(x)
    m_out = torch.empty_like(m)
    v_out = torch.empty_like(v)
    if W == 0 or N == 0:
        return x_out, m_out, v_out
    lib, fn = _launch_fn()
    with torch.cuda.device(dev):
        err = fn(x.data_ptr(), m.data_ptr(), v.data_ptr(), usage.data_ptr(),
                 jobs.data_ptr(), lo.data_ptr(), hi.data_ptr(),
                 rowp.data_ptr(), cvec.data_ptr(), cvec_stride,
                 scal.data_ptr(), x_out.data_ptr(), m_out.data_ptr(),
                 v_out.data_ptr(), W, T, MODES.index(mode), k_steps,
                 day_hours, beta1, beta2, 1.0 - beta1, 1.0 - beta2, eps,
                 int(m.dtype == torch.bfloat16), N, *strides,
                 torch.cuda.current_stream(dev).cuda_stream)
    build.check(lib, err, "al_step")
    al_step_cuda.launches += 1
    return x_out, m_out, v_out


al_step_cuda.launches = 0
