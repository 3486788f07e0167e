"""Build the CUDA kernels at first use and load them with `ctypes`.

Each source `repro_torch/csrc/<name>.cu` compiles with its own `nvcc`
into `build/torch_ext/lib<name>_<digest>.so` at the repository root. The
digest covers the source, the shared headers and the flags, so an edited
source builds anew and a stale library is never loaded. The libraries
have a plain C interface (no PyTorch headers), which keeps a build to
seconds. `build_all` starts one `nvcc` per source, all at once.

A failed build raises with the compiler's output; nothing falls back to a
plain version.

`BUILDS` counts the libraries this process compiled and the libraries it
loaded; `analysis.recompile_guard` reads it (a warm path builds and loads
nothing).
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "torch_ext"
KERNELS = ("dr_features", "al_step", "rmsnorm", "flash_attention",
           "ssd_scan")
MAX_HOURS = 64  # a row on 8 lanes, at most 8 hours a lane (row_scan.cuh)
#: Kernel libraries compiled or loaded in this process.
BUILDS = 0
NVCC_FLAGS = ("-O3", "-std=c++17", "-gencode", "arch=compute_90a,code=sm_90a",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = pathlib.Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_path(name: str) -> pathlib.Path:
    """Where the library of `csrc/<name>.cu` lives for the current sources."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def build_all(names=KERNELS) -> dict[str, str]:
    """Compile every library that is missing, one `nvcc` per source, all
    started together. Returns each kernel's `ptxas` report (registers,
    spills) for the libraries built by this call."""
    global BUILDS
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    jobs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, prefix=out.stem,
                                   suffix=".tmp.so")
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
        jobs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      tmp, out)
    reports, failed = {}, []
    for name, (proc, tmp, out) in jobs.items():
        log, _ = proc.communicate()
        reports[name] = log
        if proc.returncode == 0:
            os.replace(tmp, out)
            BUILDS += 1
        else:
            os.unlink(tmp)
            failed.append(f"{name} (exit {proc.returncode}):\n{log}")
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return reports


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, built first if missing."""
    global BUILDS
    path = library_path(name)
    if not path.exists():
        build_all((name,))
    lib = ctypes.CDLL(str(path))
    BUILDS += 1
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise on a nonzero `cudaError_t` returned by a launch function."""
    if err:
        lib.kernel_error_string.restype = ctypes.c_char_p
        msg = lib.kernel_error_string(ctypes.c_int(err)).decode()
        raise RuntimeError(f"{what} launch failed: cudaError_t {err} ({msg})")


def refuse_dtensors(what: str, **operands) -> None:
    """A kernel takes plain tensors: each rank's own rows and gathered
    weights. `TypeError` naming the launcher and the operand for a
    DTensor (its pointer would be the wrapper's, not a block's)."""
    import torch.distributed
    if not torch.distributed.is_available():
        return
    from torch.distributed.tensor import DTensor
    for name, t in operands.items():
        if isinstance(t, DTensor):
            raise TypeError(
                f"{what} takes plain tensors; operand {name!r} is a "
                f"DTensor (pass its to_local() block or a gathered "
                f"tensor)")


def check_operand(name: str, t, dtype, shape, device) -> None:
    """Validate one kernel operand before its pointer goes to C."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def check_hours(T: int) -> None:
    """The fleet kernels keep a row on 8 lanes, at most 8 hours a lane."""
    if T > MAX_HOURS:
        raise ValueError(f"the CUDA kernels take T <= {MAX_HOURS} hours "
                         f"per row; got T = {T}")
