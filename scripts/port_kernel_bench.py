#!/usr/bin/env python3
"""Time the flash_attention and rmsnorm kernels of this tree against those
of other source trees, on one CUDA card, in turns, and write the record.

    mkdir -p build/parent
    git archive <commit> src/repro_torch/csrc | tar -x -C build/parent
    python3 scripts/port_kernel_bench.py --tree before=build/parent \\
        [--out var/BENCH_port_kernels.json]

Each `--tree LABEL=DIR` names a tree whose `src/repro_torch/csrc/` holds
`flash_attention.cu` and `rmsnorm.cu` with this tree's C interface
(`flash_attention_launch`, `rmsnorm_launch`); they are built with this
tree's nvcc flags into `build/bench_<LABEL>/`. This tree's own kernels are
the "after" tree. At every shape of the serving paths (chip_smoke.py's
flash-attention serving shape and 1024-token case, and its rmsnorm rows)
each tree's output is held against the plain version, and the trees are
timed in turns (every tree, then every tree in reverse order) with
chip_smoke.py's `kernel_ms`, beside the one PyTorch call that computes
the same function and the bound. Needs a CUDA card; imports no JAX.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import math
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402


def build_tree(label: str, tree: pathlib.Path) -> dict[str, ctypes.CDLL]:
    from repro_torch.kernels import build
    out = ROOT / "build" / f"bench_{label}"
    out.mkdir(parents=True, exist_ok=True)
    libs, procs = {}, {}
    for name in ("flash_attention", "rmsnorm"):
        lib = out / f"lib{name}.so"
        src = tree / "src" / "repro_torch" / "csrc" / f"{name}.cu"
        procs[name] = (subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-o", str(lib), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {label}/{name}:\n{log}")
        libs[name] = ctypes.CDLL(str(lib))
    return libs


def fa_caller(torch, lib, q, k, v, causal):
    fn = lib.flash_attention_launch
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p] * 4 + [i] * 10 + [ctypes.c_float, i, p]
    B, Sq, H, Dh = q.shape
    Skv, KV, Dv = k.shape[1], k.shape[2], v.shape[-1]
    out = torch.empty((B, Sq, H, Dv), dtype=q.dtype, device=q.device)
    stream = torch.cuda.current_stream().cuda_stream
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Sq,
            Skv, H, KV, Dh, Dv, 0, int(causal), 1, 1.0 / math.sqrt(Dh), 1,
            stream)

    def call():
        err = fn(*args)
        if err:
            raise RuntimeError(f"flash_attention launch: cudaError_t {err}")
        return out
    return call


def rms_caller(torch, lib, x, scale):
    fn = lib.rmsnorm_launch
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, p, i, i, ctypes.c_float, i, i, p]
    out = torch.empty_like(x)
    stream = torch.cuda.current_stream().cuda_stream
    args = (x.data_ptr(), scale.data_ptr(), out.data_ptr(), x.shape[0],
            x.shape[1], 1e-6, 1, 1, stream)

    def call():
        err = fn(*args)
        if err:
            raise RuntimeError(f"rmsnorm launch: cudaError_t {err}")
        return out
    return call


def in_turns(torch, calls: dict, reps: int) -> dict[str, list[float]]:
    """Each tree timed twice: every tree in order, then in reverse."""
    times = {label: [] for label in calls}
    for label in [*calls, *reversed(list(calls))]:
        times[label].append(cs.kernel_ms(torch, calls[label], reps=reps))
    return times


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", action="append", default=[],
                    metavar="LABEL=DIR", help="another source tree")
    ap.add_argument("--out", default="var/BENCH_port_kernels.json")
    args = ap.parse_args()
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        print("port_kernel_bench: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref
    host = cs.phase_device(torch)
    trees = {}
    for spec in args.tree:
        label, _, path = spec.partition("=")
        trees[label] = build_tree(label, (ROOT / path).resolve())
    build.build_all(("flash_attention", "rmsnorm"))
    trees["after"] = {n: build.load(n) for n in ("flash_attention", "rmsnorm")}
    dev = torch.device("cuda")
    rows = []

    for n in (0, cs.FA_LONG):
        case = cs.FA_CASES[n]
        B, Sq, Skv, H, KV, Dh, Dv, causal, q_offset, _ = case
        q, k, v = cs.fa_inputs(torch, case, seed=n, dev=dev)
        want = attention_ref(q, k, v, causal=causal)
        calls, errs = {}, {}
        for label, libs in trees.items():
            calls[label] = fa_caller(torch, libs["flash_attention"], q, k, v,
                                     causal)
            got = calls[label]()
            torch.cuda.synchronize()
            errs[label] = float((got.float() - want.float()).abs().max())
            cs.require(torch.allclose(got.float(), want.float(), rtol=2e-2,
                                      atol=2e-2),
                       f"flash_attention {label} {case}: error {errs[label]}")
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        lib_ms = cs.kernel_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal))
        pairs = B * H * cs.fa_live_pairs(Sq, Skv, causal, q_offset)
        nbytes = (q.numel() + k.numel() + v.numel() + B * Sq * H * Dv) * 2
        b_ms, b_by = cs.bound(nbytes, pairs * 2 * (Dh + Dv),
                              cs.H100_BF16_OPS_PER_S)
        rows.append({"name": "flash_attention", "shape": list(case[:9]),
                     "dtype": "bfloat16", "max_abs_err": errs,
                     "us": {lb: [t * 1e3 for t in ts] for lb, ts in
                            in_turns(torch, calls, 50).items()},
                     "library": "F.scaled_dot_product_attention",
                     "library_us": lib_ms * 1e3, "bound_us": b_ms * 1e3,
                     "bound_by": b_by})
        cs.log(json.dumps(rows[-1]))

    gen = torch.Generator(device=dev).manual_seed(0)
    for N, d in cs.RMSNORM_ROWS:
        x = (1.5 * torch.randn((N, d), generator=gen, device=dev)).bfloat16()
        scale = 1.0 + 0.1 * torch.randn(d, generator=gen, device=dev)
        want = rmsnorm_ref(x, scale)
        calls, errs = {}, {}
        for label, libs in trees.items():
            calls[label] = rms_caller(torch, libs["rmsnorm"], x, scale)
            got = calls[label]()
            torch.cuda.synchronize()
            errs[label] = float((got.float() - want.float()).abs().max())
            cs.require(torch.allclose(got.float(), want.float(),
                                      rtol=2.0 ** -7, atol=1e-6),
                       f"rmsnorm {label} ({N}, {d}): error {errs[label]}")
        w = scale.bfloat16()
        lib_ms = cs.kernel_ms(torch, lambda: F.rms_norm(x, (d,), w, 1e-6),
                              reps=100)
        b_ms, b_by = cs.bound(2 * x.numel() * 2 + d * 4, 4 * x.numel(),
                              cs.H100_F32_OPS_PER_S)
        rows.append({"name": "rmsnorm", "shape": [N, d], "dtype": "bfloat16",
                     "max_abs_err": errs,
                     "us": {lb: [t * 1e3 for t in ts] for lb, ts in
                            in_turns(torch, calls, 100).items()},
                     "library": "F.rms_norm", "library_us": lib_ms * 1e3,
                     "bound_us": b_ms * 1e3, "bound_by": b_by})
        cs.log(json.dumps(rows[-1]))

    record = {
        "host": host, "device": torch.cuda.get_device_name(0),
        "torch": torch.__version__, "cuda": torch.version.cuda,
        "script": "scripts/port_kernel_bench.py",
        "timing": "chip_smoke.kernel_ms: median over windows of 20 calls "
                  "back to back after a spin kernel, CUDA events; each tree "
                  "timed twice, in turns",
        "trees": {label: spec.partition("=")[2] for spec in args.tree
                  for label in [spec.partition("=")[0]]} | {"after": "."},
        "rows": rows}
    out = ROOT / args.out
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(record, indent=1) + "\n")
    cs.log(f"[bench] wrote {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
