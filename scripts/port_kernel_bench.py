#!/usr/bin/env python3
"""Time the kernels of this tree against those of other source trees, on
one CUDA card, in turns, and write the record.

    mkdir -p build/parent
    git archive <commit> src/repro_torch/csrc | tar -x -C build/parent
    python3 scripts/port_kernel_bench.py --kernels fleet \\
        --tree before=build/parent [--out var/BENCH_port_fleet_kernels.json]
    python3 scripts/port_kernel_bench.py --kernels serving \\
        --tree before=build/parent [--out var/BENCH_port_kernels.json]

Each `--tree LABEL=DIR` names a tree whose `src/repro_torch/csrc/` holds
the chosen kernels' sources with this tree's C interface
(`al_step_launch` and `dr_features_launch` for `fleet`,
`flash_attention_launch` and `rmsnorm_launch` for `serving`); they are
built with this tree's nvcc flags into `build/bench_<LABEL>/`, all at
once; a tree that does not build is reported, left out, and makes the
exit code 1. This tree's own kernels are the "after" tree. Each tree's
output is first held against the plain version, then the trees are
timed in turns (every tree, then every tree in reverse order) with
chip_smoke.py's `kernel_ms`, beside the bound and, where one exists, the
one PyTorch call that computes the same function. Shapes:

  fleet: al_step on chip_smoke.py's W = 10,000 x 48 fleet rows
    (hinge-stable, k = 8, f32 moments) in CR1 and CR2 mode: in the
    fleet's own order (kinds interleaved) and ordered by kind (batch
    rows first, as `make_fused_inner` hands them to the kernel); in CR2
    mode also RTS rows first, each kind alone (the batch rows twice
    over; the rows recast as RTS rows), and the at-bounds inputs, whose
    day projection fixes many hours, in both orders; dr_features at W =
    10,000 x 48.
  serving: flash attention at chip_smoke.py's serving shape and its
    1024-token case, rmsnorm at its rows.

Needs a CUDA card; imports no JAX.
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


KERNEL_SETS = {"fleet": ("al_step", "dr_features"),
               "serving": ("flash_attention", "rmsnorm")}
DEFAULT_OUT = {"fleet": "var/BENCH_port_fleet_kernels.json",
               "serving": "var/BENCH_port_kernels.json"}


def start_tree(label: str, tree: pathlib.Path, names) -> dict:
    """One nvcc process per kernel of the tree, started and not waited
    for."""
    from repro_torch.kernels import build
    out = ROOT / "build" / f"bench_{label}"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        lib = out / f"lib{name}.so"
        src = tree / "src" / "repro_torch" / "csrc" / f"{name}.cu"
        procs[name] = (subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-o", str(lib), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    return procs


def finish_tree(label: str, procs: dict) -> dict[str, ctypes.CDLL] | None:
    """The tree's libraries, or None (logged) if one did not build."""
    libs, ok = {}, True
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            cs.log(f"[bench] {label}/{name} does not build; tree left "
                   f"out:\n{log}")
            ok = False
            continue
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                cs.log(f"[bench] {label}/{name}: {line.strip()}")
        libs[name] = ctypes.CDLL(str(lib))
    return libs if ok else None


def checked(fn, name):
    def call():
        err = fn()
        if err:
            raise RuntimeError(f"{name} launch: cudaError_t {err}")
    return call


def fa_caller(torch, lib, q, k, v, causal):
    fn = lib.flash_attention_launch
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p] * 4 + [i] * 10 + [ctypes.c_float, i, p, p]
    B, Sq, H, Dh = q.shape
    Skv, KV, Dv = k.shape[1], k.shape[2], v.shape[-1]
    out = torch.empty((B, Sq, H, Dv), dtype=q.dtype, device=q.device)
    stream = torch.cuda.current_stream().cuda_stream
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Sq,
            Skv, H, KV, Dh, Dv, 0, int(causal), 1, 1.0 / math.sqrt(Dh), 1,
            stream, None)   # no log-sum-exp buffer: the serving call
    return checked(lambda: fn(*args), "flash_attention"), out


def rms_caller(torch, lib, x, scale):
    fn = lib.rmsnorm_launch
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, p, i, i, ctypes.c_float, i, i, p]
    out = torch.empty_like(x)
    stream = torch.cuda.current_stream().cuda_stream
    args = (x.data_ptr(), scale.data_ptr(), out.data_ptr(), x.shape[0],
            x.shape[1], 1e-6, 1, 1, stream)
    return checked(lambda: fn(*args), "rmsnorm"), out


def al_step_caller(torch, lib, args, mode, k_steps):
    """One tree's al_step on `args` (chip_smoke.al_step_inputs' order),
    with the launcher's defaults (betas 0.9, 0.999, eps 1e-8, 24-hour
    days)."""
    from repro_torch.kernels.al_step.ref import MODES
    fn = lib.al_step_launch
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = [p] * 9 + [i] + [p] * 4 + [i] * 5 + [f] * 5 + [i, p]
    x, m, v, usage, jobs, lo, hi, rowp, cvec, scal = args
    W, T = x.shape
    outs = (torch.empty_like(x), torch.empty_like(m), torch.empty_like(v))
    stream = torch.cuda.current_stream().cuda_stream
    cargs = (x.data_ptr(), m.data_ptr(), v.data_ptr(), usage.data_ptr(),
             jobs.data_ptr(), lo.data_ptr(), hi.data_ptr(), rowp.data_ptr(),
             cvec.data_ptr(), 0 if cvec.shape[0] == 1 else T,
             scal.data_ptr(), *(o.data_ptr() for o in outs), W, T,
             MODES.index(mode), k_steps, min(24, T), 0.9, 0.999, 0.1,
             1.0 - 0.999, 1e-8, int(m.dtype == torch.bfloat16), stream)
    return checked(lambda: fn(*cargs), "al_step"), outs


def features_caller(torch, lib, d, u, j):
    fn = lib.dr_features_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 \
        + [ctypes.c_void_p]
    out = torch.empty((d.shape[0], 4), dtype=torch.float32, device=d.device)
    stream = torch.cuda.current_stream().cuda_stream
    cargs = (d.data_ptr(), u.data_ptr(), j.data_ptr(), out.data_ptr(),
             d.shape[0], d.shape[1], stream)
    return checked(lambda: fn(*cargs), "dr_features"), out


def in_turns(torch, calls: dict, reps: int) -> dict[str, list[float]]:
    """Each tree timed twice: every tree in order, then in reverse."""
    times = {label: [] for label in calls}
    for label in [*calls, *reversed(list(calls))]:
        times[label].append(cs.kernel_ms(torch, calls[label], reps=reps))
    return times


def compare_trees(torch, trees, make_call, want, rtol, atol, what):
    """Each tree's call, after its output was held against `want`."""
    calls, errs = {}, {}
    for label, libs in trees.items():
        call, out = make_call(libs)
        call()
        torch.cuda.synchronize()
        outs = out if isinstance(out, tuple) else (out,)
        wants = want if isinstance(want, tuple) else (want,)
        errs[label] = 0.0
        for o, w in zip(outs, wants):
            errs[label] = max(errs[label],
                              float((o.float() - w.float()).abs().max()))
            cs.require(torch.allclose(o.float(), w.float(), rtol=rtol,
                                      atol=atol),
                       f"{what} {label}: error {errs[label]}")
        calls[label] = call
    return calls, errs


def serving_rows(torch, trees):
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref
    dev = torch.device("cuda")
    rows = []
    for n in (0, cs.FA_LONG):
        case = cs.FA_CASES[n]
        B, Sq, Skv, H, KV, Dh, Dv, causal, q_offset, _ = case
        q, k, v = cs.fa_inputs(torch, case, seed=n, dev=dev)
        calls, errs = compare_trees(
            torch, trees, lambda libs: fa_caller(
                torch, libs["flash_attention"], q, k, v, causal),
            attention_ref(q, k, v, causal=causal), 2e-2, 2e-2,
            f"flash_attention {case}")
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
        calls, errs = compare_trees(
            torch, trees, lambda libs: rms_caller(torch, libs["rmsnorm"], x,
                                                  scale),
            rmsnorm_ref(x, scale), 2.0 ** -7, 1e-6, f"rmsnorm ({N}, {d})")
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
    return rows


def fleet_rows(np, torch, trees):
    from repro_torch.kernels.al_step.ref import al_step_ref
    from repro_torch.kernels.dr_features.ref import dr_features_ref
    dev = torch.device("cuda")
    fleet = cs.phase_fleet()[0]
    W, T = cs.W_MAIN, cs.T_MAIN
    rows = []

    def to_dev(arrs):
        return [torch.as_tensor(a, dtype=torch.float32, device=dev)
                for a in arrs]

    def pick(args, idx):
        return [a[idx].contiguous() if a.shape[0] == W else a for a in args]

    stable = to_dev(cs.al_step_inputs(np, fleet, mode="cr2", seed=1,
                                      rts_only=False, stable=True))
    # The same rows ordered by kind: batch rows first, as make_fused_inner
    # orders them, and RTS rows first.
    kind = stable[7][:, 8]
    by_kind = pick(stable, torch.argsort(-kind, stable=True))
    rts_first = pick(stable, torch.argsort(kind, stable=True))
    at_bounds = to_dev(cs.al_step_inputs(np, fleet, mode="cr2", seed=W,
                                         rts_only=False, at_bounds=True))
    at_bounds_by_kind = pick(at_bounds,
                             torch.argsort(-at_bounds[7][:, 8], stable=True))
    # Each kind alone: the fleet's batch rows twice over, and its rows
    # recast as RTS rows (chip_smoke's hinge-free inputs).
    batch_only = pick(stable, torch.nonzero(kind > 0.5)[:, 0].repeat(2)[:W])
    rts_only = to_dev(cs.al_step_inputs(np, fleet, mode="cr2", seed=1))
    cases = (("fleet rows", stable, ("cr1", "cr2")),
             ("fleet rows by kind", by_kind, ("cr1", "cr2")),
             ("fleet rows, RTS rows first", rts_first, ("cr2",)),
             ("batch rows only", batch_only, ("cr2",)),
             ("RTS rows only", rts_only, ("cr2",)),
             ("at bounds", at_bounds, ("cr2",)),
             ("at bounds by kind", at_bounds_by_kind, ("cr2",)))
    nbytes = 10 * W * T * 4 + W * 12 * 4 + T * 4 + 32
    for what, args, modes in cases:
        for mode in modes:
            calls, errs = compare_trees(
                torch, trees, lambda libs: al_step_caller(
                    torch, libs["al_step"], args, mode, 8),
                al_step_ref(*args, mode=mode, k_steps=8), 1e-5, 1e-5,
                f"al_step {what} {mode}")
            b_ms, b_by = cs.bound(nbytes, cs.al_step_ops(
                np, args[7].cpu().numpy(), T, 8, mode), cs.H100_F32_OPS_PER_S)
            rows.append({"name": "al_step", "case": what, "mode": mode,
                         "shape": [W, T], "k_steps": 8, "moments": "float32",
                         "max_abs_err": errs,
                         "us": {lb: [t * 1e3 for t in ts] for lb, ts in
                                in_turns(torch, calls, 50).items()},
                         "library": None, "library_us": None,
                         "bound_us": b_ms * 1e3, "bound_by": b_by})
            cs.log(json.dumps(rows[-1]))

    d, u, j = to_dev(cs.feature_inputs(np, W, T, seed=W))
    calls, errs = compare_trees(
        torch, trees, lambda libs: features_caller(
            torch, libs["dr_features"], d, u, j),
        dr_features_ref(d, u, j), 2e-4, 2e-4, "dr_features")
    b_ms, b_by = cs.bound(3 * d.numel() * 4 + W * 4 * 4, 20 * d.numel(),
                          cs.H100_F32_OPS_PER_S)
    rows.append({"name": "dr_features", "shape": [W, T],
                 "max_abs_err": errs,
                 "us": {lb: [t * 1e3 for t in ts] for lb, ts in
                        in_turns(torch, calls, 100).items()},
                 "library": None, "library_us": None,
                 "bound_us": b_ms * 1e3, "bound_by": b_by})
    cs.log(json.dumps(rows[-1]))
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernels", choices=sorted(KERNEL_SETS),
                    default="serving", help="which kernels to time")
    ap.add_argument("--tree", action="append", default=[],
                    metavar="LABEL=DIR", help="another source tree")
    ap.add_argument("--out", help="the record (default: "
                    + ", ".join(f"{k}: {v}" for k, v in DEFAULT_OUT.items())
                    + ")")
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("port_kernel_bench: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import build
    names = KERNEL_SETS[args.kernels]
    host = cs.phase_device(torch)
    started = {}
    for spec in args.tree:
        label, _, path = spec.partition("=")
        started[label] = start_tree(label, (ROOT / path).resolve(), names)
    build.build_all(names)
    trees = {label: finish_tree(label, procs)
             for label, procs in started.items()}
    failed = [label for label, libs in trees.items() if libs is None]
    trees = {label: libs for label, libs in trees.items() if libs}
    trees["after"] = {n: build.load(n) for n in names}
    rows = (fleet_rows(np, torch, trees) if args.kernels == "fleet"
            else serving_rows(torch, trees))

    record = {
        "host": host, "device": torch.cuda.get_device_name(0),
        "torch": torch.__version__, "cuda": torch.version.cuda,
        "script": "scripts/port_kernel_bench.py",
        "kernels": list(names),
        "timing": "chip_smoke.kernel_ms: median over windows of 20 calls "
                  "back to back after a spin kernel, CUDA events; each tree "
                  "timed twice, in turns",
        "trees": {label: spec.partition("=")[2] for spec in args.tree
                  for label in [spec.partition("=")[0]]} | {"after": "."},
        "rows": rows}
    if failed:
        record["trees_not_built"] = failed
    out = ROOT / (args.out or DEFAULT_OUT[args.kernels])
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(record, indent=1) + "\n")
    cs.log(f"[bench] wrote {out}")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
