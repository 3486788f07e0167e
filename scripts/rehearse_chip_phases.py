#!/usr/bin/env python3
"""Rehearse chip_smoke's model phases on the CPU at reduced sizes.

    PYTHONPATH=src python3 scripts/rehearse_chip_phases.py [serve] [whisper]
        [options] [moe] [hybrid] [train] [8d]

Runs `phase_serve` for qwen3-32b and granite-20b (phase 6's bf16 paths),
`phase_whisper` (6b), `phase_dense_options` (6c), `phase_moe_mla` (6d:
qwen3-moe and deepseek-v3 served, their routing report, the two
dispatches, deepseek's decode against its forward), `phase_hybrid` (6e:
jamba served at 16 layers, its routing report on a 2 x 1024 prefill,
its decode over the mixed cache against its forward, and its long
prefill, here of 1 x 1024 tokens), `phase_train_whisper` (8c) and
`phase_train_ssm` (8d: mamba2's loss and gradients kernels against
plain and its steps, then jamba, qwen3-moe and deepseek-v3 with its MTP
head at their cuts, here on batches of 2 x 64 tokens and with every
model's 4 reduced experts) of `chip_smoke.py` with every model reduced
(2 layers, or one 8-layer group for the hybrid, d_model 128, vocab 512,
bf16 activations, remat on), on the CPU: the script's "cuda" device
reads "cpu", the kernels' plain versions run and each call a kernel
would have made is counted as its launch (ssd_scan under autograd runs
`SSDScanFn` with the plain forward and backward in the wrappers'
places), the card's memory and sync calls do nothing, CUDA-event
timings read 0, and a profiler's launch count reads the expected one.
It checks the phases' control flow, shapes and launch counts; no number
it prints is a device metric. With no argument it runs all seven.
"""
from __future__ import annotations

import dataclasses
import pathlib
import sys
import types

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import repro_torch.configs as configs  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as fa_kernel  # noqa
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.rmsnorm import kernel as rms_kernel  # noqa: E402
from repro_torch.kernels.rmsnorm import ops as rms_ops  # noqa: E402
from repro_torch.kernels.ssd_scan import kernel as ssd_kernel  # noqa: E402
from repro_torch.kernels.ssd_scan import ops as ssd_ops  # noqa: E402
from repro_torch.kernels.ssd_scan import ref as ssd_ref  # noqa: E402
from repro_torch.models import encdec, transformer  # noqa: E402


def load_smoke():
    src = (ROOT / "chip_smoke.py").read_text().replace('"cuda"', '"cpu"')
    mod = types.ModuleType("chip_smoke_cpu")
    mod.__file__ = str(ROOT / "chip_smoke.py")
    exec(compile(src, "chip_smoke_cpu", "exec"), mod.__dict__)
    mod._device_breakdown = lambda torch, fn, top=10: (fn(), (1.0, 0.5, [
        ("(not measured on the CPU)", 0.0, 0)]))[1]
    mod.plain_ms = lambda torch, fn, reps=10: (fn(), 0.0)[1]
    return mod


def counted_plain(fn, counter):
    def call(*a, use_kernel=None, **k):
        if use_kernel is None:
            counter.launches += 1
        return fn(*a, use_kernel=False, **k)
    return call


def counted_ref(fn, counter):
    def call(*a):
        counter.launches += 1
        return fn(*a)
    return call


def main(which) -> int:
    for name in ("synchronize", "reset_peak_memory_stats", "empty_cache"):
        setattr(torch.cuda, name, lambda *a: None)
    torch.cuda.max_memory_allocated = lambda *a: 0
    rms_ops.rmsnorm = counted_plain(rms_ops.rmsnorm, rms_kernel.rmsnorm_cuda)
    fa_ops.flash_attention = counted_plain(fa_ops.flash_attention,
                                           fa_kernel.flash_attention_cuda)
    # The kernel route of `ssd_ops.ssd_scan` (SSDScanFn under autograd)
    # with the plain forward and backward in the two wrappers' places.
    ssd_ops.ssd_scan_cuda = counted_ref(ssd_ref.ssd_scan_ref,
                                        ssd_kernel.ssd_scan_cuda)
    ssd_ops.ssd_scan_bwd_cuda = counted_ref(ssd_ref.ssd_scan_bwd_ref,
                                            ssd_kernel.ssd_scan_bwd_cuda)
    scan = ssd_ops.ssd_scan
    ssd_ops.ssd_scan = lambda *a, use_kernel=None: scan(
        *a, use_kernel=use_kernel is None)
    cpu = lambda d=None: torch.device("cpu" if d is None else d)  # noqa
    transformer.resolve_device = encdec.resolve_device = cpu
    full = configs.get_config

    def small(arch):
        cfg = configs.reduced(full(arch), layers=2, d_model=128, vocab=512)
        if cfg.moe is not None:
            # Every token on all 4 experts: at this size a bf16 rounding
            # flips a top-2 choice often enough to move deepseek's decode
            # past the bound it is held to against its forward.
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, top_k=cfg.moe.num_experts))
        return dataclasses.replace(cfg, dtype="bfloat16", remat=True)

    configs.get_config = small
    cs = load_smoke()
    cs.WHISPER_PARAMS = small("whisper-large-v3").param_count()
    cs.WHISPER_TRAIN_SEQ = 24
    cs.JAMBA_LONG = (1, 1024)
    cs.device_launches = lambda torch, what, fn, want, names=(): (
        fn(), want)[1]
    cs.TRAIN_SEQ = 64
    cs.TRAIN_CUTS = tuple(
        (arch, {k: (4 if k == "experts" else v) for k, v in cut.items()},
         (2, 64), n, why) for arch, cut, _, n, why in cs.TRAIN_CUTS)
    which = which or ["serve", "whisper", "options", "moe", "hybrid",
                      "train", "8d"]
    if "serve" in which:
        for path in cs.SERVE_PATHS[2:cs.MOE_SERVE]:
            print(cs.phase_serve(np, torch, *path))
    if "whisper" in which:
        print(cs.phase_whisper(np, torch))
    if "options" in which:
        print(cs.phase_dense_options(np, torch))
    if "moe" in which:
        print(cs.phase_moe_mla(np, torch))
    if "hybrid" in which:
        print(cs.phase_hybrid(np, torch))
    if "train" in which:
        print(cs.phase_train_whisper(np, torch))
    if "8d" in which:
        print(cs.phase_train_ssm(np, torch))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
