#!/usr/bin/env python3
"""How far a rounding-level change moves a random-weight model's logits.

    python3 scripts/port_logits_sensitivity.py ARCH [--device cuda|cpu]
        [--width D] [--vocab V] [--layers 12,48] [--jax]

chip_smoke.py holds each model's bfloat16 prefill logits through the
kernels against those through the plain versions (relative L2 error <
0.05, top-1 agreement >= 0.9). This script measures the floor under that
comparison: the plain path against the plain path with one change that
is exact up to rounding, the RMSNorm mean of squares summed in float32
(`torch.mean`) instead of float64. It prints the relative L2 error and
the top-1 agreement at each depth, for 8 prompts of chip_smoke's length
(2 at a reduced width). By default it runs the model at full width on
the card (random weights from seed 0, bfloat16, as chip_smoke.py);
`--width` shrinks d_model (and the vocabulary, `--vocab`) for a CPU run.
`--jax` runs the JAX reference (`repro.models`, on the CPU, its own
random weights) against itself with its float32 mean of squares summed in
reverse order, patching its rmsnorm in this process only.
"""
from __future__ import annotations

import argparse
import dataclasses
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
PROMPT = {"stablelm-3b": 120, "mamba2-780m": 384}


def _f32_mean_rmsnorm(torch):
    def rmsnorm(x, scale, eps=1e-6, use_kernel=None):
        xf = x.float()
        var = torch.mean(xf * xf, dim=-1, keepdim=True)
        return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)
    return rmsnorm


def _cfg(base, layers, width, vocab, dtype="bfloat16"):
    kw = dict(num_layers=layers, dtype=dtype)
    if width:
        kw.update(d_model=width, vocab_size=vocab)
        if base.family == "dense":
            kw.update(num_heads=8, num_kv_heads=8,
                      d_ff=base.d_ff * width // base.d_model)
    return dataclasses.replace(base, **kw)


def run_port(args, depths):
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels.rmsnorm import ops as rms_ops
    from repro_torch.models import transformer as tf

    if args.device == "cuda":
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, check=True).stdout.strip())
    base = get_config(args.arch)
    batch = 2 if args.width else 8
    for L in depths:
        cfg = _cfg(base, L, args.width, args.vocab)
        params = tf.compute_params(
            tf.init_params(cfg, seed=0, device=args.device), cfg)
        toks = torch.as_tensor(np.random.default_rng(0).integers(
            0, cfg.vocab_size, (batch, PROMPT[args.arch])),
            device=args.device)
        a = tf.forward(params, cfg, {"tokens": toks}, use_kernel=False)
        plain = rms_ops.rmsnorm
        rms_ops.rmsnorm = _f32_mean_rmsnorm(torch)
        try:
            b = tf.forward(params, cfg, {"tokens": toks}, use_kernel=False)
        finally:
            rms_ops.rmsnorm = plain
        rel = float((a - b).norm() / a.norm())
        top1 = float((a.argmax(-1) == b.argmax(-1)).float().mean())
        print(f"port {args.arch} {args.device} d {cfg.d_model} layers {L} "
              f"batch {batch}: relative error {rel:.3e}, top-1 {top1:.4f}",
              flush=True)
        del params, a, b


def run_jax(args, depths):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from repro.configs import get_config
    from repro.models import common, ssm
    from repro.models import transformer as tf

    def reversed_sum(p, x, eps=1e-6):
        xf = x.astype(jnp.float32)
        sq = (xf * xf)[..., ::-1]
        var = jnp.cumsum(sq, axis=-1)[..., -1:] / x.shape[-1]
        return (xf * jax.lax.rsqrt(var + eps)
                * p["scale"].astype(jnp.float32)).astype(x.dtype)

    base = dataclasses.replace(get_config(args.arch), remat=False)
    for L in depths:
        cfg = _cfg(base, L, args.width, args.vocab)
        params = tf.init_params(cfg, jax.random.PRNGKey(0))
        toks = jnp.asarray(np.random.default_rng(0).integers(
            0, cfg.vocab_size, (2, PROMPT[args.arch])))
        a = jax.jit(lambda p: tf.forward(p, cfg, {"tokens": toks}))(params)
        plain = common.rmsnorm
        common.rmsnorm = ssm.rmsnorm = reversed_sum
        try:
            b = jax.jit(lambda p: tf.forward(p, cfg, {"tokens": toks}))(
                params)
        finally:
            common.rmsnorm = ssm.rmsnorm = plain
        a, b = np.asarray(a), np.asarray(b)
        rel = float(np.linalg.norm(a - b) / np.linalg.norm(a))
        top1 = float((a.argmax(-1) == b.argmax(-1)).mean())
        print(f"jax {args.arch} cpu d {cfg.d_model} layers {L} batch 2: "
              f"relative error {rel:.3e}, top-1 {top1:.4f}", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("arch", choices=sorted(PROMPT))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--width", type=int, default=0)
    ap.add_argument("--vocab", type=int, default=4096)
    ap.add_argument("--layers", default="12,48")
    ap.add_argument("--jax", action="store_true")
    args = ap.parse_args()
    depths = [int(n) for n in args.layers.split(",")]
    if args.jax:
        run_jax(args, depths)
    else:
        run_port(args, depths)
    return 0


if __name__ == "__main__":
    sys.exit(main())
