#!/usr/bin/env python3
"""Where the time of the port's serving path goes on the card.

    python3 scripts/port_serve_profile.py [stablelm-3b|mamba2-780m]

Draws the model (stablelm-3b by default) at full width (seeded random
weights, as chip_smoke.py does), casts it to bfloat16 once, warms up,
then runs under `torch.profiler` (CPU and CUDA activities) the two steps
`greedy_decode` is made of, at chip_smoke.py's serving shapes: the
prefill of 8 prompts (of 120 tokens for stablelm-3b, 384 for
mamba2-780m), and one decode step at batch 8 with the prompt cached.
For each it prints the wall time, the device-busy time (the union of the
traced kernel and copy intervals), the device idle share 1 - busy / wall
and the device time by kernel name, with the card's name and power limit.
If the trace holds no device events it says so.
"""
from __future__ import annotations

import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "scripts"))

BATCH = 8
# (prompt tokens, max_len) of chip_smoke.py's serving path for each model
SHAPES = {"stablelm-3b": (120, 136), "mamba2-780m": (384, 400)}


def main() -> int:
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from port_profile import _busy_us
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tf

    if not torch.cuda.is_available():
        print("port_serve_profile: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    arch = sys.argv[1] if len(sys.argv) > 1 else "stablelm-3b"
    prompt, max_len = SHAPES[arch]
    cfg = get_config(arch)
    params = tf.compute_params(tf.init_params(cfg, seed=0, device="cuda"),
                               cfg)
    rng = np.random.default_rng(0)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (BATCH, prompt)),
                           device="cuda")
    cache = tf.init_cache(cfg, BATCH, max_len)
    steps = {
        f"prefill {BATCH} x {prompt}":
            lambda: tf.forward(params, cfg, {"tokens": toks}),
        f"decode step, batch {BATCH}, {prompt} cached":
            lambda: tf.decode_step(params, cfg, cache, toks[:, :1], prompt),
    }
    for fn in steps.values():
        fn()
    torch.cuda.synchronize()
    for what, fn in steps.items():
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        if not dev:
            print(f"{what}: the trace holds no device events")
            continue
        busy = _busy_us((e.time_range.start, e.time_range.end) for e in dev)
        print(f"{what}: wall {wall_us / 1e3:.3f} ms (profiler on), device "
              f"busy {busy / 1e3:.3f} ms, idle share "
              f"{1.0 - busy / wall_us:.4f}, {len(dev)} device events")
        by_name: dict[str, list[float]] = {}
        for e in dev:
            by_name.setdefault(e.name, []).append(
                e.time_range.end - e.time_range.start)
        top = sorted(by_name.items(), key=lambda kv: -sum(kv[1]))[:10]
        for name, ts in top:
            print(f"  {sum(ts) / 1e3:9.3f} ms  {len(ts):5d} x  {name[:90]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
