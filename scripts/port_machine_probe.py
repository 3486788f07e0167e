#!/usr/bin/env python3
"""Read what a checkpoint on this machine costs before writing one: the
temp directory's free space, the host memory available, and the rates
of a 4 GiB host copy (one, and four on four threads) and `np.save`
(one file, and four files on four threads) / `np.load` there.

    python3 scripts/port_machine_probe.py

Needs a CUDA device (the copies are device <-> host); prints one line a
reading and removes what it wrote.
"""
import concurrent.futures
import os
import shutil
import sys
import tempfile
import time

import numpy as np
import torch


def main() -> int:
    if not torch.cuda.is_available():
        print("port_machine_probe: no CUDA device", file=sys.stderr)
        return 2
    tmp = tempfile.gettempdir()
    print(f"temp directory {tmp}: {shutil.disk_usage(tmp).free / 1e9:.1f} GB"
          f" free")
    with open("/proc/meminfo") as f:
        for line in f:
            if line.split(":")[0] in ("MemTotal", "MemAvailable"):
                print(line.strip())
    print(f"cores {os.cpu_count()}")
    x = torch.randn(1024, 1024, 1024, device="cuda")          # 4 GiB
    torch.cuda.synchronize()
    t = time.perf_counter()
    host = x.cpu().numpy()
    print(f"device -> host, 4 GiB pageable: {time.perf_counter() - t:.2f} s")
    t = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(4) as pool:
        list(pool.map(lambda c: c.cpu(), x.chunk(4)))
    print(f"device -> host, 4 GiB pageable as 4 copies on 4 threads: "
          f"{time.perf_counter() - t:.2f} s")
    d = tempfile.mkdtemp()
    try:
        path = os.path.join(d, "a.npy")
        t = time.perf_counter()
        np.save(path, host)
        os.sync()
        print(f"np.save, 4 GiB: {time.perf_counter() - t:.2f} s")
        parts = np.split(host.reshape(-1), 4)
        t = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(4) as pool:
            list(pool.map(lambda i: np.save(os.path.join(d, f"p{i}.npy"),
                                            parts[i]), range(4)))
        os.sync()
        print(f"np.save, 4 GiB as 4 files on 4 threads: "
              f"{time.perf_counter() - t:.2f} s")
        t = time.perf_counter()
        back = np.load(path)
        print(f"np.load, 4 GiB: {time.perf_counter() - t:.2f} s")
        t = time.perf_counter()
        torch.from_numpy(back).to("cuda")
        torch.cuda.synchronize()
        print(f"host -> device, 4 GiB: {time.perf_counter() - t:.2f} s")
    finally:
        shutil.rmtree(d)
    return 0


if __name__ == "__main__":
    sys.exit(main())
