"""Checkpointing with an asynchronous save: the port of
`repro/runtime/checkpoint.py`, with the reference's layout on disk.

Layout: <dir>/step_<N>/
  meta.json           {"step": N, "leaves": {key: {"shape", "dtype"}}}
  <leaf-key>.npy      one array per leaf, named by its dotted key
                      (`params.blocks.l0.attn.wq.w`, `opt.step`, ...)

The reference's `meta.json` also carries the JAX treedef, which the port
leaves out: both packages' `restore` read only the leaf files, so each
reads the other's checkpoints. bfloat16 leaves are written as the
reference writes them (2-byte raw values, numpy type `<V2`, meta dtype
`bfloat16`).

  * async: `save()` copies the tree to host memory at once and writes it
    on a background thread, so training goes on during the write.
  * atomic: writes go to step_<N>.tmp and are then renamed, so a crash
    mid-write never corrupts the latest checkpoint.
  * `restore(..., device=...)` puts the leaves onto a given device.
  * GC: the most recent `keep` checkpoints stay.
  * `timings`: each save's step, bytes, seconds to snapshot to the host
    and seconds to write (filled in when the write ends).
"""
from __future__ import annotations

import concurrent.futures
import json
import os
import pathlib
import shutil
import threading
import time

import numpy as np
import torch

from repro_torch.optim.adamw import tree_items


def _to_host(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view("V2")
    return t.numpy()


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).removeprefix("torch.")


def _to_tensor(a: np.ndarray, like: torch.Tensor, device) -> torch.Tensor:
    if like.dtype == torch.bfloat16:
        if a.dtype.kind == "V":
            t = torch.from_numpy(np.asarray(a, order="C").view(np.int16))
            return t.view(torch.bfloat16).to(device)
        return torch.from_numpy(a.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    t = torch.from_numpy(np.asarray(a, order="C"))
    return t.to(device=device, dtype=like.dtype)


class CheckpointManager:
    def __init__(self, directory: str | os.PathLike, keep: int = 3):
        self.dir = pathlib.Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._pool = concurrent.futures.ThreadPoolExecutor(max_workers=1)
        self._pending: concurrent.futures.Future | None = None
        self._lock = threading.Lock()
        self.timings: list[dict] = []

    # ------------------------------------------------------------------
    def save(self, step: int, tree: dict, blocking: bool = False) -> None:
        """Snapshot to host memory now; write to disk asynchronously."""
        t0 = time.perf_counter()
        host = {k: _to_host(v) for k, v in tree_items(tree)}
        timing = {"step": step,
                  "bytes": sum(a.nbytes for a in host.values()),
                  "snapshot_s": time.perf_counter() - t0, "write_s": None}
        self.timings.append(timing)
        meta = {"step": step,
                "leaves": {k: {"shape": list(v.shape),
                               "dtype": _dtype_name(t)}
                           for (k, v), (_, t) in zip(host.items(),
                                                     tree_items(tree))}}
        self.wait()
        self._pending = self._pool.submit(self._write, step, host, meta,
                                          timing)
        if blocking:
            self.wait()

    def _write(self, step: int, host: dict[str, np.ndarray],
               meta: dict, timing: dict) -> None:
        t0 = time.perf_counter()
        tmp = self.dir / f"step_{step:08d}.tmp"
        final = self.dir / f"step_{step:08d}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        for key, arr in host.items():
            np.save(tmp / f"{key}.npy", arr)
        (tmp / "meta.json").write_text(json.dumps(meta))
        if final.exists():
            shutil.rmtree(final)
        tmp.rename(final)
        timing["write_s"] = time.perf_counter() - t0
        self._gc()

    def wait(self) -> None:
        with self._lock:
            if self._pending is not None:
                self._pending.result()
                self._pending = None

    def _gc(self) -> None:
        steps = sorted(self.all_steps())
        for s in steps[: -self.keep]:
            shutil.rmtree(self.dir / f"step_{s:08d}", ignore_errors=True)

    # ------------------------------------------------------------------
    def all_steps(self) -> list[int]:
        return sorted(int(p.name.split("_")[1])
                      for p in self.dir.glob("step_*")
                      if p.is_dir() and not p.name.endswith(".tmp"))

    def latest_step(self) -> int | None:
        # Flush any in-flight async save: a restore after `save()` returned
        # must see that checkpoint (the recovery path depends on it).
        self.wait()
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, tree_like: dict, step: int | None = None,
                device=None) -> tuple[dict, int]:
        """A tree of `tree_like`'s structure and dtypes from checkpoint
        `step` (the latest by default), each leaf on `device` (by default
        the device of its `tree_like` leaf)."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        path = self.dir / f"step_{step:08d}"

        def walk(node, prefix):
            out = {}
            for k, v in node.items():
                key = f"{prefix}{k}"
                if isinstance(v, dict):
                    out[k] = walk(v, key + ".")
                else:
                    out[k] = _to_tensor(np.load(path / f"{key}.npy"), v,
                                        v.device if device is None
                                        else device)
            return out

        return walk(tree_like, ""), step
