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
  * sharded state: `save()` of a tree of DTensors (`runtime/dtensor.py`)
    gathers each leaf (every rank of the mesh calls it), the mesh's first
    rank writes the layout above, and the save blocks and ends in a
    barrier of the mesh's ranks, so every rank then sees the checkpoint.
    `restore(..., shardings=...)` (a tree of `sharding.NamedPlacement`)
    places each leaf with the target placements; the mesh may differ from
    the one that saved (the elastic resize path). A rank reads only its
    block of each file (`np.load(mmap_mode="r")`).
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
import torch.distributed as dist

from repro_torch.runtime import dtensor as dt
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
        """Snapshot to host memory now; write to disk asynchronously. A
        tree of DTensors is gathered, written by its mesh's first rank
        only, and saved blocking (module docstring)."""
        meshes = [v.device_mesh for _, v in tree_items(tree)
                  if dt.is_dtensor(v)]
        if meshes:
            mesh = meshes[0]
            tree = dt.gather_tree(tree)
            if dist.get_rank() == int(mesh.mesh.flatten()[0]):
                self.save(step, tree, blocking=True)
            dt.mesh_all_reduce(torch.zeros(1, device=dt.mesh_device(mesh)),
                               mesh)
            return
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
                device=None, shardings: dict | None = None
                ) -> tuple[dict, int]:
        """A tree of `tree_like`'s structure and dtypes from checkpoint
        `step` (the latest by default), each leaf on `device` (by default
        the device of its `tree_like` leaf), or, with `shardings` (a
        matching tree of `sharding.NamedPlacement`), a DTensor with those
        placements holding this rank's block, read alone from the file.
        `ValueError` when this rank is not in a placement's mesh."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        path = self.dir / f"step_{step:08d}"

        def leaf(key, like, placed):
            if placed is None:
                return _to_tensor(np.load(path / f"{key}.npy"), like,
                                  like.device if device is None else device)
            mesh = placed.mesh
            if not dt.is_member(mesh):
                raise ValueError(
                    f"restore(shardings=): rank {dist.get_rank()} is not in "
                    f"the mesh of {key!r} (ranks "
                    f"{mesh.mesh.flatten().tolist()})")
            full = np.load(path / f"{key}.npy", mmap_mode="r")
            block = dt.local_slice(full, placed.placements, mesh)
            # A copy: the block of a read-only map must not back a tensor.
            local = _to_tensor(np.array(block, order="C"), like,
                               dt.mesh_device(mesh))
            return dt.wrap_local(local, mesh, placed.placements, full.shape)

        def walk(node, placed, prefix):
            out = {}
            for k, v in node.items():
                key = f"{prefix}{k}"
                p = None if placed is None else placed[k]
                out[k] = (walk(v, p, key + ".") if isinstance(v, dict)
                          else leaf(key, v, p))
            return out

        return walk(tree_like, shardings, ""), step
