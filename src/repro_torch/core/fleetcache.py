"""Disk cache for the calibrated paper fleet.

Building the four-service fleet runs ~160 EDD simulations; the port keeps
one cached copy per build setting and calibrating device type. The file
layout is the JAX package's (`repro/core/fleetcache.py`): a `meta` JSON
string plus `<name>_usage` and `<name>_jobs` arrays. The key carries its
own `torch_` prefix, so a fleet the JAX package cached never stands in
for the port's own build.

Writes go to a temp file in the cache directory and land by `os.replace`
(atomic on POSIX), so racing workers never leave a truncated file; a
corrupt file is rebuilt.
"""
from __future__ import annotations

import json
import os
import pathlib
import tempfile
import warnings
import zipfile

import numpy as np
import torch

from repro_torch.core.penalty import PenaltyModel, build_paper_fleet
from repro_torch.kernels.dispatch import resolve_device

CACHE_DIR = pathlib.Path(__file__).resolve().parents[3] / "var"


def load_cache(path: pathlib.Path) -> dict[str, PenaltyModel] | None:
    """Read a cached fleet; None (rebuild) on any corruption."""
    try:
        with np.load(path, allow_pickle=False) as z:
            meta = json.loads(str(z["meta"]))
            out = {}
            for name, m in meta.items():
                out[name] = PenaltyModel(
                    name=name, kind=m["kind"], usage=z[f"{name}_usage"],
                    entitlement=m["entitlement"], k=m["k"],
                    params=tuple(m["params"]),
                    jobs=z[f"{name}_jobs"] if f"{name}_jobs" in z else None,
                    slo_hours=m["slo_hours"],
                    feature_names=tuple(m["feature_names"])
                    if m["feature_names"] else None)
            return out
    except (zipfile.BadZipFile, OSError, EOFError, ValueError, KeyError,
            json.JSONDecodeError) as e:
        warnings.warn(f"corrupt fleet cache {path} ({e!r}); rebuilding",
                      RuntimeWarning, stacklevel=3)
        return None


def save_cache(path: pathlib.Path, fleet: dict[str, PenaltyModel]) -> None:
    """Atomic cache write: temp file in the same directory + os.replace."""
    arrays: dict[str, np.ndarray] = {}
    meta: dict[str, dict] = {}
    for name, m in fleet.items():
        arrays[f"{name}_usage"] = m.usage
        if m.jobs is not None:
            arrays[f"{name}_jobs"] = m.jobs
        meta[name] = {
            "kind": m.kind, "entitlement": m.entitlement, "k": m.k,
            "params": list(m.params), "slo_hours": m.slo_hours,
            "feature_names": list(m.feature_names) if m.feature_names
            else None,
        }
    path.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=path.parent, prefix=path.stem,
                               suffix=".tmp.npz")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, meta=np.str_(json.dumps(meta)), **arrays)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def cache_key(hours: int, total_power: float, num_samples: int,
              num_jobs: int, seed: int, device: torch.device) -> str:
    """The cache file's stem: `torch_fleet_h…_p…_s…_j…_r…`, with the
    calibrating device's type appended unless it is the CPU. The
    calibration's float32 fits round differently on the card and on the
    CPU, so a fleet built on one never stands in for the other's (a
    CPU-built file read on the card once moved the SLSQP reference's
    unconverged CR1 by 0.05 pp, PERF.md §7)."""
    key = (f"torch_fleet_h{hours}_p{total_power:g}_s{num_samples}"
           f"_j{num_jobs}_r{seed}")
    kind = torch.device(device).type
    return key if kind == "cpu" else f"{key}_{kind}"


def cached_paper_fleet(hours: int = 48, total_power: float = 100.0,
                       num_samples: int = 160, num_jobs: int = 10_000,
                       seed: int = 0, device: str | torch.device | None = None,
                       cache_dir: str | os.PathLike | None = None,
                       ) -> dict[str, PenaltyModel]:
    """`build_paper_fleet` on `device` (None = the CUDA device), cached in
    `cache_dir` (default: `var/` at the repository root) under
    `cache_key(...)`.npz."""
    device = resolve_device(device)
    key = cache_key(hours, total_power, num_samples, num_jobs, seed, device)
    path = pathlib.Path(cache_dir or CACHE_DIR) / f"{key}.npz"
    if path.exists():
        cached = load_cache(path)
        if cached is not None:
            return cached
    fleet = build_paper_fleet(hours=hours, total_power=total_power,
                              num_samples=num_samples, num_jobs=num_jobs,
                              seed=seed, device=device)
    save_cache(path, fleet)
    return fleet
