#!/usr/bin/env python3
"""chip_smoke phase 8e's model-mesh training over NCCL on four cards, one
process a card: stablelm-3b at full width and 2 layers (remat), a
global batch of 4 x 1024, 2 steps on a 2 x 2 mesh, `resize` to 1 x 2 and
a third step, `compressed_psum_pod` over the pod axis of a (pod 2, data
1, model 2) mesh, each held to phase 8e's bounds against the unsharded
`make_train_step` run first in this process on card 0 (the yardstick).

    python3 scripts/port_model_mesh_nccl.py

Needs four CUDA devices on one host; logs each rank's
losses, walls, gather and reduction bytes, state gather and resize times
and peak memory, and exits nonzero on any failed check.
"""
import os
import pathlib
import pickle
import shutil
import sys
import tempfile
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

WORLD = 4


def _rank(rank, world, tmp):
    import numpy as np
    import torch
    import torch.distributed as dist

    import chip_smoke
    torch.cuda.set_device(rank)
    dist.init_process_group("nccl", store=dist.FileStore(
        os.path.join(tmp, "nccl"), world), rank=rank, world_size=world)
    try:
        res = chip_smoke._mesh_rank_work(np, torch, rank, tmp)
        with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(res, f)
    finally:
        dist.destroy_process_group()


def main() -> int:
    import torch
    import torch.multiprocessing as mp

    import chip_smoke as cs
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import transformer as tf
    from repro_torch.optim.adamw import adamw_init
    from repro_torch.runtime.checkpoint import CheckpointManager
    if torch.cuda.device_count() < WORLD:
        print(f"port_model_mesh_nccl: needs {WORLD} CUDA devices",
              file=sys.stderr)
        return 2
    cs.phase_device(torch)
    cs.phase_build()
    cfg, opt_cfg, batches = cs._mesh_cfg(), cs._mesh_opt(), \
        cs._mesh_batches()
    per_step = {"rmsnorm": 4 * cfg.num_layers + 1,
                "flash_attention": 2 * cfg.num_layers}
    tmp = tempfile.mkdtemp(prefix="model_mesh_nccl_")
    try:
        counted = cs._counter(torch, {})
        p = tf.init_params(cfg, seed=cs.MESH_SEED, device="cuda")
        o = adamw_init(p, opt_cfg)
        step = make_train_step(cfg, opt_cfg)
        yard = []
        for i, batch in enumerate(batches):
            (p, o, loss), got, ms = counted(lambda: step(p, o, batch))
            cs.require(got == per_step, f"unsharded launches {got}")
            yard.append(loss)
            cs.log(f"[nccl x{WORLD}] unsharded step {i + 1}: loss "
                   f"{loss:.6f}, {ms:.1f} ms")
            if i == 1:
                CheckpointManager(os.path.join(tmp, "yard")).save(
                    2, {"params": p}, blocking=True)
                pathlib.Path(tmp, "yard").touch()
        del p, o
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        mp.start_processes(_rank, args=(WORLD, tmp), nprocs=WORLD,
                           join=True, start_method="spawn")
        ranks = []
        for r in range(WORLD):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                ranks.append(pickle.load(f))
        cs.mesh_check_ranks(ranks, yard, per_step, f"NCCL x{WORLD} cards")
        cs.log(f"[nccl x{WORLD}] ranks' wall {time.perf_counter() - t0:.2f}"
               f" s (their start included)")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
