#!/usr/bin/env python3
"""Which collectives a gloo group takes on CUDA tensors, on this machine's
torch: 4 processes sharing card 0 (as chip_smoke's phases 5g and 8e run
them) try c10d's list-form `all_gather`, `all_reduce` (int32),
`all_gather_into_tensor` and `reduce_scatter_tensor` over the "data"
dim of a 2 x 2 `DeviceMesh`, and time an all-reduce of 256 MB and a
list all-gather of 64 MB a rank; then, in a group of its own (a crash
kills its processes), DTensor's `full_tensor`. One line a rank and a
result line for DTensor.

    python3 scripts/port_gloo_cuda_probe.py

Needs a CUDA device. `runtime/dtensor.py` calls the c10d collectives,
not DTensor's redistribution, from what this prints on the H100 machine.
"""
import os
import sys
import tempfile
import time

WORLD = 4


def _c10d(rank, world, store):
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    mesh = DeviceMesh("cuda", torch.arange(world).reshape(2, world // 2),
                      mesh_dim_names=("data", "model"))
    g = mesh.get_group("data")
    t = torch.full((2,), float(rank), device="cuda")
    out = {}

    def gather_list():
        parts = [torch.empty(2, device="cuda") for _ in range(2)]
        dist.all_gather(parts, t, group=g)
        return [p.tolist() for p in parts]

    def reduce_int32():
        x = torch.full((3,), rank, dtype=torch.int32, device="cuda")
        dist.all_reduce(x, group=g)
        return x.tolist()

    def gather_tensor():
        o = torch.empty(4, device="cuda")
        dist.all_gather_into_tensor(o, t, group=g)
        return o.tolist()

    def reduce_scatter():
        o = torch.empty(1, device="cuda")
        dist.reduce_scatter_tensor(o, t, group=g)
        return o.tolist()

    for name, fn in (("all_gather", gather_list), ("all_reduce_i32",
                     reduce_int32), ("all_gather_into_tensor",
                     gather_tensor), ("reduce_scatter_tensor",
                     reduce_scatter)):
        try:
            out[name] = fn()
        except RuntimeError as e:
            out[name] = f"refused: {e}"[:120]
    x = torch.ones(64 * 2**20, device="cuda")               # 256 MB
    dist.barrier()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dist.all_reduce(x)
    torch.cuda.synchronize()
    out["all_reduce_256MB_s"] = round(time.perf_counter() - t0, 4)
    y = torch.ones(16 * 2**20, device="cuda")               # 64 MB
    parts = [torch.empty_like(y) for _ in range(world)]
    dist.barrier()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dist.all_gather(parts, y)
    torch.cuda.synchronize()
    out["all_gather_64MB_s"] = round(time.perf_counter() - t0, 4)
    print(f"rank {rank} coordinate {mesh.get_coordinate()}: {out}",
          flush=True)
    dist.destroy_process_group()


def _dtensor(rank, world, store):
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import DTensor, Replicate, Shard
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    mesh = DeviceMesh("cuda", torch.arange(world).reshape(2, world // 2),
                      mesh_dim_names=("data", "model"))
    t = torch.full((2,), float(rank), device="cuda")
    d = DTensor.from_local(t, mesh, [Shard(0), Replicate()], run_check=False,
                           shape=(4,), stride=(1,))
    print(f"rank {rank}: DTensor full_tensor {d.full_tensor().tolist()}",
          flush=True)
    dist.destroy_process_group()


def main() -> int:
    import torch
    import torch.multiprocessing as mp
    if not torch.cuda.is_available():
        print("port_gloo_cuda_probe: no CUDA device", file=sys.stderr)
        return 2
    print(sys.version.split()[0], torch.__version__, torch.version.cuda)
    tmp = tempfile.mkdtemp(prefix="gloo_probe_")
    mp.start_processes(_c10d, args=(WORLD, os.path.join(tmp, "a")),
                       nprocs=WORLD, start_method="spawn")
    try:
        mp.start_processes(_dtensor, args=(WORLD, os.path.join(tmp, "b")),
                           nprocs=WORLD, start_method="spawn")
        print("DTensor full_tensor over gloo on CUDA tensors: ran")
    except mp.ProcessExitedException as e:
        print(f"DTensor full_tensor over gloo on CUDA tensors: a rank "
              f"died ({e})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
