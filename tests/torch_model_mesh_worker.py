"""Ranks of a gloo process group on the CPU, for the port's model-mesh
tests (`tests/test_torch_model_mesh_train.py`,
`tests/test_torch_model_mesh_runtime.py`).

`Group(world, jobs)` spawns `world` processes (the spawn start method, a
`FileStore` under a fresh temporary directory, so that parallel test
workers never share a port or a store), each with one thread, as
`tests/torch_sharding_worker.py` does. Every rank runs every job, in
order, and returns what it saw; the caller holds the ranks to each other
and to the unsharded step. This module imports the port only: the
spawned ranks load nothing of JAX.

A job is (name, dict); "kind" picks the runner (`KINDS`):
  * "train": `elastic.build` of "cfg" on a mesh ("mesh": (data, model,
    pod)) from the full numpy "params" and "opt", one sharded step a
    batch of "batches"; -> the losses, each rank's state bytes and the
    rules' count, a digest of the gathered state and,
    on rank 0, the gathered params, m and v;
  * "elastic": build on 2 x 2, a step, `resize` to 1 x 2 (ranks 2 and 3
    leave) and back to 2 x 2, a step on each; -> the gathered params at
    each stage, each rank's membership;
  * "checkpoint": build on 2 x 2, a step, a sharded `save`, then
    `restore(shardings=)` onto a (2, 1) mesh of ranks 0 and 1 (ranks 2
    and 3: the refusal) and a step there;
  * "runner": `FaultTolerantRunner` over the sharded step on 2 x 2 with a
    checkpoint every 2 steps and a failure at step 3, recovering onto the
    mesh (`run(shardings=)`), "steps" steps;
  * "compress": `compressed_psum_pod` over the pod axis of a (pod 2,
    data 1, model 2) mesh ("mesh": (data, model, pod) for another), each
    pod's row of "g", on "device" ("cpu" by default; "cuda": the card);
  * "refusals": what the meshes and launchers refuse, each message.
"""
from __future__ import annotations

import hashlib
import os
import pickle
import shutil
import tempfile
import time

import numpy as np


def _np(t):
    import torch
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.float().numpy()
    return t.numpy()


def _flat(tree, prefix=""):
    out = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _digest(tree) -> str:
    h = hashlib.sha256()
    for k, v in _flat(tree).items():
        h.update(k.encode())
        h.update(np.ascontiguousarray(_np(v)).tobytes())
    return h.hexdigest()


def _tensors(tree):
    import torch
    return {k: _tensors(v) if isinstance(v, dict) else torch.tensor(v)
            for k, v in tree.items()}


def _mesh(shape, device_type="cpu"):
    from repro_torch.launch.mesh import make_test_mesh
    data, model, pod = shape
    return make_test_mesh(data, model, pod, device_type=device_type)


def _build(job, mesh):
    from repro_torch.runtime import elastic
    return elastic.build(job["cfg"], mesh, _tensors(job["params"]),
                         _tensors(job["opt"]), job["opt_cfg"])


def _step(st, batch) -> float:
    """One step of an `ElasticState`, kept in it; -> the loss."""
    st.params, st.opt_state, loss = st.step_fn(st.params, st.opt_state,
                                               batch)
    return loss


def _gathered(st):
    from repro_torch.runtime.dtensor import gather_tree
    return gather_tree({"params": st.params, "m": st.opt_state["m"],
                        "v": st.opt_state["v"]})


def _train_job(name, job, rank, results):
    from repro_torch.launch import sharding as sh
    from repro_torch.runtime.dtensor import state_bytes
    st = _build(job, _mesh(job["mesh"]))
    losses = []
    for batch in job["batches"]:
        losses.append(_step(st, batch))
    pspecs = sh.legalize(st.params, sh.param_specs(st.params),
                         st.mesh)
    want = sh.rule_bytes({"p": st.params, "m": st.opt_state["m"],
                          "v": st.opt_state["v"], "step":
                          st.opt_state["step"]},
                         {"p": pspecs, "m": pspecs, "v": pspecs,
                          "step": ()}, st.mesh)
    full = _gathered(st)
    out = {"losses": losses, "digest": _digest(full),
           "bytes": state_bytes(st.params) + state_bytes(st.opt_state),
           "rule_bytes": want,
           "step": int(st.opt_state["step"].to_local())}
    if rank == 0:
        out["state"] = {k: _np(v) for k, v in _flat(full).items()}
    results[name] = out


def _elastic_job(name, job, rank, results):
    from repro_torch.runtime import elastic
    st = _build(job, _mesh((2, 2, 1)))
    out = {"losses": [_step(st, job["batches"][0])]}
    out["before"] = _digest(_gathered(st))
    small = elastic.mesh_from_devices([0, 1], 1, 2, device_type="cpu")
    st = elastic.resize(st, job["cfg"], small, job["opt_cfg"])
    out["member_small"] = st.member
    out["meta_small"] = all(v.device.type == "meta"
                            for v in _flat(st.params).values())
    if st.member:
        out["shrunk"] = _digest(_gathered(st))
        out["losses"].append(_step(st, job["batches"][1]))
        out["after_step"] = _digest(_gathered(st))
    big = elastic.mesh_from_devices([0, 1, 2, 3], 2, 2, device_type="cpu")
    st = elastic.resize(st, job["cfg"], big, job["opt_cfg"])
    out["member_big"] = st.member
    out["grown"] = _digest(_gathered(st))
    out["losses"].append(_step(st, job["batches"][2]))
    full = _gathered(st)
    if rank == 0:
        out["state"] = {k: _np(v) for k, v in _flat(full).items()}
    results[name] = out


def _checkpoint_job(name, job, rank, results):
    from repro_torch.launch import sharding as sh
    from repro_torch.runtime import elastic
    from repro_torch.runtime.checkpoint import CheckpointManager
    st = _build(job, _mesh((2, 2, 1)))
    _step(st, job["batches"][0])
    ckpt = CheckpointManager(job["dir"], keep=2)
    state = {"params": st.params, "opt": st.opt_state}
    ckpt.save(1, state)
    out = {"saved": _digest(_gathered(st)),
           "files": sorted(os.listdir(job["dir"]))}
    two = elastic.mesh_from_devices([0, 1], 2, 1, device_type="cpu")
    target = elastic.build(job["cfg"], two, _tensors(job["params"]),
                           _tensors(job["opt"]), job["opt_cfg"])
    if target.member:
        pspecs = sh.legalize(st.params, sh.param_specs(st.params), two)
        shard = {"params": sh.to_named(pspecs, two),
                 "opt": sh.to_named({"m": pspecs, "v": pspecs,
                                     "step": ()}, two)}
        restored, step = ckpt.restore(state, shardings=shard)
        out["step"] = step
        out["placements"] = [tuple(v.placements) == tuple(p.placements)
                             for v, p in zip(_flat(restored).values(),
                                             _flat(shard).values())]
        target.params, target.opt_state = restored["params"], restored["opt"]
        out["restored"] = _digest(_gathered(target))
        out["loss"] = _step(target, job["batches"][1])
        full = _gathered(target)
        out["after"] = _digest(full)
        if rank == 0:
            out["state"] = {k: _np(v) for k, v in _flat(full).items()}
    else:
        shard = sh.to_named(sh.legalize(st.params,
                                        sh.param_specs(st.params), two), two)
        try:
            ckpt.restore({"params": st.params}, shardings={"params": shard})
            out["refused"] = None
        except ValueError as e:
            out["refused"] = str(e)
    results[name] = out


def _runner_job(name, job, rank, results):
    from repro_torch.launch import sharding as sh
    from repro_torch.runtime.checkpoint import CheckpointManager
    from repro_torch.runtime.dtensor import is_dtensor
    from repro_torch.runtime.ft import FailurePlan, FaultTolerantRunner, \
        FTConfig
    st = _build(job, _mesh((2, 2, 1)))
    pspecs = sh.legalize(st.params, sh.param_specs(st.params), st.mesh)
    shardings = (sh.to_named(pspecs, st.mesh),
                 sh.to_named({"m": pspecs, "v": pspecs, "step": ()},
                             st.mesh))
    runner = FaultTolerantRunner(
        st.step_fn, CheckpointManager(job["dir"]),
        FTConfig(checkpoint_every=2), FailurePlan(fail_steps=(3,)))
    p, o, losses = runner.run(st.params, st.opt_state, iter(job["batches"]),
                              num_steps=job["steps"],
                              shardings=shardings)
    st.params, st.opt_state = p, o
    full = _gathered(st)
    out = {"losses": losses, "events": [e["event"] for e in runner.events],
           "digest": _digest(full),
           "sharded": all(is_dtensor(v) for v in _flat(p).values())}
    if rank == 0:
        out["state"] = {k: _np(v) for k, v in _flat(full).items()}
    results[name] = out


def _compress_job(name, job, rank, results):
    import torch
    from repro_torch.runtime.compression import compressed_psum_pod, \
        init_error
    device = job.get("device", "cpu")
    if device == "cuda":
        torch.cuda.set_device(0)
    mesh = _mesh(job.get("mesh", (1, 2, 2)), device)
    pod = mesh.get_coordinate()[0]
    g = {"w": torch.tensor(job["g"][pod:pod + 1], device=device)}
    out, err = compressed_psum_pod(g, init_error(g), mesh, "pod")
    results[name] = {"pod": pod, "out": out["w"].cpu().numpy(),
                     "error": err["w"].float().cpu().numpy(),
                     "error_dtype": str(err["w"].dtype),
                     "device": out["w"].device.type}


def _refusals_job(name, job, rank, results):
    import torch
    from repro_torch.kernels.al_step.kernel import al_step_cuda
    from repro_torch.kernels.dr_features.kernel import dr_features_cuda
    from repro_torch.kernels.flash_attention.kernel import \
        flash_attention_cuda
    from repro_torch.kernels.rmsnorm.kernel import rmsnorm_cuda
    from repro_torch.kernels.ssd_scan.kernel import ssd_scan_bwd_cuda, \
        ssd_scan_cuda
    from repro_torch.launch import mesh as tm
    from repro_torch.launch import sharding as sh
    from repro_torch.runtime import elastic
    world = torch.distributed.get_world_size()
    mesh = tm.make_test_mesh(world // 2 or 1, 2 if world > 1 else 1,
                             device_type="cpu")
    x = sh.distribute_tree({"x": torch.ones(4, 8)},
                           {"x": ("data", None)}, mesh)["x"]
    w = torch.ones(8)
    calls = {
        "production": lambda: tm.make_production_mesh(device_type="cpu"),
        "production_pod": lambda: tm.make_production_mesh(
            multi_pod=True, device_type="cpu"),
        "test_mesh": lambda: tm.make_test_mesh(world, 2, device_type="cpu"),
        "devices": lambda: elastic.mesh_from_devices(
            list(range(world)), world, 2, device_type="cpu"),
        "rmsnorm": lambda: rmsnorm_cuda(x, w),
        "flash_attention": lambda: flash_attention_cuda(x, w, w),
        "dr_features": lambda: dr_features_cuda(x, w, w),
        "al_step": lambda: al_step_cuda(x, w, w, w, w, w, w, w, w, w,
                                        mode="cr1", k_steps=1),
        "ssd_scan": lambda: ssd_scan_cuda(x, w),
        "ssd_scan_bwd": lambda: ssd_scan_bwd_cuda(None, None, w, x, False)}
    out = {}
    for key, call in calls.items():
        try:
            call()
            out[key] = None
        except (ValueError, TypeError) as e:
            out[key] = (type(e).__name__, str(e))
    results[name] = out


#: Job kind -> its runner (name, job, rank, results).
KINDS = {"train": _train_job, "elastic": _elastic_job,
         "checkpoint": _checkpoint_job, "runner": _runner_job,
         "compress": _compress_job, "refusals": _refusals_job}


def _rank(rank: int, world: int, store: str, jobs: list, out: str) -> None:
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    try:
        results = {}
        for name, job in jobs:
            t0 = time.perf_counter()
            KINDS[job["kind"]](name, job, rank, results)
            results[name]["wall"] = time.perf_counter() - t0
        with open(os.path.join(out, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(results, f)
    finally:
        dist.destroy_process_group()


class Group:
    """`world` gloo ranks running `jobs` ((name, job) pairs), started at
    once: the caller works beside them until `results()`. `tmp` is a
    fresh directory the jobs may write in (checkpoints)."""

    def __init__(self, world: int, jobs_fn):
        import torch.multiprocessing as mp
        self.world = world
        self.tmp = tempfile.mkdtemp(prefix="model_mesh_")
        jobs = jobs_fn(self.tmp)
        self._procs = mp.start_processes(
            _rank, args=(world, os.path.join(self.tmp, "store"), jobs,
                         self.tmp),
            nprocs=world, join=False, start_method="spawn")

    def results(self) -> list[dict]:
        """Wait for every rank (a rank's exception is raised here) and
        return each rank's results, rank 0 first."""
        try:
            while not self._procs.join():
                pass
            out = []
            for r in range(self.world):
                with open(os.path.join(self.tmp, f"rank{r}.pkl"),
                          "rb") as f:
                    out.append(pickle.load(f))
            return out
        finally:
            shutil.rmtree(self.tmp, ignore_errors=True)
