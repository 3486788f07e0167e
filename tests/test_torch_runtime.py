"""The port's data pipeline, checkpoints and fault-tolerant runner
against the JAX package's, on the CPU.

* `synthetic_batch` bitwise the reference's for the same (seed, step,
  host); the prefetching loader yields that sequence.
* `CheckpointManager`: a round trip (f32, bf16 and int32 leaves), the
  `.tmp` rename and `keep`, the asynchronous save, and the port restoring
  a checkpoint that the reference's manager wrote, and the reverse.
* `FaultTolerantRunner`: the failure, `restored`, `restart_from_init` and
  straggler events equal the reference runner's on the same sequence of
  steps, with a step function of numbers alone. Over the port's in-place
  train step, a NaN loss before the first checkpoint is retried from
  the state as it is (nothing written), and a step that keeps failing
  raises after `max_retries`.

Footprint: the JAX reference is called only through `repro.data.pipeline`
and `repro.runtime.{checkpoint, ft}` (jax and numpy alone).
"""
import json
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import reduced as j_reduced
from repro.configs.base import ShapeCell as JShapeCell
from repro.data import pipeline as j_pipeline
from repro.runtime import checkpoint as j_checkpoint
from repro.runtime import ft as j_ft
from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import ShapeCell
from repro_torch.data.pipeline import (DataConfig, PrefetchingLoader,
                                       synthetic_batch)
from repro_torch.runtime.checkpoint import CheckpointManager
from repro_torch.runtime.ft import FailurePlan, FaultTolerantRunner, FTConfig

CFG = reduced(get_config("stablelm-3b"), layers=2, d_model=64)
JCFG = j_reduced(j_get_config("stablelm-3b"), layers=2, d_model=64)
SHAPE = ShapeCell("t", 32, 4, "train")


@pytest.mark.parametrize("seed,step,host,count", [
    (0, 0, 0, 1), (0, 7, 0, 1), (3, 2, 1, 2), (11, 1000, 3, 4)])
def test_synthetic_batch_is_the_references_bytes(seed, step, host, count):
    got = synthetic_batch(CFG, SHAPE, step, DataConfig(seed, host, count))
    want = j_pipeline.synthetic_batch(
        JCFG, JShapeCell("t", 32, 4, "train"), step,
        j_pipeline.DataConfig(seed, host, count))
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


def test_prefetching_loader_yields_the_batch_sequence():
    loader = PrefetchingLoader(CFG, SHAPE, DataConfig(seed=2), start_step=5)
    try:
        for step in range(5, 9):
            if step == 7:
                loader.set_throttle(0.5)
            b = next(loader)
            want = synthetic_batch(CFG, SHAPE, step, DataConfig(seed=2))
            np.testing.assert_array_equal(b["tokens"], want["tokens"])
    finally:
        loader.close()


def _state(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"params": {"blocks": {"l0": {"w": torch.randn(3, 4, 5,
                                                          generator=g)}},
                       "ln_f": {"scale": torch.randn(5, generator=g)}},
            "opt": {"m": {"w": torch.randn(4, generator=g).bfloat16()},
                    "step": torch.tensor(9, dtype=torch.int32)}}


def _leaves(tree, prefix=""):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _leaves(tree[k], f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", tree[k]


def test_checkpoint_roundtrip_layout_and_dtypes(tmp_path):
    state = _state()
    mgr = CheckpointManager(tmp_path)
    mgr.save(7, state, blocking=True)
    path = tmp_path / "step_00000007"
    meta = json.loads((path / "meta.json").read_text())
    assert meta["step"] == 7
    assert meta["leaves"]["opt.m.w"] == {"shape": [4], "dtype": "bfloat16"}
    assert meta["leaves"]["opt.step"] == {"shape": [], "dtype": "int32"}
    assert sorted(p.name for p in path.iterdir()) == sorted(
        [f"{k}.npy" for k, _ in _leaves(state)] + ["meta.json"])
    like = _state(seed=1)
    restored, step = mgr.restore(like)
    assert step == 7
    for (k, a), (_, b) in zip(_leaves(state), _leaves(restored)):
        assert a.dtype == b.dtype and torch.equal(a, b), k


def test_checkpoint_tmp_rename_and_keep(tmp_path, monkeypatch):
    mgr = CheckpointManager(tmp_path, keep=2)
    seen = []
    real = mgr._gc

    def gc():
        seen.append(sorted(p.name for p in tmp_path.iterdir()))
        real()

    monkeypatch.setattr(mgr, "_gc", gc)
    for s in (1, 2, 3, 4):
        mgr.save(s, _state(s), blocking=True)
    # The write lands under .tmp and is renamed before the GC runs.
    assert seen[-1] == ["step_00000002", "step_00000003", "step_00000004"]
    assert mgr.all_steps() == [3, 4]
    assert mgr.latest_step() == 4
    assert not list(tmp_path.glob("*.tmp"))


def test_checkpoint_save_is_asynchronous(tmp_path, monkeypatch):
    mgr = CheckpointManager(tmp_path)
    real = mgr._write

    def slow_write(*a):
        time.sleep(0.3)
        real(*a)

    monkeypatch.setattr(mgr, "_write", slow_write)
    t0 = time.perf_counter()
    mgr.save(1, _state())
    assert time.perf_counter() - t0 < 0.25          # snapshot only
    assert mgr.latest_step() == 1                   # waits for the write


def _jax_tree(state):
    return jax.tree.map(
        lambda t: jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
        if t.dtype == torch.bfloat16 else jnp.asarray(t.numpy()), state)


def test_port_restores_a_reference_checkpoint(tmp_path):
    state = _state()
    j_checkpoint.CheckpointManager(tmp_path).save(
        3, _jax_tree(state), blocking=True)
    restored, step = CheckpointManager(tmp_path).restore(_state(seed=1))
    assert step == 3
    for (k, a), (_, b) in zip(_leaves(state), _leaves(restored)):
        assert a.dtype == b.dtype and torch.equal(a, b), k


def test_reference_restores_a_port_checkpoint(tmp_path):
    state = _state()
    state["opt"]["m"]["w"] = state["opt"]["m"]["w"].float()  # see below
    CheckpointManager(tmp_path).save(5, state, blocking=True)
    # The reference's restore casts each leaf with numpy's astype, which
    # cannot read raw bfloat16 (its own bfloat16 checkpoints alike).
    like = jax.eval_shape(lambda: _jax_tree(state))
    restored, step = j_checkpoint.CheckpointManager(tmp_path).restore(like)
    assert step == 5
    want = dict(_leaves(state))
    for k, b in _leaves(restored):
        np.testing.assert_array_equal(want[k].numpy(), np.asarray(b),
                                      err_msg=k)


def _numbers_step(params, opt, batch):
    """A train step of numbers alone, whose 50 ms sleep sets its time (the
    straggler watchdog reads it), so that neither package's dispatch
    overhead reads as a straggler."""
    time.sleep(0.05)
    return params + 1, opt + batch, params.sum() * 0 + float(batch)


def _run(pkg, tmp_path, plan, every, n):
    if pkg == "port":
        runner = FaultTolerantRunner(
            _numbers_step, CheckpointManager(tmp_path),
            FTConfig(checkpoint_every=every),
            FailurePlan(**plan) if plan else None)
        p0, o0 = (torch.zeros(3), torch.zeros(()))
    else:
        runner = j_ft.FaultTolerantRunner(
            _numbers_step, j_checkpoint.CheckpointManager(tmp_path),
            j_ft.FTConfig(checkpoint_every=every),
            j_ft.FailurePlan(**plan) if plan else None)
        p0, o0 = (jnp.zeros(3), jnp.zeros(()))
    p, o, losses = runner.run(p0, o0, iter(range(1, 10_000)), num_steps=n)
    return ([(e["step"], e["event"]) for e in runner.events], losses,
            np.asarray(p), float(o))


@pytest.mark.parametrize("plan,every,n", [
    (dict(fail_steps=(7,)), 5, 15),                  # restored from 5
    (dict(fail_steps=(3, 11)), 5, 14),               # from init, then 10
    (dict(slow_steps=(12, 13, 14, 15), slow_seconds=0.3), 50, 18),
])
def test_runner_events_match_the_reference(tmp_path, plan, every, n):
    """The same events, losses and final state; the straggler watchdog
    reads the host clock, so only its events at the slow steps count."""
    port = _run("port", tmp_path / "port", plan, every, n)
    ref = _run("ref", tmp_path / "ref", plan, every, n)
    slow = set(plan.get("slow_steps", ()))

    def events(run):
        return [(s, e) for s, e in run[0]
                if not e.startswith("straggler") or s in slow]

    assert events(port) == events(ref)
    assert port[1] == ref[1]
    np.testing.assert_array_equal(port[2], ref[2])
    assert port[3] == ref[3]
    kinds = {e for _, e in events(port)}
    if "fail_steps" in plan:
        assert "failure" in kinds and "restored" in kinds
    else:
        assert "straggler" in kinds and "straggler_escalate" in kinds


def _in_place_run(tmp_path, poison, ft_cfg, n=8, seen=None):
    """The runner over the port's in-place train step on the reduced
    stablelm-3b; `poison(call)` says whether a call's ln_f scale holds a
    NaN (a NaN loss). Returns the runner, the final state, the losses and
    the state before each poisoned call with the state after it (also
    appended to `seen`)."""
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import transformer as tf
    from repro_torch.optim.adamw import AdamWConfig, adamw_init
    oc = AdamWConfig(total_steps=n)
    params = tf.init_params(CFG, seed=0, device="cpu")
    step = make_train_step(CFG, oc)
    calls, seen = [0], [] if seen is None else seen

    def leaves(p, o):
        return [t.clone() for t in jax.tree.leaves((p, o))]

    def poisoned_step(p, o, batch):
        calls[0] += 1
        if not poison(calls[0]):
            return step(p, o, batch)
        scale = p["ln_f"]["scale"]
        keep = scale[3].clone()
        scale[3] = float("nan")
        before = leaves(p, o)
        try:
            return step(p, o, batch)
        finally:
            seen.append((before, leaves(p, o)))
            scale[3] = keep

    runner = FaultTolerantRunner(poisoned_step, CheckpointManager(tmp_path),
                                 ft_cfg)
    loader = PrefetchingLoader(CFG, SHAPE, DataConfig())
    try:
        out = runner.run(params, adamw_init(params, oc), loader, num_steps=n)
    finally:
        loader.close()
    return runner, out, seen


def test_runner_retries_a_nan_loss_before_the_first_checkpoint(tmp_path):
    """A NaN loss at step 3, before the first checkpoint (at 10): the
    in-place step raised before it wrote, so the runner retries step 3
    from the state as it is (there is no initial state left to restart
    from), and the run completes with finite losses."""
    runner, (p, o, losses), seen = _in_place_run(
        tmp_path, lambda call: call == 4, FTConfig(checkpoint_every=10))
    events = [(e["step"], e["event"]) for e in runner.events
              if not e["event"].startswith("straggler")]
    assert events == [(3, "failure"), (3, "retry")]
    assert "non-finite loss" in runner.events[0]["error"]
    assert len(losses) == 8 and all(np.isfinite(losses))
    assert int(o["step"]) == 8
    (before, after), = seen
    for a, b in zip(before, after):
        torch.testing.assert_close(b, a, rtol=0, atol=0, equal_nan=True)


@pytest.mark.parametrize("max_retries", [0, 2])
def test_runner_raises_after_max_retries(tmp_path, max_retries):
    """A NaN loss on every call from the third: step 2 fails
    max_retries + 1 times and the runner raises; the state stays the
    one after steps 0 and 1, which no failed step wrote."""
    seen = []
    with pytest.raises(RuntimeError, match=f"step 2 failed "
                       f"{max_retries + 1} times"):
        _in_place_run(tmp_path, lambda call: call >= 3,
                      FTConfig(checkpoint_every=10, max_retries=max_retries),
                      seen=seen)
    assert len(seen) == max_retries + 1
    for before, after in seen:
        for a, b in zip(before, after):
            torch.testing.assert_close(b, a, rtol=0, atol=0, equal_nan=True)
