"""The port's `train()` on the integration tests' config, on the CPU
(`tests/test_integration.py:19-39`: reduced stablelm-3b, 2 layers, d 64,
seq 64, batch 4): the losses decrease over 40 steps, an injected failure
is restored from a checkpoint and the run completes, and under a DR
throttle each hour's step budget is the reference's formula
(`repro/launch/train.py:58-72`), written out here.

The JAX reference's `train()` spans `jax.devices()` and is not called
(footprint rule); the step it runs is held against the port's in
`test_torch_optim.py`.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import ShapeCell
from repro_torch.launch.train import hour_budgets, train
from repro_torch.runtime.ft import FailurePlan

CFG = reduced(get_config("stablelm-3b"), layers=2, d_model=64)
SHAPE = ShapeCell("t", 64, 4, "train")


def _reference_budgets(steps, throttle):
    """`repro/launch/train.py:58-72`, the loop's budgets."""
    base_budget = max(1, steps // len(throttle))
    done, hour, out = 0, 0, []
    while done < steps:
        budget = max(1, int(round(base_budget
                                  * throttle[hour % len(throttle)])))
        budget = min(budget, steps - done)
        out.append(budget)
        done += budget
        hour += 1
    return out


def test_training_loss_decreases(tmp_path):
    report = train(CFG, SHAPE, steps=40, ckpt_dir=str(tmp_path),
                   device="cpu")
    losses = report["losses"]
    assert len(losses) == 40 and all(np.isfinite(losses))
    assert np.mean(losses[-5:]) < np.mean(losses[:5])
    # Only the straggler watchdog may speak (it reads the host clock).
    assert {e["event"] for e in report["events"]} <= {"straggler",
                                                      "straggler_escalate"}
    assert all(t.device.type == "cpu" for t in
               report["params"]["blocks"]["l0"]["ffn"]["w_up"].values())


def test_training_with_injected_failure_completes(tmp_path):
    report = train(CFG, SHAPE, steps=30, ckpt_dir=str(tmp_path),
                   failure_plan=FailurePlan(fail_steps=(13,)), device="cpu")
    assert report["steps"] >= 30
    events = [(e["step"], e["event"]) for e in report["events"]
              if not e["event"].startswith("straggler")]
    # checkpoint_every = max(30 // 5, 10) = 10: step 13 restores step 10.
    assert events == [(13, "failure"), (10, "restored")]
    assert report["steps"] == 33


@pytest.mark.parametrize("throttle,steps", [
    ([1.0, 0.4, 1.0, 0.4], 24),
    ([0.9, 0.2, 0.55, 1.0, 0.05, 0.7], 20),
    (list(np.linspace(0.1, 1.0, 48)), 6),
])
def test_dr_throttled_training_budgets(tmp_path, throttle, steps):
    throttle = np.asarray(throttle)
    assert hour_budgets(steps, throttle) == \
        _reference_budgets(steps, throttle)
    report = train(CFG, SHAPE, steps=steps, ckpt_dir=str(tmp_path),
                   throttle=throttle, device="cpu")
    assert report["budgets"] == _reference_budgets(steps, throttle)
    assert report["steps"] >= steps      # work completes (preservation)
    assert all(np.isfinite(report["losses"]))


def test_train_state_is_its_last_checkpoint(tmp_path):
    """The runner's last save holds the final parameters: restored, they
    are the report's, bit for bit."""
    from repro_torch.runtime.checkpoint import CheckpointManager
    report = train(CFG, SHAPE, steps=12, ckpt_dir=str(tmp_path),
                   device="cpu")
    mgr = CheckpointManager(tmp_path)
    assert mgr.latest_step() == 12
    restored, _ = mgr.restore({"params": report["params"]})
    opt, _ = mgr.restore({"opt": report["opt_state"]})
    assert int(opt["opt"]["step"]) == 12
    for a, b in zip(_tree_leaves(report["opt_state"]),
                    _tree_leaves(opt["opt"])):
        assert torch.equal(a, b)

    def leaves(t):
        for k in sorted(t):
            yield from (leaves(t[k]) if isinstance(t[k], dict) else [t[k]])

    for a, b in zip(leaves(report["params"]), leaves(restored["params"])):
        assert torch.equal(a, b)


def _tree_leaves(tree):
    for k in sorted(tree):
        v = tree[k]
        yield from (_tree_leaves(v) if isinstance(v, dict) else [v])


def test_train_reports_each_checkpoints_timings(tmp_path):
    """Each save reports its step, its bytes and its snapshot and write
    seconds: at 12 steps, the checkpoint at 10 and the final one."""
    report = train(CFG, SHAPE, steps=12, ckpt_dir=str(tmp_path),
                   device="cpu")
    timings = report["checkpoints"]
    assert [t["step"] for t in timings] == [10, 12]
    assert len({t["bytes"] for t in timings}) == 1 and timings[0]["bytes"] > 0
    assert all(t["snapshot_s"] >= 0 and t["write_s"] > 0 for t in timings)
