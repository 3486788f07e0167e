"""Fault-tolerant training loop: checkpoint/restart, retry, stragglers;
the port of `FailurePlan`, `FTConfig` and `FaultTolerantRunner` from
`repro/runtime/ft.py`.

The failure model: a step that raises (an injected node failure, a
non-finite loss) restores the latest checkpoint, or the initial state
where there is none, and goes on from its step. Where there is none and
the state the runner holds is still the params object it was given, the
runner retries the failed step from that state (event `retry`): a step
that updates in place (`launch/steps.make_train_step` returns the params
it was given) leaves no initial state once it has run, and writes
nothing when it fails. A step that fails more than `max_retries` times
raises (the reference never reads `max_retries`, and a deterministic
failure loops there). Stragglers: steps slower
than `straggler_factor` × the trailing median are counted; after
`straggler_patience` consecutive slow steps the runner records an
escalation. `FailurePlan` injects failures and slow steps for tests.
The loss is read back to the host once a step, as in the reference.
On a model mesh (`runtime/elastic.py`: a sharded step and DTensor state)
every rank runs the runner; `run(..., shardings=(params, opt))` (trees
of `launch/sharding.NamedPlacement`) restores a checkpoint onto those
placements, the mesh the state lives on now.
"""
from __future__ import annotations

import dataclasses
import math
import statistics
import time
from typing import Any, Callable, Iterable

from repro_torch.runtime.checkpoint import CheckpointManager


@dataclasses.dataclass
class FailurePlan:
    """Deterministic failure injection for tests."""
    fail_steps: tuple[int, ...] = ()          # raise once at these steps
    slow_steps: tuple[int, ...] = ()          # sleep to look like stragglers
    slow_seconds: float = 0.15

    def check(self, step: int, already_failed: set[int]) -> None:
        if step in self.fail_steps and step not in already_failed:
            already_failed.add(step)
            raise RuntimeError(f"injected node failure at step {step}")
        if step in self.slow_steps:
            time.sleep(self.slow_seconds)


@dataclasses.dataclass
class FTConfig:
    checkpoint_every: int = 20
    max_retries: int = 3
    straggler_factor: float = 2.5
    straggler_patience: int = 3
    keep: int = 3


class FaultTolerantRunner:
    """Wraps a train step with checkpointing, retry and straggler
    accounting. The step function signature is
    (params, opt_state, batch) -> (params, opt_state, loss)."""

    def __init__(self, step_fn: Callable, ckpt: CheckpointManager,
                 cfg: FTConfig = FTConfig(),
                 failure_plan: FailurePlan | None = None):
        self.step_fn = step_fn
        self.ckpt = ckpt
        self.cfg = cfg
        self.plan = failure_plan or FailurePlan()
        self._failed: set[int] = set()
        self.step_times: list[float] = []
        self.events: list[dict] = []
        self.straggler_strikes = 0

    # ------------------------------------------------------------------
    def run(self, params: Any, opt_state: Any, batches: Iterable,
            start_step: int = 0, num_steps: int = 100,
            shardings: tuple = (None, None),
            ) -> tuple[Any, Any, list[float]]:
        losses: list[float] = []
        state = {"params": params, "opt": opt_state}
        it = iter(batches)
        step = start_step
        failures: dict[int, int] = {}
        while step < start_step + num_steps:
            batch = next(it)
            try:
                t0 = time.time()
                self.plan.check(step, self._failed)
                p, o, loss = self.step_fn(state["params"], state["opt"],
                                          batch)
                loss = float(loss)
                if not math.isfinite(loss):
                    raise FloatingPointError(f"non-finite loss at {step}")
                state["params"], state["opt"] = p, o
                dt = time.time() - t0
                self._track_straggler(step, dt)
                losses.append(loss)
                if (step + 1) % self.cfg.checkpoint_every == 0:
                    self.ckpt.save(step + 1, state)
                step += 1
            except Exception as e:  # noqa: BLE001 — restart path
                self.events.append({"step": step, "event": "failure",
                                    "error": str(e)})
                failures[step] = failures.get(step, 0) + 1
                if failures[step] > self.cfg.max_retries:
                    raise RuntimeError(
                        f"step {step} failed {failures[step]} times "
                        f"(max_retries {self.cfg.max_retries})") from e
                state, step = self._recover(state, step, params, opt_state,
                                            shardings)
        self.ckpt.save(step, state, blocking=True)
        return state["params"], state["opt"], losses

    def _recover(self, state, step, params0, opt0, shardings=(None, None)):
        """Restore the latest checkpoint (or the initial state) onto the
        state's devices, or onto `shardings` where given, after a failure;
        without a checkpoint, a state that is still the given params
        object (updated in place, or no step done) is kept and the failed
        step retried."""
        latest = self.ckpt.latest_step()
        if latest is None and state["params"] is params0:
            self.events.append({"step": step, "event": "retry"})
            return state, step
        if latest is None:
            self.events.append({"step": 0, "event": "restart_from_init"})
            return {"params": params0, "opt": opt0}, 0
        sh = ({"params": shardings[0], "opt": shardings[1]}
              if shardings[0] is not None else None)
        restored, step = self.ckpt.restore(state, latest, shardings=sh)
        self.events.append({"step": step, "event": "restored"})
        return restored, step

    def _track_straggler(self, step: int, dt: float) -> None:
        self.step_times.append(dt)
        hist = self.step_times[-50:]
        if len(hist) < 8:
            return
        med = float(statistics.median(hist))
        if dt > self.cfg.straggler_factor * med:
            self.straggler_strikes += 1
            self.events.append({"step": step, "event": "straggler",
                                "dt": dt, "median": med})
        else:
            self.straggler_strikes = 0
        if self.straggler_strikes >= self.cfg.straggler_patience:
            self.events.append({"step": step, "event": "straggler_escalate"})
            self.straggler_strikes = 0
