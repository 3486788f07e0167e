"""Earliest-Due-Date (EDD) batch scheduler simulator (paper §IV-A2).

"We implement an earliest due date (EDD) scheduler ... The simulator's inputs
include hourly energy capacity, server capacity, and a trace of batch jobs.
The simulator reports waiting time and tardiness — the waiting time beyond
what can be tolerated by the SLO for each job."

The simulator is discrete-hour and non-preemptive: a job occupies `power` NP
for `duration` consecutive hours once started. Each hour, queued jobs are
considered in EDD order and started if their power reservation fits within
the remaining hourly capacity for every hour of their run. This is the
training-data generator for the Lasso penalty models; Carbon Responder
supports any scheduling framework — EDD is the paper's choice.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Sequence

import numpy as np

from repro_torch.sched.traces import JobTrace


@dataclasses.dataclass(frozen=True)
class ScheduleResult:
    """Outcome of one simulated schedule.

    Attributes:
      start: (J,) hour each job started (np.inf if never scheduled in-window).
      waiting: (J,) hours waited beyond arrival (start - arrival).
      tardiness: (J,) positive part of (completion - due) for SLO'd jobs; 0
        for jobs with slo=inf.
      total_waiting: scalar sum of waiting over scheduled jobs (+ penalty
        window overflow for unscheduled ones).
      total_tardiness: scalar sum of tardiness.
      utilization: (T,) NP actually consumed each hour.
    """

    start: np.ndarray
    waiting: np.ndarray
    tardiness: np.ndarray
    total_waiting: float
    total_tardiness: float
    utilization: np.ndarray


class EDDScheduler:
    """Non-preemptive EDD scheduler over hourly power capacity."""

    def __init__(self, horizon_slack: int = 24):
        # Jobs that cannot finish in-window are charged waiting time up to
        # the extended horizon; keeps penalties finite and monotone.
        self.horizon_slack = horizon_slack

    def run(self, trace: JobTrace, capacity: np.ndarray) -> ScheduleResult:
        """Simulate. `capacity` is (T,) hourly NP available to this service."""
        capacity = np.asarray(capacity, dtype=float)
        T = capacity.shape[0]
        H = T + self.horizon_slack
        # Extend the horizon at baseline (last-hour) capacity so deferred work
        # drains rather than vanishing.
        cap = np.concatenate([capacity, np.full(self.horizon_slack,
                                                capacity[-1] if T else 0.0)])
        free = cap.copy()
        J = trace.num_jobs
        due = trace.due()
        start = np.full(J, np.inf)
        # Priority queue keyed by (due, arrival, jid); jobs enter at arrival.
        order = np.lexsort((trace.arrival, due))
        pending: list[tuple[float, float, int]] = []
        by_arrival: dict[int, list[int]] = {}
        for jid in order:
            by_arrival.setdefault(int(trace.arrival[jid]), []).append(int(jid))
        for t in range(H):
            for jid in by_arrival.get(t, ()):
                heapq.heappush(pending, (float(due[jid]), float(trace.arrival[jid]), jid))
            # Try to start pending jobs in EDD order. One deferred pass per
            # hour: jobs that do not fit stay queued (EDD is a heuristic, not
            # an optimal packer — matching production schedulers).
            deferred: list[tuple[float, float, int]] = []
            while pending:
                key = heapq.heappop(pending)
                jid = key[2]
                p = trace.power[jid]
                dur = int(trace.duration[jid])
                end = min(t + dur, H)
                if np.all(free[t:end] >= p - 1e-9) and end - t == dur:
                    free[t:end] -= p
                    start[jid] = t
                else:
                    deferred.append(key)
            for key in deferred:
                heapq.heappush(pending, key)
        # Unstarted jobs (couldn't fit even in the slack window): charge
        # maximal waiting; they would run after the horizon.
        unstarted = ~np.isfinite(start)
        eff_start = np.where(unstarted, float(H), start)
        waiting = eff_start - trace.arrival
        completion = eff_start + trace.duration
        with np.errstate(invalid="ignore"):
            tard = np.where(np.isfinite(trace.slo),
                            np.maximum(completion - due, 0.0), 0.0)
        util = cap - free
        return ScheduleResult(
            start=start, waiting=waiting, tardiness=tard,
            total_waiting=float(waiting.sum()),
            total_tardiness=float(tard.sum()),
            utilization=util[:T])


def random_walk_curtailments(usage: np.ndarray, num: int, seed: int = 0,
                             step_frac: float = 0.08,
                             max_frac: float = 0.5) -> np.ndarray:
    """Sample diverse curtailment vectors d via a random walk (paper §IV-A2,
    citing [63]), keeping only those with positive average curtailment.

    Returns (num, T) array; each row satisfies |d_t| <= max_frac * usage_t.
    """
    rng = np.random.default_rng(seed)
    T = usage.shape[0]
    out = np.zeros((num, T))
    kept = 0
    while kept < num:
        steps = rng.standard_normal(T) * step_frac * usage
        d = np.cumsum(steps)
        # Re-center around a random positive offset so means vary.
        d = d - d.mean() + rng.uniform(0.0, 0.15) * usage.mean()
        d = np.clip(d, -max_frac * usage, max_frac * usage)
        if d.mean() > 0:
            out[kept] = d
            kept += 1
    return out


def dr_shaped_curtailments(usage: np.ndarray, num: int, seed: int = 0,
                           max_frac: float = 0.5) -> np.ndarray:
    """Sustained DR-window curtailments: cut a contiguous block of hours by a
    constant depth, optionally rebounding afterwards. This is the shape real
    DR schedules take (paper Fig. 7: defer 18:00–08:00, recover 08:00–18:00)
    and covers the deep-sustained region the random walk rarely reaches.

    Returns (num, T); |d_t| <= max_frac * usage_t.
    """
    rng = np.random.default_rng(seed)
    T = usage.shape[0]
    out = np.zeros((num, T))
    for n in range(num):
        start = int(rng.integers(0, T - 4))
        length = int(rng.integers(4, min(24, T - start) + 1))
        depth = float(rng.uniform(0.1, max_frac))
        d = np.zeros(T)
        d[start:start + length] = depth * usage[start:start + length]
        if rng.uniform() < 0.5:  # rebound: run the deferred work later
            rb_len = min(T - (start + length), length)
            if rb_len > 0:
                deferred = d.sum() * float(rng.uniform(0.3, 1.0))
                sl = slice(start + length, start + length + rb_len)
                d[sl] -= deferred / rb_len
        out[n] = np.clip(d, -max_frac * usage, max_frac * usage)
    return out


def mixed_curtailments(usage: np.ndarray, num: int, seed: int = 0,
                       max_frac: float = 0.5) -> np.ndarray:
    """Half random-walk (paper §IV-A2, [63]), half sustained DR windows."""
    n_walk = num // 2
    walk = random_walk_curtailments(usage, n_walk, seed=seed,
                                    max_frac=max_frac)
    shaped = dr_shaped_curtailments(usage, num - n_walk, seed=seed + 1,
                                    max_frac=max_frac)
    return np.concatenate([walk, shaped], axis=0)
