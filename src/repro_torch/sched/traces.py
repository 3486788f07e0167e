"""Synthetic production-like traces (paper Table II/III).

The paper uses confidential Meta traces: daily-average power usage for four
services over 2021, plus job-level traces for AI training and data pipeline
(10,000 jobs subsampled in a two-day window). We generate synthetic traces
matched to the published statistics:

  - Fig. 1: datacenter power is nearly flat hour-to-hour (±~5%); real-time
    services dominate the mix, batch (AI + pipeline) is a smaller share.
  - Data pipeline jobs carry 5 SLO tiers: [1, 2, 4, 8, inf] hours.
  - AI training jobs have no SLO.

Power is expressed in **NP (Normalized Power)** units, the paper's internal
currency (§IV "Model Input").
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Sequence

import numpy as np

SLO_TIERS_HOURS = (1.0, 2.0, 4.0, 8.0, np.inf)

# Fleet mix fractions of total datacenter power, shaped after Fig. 1
# (RTS-dominant; batch without SLOs is a small share — §VI-C notes B4 is
# ineffective "because batch workloads without SLOs constitute a small share").
DEFAULT_MIX = {
    "RTS1": 0.42,
    "RTS2": 0.28,
    "DataPipeline": 0.20,
    "AITraining": 0.10,
}


@dataclasses.dataclass(frozen=True)
class ServiceTrace:
    """Hourly power usage for one service.

    Attributes:
      name: service name.
      usage: (T,) hourly power usage in NP.
      entitlement: power capacity entitlement E_i in NP (max permissible).
      kind: "realtime" | "batch_slo" | "batch_noslo".
    """

    name: str
    usage: np.ndarray
    entitlement: float
    kind: str

    @property
    def hours(self) -> int:
        return int(self.usage.shape[0])


@dataclasses.dataclass(frozen=True)
class JobTrace:
    """Job-level batch trace.

    Attributes:
      arrival: (J,) arrival hour (integer-valued float, within [0, T)).
      power: (J,) power draw while running, NP.
      duration: (J,) run length in hours (integer >= 1).
      slo: (J,) SLO in hours after arrival (np.inf for no-SLO jobs).
    """

    arrival: np.ndarray
    power: np.ndarray
    duration: np.ndarray
    slo: np.ndarray

    @property
    def num_jobs(self) -> int:
        return int(self.arrival.shape[0])

    def due(self) -> np.ndarray:
        """Due hour = arrival + duration + slo (landing time)."""
        return self.arrival + self.duration + self.slo

    def jobs_per_hour(self, hours: int) -> np.ndarray:
        """|J_{i,t}|: number of jobs arriving at each hour (Table IV)."""
        counts = np.zeros(hours)
        idx = np.clip(self.arrival.astype(int), 0, hours - 1)
        np.add.at(counts, idx, 1.0)
        return counts


def fleet_power_traces(hours: int = 48, total_power: float = 100.0,
                       mix: Mapping[str, float] | None = None,
                       headroom: float = 1.18, seed: int = 0,
                       ) -> dict[str, ServiceTrace]:
    """Hourly power usage for the four representative services (Fig. 1).

    Datacenter usage is nearly flat: each service gets a small diurnal ripple
    (+ noise) around its share of `total_power` NP. Entitlements sit slightly
    above observed peak usage (`headroom`), mirroring provisioned capacity.
    """
    mix = dict(DEFAULT_MIX if mix is None else mix)
    rng = np.random.default_rng(seed)
    t = np.arange(hours)
    out: dict[str, ServiceTrace] = {}
    kinds = {"RTS1": "realtime", "RTS2": "realtime",
             "DataPipeline": "batch_slo", "AITraining": "batch_noslo"}
    phases = {"RTS1": 15.0, "RTS2": 14.0, "DataPipeline": 2.0, "AITraining": 7.0}
    for name, share in mix.items():
        base = share * total_power
        # Realtime follows user diurnal load (peaks mid-afternoon); batch is
        # flatter (schedulers keep utilization high — Fan et al. [16]).
        ripple = 0.05 if kinds[name] == "realtime" else 0.02
        usage = base * (1.0 + ripple * np.sin(2 * np.pi * (t - phases[name]) / 24.0)
                        + 0.01 * rng.standard_normal(hours))
        usage = np.clip(usage, 0.05 * base, None)
        out[name] = ServiceTrace(
            name=name, usage=usage,
            entitlement=float(usage.max() * headroom), kind=kinds[name])
    return out


def make_job_trace(kind: str, hours: int = 48, num_jobs: int = 10_000,
                   total_power: float = 20.0, seed: int = 0) -> JobTrace:
    """Job-level trace for a batch service (paper: 10,000 jobs / 2 days).

    Args:
      kind: "batch_slo" (data pipeline — 5 SLO tiers) or "batch_noslo"
        (AI training — SLO = inf).
      total_power: average aggregate NP drawn by this service; individual job
        power is scaled so that expected concurrent demand matches it.
    """
    rng = np.random.default_rng(seed)
    arrival = rng.integers(0, hours, size=num_jobs).astype(float)
    if kind == "batch_slo":
        # Pipeline jobs: short, bursty, heavy-tailed power.
        duration = rng.choice([1, 1, 1, 2, 2, 3], size=num_jobs).astype(float)
        tier = rng.choice(len(SLO_TIERS_HOURS), size=num_jobs,
                          p=[0.3, 0.3, 0.2, 0.15, 0.05])
        slo = np.asarray(SLO_TIERS_HOURS, dtype=float)[tier]
    elif kind == "batch_noslo":
        # Training jobs: longer, no deadline.
        duration = rng.choice([1, 2, 2, 3, 4, 6], size=num_jobs).astype(float)
        slo = np.full(num_jobs, np.inf)
    else:
        raise ValueError(f"unknown batch kind {kind!r}")
    raw_power = rng.lognormal(mean=0.0, sigma=0.6, size=num_jobs)
    # Scale so that sum(power*duration) spread across `hours` equals
    # total_power on average.
    scale = total_power * hours / float((raw_power * duration).sum())
    power = raw_power * scale
    return JobTrace(arrival=arrival, power=power, duration=duration, slo=slo)
