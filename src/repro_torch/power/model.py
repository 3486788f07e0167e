"""Roofline → power models: the bridge from the LM fleet to Carbon Responder.

The paper's Table III sources per-service power from production meters.
Here a job's "meter" is its roofline: per (arch × shape) the three
roofline terms give a step time and a utilization estimate, and chip
power follows the classic linear utilization model (Fan et al., 2007,
the paper's ref [16]):

    P_chip = P_idle + (P_peak − P_idle) · u,   u = t_compute / t_step

DR enforcement is throughput throttling (steps-per-hour budgets): cutting
a training job's power by δ% means running (δ/dynamic_range)% fewer
steps, which is exactly the "batch without SLO" penalty family of §IV.
Serving jobs degrade QoS per the Dynamo latency curves. 1 NP ≡ 1 MW.

`ChipPower`'s defaults (idle 95 W, peak 250 W, host share 40 W) are the
JAX package's model constants for its fleet's accelerators, kept so that
both packages plan the same fleet; they are not a reading of any card
this port runs on. Pure numpy: nothing here touches a device.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class ChipPower:
    """A chip's power envelope (W): the JAX package's model constants."""
    idle: float = 95.0
    peak: float = 250.0
    host_overhead: float = 40.0   # per-chip share of host/interconnect/fans


@dataclasses.dataclass(frozen=True)
class JobPowerModel:
    """Power/throughput model for one fleet job."""
    name: str
    chips: int
    t_compute_s: float
    t_step_s: float               # max of the three roofline terms
    chip: ChipPower = ChipPower()

    @property
    def utilization(self) -> float:
        return min(1.0, self.t_compute_s / max(self.t_step_s, 1e-12))

    @property
    def power_watts(self) -> float:
        c = self.chip
        return self.chips * (c.idle + c.host_overhead
                             + (c.peak - c.idle) * self.utilization)

    @property
    def power_np(self) -> float:
        """NP units (1 NP = 1 MW)."""
        return self.power_watts / 1e6

    @property
    def dynamic_fraction(self) -> float:
        """Share of power that throttling can shed (idle floor stays)."""
        c = self.chip
        dyn = (c.peak - c.idle) * self.utilization
        return dyn / (c.idle + c.host_overhead + dyn)

    def steps_per_hour(self, throttle: float = 1.0) -> float:
        return 3600.0 / max(self.t_step_s, 1e-12) * min(max(throttle, 0.0),
                                                        1.0)

    def throttle_for_power_cut(self, cut_frac: float) -> float:
        """Throughput multiplier that sheds `cut_frac` of total job power.
        Cuts beyond the dynamic range saturate at the idle floor."""
        dyn = self.dynamic_fraction
        if dyn <= 0:
            return 1.0
        return float(np.clip(1.0 - cut_frac / dyn, 0.0, 1.0))


def job_power_from_roofline(name: str, roofline: dict, chips: int,
                            chip: ChipPower = ChipPower()) -> JobPowerModel:
    """Build from a roofline record: `t_compute_s`, `t_memory_s` and
    `t_collective_s`, in seconds per step."""
    tc = float(roofline["t_compute_s"])
    ts = max(float(roofline[k]) for k in
             ("t_compute_s", "t_memory_s", "t_collective_s"))
    return JobPowerModel(name=name, chips=chips, t_compute_s=tc,
                         t_step_s=ts, chip=chip)
