"""Batch-job scheduling substrate: trace generation + EDD simulator.

This is the data source for the paper's batch penalty models (§IV-A2):
"We obtain training data by implementing a scheduler, simulating schedules
under varied processor availabilities, and measuring tardiness."
"""
from repro_torch.sched.traces import (  # noqa: F401
    JobTrace,
    ServiceTrace,
    fleet_power_traces,
    make_job_trace,
)
from repro_torch.sched.edd import EDDScheduler, ScheduleResult  # noqa: F401
