"""Plain PyTorch version of the DR feature kernel, built from
`repro_torch.core.features` (the shared definition of Table IV)."""
from __future__ import annotations

import torch

from repro_torch.core import features as feat


def dr_features_ref(d: torch.Tensor, usage: torch.Tensor,
                    jobs: torch.Tensor) -> torch.Tensor:
    """d/usage/jobs: (W, T) -> (W, 4): [wait_jobs, wait_power, wait_sq,
    njobs_delayed] (tardiness excluded: SLO lag is workload-specific)."""
    return torch.stack([
        feat.waiting_time_jobs(d, usage, jobs),
        feat.waiting_time_power(d),
        feat.waiting_time_squared(d, usage, jobs),
        feat.num_jobs_delayed(d, usage, jobs),
    ], dim=-1)
