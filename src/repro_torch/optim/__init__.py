"""The port's optimizer (`repro/optim`): AdamW."""
from repro_torch.optim.adamw import (  # noqa: F401
    AdamWConfig, adamw_init, adamw_step_, adamw_update, apply_updates,
    cosine_schedule, global_norm,
)
