from repro_torch.power.model import (  # noqa: F401
    ChipPower, JobPowerModel, job_power_from_roofline,
)
