"""Device and kernel resolution shared by every entry point of the port.

There is no environment override and no interpret mode: a CUDA tensor
goes through the hand-written kernel, a CPU tensor through its plain
PyTorch version, and nothing falls back from one to the other.
"""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """`None` means the CUDA device; a missing CUDA device raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port's plain PyTorch path on the CPU")
    return dev


def resolve_use_kernel(flag: bool | None, device: torch.device) -> bool:
    """`None` means on: the kernels on CUDA, the plain path on the CPU."""
    if flag is None:
        return device.type == "cuda"
    return bool(flag)
