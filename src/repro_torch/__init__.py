"""PyTorch/CUDA port of the Carbon Responder fleet coordinator.

Mirrors the JAX package `repro` module for module (`repro_torch.core.api`
is the counterpart of `repro.core.api`, and so on) and imports nothing of
it. Entry points run on the CUDA device unless the caller passes
`device="cpu"`; on the card the hot paths go through the hand-written
Hopper kernels under `repro_torch/csrc/`, on the CPU through their plain
PyTorch versions.
"""
from repro_torch.kernels.dispatch import resolve_device, resolve_use_kernel

__all__ = ["resolve_device", "resolve_use_kernel"]
