"""Step builders: train / prefill / decode; the port of
`repro/launch/steps.py` for one device.

`make_train_step` returns (params, opt_state, batch) -> (params,
opt_state, loss), the reference's signature; the batch may be numpy (the
data pipeline's) and is moved to the parameters' device. The gradient is
autograd's through `loss_fn`, the reference's `jax.value_and_grad`. The
step updates params and opt_state in place (`adamw_step_`), the memory
of the reference's jit with `donate_argnums=(0, 1)`: 32-layer
stablelm-3b with f32 masters does not fit on one card twice.
`make_step_bundle` and `lower_cell` lower a step over a device mesh for
XLA and wait for the model mesh (ROADMAP item 11b).
"""
from __future__ import annotations

import math
from typing import Callable

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import encdec
from repro_torch.models import transformer as tf
from repro_torch.optim.adamw import (AdamWConfig, adamw_step_, tree_items,
                                     tree_map)


def model_module(cfg: ArchConfig):
    return encdec if cfg.family == "encdec" else tf


def make_loss_fn(cfg: ArchConfig, use_kernel: bool | None = None,
                 ) -> Callable:
    mod = model_module(cfg)
    return lambda params, batch: mod.loss_fn(params, cfg, batch,
                                             use_kernel=use_kernel)


def _to_device(batch: dict, device: torch.device) -> dict:
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def value_and_grad(loss_fn: Callable, params: dict, batch: dict):
    """(loss, gradient tree) of `loss_fn(params, batch)` by autograd; the
    parameters themselves are left as they were."""
    keys = [k for k, _ in tree_items(params)]
    with torch.enable_grad():
        live = {k: p.detach().requires_grad_() for k, p in tree_items(params)}
        loss = loss_fn(_rebuild(params, live), batch)
        grads = torch.autograd.grad(loss, [live[k] for k in keys])
    return loss.detach(), _rebuild(params, dict(zip(keys, grads)))


def _rebuild(tree: dict, flat: dict, prefix: str = "") -> dict:
    """`tree`'s structure with the leaves of `flat` (dotted keys)."""
    return {k: _rebuild(v, flat, f"{prefix}{k}.") if isinstance(v, dict)
            else flat[f"{prefix}{k}"] for k, v in tree.items()}


def make_train_step(cfg: ArchConfig, opt_cfg: AdamWConfig,
                    grad_accum: int = 1,
                    use_kernel: bool | None = None) -> Callable:
    """Train step with optional gradient accumulation, updating params
    and opt_state in place: the step's inputs are its outputs.

    grad_accum > 1 splits the global batch into `grad_accum` microbatches
    run one after another, their gradients summed in f32 and averaged,
    as the reference's scan. The loss is read to the host (the step's one
    read) before anything is written: a non-finite loss raises
    `FloatingPointError` and leaves params and opt_state as they were,
    so a runner may retry the step. The loss returned is that float.
    """
    loss_fn = make_loss_fn(cfg, use_kernel)

    def train_step(params, opt_state, batch):
        device = next(tree_items(params))[1].device
        batch = _to_device(batch, device)
        if grad_accum <= 1:
            loss, grads = value_and_grad(loss_fn, params, batch)
        else:
            for v in batch.values():
                assert v.shape[0] % grad_accum == 0, (v.shape[0], grad_accum)
            micro = [{k: v.chunk(grad_accum)[i] for k, v in batch.items()}
                     for i in range(grad_accum)]
            loss = torch.zeros((), dtype=torch.float32, device=device)
            grads = tree_map(lambda p: torch.zeros(p.shape,
                                                   dtype=torch.float32,
                                                   device=device), params)
            for mb in micro:
                loss_i, grads_i = value_and_grad(loss_fn, params, mb)
                loss = loss + loss_i
                grads = tree_map(lambda a, g: a + g, grads, grads_i)
            loss = loss / grad_accum
            grads = tree_map(lambda g: g / grad_accum, grads)
        loss = float(loss)
        if not math.isfinite(loss):
            raise FloatingPointError(f"non-finite loss {loss}: nothing "
                                     f"written")
        return params, adamw_step_(params, grads, opt_state, opt_cfg), loss

    return train_step


def make_prefill_step(cfg: ArchConfig) -> Callable:
    """(params, batch) -> f32 logits: the encoder-decoder's `forward`
    over {frames, tokens}, the decoder's over {tokens[, vision_embeds,
    mrope_positions]}."""
    mod = model_module(cfg)

    def prefill_step(params, batch):
        return mod.forward(params, cfg, batch)

    return prefill_step


def make_decode_step(cfg: ArchConfig) -> Callable:
    mod = model_module(cfg)

    def decode_step(params, cache, token, length):
        return mod.decode_step(params, cfg, cache, token, length)

    return decode_step
