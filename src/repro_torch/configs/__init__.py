"""Registry of the ported architectures and the reduced CPU-test configs.

`get_config(arch_id)` returns the full config; `reduced(cfg)` shrinks it
as the JAX package's `repro.configs.reduced` does for the ported
families. The reference's MoE, MLA and hybrid configs are not registered:
their families wait for ROADMAP items 12d and 12e.
"""
from __future__ import annotations

import dataclasses
import importlib

from repro_torch.configs.base import (ArchConfig, ShapeCell,  # noqa: F401
                                      SSMConfig)

_MODULES = {
    "mamba2-780m": "mamba2_780m",
    "whisper-large-v3": "whisper_large_v3",
    "qwen1.5-110b": "qwen1_5_110b",
    "qwen3-32b": "qwen3_32b",
    "stablelm-3b": "stablelm_3b",
    "granite-20b": "granite_20b",
    "qwen2-vl-72b": "qwen2_vl_72b",
}

ARCH_IDS = tuple(_MODULES)


def get_config(arch_id: str) -> ArchConfig:
    if arch_id not in _MODULES:
        raise KeyError(f"unknown or unported arch {arch_id!r}; ported: "
                       f"{ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")
    return mod.CONFIG


def reduced(cfg: ArchConfig, layers: int = 2, d_model: int = 64,
            vocab: int = 256) -> ArchConfig:
    """Same-family tiny config, with the JAX package's reduction rules:
    2-4 heads, 1-2 kv heads (0 for SSM), d_ff = 2·d_model (0 where the
    model has no FFN), SSM d_state 16, head_dim 16 and chunk 8, M-RoPE
    sections split over the reduced rotary half-width, the encoder as
    deep as the decoder over 16 frames, float32 throughout, no remat."""
    heads = max(2, min(4, cfg.num_heads))
    updates = dict(
        num_layers=layers, d_model=d_model, num_heads=heads,
        num_kv_heads=0 if cfg.family == "ssm"
        else max(1, min(2, cfg.num_kv_heads)),
        head_dim=d_model // heads, d_ff=0 if cfg.d_ff == 0 else d_model * 2,
        vocab_size=vocab, dtype="float32", param_dtype="float32",
        remat=False)
    if cfg.mrope_sections is not None:
        half = (d_model // heads) // 2
        t = max(1, half // 4)
        hw = (half - t) // 2
        updates["mrope_sections"] = (t, hw, half - t - hw)
    if cfg.ssm is not None:
        updates["ssm"] = dataclasses.replace(cfg.ssm, d_state=16,
                                             head_dim=16, chunk=8)
    if cfg.family == "encdec":
        updates["encoder_layers"] = layers
        updates["encoder_seq"] = 16
    return dataclasses.replace(cfg, **updates)
