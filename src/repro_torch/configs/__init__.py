"""Registry of the ported architectures and the reduced CPU-test configs.

`get_config(arch_id)` returns the full config; `reduced(cfg)` shrinks it
as the JAX package's `repro.configs.reduced` does; every config of the
reference is registered. `input_specs(cfg, shape)` gives a cell's inputs
as tensors on the `meta` device (shapes and dtypes, no storage), as the
reference's `jax.ShapeDtypeStruct` stand-ins.
"""
from __future__ import annotations

import dataclasses
import importlib

import torch

from repro_torch.configs.base import (SHAPES, ArchConfig,  # noqa: F401
                                      MLAConfig, MoEConfig, ShapeCell,
                                      SSMConfig, shape_by_name)

_MODULES = {
    "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
    "deepseek-v3-671b": "deepseek_v3_671b",
    "mamba2-780m": "mamba2_780m",
    "whisper-large-v3": "whisper_large_v3",
    "qwen1.5-110b": "qwen1_5_110b",
    "qwen3-32b": "qwen3_32b",
    "stablelm-3b": "stablelm_3b",
    "granite-20b": "granite_20b",
    "qwen2-vl-72b": "qwen2_vl_72b",
    "jamba-v0.1-52b": "jamba_v0_1_52b",
}

ARCH_IDS = tuple(_MODULES)


def get_config(arch_id: str) -> ArchConfig:
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")
    return mod.CONFIG


def reduced(cfg: ArchConfig, layers: int = 2, d_model: int = 64,
            vocab: int = 256) -> ArchConfig:
    """Same-family tiny config, with the JAX package's reduction rules:
    2-4 heads, 1-2 kv heads (0 for SSM), d_ff = 2·d_model (0 where the
    model has no FFN), SSM d_state 16, head_dim 16 and chunk 8, M-RoPE
    sections split over the reduced rotary half-width, MoE at 4 experts of
    d_model, top-2, capacity factor 8 (no token dropped, so per-token
    decode groups and whole-sequence forward groups agree), MLA at ranks
    32 / 16 with heads of 16 + 8 (head_dim 16), a hybrid stack at least
    one attention period deep (`attn_layer_period` layers) with the
    attention offset inside it, the encoder as deep as the decoder over
    16 frames, float32 throughout, no remat."""
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
    if cfg.moe is not None:
        updates["moe"] = dataclasses.replace(
            cfg.moe, num_experts=4, top_k=2, d_expert_ff=d_model,
            capacity_factor=8.0)
    if cfg.ssm is not None:
        updates["ssm"] = dataclasses.replace(cfg.ssm, d_state=16,
                                             head_dim=16, chunk=8)
    if cfg.mla is not None:
        updates["mla"] = MLAConfig(q_lora_rank=32, kv_lora_rank=16,
                                   qk_nope_head_dim=16, qk_rope_head_dim=8,
                                   v_head_dim=16)
        updates["head_dim"] = 16
    if cfg.family == "hybrid":
        updates["num_layers"] = max(layers, cfg.attn_layer_period)
        updates["attn_layer_offset"] = min(cfg.attn_layer_offset,
                                           updates["num_layers"] - 1)
    if cfg.family == "encdec":
        updates["encoder_layers"] = layers
        updates["encoder_seq"] = 16
    return dataclasses.replace(cfg, **updates)


def input_specs(cfg: ArchConfig, shape: ShapeCell | str) -> dict:
    """`meta` tensors standing in for every model input of the cell, with
    the reference's shapes and dtypes: a train cell's tokens and labels
    (the encoder-decoder's frames, the vlm's text tail, vision embeddings
    and M-RoPE positions), a prefill cell's the same without labels, a
    decode cell's one token (B, 1) and the cache of S tokens from the
    model's `init_cache` on `meta`."""
    if isinstance(shape, str):
        shape = shape_by_name(shape)
    B, S = shape.global_batch, shape.seq_len
    i32 = torch.int32
    adtype = {"bfloat16": torch.bfloat16, "float32": torch.float32}[cfg.dtype]

    def sds(shp, dtype):
        return torch.empty(shp, dtype=dtype, device="meta")

    if shape.kind in ("train", "prefill"):
        if cfg.family == "encdec":
            out = {"frames": sds((B, cfg.encoder_seq, cfg.d_model), adtype),
                   "tokens": sds((B, S), i32)}
        elif cfg.family == "vlm":
            sv = int(S * cfg.vision_tokens_frac)
            out = {"tokens": sds((B, S - sv), i32),
                   "vision_embeds": sds((B, sv, cfg.d_model), adtype),
                   "mrope_positions": sds((3, B, S), i32)}
        else:
            out = {"tokens": sds((B, S), i32)}
        if shape.kind == "train":
            out["labels"] = sds(out["tokens"].shape, i32)
        return out

    # decode: one new token against a cache of S tokens.
    from repro_torch.models import encdec
    from repro_torch.models import transformer as tf
    mod = encdec if cfg.family == "encdec" else tf
    return {"token": sds((B, 1), i32),
            "cache": mod.init_cache(cfg, B, S, device="meta")}
