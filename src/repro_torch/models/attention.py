"""GQA/MQA attention with RoPE or M-RoPE, qk-norm and qkv bias: the GQA
path of `repro/models/attention.py` (MLA is not ported, ROADMAP 12d).

Full-sequence attention (`gqa_attend`, `gqa_prefill_cache`) goes through
the hand-written flash-attention kernel on the card, where the JAX model
calls its chunked jnp version `flash_attention_jnp` (`attention.py:148`,
`:157`); on the CPU, and with `use_kernel=False`, through the kernel's
plain version. qk-norm normalises q and k over Dh through the rmsnorm
kernel, (B·S·heads, Dh) rows. Decode over the cache (`decode_attention`)
is plain torch, as in the reference, where it is no Pallas kernel either.

The decode cache is updated in place: the reference's
`dynamic_update_slice` returns a new array, the port writes the new
token's k/v (or, with `cfg.kv_quant`, its int8 k/v and their scales)
into the cache it was given (one (B, KV, Dh) row per step, not a copy of
the whole cache) and returns that same dict.
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.models import common
from repro_torch.models.common import (apply_mrope, apply_rope, linear,
                                       linear_init)

NEG_INF = -1e30


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, length) -> torch.Tensor:
    """Single-step decode: q (B, 1, H, Dh), caches (B, S, KV, Dh).

    Attends over cache[:length], scores and the weighted sum accumulated
    in f32 as the reference's `preferred_element_type`. Returns
    (B, 1, H, Dh)."""
    B, _, H, Dh = q.shape
    S, KV = k_cache.shape[1], k_cache.shape[2]
    groups = H // KV
    scale = 1.0 / math.sqrt(Dh)
    qg = q.reshape(B, KV, groups, Dh)
    s = torch.einsum("bkgd,bskd->bkgs", qg.float(), k_cache.float()) * scale
    pos = torch.arange(S, device=q.device)
    s = s.masked_fill(pos >= length, NEG_INF)
    p = torch.softmax(s, dim=-1).to(v_cache.dtype)
    out = torch.einsum("bkgs,bskd->bkgd", p.float(), v_cache.float())
    return out.reshape(B, 1, H, Dh).to(q.dtype)


def gqa_init(gen, cfg: ArchConfig, dtype, device, lead: tuple = ()) -> dict:
    d, H, KV, Dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.dh
    bias = cfg.qkv_bias
    p = {"wq": linear_init(gen, d, H * Dh, dtype, device, lead, bias),
         "wk": linear_init(gen, d, KV * Dh, dtype, device, lead, bias),
         "wv": linear_init(gen, d, KV * Dh, dtype, device, lead, bias),
         "wo": linear_init(gen, H * Dh, d, dtype, device, lead)}
    if cfg.qk_norm:
        p["q_norm"] = common.rmsnorm_init(Dh, dtype, device, lead)
        p["k_norm"] = common.rmsnorm_init(Dh, dtype, device, lead)
    return p


def _project_qkv(p: dict, x: torch.Tensor, cfg: ArchConfig,
                 positions: torch.Tensor,
                 mrope_positions: torch.Tensor | None = None,
                 use_rope: bool = True, use_kernel: bool | None = None):
    B, S, _ = x.shape
    H, KV, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.dh
    q = linear(p["wq"], x).reshape(B, S, H, Dh)
    k = linear(p["wk"], x).reshape(B, S, KV, Dh)
    v = linear(p["wv"], x).reshape(B, S, KV, Dh)
    if cfg.qk_norm:
        q = common.rmsnorm(p["q_norm"], q, use_kernel=use_kernel)
        k = common.rmsnorm(p["k_norm"], k, use_kernel=use_kernel)
    if not use_rope:                # absolute-position models (Whisper)
        return q, k, v
    if cfg.mrope_sections is not None and mrope_positions is not None:
        q = apply_mrope(q, mrope_positions, cfg.mrope_sections,
                        cfg.rope_theta)
        k = apply_mrope(k, mrope_positions, cfg.mrope_sections,
                        cfg.rope_theta)
    else:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def gqa_attend(p: dict, x: torch.Tensor, cfg: ArchConfig,
               positions: torch.Tensor, causal: bool = True,
               mrope_positions: torch.Tensor | None = None,
               use_rope: bool = True,
               use_kernel: bool | None = None) -> torch.Tensor:
    q, k, v = _project_qkv(p, x, cfg, positions, mrope_positions, use_rope,
                           use_kernel)
    out = fa_ops.flash_attention(q, k, v, causal=causal,
                                 use_kernel=use_kernel)
    B, S = x.shape[:2]
    return linear(p["wo"], out.reshape(B, S, cfg.num_heads * cfg.dh))


def gqa_prefill_cache(p: dict, x: torch.Tensor, cfg: ArchConfig,
                      positions: torch.Tensor) -> tuple[torch.Tensor, dict]:
    """Prefill: returns (out, {k, v}) so serving can reuse the projections."""
    q, k, v = _project_qkv(p, x, cfg, positions)
    out = fa_ops.flash_attention(q, k, v, causal=True)
    B, S = x.shape[:2]
    return linear(p["wo"], out.reshape(B, S, cfg.num_heads * cfg.dh)), \
        {"k": k, "v": v}


def quantize_kv(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-(token, head) symmetric int8 over Dh. x: (..., Dh) -> (int8
    values, f32 scales (..., 1)); rounds half to even, as `jnp.round`."""
    xf = x.float()
    scale = xf.abs().amax(dim=-1, keepdim=True) / 127.0
    q = torch.round(xf / scale.clamp_min(1e-12)).to(torch.int8)
    return q, scale


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor,
                  dtype) -> torch.Tensor:
    return (q.float() * scale).to(dtype)


def gqa_decode(p: dict, x: torch.Tensor, cfg: ArchConfig, cache: dict,
               length: int) -> tuple[torch.Tensor, dict]:
    """x: (B, 1, d). cache: {k, v} (B, S_max, KV, Dh), or with
    `cfg.kv_quant` the int8 cache {k_q, k_s, v_q, v_s} (values (B, S_max,
    KV, Dh), f32 scales (B, S_max, KV, 1)), dequantized whole for the
    step as in the reference. `length` tokens are already cached; the new
    token is written at index `length`, in place."""
    B = x.shape[0]
    pos = torch.full((B, 1), length, dtype=torch.int32, device=x.device)
    q, k, v = _project_qkv(p, x, cfg, pos)
    if cfg.kv_quant:
        for name, t in (("k", k), ("v", v)):
            tq, ts = quantize_kv(t[:, 0])
            cache[f"{name}_q"][:, length] = tq
            cache[f"{name}_s"][:, length] = ts
        k_cache = dequantize_kv(cache["k_q"], cache["k_s"], x.dtype)
        v_cache = dequantize_kv(cache["v_q"], cache["v_s"], x.dtype)
    else:
        cache["k"][:, length] = k[:, 0]
        cache["v"][:, length] = v[:, 0]
        k_cache, v_cache = cache["k"], cache["v"]
    out = decode_attention(q, k_cache, v_cache, length + 1)
    y = linear(p["wo"], out.reshape(B, 1, cfg.num_heads * cfg.dh))
    return y, cache
