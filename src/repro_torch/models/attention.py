"""GQA/MQA attention with RoPE or M-RoPE, qk-norm and qkv bias, and
DeepSeek's multi-head latent attention (MLA): the port of
`repro/models/attention.py`.

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

MLA (`mla_attend`, `mla_decode`): queries come up from a q_lora_rank
latent, keys and values from a kv_lora_rank latent c_kv, and a rotary key
of qk_rope_head_dim columns shared by every head. Its two latent norms
go through the rmsnorm kernel. Full-sequence attention expands the
latents to per-head keys (qk_nope + qk_rope columns: 192 at deepseek's
widths) and values (v_head_dim: 128) and goes through the flash-attention
kernel at those two widths. Decode keeps only {c_kv, k_rope} in its cache
and absorbs W_uk into the query and W_uv into the output, in plain torch
with f32 scores and weighted sum, as the reference.
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


# ---------------------------------------------------------------------------
# DeepSeek-V3 multi-head latent attention (MLA)
# ---------------------------------------------------------------------------
def mla_init(gen, cfg: ArchConfig, dtype, device, lead: tuple = ()) -> dict:
    m = cfg.mla
    d, H = cfg.d_model, cfg.num_heads
    qk_head = m.qk_nope_head_dim + m.qk_rope_head_dim
    return {
        "wdq": linear_init(gen, d, m.q_lora_rank, dtype, device, lead),
        "q_norm": common.rmsnorm_init(m.q_lora_rank, dtype, device, lead),
        "wuq": linear_init(gen, m.q_lora_rank, H * qk_head, dtype, device,
                           lead),
        "wdkv": linear_init(gen, d, m.kv_lora_rank, dtype, device, lead),
        "kv_norm": common.rmsnorm_init(m.kv_lora_rank, dtype, device, lead),
        "wkr": linear_init(gen, d, m.qk_rope_head_dim, dtype, device, lead),
        "wuk": linear_init(gen, m.kv_lora_rank, H * m.qk_nope_head_dim,
                           dtype, device, lead),
        "wuv": linear_init(gen, m.kv_lora_rank, H * m.v_head_dim, dtype,
                           device, lead),
        "wo": linear_init(gen, H * m.v_head_dim, d, dtype, device, lead),
    }


def _mla_qkr(p: dict, x: torch.Tensor, cfg: ArchConfig,
             positions: torch.Tensor, use_kernel: bool | None = None):
    """(q_nope (B, S, H, dn), q_rope (B, S, H, dr), c_kv (B, S, r),
    k_rope (B, S, dr)): the query heads, the kv latent and the rotary key
    shared by the heads."""
    m = cfg.mla
    B, S, _ = x.shape
    H = cfg.num_heads
    qk_head = m.qk_nope_head_dim + m.qk_rope_head_dim
    q_lat = common.rmsnorm(p["q_norm"], linear(p["wdq"], x),
                           use_kernel=use_kernel)
    q = linear(p["wuq"], q_lat).reshape(B, S, H, qk_head)
    q_nope, q_rope = torch.split(q, [m.qk_nope_head_dim,
                                     m.qk_rope_head_dim], dim=-1)
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    c_kv = common.rmsnorm(p["kv_norm"], linear(p["wdkv"], x),
                          use_kernel=use_kernel)
    k_rope = apply_rope(linear(p["wkr"], x), positions, cfg.rope_theta)
    return q_nope, q_rope, c_kv, k_rope


def mla_attend(p: dict, x: torch.Tensor, cfg: ArchConfig,
               positions: torch.Tensor, causal: bool = True,
               use_kernel: bool | None = None) -> torch.Tensor:
    """Prefill and training: the latents expanded to per-head keys (Dh =
    qk_nope + qk_rope) and values (Dv = v_head_dim), then flash attention
    (the kernel on the card)."""
    m = cfg.mla
    B, S, _ = x.shape
    H = cfg.num_heads
    q_nope, q_rope, c_kv, k_rope = _mla_qkr(p, x, cfg, positions,
                                            use_kernel)
    k_nope = linear(p["wuk"], c_kv).reshape(B, S, H, m.qk_nope_head_dim)
    v = linear(p["wuv"], c_kv).reshape(B, S, H, m.v_head_dim)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(
        B, S, H, m.qk_rope_head_dim)], dim=-1)
    out = fa_ops.flash_attention(q, k, v, causal=causal,
                                 use_kernel=use_kernel)
    return linear(p["wo"], out.reshape(B, S, H * m.v_head_dim))


def mla_decode(p: dict, x: torch.Tensor, cfg: ArchConfig, cache: dict,
               length: int) -> tuple[torch.Tensor, dict]:
    """Absorbed decode over the latent cache {c_kv (B, S_max, r), k_rope
    (B, S_max, dr)}: scores q_nope·W_uk·c_kv + q_rope·k_rope, W_uk folded
    into the query and W_uv into the output, so the cache stays
    compressed. x: (B, 1, d); the new token's latent and rotary key are
    written at index `length`, in place."""
    m = cfg.mla
    B = x.shape[0]
    H = cfg.num_heads
    pos = torch.full((B, 1), length, dtype=torch.int32, device=x.device)
    q_nope, q_rope, c_new, kr_new = _mla_qkr(p, x, cfg, pos)
    cache["c_kv"][:, length] = c_new[:, 0]
    cache["k_rope"][:, length] = kr_new[:, 0]
    c_cache, kr_cache = cache["c_kv"], cache["k_rope"]
    wuk = p["wuk"]["w"].reshape(m.kv_lora_rank, H, m.qk_nope_head_dim)
    q_lat = torch.einsum("bhd,rhd->bhr", q_nope[:, 0], wuk.to(x.dtype))
    scale = 1.0 / math.sqrt(m.qk_nope_head_dim + m.qk_rope_head_dim)
    s = (torch.einsum("bhr,bsr->bhs", q_lat.float(), c_cache.float())
         + torch.einsum("bhd,bsd->bhs", q_rope[:, 0].float(),
                        kr_cache.float())) * scale
    idx = torch.arange(c_cache.shape[1], device=x.device)
    s = s.masked_fill(idx >= length + 1, NEG_INF)
    pattn = torch.softmax(s, dim=-1).to(x.dtype)
    ctx = torch.einsum("bhs,bsr->bhr", pattn.float(),
                       c_cache.float()).to(x.dtype)
    wuv = p["wuv"]["w"].reshape(m.kv_lora_rank, H, m.v_head_dim)
    out = torch.einsum("bhr,rhv->bhv", ctx, wuv.to(x.dtype))
    y = linear(p["wo"], out.reshape(B, 1, H * m.v_head_dim))
    return y, cache
