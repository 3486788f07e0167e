"""Shared model primitives: norms, rotary embeddings, FFNs, embeddings.

The port of `repro/models/common.py`. Functional
style, as there: params are nested dicts of tensors and every layer is a
function `f(params, x, ...)`. Initialisers take an explicit
`torch.Generator` (None only on the `meta` device, where nothing is
drawn) and a `lead` shape that stacks one draw per layer, so a whole
model's stacked leaves are drawn in one call each.

`rmsnorm` goes through the hand-written kernel on the card
(`repro_torch.kernels.rmsnorm.ops`); the matrix products stay
`torch.matmul`, as the JAX package leaves them to XLA.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels.rmsnorm import ops as rmsnorm_ops

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


def dtype_of(name: str) -> torch.dtype:
    return _DTYPES[name]


def _normal(gen, shape, dtype, device) -> torch.Tensor:
    return torch.randn(shape, generator=gen, dtype=dtype, device=device)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------
def rmsnorm_init(d: int, dtype, device, lead: tuple = ()) -> dict:
    return {"scale": torch.ones(lead + (d,), dtype=dtype, device=device)}


def rmsnorm(p: dict, x: torch.Tensor, eps: float = 1e-6,
            use_kernel: bool | None = None) -> torch.Tensor:
    """RMSNorm in f32 accumulation, cast back to x's dtype."""
    return rmsnorm_ops.rmsnorm(x, p["scale"], eps, use_kernel=use_kernel)


# ---------------------------------------------------------------------------
# Rotary position embeddings (+ M-RoPE for Qwen2-VL), sinusoidal positions
# ---------------------------------------------------------------------------
def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 1e6) -> torch.Tensor:
    """x: (..., S, H, Dh) or (..., S, Dh); positions: (..., S)."""
    dh = x.shape[-1]
    freqs = rope_freqs(dh, theta, x.device)                 # (Dh/2,)
    angles = positions[..., None].float() * freqs           # (..., S, Dh/2)
    if x.dim() == angles.dim() + 1:                         # has head axis
        angles = angles[..., None, :]
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_mrope(x: torch.Tensor, positions: torch.Tensor,
                sections, theta: float = 1e6) -> torch.Tensor:
    """Multimodal RoPE (Qwen2-VL): positions (3, ..., S) for (t, h, w);
    `sections` splits the rotary half-width across the three components,
    frequency i turning with component j where i falls in section j."""
    dh = x.shape[-1]
    freqs = rope_freqs(dh, theta, x.device)                 # (Dh/2,)
    sec = torch.repeat_interleave(
        torch.arange(len(sections), device=x.device),
        torch.tensor(sections, device=x.device))            # (Dh/2,)
    pos_sel = positions.index_select(0, sec).movedim(0, -1)  # (..., S, Dh/2)
    angles = pos_sel.float() * freqs
    if x.dim() == angles.dim() + 1:
        angles = angles[..., None, :]
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def sinusoidal_positions(seq: int, d: int, device=None) -> torch.Tensor:
    """Whisper-style fixed sinusoidal embeddings (seq, d), in f32; the
    callers cast them to the activation dtype."""
    pos = torch.arange(seq, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(0, d, 2, dtype=torch.float32, device=device)[None, :]
    angle = pos / torch.pow(10000.0, dim / d)
    return torch.cat([torch.sin(angle), torch.cos(angle)], dim=-1)


# ---------------------------------------------------------------------------
# Dense / SwiGLU FFN
# ---------------------------------------------------------------------------
def linear_init(gen, d_in: int, d_out: int, dtype, device,
                lead: tuple = (), bias: bool = False) -> dict:
    """Weight N(0, 1/d_in); the bias, where asked for, zeros, as the
    reference's."""
    w = _normal(gen, lead + (d_in, d_out), dtype, device)
    p = {"w": w.div_(math.sqrt(d_in))}
    if bias:
        p["b"] = torch.zeros(lead + (d_out,), dtype=dtype, device=device)
    return p


def linear(p: dict, x: torch.Tensor) -> torch.Tensor:
    """x @ w, plus the bias in x's dtype where the layer has one."""
    y = x @ p["w"].to(x.dtype)
    if "b" in p:
        y = y + p["b"].to(x.dtype)
    return y


def swiglu_init(gen, d: int, d_ff: int, dtype, device,
                lead: tuple = ()) -> dict:
    return {"w_gate": linear_init(gen, d, d_ff, dtype, device, lead),
            "w_up": linear_init(gen, d, d_ff, dtype, device, lead),
            "w_down": linear_init(gen, d_ff, d, dtype, device, lead)}


def swiglu(p: dict, x: torch.Tensor) -> torch.Tensor:
    g = F.silu(linear(p["w_gate"], x))
    return linear(p["w_down"], g * linear(p["w_up"], x))


# ---------------------------------------------------------------------------
# Embeddings / LM head
# ---------------------------------------------------------------------------
def embedding_init(gen, vocab: int, d: int, dtype, device) -> dict:
    return {"table": _normal(gen, (vocab, d), dtype, device).mul_(0.02)}


def embed(p: dict, tokens: torch.Tensor, dtype) -> torch.Tensor:
    return p["table"][tokens].to(dtype)


def lm_head(p: dict, x: torch.Tensor) -> torch.Tensor:
    """Logits in f32 for a stable softmax."""
    return (x @ p["table"].to(x.dtype).T).float()


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  ignore_id: int = -1) -> torch.Tensor:
    """Mean token cross-entropy; f32 logits (B, S, V), labels (B, S); the
    log-sum-exp in f32, positions labelled `ignore_id` left out."""
    mask = (labels != ignore_id).float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1,
                        labels.clamp_min(0).long()[..., None])[..., 0]
    nll = (lse - gold) * mask
    return nll.sum() / mask.sum().clamp_min(1.0)
