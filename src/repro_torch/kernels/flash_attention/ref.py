"""Plain PyTorch version of the flash-attention kernel: direct
(materialising) softmax attention in f32, the port of the JAX package's
oracle `repro/kernels/flash_attention/ref.py`, with the kernel's
`q_offset` (query row i sits at absolute position q_offset + i)."""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True, q_offset: int = 0) -> torch.Tensor:
    """q: (B, Sq, H, Dh); k: (B, Skv, KV, Dh); v: (B, Skv, KV, Dv), with
    H % KV == 0 -> (B, Sq, H, Dv) in q's dtype."""
    B, Sq, H, Dh = q.shape
    Skv, KV, Dv = k.shape[1], k.shape[2], v.shape[-1]
    groups = H // KV
    scale = 1.0 / math.sqrt(Dh)
    qg = q.reshape(B, Sq, KV, groups, Dh)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg.float(), k.float()) * scale
    if causal:
        qpos = q_offset + torch.arange(Sq, device=q.device)
        mask = torch.arange(Skv, device=q.device)[None, :] > qpos[:, None]
        s = s.masked_fill(mask, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", p, v.float())
    return out.reshape(B, Sq, H, Dv).to(q.dtype)


def attention_lse_ref(q: torch.Tensor, k: torch.Tensor, causal: bool = True,
                      q_offset: int = 0) -> torch.Tensor:
    """Each query row's f32 log-sum-exp of its scaled, masked scores,
    (B, H, Sq): what the kernel writes when it is given a buffer."""
    B, Sq, H, Dh = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    qg = q.reshape(B, Sq, KV, H // KV, Dh)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg.float(), k.float()) \
        / math.sqrt(Dh)
    if causal:
        qpos = q_offset + torch.arange(Sq, device=q.device)
        mask = torch.arange(Skv, device=q.device)[None, :] > qpos[:, None]
        s = s.masked_fill(mask, NEG_INF)
    return torch.logsumexp(s, dim=-1).reshape(B, H, Sq)
