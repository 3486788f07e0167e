"""Closed-form backward of flash attention, in torch ops.

From the saved q, k, v, the output O and each query row's log-sum-exp
(the kernel writes it beside O), per kv chunk of `chunk` keys, as the JAX
package's `flash_attention_jnp` walks the keys
(`repro/models/attention.py:30-82`):

    D  = rowsum(dO · O)
    S  = scale · Q Kᵀ,        P = exp(S − LSE)   (0 where masked)
    dV = Pᵀ dO,   dP = dO Vᵀ,   dS = P · (dP − D)
    dQ = scale · dS K,        dK = scale · dSᵀ Q

so no Sq × Skv matrix larger than one chunk exists. Where a chunk lies
wholly above the causal diagonal for a query row, that row is left out
of the chunk's products. GQA folds the H / KV query heads of a kv head
into its rows, so dK and dV sum over them. The products take the
forward's operand dtype (bfloat16 in the model: P and dS are rounded to
it, as the forward rounds P before P·V) and accumulate in f32, as the
reference's einsums with `preferred_element_type=f32`; float32 operands
give float32 products. The JAX package has no backward kernel: its
models differentiate `flash_attention_jnp`.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30
CHUNK = 1024


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b over the leading dims, with f32 accumulation and an f32
    result. bfloat16 operands on the card take `out_dtype`; elsewhere they
    are widened first, which gives the same products (a bf16 × bf16
    product is exact in f32)."""
    if a.dtype == torch.float32:
        return torch.matmul(a, b)
    if a.device.type == "cuda":
        lead = a.shape[:-2]
        out = torch.bmm(a.reshape(-1, *a.shape[-2:]),
                        b.reshape(-1, *b.shape[-2:]),
                        out_dtype=torch.float32)
        return out.reshape(*lead, *out.shape[-2:])
    return torch.matmul(a.float(), b.float())


def attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  out: torch.Tensor, lse: torch.Tensor, dout: torch.Tensor,
                  causal: bool = True, q_offset: int = 0,
                  chunk: int = CHUNK):
    """q (B, Sq, H, Dh), k (B, Skv, KV, Dh), v (B, Skv, KV, Dv), out and
    dout (B, Sq, H, Dv), lse (B, H, Sq) f32 -> (dq, dk, dv) in the dtypes
    of q, k and v."""
    B, Sq, H, Dh = q.shape
    Skv, KV, Dv = k.shape[1], k.shape[2], v.shape[-1]
    g = H // KV
    op = q.dtype
    scale = 1.0 / math.sqrt(Dh)

    def fold(t, D):         # (B, S, H, D) -> (B, KV, g, S, D)
        return t.reshape(B, Sq, KV, g, D).permute(0, 2, 3, 1, 4)

    qg, og, dog = fold(q, Dh), fold(out, Dv), fold(dout.to(op), Dv)
    lse_g = lse.reshape(B, KV, g, Sq, 1)
    delta = (dog.float() * og.float()).sum(dim=-1, keepdim=True)
    kg = k.permute(0, 2, 1, 3)                     # (B, KV, Skv, Dh)
    vg = v.permute(0, 2, 1, 3)
    dq = torch.zeros((B, KV, g, Sq, Dh), dtype=torch.float32,
                     device=q.device)
    dk = torch.zeros((B, KV, Skv, Dh), dtype=torch.float32, device=q.device)
    dv = torch.zeros((B, KV, Skv, Dv), dtype=torch.float32, device=q.device)
    q_pos = q_offset + torch.arange(Sq, device=q.device)
    for c0 in range(0, Skv, chunk):
        c1 = min(Skv, c0 + chunk)
        # Query rows that see no key of the chunk take no part in it.
        r0 = min(Sq, max(0, c0 - q_offset)) if causal else 0
        if r0 == Sq:
            continue
        n = Sq - r0

        def rows(t, D):     # the chunk's query rows, heads folded in
            return t[:, :, :, r0:].reshape(B, KV, g * n, D)

        qc, doc = rows(qg, Dh), rows(dog, Dv)
        kc, vc = kg[:, :, c0:c1], vg[:, :, c0:c1]
        s = _mm(qc, kc.transpose(-1, -2)).reshape(B, KV, g, n, c1 - c0) \
            * scale
        p = torch.exp(s - lse_g[:, :, :, r0:])
        if causal:
            dead = (torch.arange(c0, c1, device=q.device)[None, :]
                    > q_pos[r0:, None])
            p = p.masked_fill(dead, 0.0)
        pc = p.reshape(B, KV, g * n, c1 - c0)
        dv[:, :, c0:c1] += _mm(pc.to(op).transpose(-1, -2), doc)
        dp = _mm(doc, vc.transpose(-1, -2)).reshape(p.shape)
        ds = (p * (dp - delta[:, :, :, r0:])).mul_(scale)
        dsc = ds.reshape(B, KV, g * n, c1 - c0).to(op)
        dq[:, :, :, r0:] += _mm(dsc, kc).reshape(B, KV, g, n, Dh)
        dk[:, :, c0:c1] += _mm(dsc.transpose(-1, -2), qc)
    dq = dq.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, Dh)
    return (dq.to(q.dtype), dk.permute(0, 2, 1, 3).to(k.dtype),
            dv.permute(0, 2, 1, 3).to(v.dtype))
