"""Mixture-of-experts FFN with top-k routing and two dispatches: the port
of `repro/models/moe.py`.

Tokens are routed in fixed-size groups (GShard's G axis): capacity and
the dispatch tensors are per group, so the one-hot intermediates are
O(tokens · group size · k · capacity factor), whatever E is.

  * "einsum":  GShard's one-hot dispatch and combine (`moe.py:81-109`).
  * "scatter": each (token, slot) goes to its expert's queue by an
    indexed add and comes back by a gather (`moe.py:112-148`).

Both keep the reference's queue order: an exclusive cumsum over the
group's (token, slot) one-hot, token-major and slot-minor, with the k
slots of a token in `topk`'s descending order; a slot at or past the
capacity C of its expert is dropped, and so (einsum) is a kept slot whose
combine weight is 0, as `dispatch = combine > 0` drops it there. The
router's logits and softmax are f32, from the router weight widened to
f32 (`moe.py:51-52`); `transformer.compute_params` leaves that weight in
its parameter dtype. The expert products are batched matrix products
over the stacked (E, ...) weights, as the reference leaves them to XLA:
the JAX package has no Pallas kernel here.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig, MoEConfig
from repro_torch.models.common import (_normal, linear_init, swiglu,
                                       swiglu_init)

GROUP_SIZE = 256


def moe_init(gen, cfg: ArchConfig, dtype, device, lead: tuple = ()) -> dict:
    """The router (d, E), the stacked experts' w_gate and w_up (E, d, f)
    and w_down (E, f, d), N(0, 1/fan_in), behind `lead`; the shared
    SwiGLU of width num_shared · f where the config has one."""
    e = cfg.moe
    d, f, E = cfg.d_model, e.d_expert_ff, e.num_experts
    p = {"router": linear_init(gen, d, E, dtype, device, lead),
         "w_gate": _normal(gen, lead + (E, d, f), dtype,
                           device).div_(math.sqrt(d)),
         "w_up": _normal(gen, lead + (E, d, f), dtype,
                         device).div_(math.sqrt(d)),
         "w_down": _normal(gen, lead + (E, f, d), dtype,
                           device).div_(math.sqrt(f))}
    if e.num_shared:
        p["shared"] = swiglu_init(gen, d, e.num_shared * f, dtype, device,
                                  lead)
    return p


def _router(p: dict, x: torch.Tensor, e: MoEConfig):
    """Top-k routing. x: (..., d) -> (weights f32, ids int64), (..., k),
    the weights renormalised over the k slots."""
    logits = x.float() @ p["router"]["w"].float()            # (..., E)
    probs = torch.softmax(logits, dim=-1)
    weights, ids = torch.topk(probs, e.top_k, dim=-1)
    weights = weights / weights.sum(dim=-1, keepdim=True).clamp_min(1e-9)
    return weights, ids


def _group(x: torch.Tensor, group_size: int):
    """(B, S, d) -> ((G, gs, d), G, gs), gs the largest divisor of the
    token count that is at most `group_size`."""
    B, S, d = x.shape
    n = B * S
    gs = min(group_size, n)
    while n % gs:
        gs -= 1
    return x.reshape(n // gs, gs, d), n // gs, gs


def _capacity(tokens_per_group: int, e: MoEConfig) -> int:
    """Slots per expert and group: at least 4, a multiple of 4."""
    c = int(math.ceil(tokens_per_group * e.top_k / e.num_experts
                      * e.capacity_factor))
    return max(4, -(-c // 4) * 4)


def _positions(ids: torch.Tensor, E: int) -> torch.Tensor:
    """Queue position of each (token, slot) in its expert within the
    group: ids (G, gs, k) -> (G, gs, k), the exclusive cumsum of the
    token-major, slot-minor one-hot read at the slot's expert."""
    G, gs, k = ids.shape
    flat = F.one_hot(ids, E).reshape(G, gs * k, E)
    pos = torch.cumsum(flat, dim=1) - flat
    return pos.reshape(G, gs, k, E).gather(-1, ids[..., None])[..., 0]


def moe_apply_einsum(p: dict, x: torch.Tensor, cfg: ArchConfig
                     ) -> torch.Tensor:
    """GShard one-hot dispatch. x: (B, S, d) -> (B, S, d)."""
    e = cfg.moe
    B, S, d = x.shape
    xg, G, gs = _group(x, GROUP_SIZE)
    C = _capacity(gs, e)
    weights, ids = _router(p, xg, e)                          # (G, gs, k)
    onehot = F.one_hot(ids, e.num_experts).float()            # (G,gs,k,E)
    flat = onehot.reshape(G, gs * e.top_k, e.num_experts)
    pos = (torch.cumsum(flat, dim=1) - flat).reshape(onehot.shape)
    keep = (pos < C).float() * onehot
    # One-hot of the slot's position, all zeros at or past C (as
    # `jax.nn.one_hot` of an index out of range).
    slot = (pos * onehot).sum(-1).long().clamp_max(C)
    pos_c = F.one_hot(slot, C + 1)[..., :C].float()           # (G,gs,k,C)
    # combine[g,s,e,c] = Σ_k w_k · keep · onehot(position): at most one
    # slot k of a token is nonzero at (e, c), so the sum is exact, and a
    # two-operand product is what the reference's three-operand one is.
    combine = torch.einsum("gske,gskc->gsec", keep * weights[..., None],
                           pos_c)
    dispatch = (combine > 0).to(x.dtype)                      # (G,gs,E,C)
    xe = torch.einsum("gsec,gsd->egcd", dispatch, xg)         # (E,G,C,d)
    xe = xe.reshape(e.num_experts, G * C, d)
    h = F.silu(torch.bmm(xe, p["w_gate"].to(x.dtype)))
    h = h * torch.bmm(xe, p["w_up"].to(x.dtype))
    ye = torch.bmm(h, p["w_down"].to(x.dtype))                # (E, G·C, d)
    ye = ye.reshape(e.num_experts, G, C, d)
    y = torch.einsum("gsec,egcd->gsd", combine.to(x.dtype), ye)
    y = y.reshape(B, S, d)
    if e.num_shared:
        y = y + swiglu(p["shared"], x)
    return y


def moe_apply_scatter(p: dict, x: torch.Tensor, cfg: ArchConfig
                      ) -> torch.Tensor:
    """Scatter/gather dispatch: no dispatch products."""
    e = cfg.moe
    B, S, d = x.shape
    E, k = e.num_experts, e.top_k
    xg, G, gs = _group(x, GROUP_SIZE)
    C = _capacity(gs, e)
    weights, ids = _router(p, xg, e)                          # (G, gs, k)
    pos = _positions(ids, E)
    eid = ids.reshape(G, gs * k)
    pidx = torch.where(pos < C, pos, C).reshape(G, gs * k)    # C: dropped
    gid = torch.arange(G, device=x.device)[:, None].expand(G, gs * k)
    src = xg.repeat_interleave(k, dim=1)                      # (G, gs·k, d)
    buf = x.new_zeros((G, E, C + 1, d))
    buf.index_put_((gid, eid, pidx), src, accumulate=True)
    xe = buf[:, :, :C].transpose(0, 1).reshape(E, G * C, d)
    h = F.silu(torch.bmm(xe, p["w_gate"].to(x.dtype)))
    h = h * torch.bmm(xe, p["w_up"].to(x.dtype))
    ye = torch.bmm(h, p["w_down"].to(x.dtype))                # (E, G·C, d)
    ye = F.pad(ye.reshape(E, G, C, d).transpose(0, 1),
               (0, 0, 0, 1))                                  # drop row C
    out = ye[gid, eid, pidx].reshape(G, gs, k, d)
    y = (out * weights[..., None].to(x.dtype)).sum(dim=2)
    y = y.reshape(B, S, d)
    if e.num_shared:
        y = y + swiglu(p["shared"], x)
    return y


def moe_apply(p: dict, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    if cfg.moe.dispatch == "scatter":
        return moe_apply_scatter(p, x, cfg)
    return moe_apply_einsum(p, x, cfg)
