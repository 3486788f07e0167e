"""Mamba-2 (SSD, state-space duality) blocks: the port of
`repro/models/ssm.py`.

  y = SSD(x)   with  h_t = exp(dt·A)·h_{t-1} + dt·B_t x_t,   y_t = C_t h_t

computed in chunks: the intra-chunk part as masked matrix products, the
inter-chunk state recurrence through the hand-written `ssd_scan` kernel
on the card (`repro_torch.kernels.ssd_scan.ops`), where the JAX model
runs it inline as a `lax.scan`. Under autograd the scan runs inside
`SSDScanFn`, whose backward is the hand-written backward kernel (the
recurrence in reverse); everything around it is differentiated by
autograd, as `jax.grad` differentiates the reference: the masked
exponent's -inf gives exp 0 and a zero gradient, and the bf16 round
trips pass their gradient through as the reference's `astype` does.
Decode is the O(1) recurrence on the (H, P, N) state, updated in place
in the cache it is given.

The numerics follow the JAX model's: where it multiplies a bfloat16
array by a float32 one (which promotes to float32) or asks an einsum for
float32 accumulation, the port computes in float32; where it casts an
operand to the activation dtype first (the masked scores, the decays,
`h_prev`, `D` in `ssm_apply`), the port rounds it the same way before
the float32 product. Torch's matmul and einsum refuse mixed dtypes and
would return bfloat16 from bfloat16 inputs, so the operands are upcast
explicitly.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.models.common import (linear, linear_init, rmsnorm,
                                       rmsnorm_init)


def ssm_dims(cfg: ArchConfig) -> tuple[int, int, int, int]:
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    nheads = d_in // s.head_dim
    return d_in, nheads, s.head_dim, s.d_state


def ssm_init(gen, cfg: ArchConfig, dtype, device, lead: tuple = ()) -> dict:
    """One draw per layer for each leaf, stacked on `lead`. A_log, D and
    dt_bias are float32 whatever `dtype` is, as in the reference."""
    s = cfg.ssm
    d = cfg.d_model
    d_in, H, P, N = ssm_dims(cfg)
    G = s.n_groups
    d_proj = 2 * d_in + 2 * G * N + H   # z, x, B, C, dt
    conv_dim = d_in + 2 * G * N
    f32 = dict(dtype=torch.float32, device=device)
    conv_w = torch.randn(lead + (s.conv_kernel, conv_dim), generator=gen,
                         dtype=dtype, device=device)
    return {
        "in_proj": linear_init(gen, d, d_proj, dtype, device, lead),
        "conv_w": conv_w.div_(math.sqrt(s.conv_kernel)),
        "conv_b": torch.zeros(lead + (conv_dim,), dtype=dtype, device=device),
        "A_log": torch.zeros(lead + (H,), **f32),
        "D": torch.ones(lead + (H,), **f32),
        "dt_bias": torch.zeros(lead + (H,), **f32),
        "norm": rmsnorm_init(d_in, dtype, device, lead),
        "out_proj": linear_init(gen, d_in, d, dtype, device, lead),
    }


def _split_at(x: torch.Tensor, indices) -> list[torch.Tensor]:
    """`jnp.split(x, indices, axis=-1)`: cuts the last axis AT the given
    indices (torch.split takes sizes)."""
    bounds = [0, *indices, x.shape[-1]]
    return [x[..., a:b] for a, b in zip(bounds, bounds[1:])]


def _split_proj(proj: torch.Tensor, cfg: ArchConfig):
    d_in, H, P, N = ssm_dims(cfg)
    G = cfg.ssm.n_groups
    z, xbc, dt = _split_at(proj, [d_in, 2 * d_in + 2 * G * N])
    return z, xbc, dt


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over sequence. xbc: (B, S, Cdim)."""
    K = w.shape[0]
    pad = F.pad(xbc, (0, 0, K - 1, 0))
    out = sum(pad[:, i:i + xbc.shape[1]] * w[i] for i in range(K))
    return F.silu(out + b)


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """Lower-triangular pairwise cumulative sums: out[..., i, j] =
    Σ_{j<k<=i} a[..., k] for i >= j, −inf above the diagonal (so that
    exp gives 0 there)."""
    Q = a.shape[-1]
    cum = torch.cumsum(a, dim=-1)
    diff = cum[..., :, None] - cum[..., None, :]
    mask = torch.ones((Q, Q), dtype=torch.bool, device=a.device).tril()
    return diff.masked_fill(~mask, -math.inf)


def ssd_chunked(xh: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                Bm: torch.Tensor, Cm: torch.Tensor, chunk: int,
                h0: torch.Tensor | None = None,
                use_kernel: bool | None = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan.

    Args:
      xh: (B, S, H, P) inputs per head.
      dt: (B, S, H) positive step sizes, float32.
      A:  (H,) negative decay rates, float32.
      Bm: (B, S, G, N) input maps;  Cm: (B, S, G, N) output maps.
      chunk: chunk length Q (S % Q == 0 assumed; callers pad).
      h0: optional initial state (B, H, P, N).
      use_kernel: the inter-chunk scan through the CUDA kernel (None: on
        the card) or its plain version (False).

    Returns (y: (B, S, H, P) in xh's dtype, final_state: (B, H, P, N) f32).
    """
    Bsz, S, H, P = xh.shape
    G, N = Bm.shape[2], Bm.shape[3]
    Q = chunk
    nc = S // Q
    rep = H // G
    # Broadcast groups to heads (jnp.repeat: each group `rep` times in a row).
    Bh = torch.repeat_interleave(Bm, rep, dim=2)          # (B,S,H,N)
    Ch = torch.repeat_interleave(Cm, rep, dim=2)
    xc = xh.reshape(Bsz, nc, Q, H, P)
    dtc = dt.reshape(Bsz, nc, Q, H)
    Bc = Bh.reshape(Bsz, nc, Q, H, N)
    Cc = Ch.reshape(Bsz, nc, Q, H, N)
    dA = (dtc * A).float()                                # (B,nc,Q,H) < 0
    cum = torch.cumsum(dA, dim=2)                         # within-chunk
    # 1) intra-chunk (diagonal blocks): Y = (L ∘ C Bᵀ) · (dt·X)
    Lmat = torch.exp(_segsum(dA.permute(0, 1, 3, 2)))     # (B,nc,H,Q,Q)
    scores = torch.einsum("bcqhn,bckhn->bchqk", Cc.float(), Bc.float())
    scores = scores * Lmat
    xdt = xc * dtc[..., None]                             # promotes to f32
    y_diag = torch.einsum("bchqk,bckhp->bcqhp",
                          scores.to(xh.dtype).float(), xdt)
    # 2) chunk states: S_c = Σ_q exp(cum_last − cum_q)·B_q ⊗ (dt·x)_q
    decay_out = torch.exp(cum[:, :, -1:, :] - cum)        # (B,nc,Q,H)
    states = torch.einsum("bcqhn,bcqh,bcqhp->bchpn", Bc.float(),
                          decay_out.to(Bc.dtype).float(), xdt)
    # 3) inter-chunk recurrence over chunk states: the ssd_scan kernel.
    chunk_decay = torch.exp(cum[:, :, -1, :])             # (B,nc,H)
    h_prev, h_last = ssd_ops.ssd_scan(states, chunk_decay, h0,
                                      use_kernel=use_kernel)
    # 4) inter-chunk output: y_off = exp(cum)·C · h_prev
    y_off = torch.einsum("bcqhn,bchpn,bcqh->bcqhp", Cc.float(),
                         h_prev.to(Cc.dtype).float(),
                         torch.exp(cum).to(Cc.dtype).float())
    y = (y_diag + y_off).reshape(Bsz, S, H, P).to(xh.dtype)
    return y, h_last


def ssm_apply(p: dict, x: torch.Tensor, cfg: ArchConfig,
              use_kernel: bool | None = None) -> torch.Tensor:
    """Full-sequence Mamba-2 block. x: (B, S, d) -> (B, S, d).
    `use_kernel=False` takes the kernels' plain versions on the card."""
    s = cfg.ssm
    d_in, H, P, N = ssm_dims(cfg)
    G = s.n_groups
    B_, S, _ = x.shape
    proj = linear(p["in_proj"], x)
    z, xbc, dt = _split_proj(proj, cfg)
    xbc = _causal_conv(xbc, p["conv_w"].to(x.dtype),
                       p["conv_b"].to(x.dtype))
    xs, Bm, Cm = _split_at(xbc, [d_in, d_in + G * N])
    dt = F.softplus(dt.float() + p["dt_bias"])            # (B,S,H)
    A = -torch.exp(p["A_log"])                            # (H,) < 0
    xh = xs.reshape(B_, S, H, P)
    Bm = Bm.reshape(B_, S, G, N)
    Cm = Cm.reshape(B_, S, G, N)
    Q = min(s.chunk, S)
    pad = (-S) % Q
    if pad:
        # Padded positions get dt = 0: decay 1, no state contribution.
        xh = F.pad(xh, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, 0, 0, pad))
    y, _ = ssd_chunked(xh, dt, A, Bm, Cm, Q, use_kernel=use_kernel)
    y = y[:, :S]
    y = y + xh[:, :S] * p["D"][None, None, :, None].to(y.dtype)
    y = y.reshape(B_, S, d_in)
    y = rmsnorm(p["norm"], y * F.silu(z), use_kernel=use_kernel)
    return linear(p["out_proj"], y)


def ssm_decode(p: dict, x: torch.Tensor, cfg: ArchConfig, state: dict,
               ) -> tuple[torch.Tensor, dict]:
    """O(1) decode step. x: (B, 1, d); state: {h: (B, H, P, N) f32,
    conv: (B, K-1, conv_dim)} (the conv tail for the causal conv). The
    reference returns a new state; the port writes it into `state` (one
    state per layer, no copy of the whole cache) and returns that dict."""
    s = cfg.ssm
    d_in, H, P, N = ssm_dims(cfg)
    G = s.n_groups
    B_ = x.shape[0]
    proj = linear(p["in_proj"], x)                        # (B,1,·)
    z, xbc, dt = _split_proj(proj, cfg)
    conv_in = torch.cat([state["conv"], xbc], dim=1)      # (B,K,·)
    w = p["conv_w"].to(x.dtype)
    out = (conv_in * w[None]).sum(dim=1, keepdim=True)
    xbc = F.silu(out + p["conv_b"].to(x.dtype))
    xs, Bm, Cm = _split_at(xbc, [d_in, d_in + G * N])
    dt = F.softplus(dt.float() + p["dt_bias"])            # (B,1,H)
    A = -torch.exp(p["A_log"])
    xh = xs.reshape(B_, H, P)
    Bm = torch.repeat_interleave(Bm.reshape(B_, G, N), H // G, dim=1)
    Cm = torch.repeat_interleave(Cm.reshape(B_, G, N), H // G, dim=1)
    dA = torch.exp(dt[:, 0, :] * A[None, :])              # (B,H)
    h = state["h"]
    h.mul_(dA[..., None, None]).add_(torch.einsum(
        "bhp,bhn->bhpn", xh * dt[:, 0, :, None], Bm.float()))
    y = torch.einsum("bhpn,bhn->bhp", h, Cm.float())
    y = y + xh * p["D"][None, :, None]                    # f32
    y = y.reshape(B_, 1, d_in).to(x.dtype)
    y = rmsnorm(p["norm"], y * F.silu(z))
    state["conv"].copy_(conv_in[:, 1:])
    return linear(p["out_proj"], y), state


def ssm_init_state(cfg: ArchConfig, batch: int, dtype, device,
                   lead: tuple = ()) -> dict:
    """Zeroed decode state, stacked on `lead` (the model's layer axis)."""
    s = cfg.ssm
    d_in, H, P, N = ssm_dims(cfg)
    conv_dim = d_in + 2 * s.n_groups * s.d_state
    return {"h": torch.zeros(lead + (batch, H, P, N), dtype=torch.float32,
                             device=device),
            "conv": torch.zeros(lead + (batch, s.conv_kernel - 1, conv_dim),
                                dtype=dtype, device=device)}
