"""Chunked dispatch for the fused AL inner-step kernel.

`make_fused_inner` packs a fleet's static tensors into the kernel's
layout once and returns a `fused_inner(x, lam_eq, lam_in, mu)` callback
for `engine.al_minimize`: `inner_steps // k_steps` kernel calls and one
shorter call for the remainder, carrying (x, m, v) and the Adam step
count t0, so bias correction is the same as one long loop. Moments start
at zero on every call, the engine's contract (they reset every outer
multiplier round).

The kernel runs each row kind's code on the warps that hold rows of that
kind, so the callback works on the rows ordered by kind (a stable
permutation built once, batch rows first, so the kernel's slower blocks
start first): one warp holds both kinds, whatever the fleet's order. x
goes back in the caller's order.

The per-call scalars (`scal` rows, t0 included) are built on the device
with tensor ops, so a solve never reads a device value on the host.

Lanes (`api.sweep`, the ensembles): with a stacked x (N, W, T), the
callback runs N solves through one kernel call per k steps. Each lane
has its own `scal` row (coef0, mu, 1/scale, lr_scale), rowp and
moments; the fleet constants are shared (W, T) or per lane (N, W, T).
`is_batch` is never per lane, so one permutation by kind serves them all.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.al_step.kernel import al_step_cuda
from repro_torch.kernels.al_step.ref import al_step_ref

def al_step(x, m, v, usage, jobs, lo, hi, rowp, cvec, scal, **kw):
    """The CUDA kernel for CUDA tensors, its plain version for CPU ones."""
    if x.device.type == "cuda":
        return al_step_cuda(x, m, v, usage, jobs, lo, hi, rowp, cvec, scal,
                            **kw)
    if x.device.type == "cpu":
        return al_step_ref(x, m, v, usage, jobs, lo, hi, rowp, cvec, scal,
                           **kw)
    raise ValueError(f"al_step runs on cuda or cpu; got {x.device}")


def pack_rows(rts_coeffs, betas, k, x2_kind, is_batch, refs=None):
    """Per-workload penalty parameters -> the (W, 10) static row block
    (cols 0-9 of the kernel's `rowp`; see `ref.py` for the layout).
    `refs=None` fills zeros (CR1 has no per-row reference). `k` or `refs`
    of shape (N, W), one vector per lane (a multi-region fleet folds its
    per-row weights into k), give (N, W, 10)."""
    f32 = torch.float32
    k = k.to(f32)[..., None]
    r = torch.zeros_like(k) if refs is None else refs.to(f32)[..., None]
    lead = torch.broadcast_shapes(tuple(k.shape[:-2]), tuple(r.shape[:-2]))
    cols = [rts_coeffs.to(f32), betas.to(f32), k, x2_kind.to(f32)[:, None],
            is_batch.to(f32)[:, None], r]
    return torch.cat([c.expand(lead + tuple(c.shape[-2:])) for c in cols],
                     dim=-1)


def make_fused_inner(usage, jobs, lo, hi, row_base, cvec, *, mode: str,
                     cfg, step_scale, coef0=0.0, scale=None,
                     k_steps: int = 8, day_hours: int = 24):
    """Build the `fused_inner` hook for `engine.al_minimize`.

    Args:
      usage/jobs/lo/hi: (W, T) f32 fleet constants (bounds from
        `fleet_solver._bounds`), or (N, W, T) where the lanes differ.
      row_base: (W, 10) from `pack_rows` (CR2 passes `refs` there), or
        (N, W, 10).
      cvec: (1, T) carbon gradient term, `-car_norm * mci[None, :]`; for
        N lanes each lane's own, (N, 1, T) (or (N, W, T)).
      mode: "cr1" (fixed penalty weight `coef0 = lam * pen_norm`) or
        "cr2" (equality-multiplier form; needs `scale`).
      cfg: `EngineConfig`: inner_steps, lr, betas, eps, moment dtype.
      step_scale: the adapter's step scale (multiplies cfg.lr). A scalar
        tensor or float (or (N,) for N lanes) folds into `lr_scale` and
        rowp col 11 packs ones; a per-row (W, 1) tensor (or (N, W, 1)), a
        multi-region fleet's per-region scale, rides col 11 with
        `lr_scale = cfg.lr`.
      coef0, scale: (N,) tensors for N lanes.
      k_steps: fused steps per kernel call; `inner_steps` need not divide
        evenly, the remainder runs as one short call.

    The callback runs exactly `cfg.inner_steps` projected-Adam steps from
    zero moments and returns the new x (f32). With lanes (a 3-D cvec) its
    x, lam_eq and mu lead with the lane axis.
    """
    W, T = usage.shape[-2:]
    dev = usage.device
    order = torch.argsort(row_base.reshape(-1, W, 10)[0, :, 8],  # is_batch
                          descending=True, stable=True)
    restore = torch.argsort(order)
    usage, jobs, lo, hi, row_base = (a[..., order, :] for a in
                                     (usage, jobs, lo, hi, row_base))
    if cvec.shape[-2] == W:
        cvec = cvec[..., order, :]
    lead = tuple(cvec.shape[:-2])     # (N,) with lanes
    row_base = row_base.expand(lead + (W, 10))
    f32 = torch.float32
    mdt = getattr(torch, cfg.moment_dtype)
    steps = cfg.inner_steps
    k_steps = max(1, min(k_steps, steps))
    n_full, rem = divmod(steps, k_steps)
    n_calls = n_full + (1 if rem else 0)
    if isinstance(step_scale, torch.Tensor) and step_scale.dim() >= 2:
        # Per row: rowp col 11, lr_scale = cfg.lr.
        step_col = step_scale.to(f32)[..., order, :].expand(lead + (W, 1))
        step_scale = 1.0
    else:
        step_col = torch.ones(lead + (W, 1), dtype=f32, device=dev)
    kw = dict(mode=mode, beta1=cfg.beta1, beta2=cfg.beta2, eps=cfg.eps,
              day_hours=day_hours)
    # One scal row per call and lane: [coef0, mu, inv_scale, lr_scale, t0,
    # 0, 0, 0].
    scal = torch.zeros((n_calls,) + lead + (8,), dtype=f32, device=dev)
    scal[..., 0] = coef0
    scal[..., 2] = 0.0 if scale is None else 1.0 / scale
    scal[..., 3] = cfg.lr * step_scale
    scal[..., 4] = (torch.arange(n_calls, dtype=f32, device=dev)
                    * k_steps).reshape((n_calls,) + (1,) * len(lead))

    def fused_inner(x, lam_eq, lam_in, mu):
        del lam_in  # CR1/CR2 carry no inequality multipliers
        x = x.to(f32)[..., order, :]
        if mode == "cr2":
            lam_col = lam_eq.to(f32).reshape(lead + (W, 1))[..., order, :]
        else:
            lam_col = torch.zeros(lead + (W, 1), dtype=f32, device=dev)
        rowp = torch.cat([row_base, lam_col, step_col], dim=-1)
        s = scal.clone()
        s[..., 1] = mu
        m = torch.zeros(x.shape, dtype=mdt, device=dev)
        v = torch.zeros(x.shape, dtype=mdt, device=dev)
        for c in range(n_calls):
            n = k_steps if c < n_full else rem
            x, m, v = al_step(x, m, v, usage, jobs, lo, hi, rowp, cvec,
                              s[c].reshape(-1, 8), k_steps=n, **kw)
        return x[..., restore, :]

    return fused_inner
