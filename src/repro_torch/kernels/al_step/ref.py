"""Plain PyTorch version of the fused AL inner-step kernel.

Follows the JAX package's oracle (`repro/kernels/al_step/ref.py`) op for
op on (W, T) tensors: the analytic augmented-Lagrangian gradient (CR1's
fixed-weight penalty or CR2's equality-multiplier form), a bias-corrected
Adam update with 1 - exp(t·log β), and a projection onto the box and the
batch rows' day preservation, `k_steps` of them per call, carrying
(x, m, v) as one kernel call does. It departs from that oracle in two
places, both so that the fused path computes what the generic engine
computes and meets the day-preservation check at fleet scale:

  * Hinge derivatives are autodiff's derivative of max(c, 0): 1 above,
    0 below, one half at an exact tie (the oracle takes 0 at a tie). The
    cold start D = 0 sits on every hinge, and Adam's second moment keeps
    that first gradient for ~1/(1 − β2) steps, so the convention moved
    the whole solve: at W = 1024 the strict oracle's CR1 solve lands
    0.07 pp of carbon below the generic engine's.
  * The projection is the exact Euclidean one (`_project`). The oracle
    clips and then removes day means 3 times, which stops short of the
    day sums where bounds are active: the JAX package's own CR2 solves
    at W = 1024-2048 end with day sums off by 0.2-0.7 NP·h
    (`scripts/ref_fused_vs_generic.py`). Where no bound is active on a
    batch day the two agree.

The analytic subgradient is discontinuous at the hinge boundaries, so a
1-ulp difference between two formulations (a warp scan against a
sequential cumsum) can flip an active-hinge indicator after a few steps.
Kernel-vs-plain checks therefore use hinge-free (RTS-only) or
hinge-stable inputs; the semantic check against the independent autodiff
engine is at solution level.

Away from exact ties and active day bounds (the parity checks' inputs)
both departures vanish, so the JAX oracle remains this module's
reference.

Row-parameter packing (see `ops.pack_rows`): `rowp` is (W, 12) f32:

  col 0-2   rts_coeffs (a3, a2, a1)
  col 3-5   betas (b0, b1, b2)
  col 6     k (annual job volume scale)
  col 7     x2_kind (>0.5: wait_sq, else njobs_delayed)
  col 8     is_batch (>0.5: batch penalty + day-mean projection)
  col 9     refs (CR2 per-workload penalty reference; 0 for CR1)
  col 10    lam_eq (CR2 equality multiplier, refreshed per outer round)
  col 11    step multiplier (per-row learning-rate scale; ones when the
            step scale is the fleet-global scalar folded into `lr_scale`)

Scalar packing: `scal` is (1, 8) f32,

  [coef0, mu, inv_scale, lr_scale, t0, 0, 0, 0]

where `coef0 = lam · pen_norm` (CR1 penalty weight; unused for CR2),
`inv_scale = 1/scale` (CR2 residual normalizer; unused for CR1),
`lr_scale = cfg.lr · step_scale`, and `t0` is the Adam step count already
taken this outer round (bias correction resumes at t0 + 1).

`cvec` is (1, T), or (W, T) for per-row carbon weights.

Lanes: x, m, v and rowp may lead with a lane axis N (N independent
solves, a sweep's policies or an ensemble's scenarios), `scal` is then
(N, 8), one row per lane, and usage, jobs, lo, hi and cvec are either
shared ((W, T); cvec (1, T) or (W, T)) or per lane ((N, W, T); cvec
(N, 1, T) or (N, W, T)). Each lane is the one-lane call on its slices.
"""
from __future__ import annotations

import torch

from repro_torch.core.fleet_solver import project_days

MODES = ("cr1", "cr2")


def _revcum(x: torch.Tensor) -> torch.Tensor:
    return torch.flip(torch.cumsum(torch.flip(x, (1,)), dim=1), (1,))


def _hinge(c: torch.Tensor) -> torch.Tensor:
    """d max(c, 0)/dc as autodiff takes it: one half at an exact tie."""
    return (c > 0).to(c.dtype) + 0.5 * (c == 0).to(c.dtype)


def _pen_and_grad(x, inv_u, ju, rowp):
    """Fleet penalty vector (W, 1) and its analytic gradient (W, T)."""
    a3, a2, a1 = rowp[:, 0:1], rowp[:, 1:2], rowp[:, 2:3]
    b0, b1, b2 = rowp[:, 3:4], rowp[:, 4:5], rowp[:, 5:6]
    kk, x2k, isb = rowp[:, 6:7], rowp[:, 7:8], rowp[:, 8:9]
    zero = torch.zeros((), dtype=x.dtype, device=x.device)

    # RTS: pen = k·Σ_t a3·δ³ + a2·δ² + a1·δ, δ = d/usage.
    delta = x * inv_u
    rts_pen = kk * (a3 * delta ** 3 + a2 * delta ** 2
                    + a1 * delta).sum(dim=1, keepdim=True)
    rts_g = kk * (3.0 * a3 * delta ** 2 + 2.0 * a2 * delta + a1) * inv_u

    # Batch: pen = k·max(b0 + b1·wait_power + b2·x2, 0).
    c1 = torch.cumsum(x, dim=1)
    x1 = torch.maximum(c1, zero).sum(dim=1, keepdim=True)
    c2 = torch.cumsum(ju * x * torch.abs(x), dim=1)
    x2s = torch.maximum(c2, zero).sum(dim=1, keepdim=True)
    nj = (ju * torch.maximum(x, zero)).sum(dim=1, keepdim=True)
    x2 = torch.where(x2k > 0.5, x2s, nj)
    z = b0 + b1 * x1 + b2 * x2
    batch_pen = kk * torch.maximum(z, zero)

    g1 = _revcum(_hinge(c1))
    g2s = 2.0 * ju * torch.abs(x) * _revcum(_hinge(c2))
    g2n = ju * _hinge(x)
    gx2 = torch.where(x2k > 0.5, g2s, g2n)
    batch_g = kk * _hinge(z) * (b1 * g1 + b2 * gx2)

    pen = torch.where(isb > 0.5, batch_pen, rts_pen)
    dpen = torch.where(isb > 0.5, batch_g, rts_g)
    return pen, dpen


def _project(x, lo, hi, isb, day_hours: int):
    """Box clip, and on batch rows the Euclidean projection onto the box ∩
    {every whole day sums to 0}: the generic engine's breakpoint search
    (`fleet_solver.project_days`). The kernel reaches the same point by
    another algorithm, variable fixing; the point is unique, so the two
    agree to rounding."""
    return project_days(x, lo, hi, isb[:, 0] > 0.5, day_hours)


def al_step_ref(x, m, v, usage, jobs, lo, hi, rowp, cvec, scal, *,
                mode: str, k_steps: int, beta1: float = 0.9,
                beta2: float = 0.999, eps: float = 1e-8,
                day_hours: int = 24):
    """Run `k_steps` fused projected-Adam AL steps; returns (x, m, v).

    x: (W, T) f32 primal iterate; m/v: (W, T) Adam moments (f32 or bf16,
    up-cast for arithmetic and stored back in their dtype); cvec: (1, T)
    or (W, T); rowp/scal: packed parameters, see the module docstring.
    With a leading lane axis on x, each lane is run on its own slices.
    """
    if mode not in MODES:
        raise ValueError(f"mode must be cr1|cr2, got {mode!r}")
    kw = dict(mode=mode, k_steps=k_steps, beta1=beta1, beta2=beta2, eps=eps,
              day_hours=day_hours)
    if x.dim() == 3:
        def lane(a, i):
            return a[i] if a.dim() == 3 else a

        outs = [al_step_ref(x[i], m[i], v[i], *(lane(a, i) for a in (
            usage, jobs, lo, hi)), rowp[i], lane(cvec, i), scal[i:i + 1],
            **kw) for i in range(x.shape[0])]
        return tuple(torch.stack(o) for o in zip(*outs))
    f32 = torch.float32
    x = x.to(f32)
    mdt = m.dtype
    m = m.to(f32)
    v = v.to(f32)
    inv_u = 1.0 / usage.to(f32)
    ju = jobs.to(f32) * inv_u
    isb = rowp[:, 8:9]
    refs, lam_eq, stepw = rowp[:, 9:10], rowp[:, 10:11], rowp[:, 11:12]
    coef0, mu = scal[0, 0], scal[0, 1]
    inv_scale, lr_scale, t0 = scal[0, 2], scal[0, 3], scal[0, 4]
    lb1 = torch.log(torch.tensor(beta1, dtype=f32, device=x.device))
    lb2 = torch.log(torch.tensor(beta2, dtype=f32, device=x.device))

    for i in range(k_steps):
        pen, dpen = _pen_and_grad(x, inv_u, ju, rowp)
        if mode == "cr1":
            coef = coef0
        else:
            # L = obj + lam_eq·h + (mu/2)·h², h = (pen − refs)/scale
            # ⇒ ∂L/∂pen = (lam_eq + mu·h)/scale.
            h = (pen - refs) * inv_scale
            coef = (lam_eq + mu * h) * inv_scale
        g = coef * dpen + cvec
        t = t0 + float(i + 1)
        m = beta1 * m + (1.0 - beta1) * g
        v = beta2 * v + (1.0 - beta2) * g * g
        mhat = m / (1.0 - torch.exp(t * lb1))
        vhat = v / (1.0 - torch.exp(t * lb2))
        x = _project(x - lr_scale * stepw * mhat / (torch.sqrt(vhat) + eps),
                     lo, hi, isb, day_hours)
    return x, m.to(mdt), v.to(mdt)
