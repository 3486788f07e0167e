"""Projected Adam on an augmented Lagrangian: the fleet solvers' engine.

`al_minimize` runs `outer_steps` rounds of multiplier updates around
`inner_steps` of bias-corrected Adam, projecting after every step. Box
bounds and batch day-preservation are the caller's projection (both cheap
closed forms); equality residuals h(x) = 0 and inequality residuals
g(x) >= 0 get AL multiplier + quadratic terms with a growing penalty
weight mu. The generic inner step differentiates the Lagrangian with
`torch.autograd.grad`; `fused_inner` hands the whole inner loop to a
caller's implementation (the `al_step` kernel).

Warm starts: `init` (an `EngineState`, the (x, lam_eq, lam_in, mu) carry
of a previous solve) replaces the cold start, and the final state is
returned in `aux["state"]`. Multipliers and mu stay device tensors; the
loop never reads a device value on the host.

Lanes: an `init` whose mu is a vector (N,) (`EngineState.lanes`) runs N
independent solves at once, a sweep's policies or an ensemble's
scenarios: x (N, W, T), multipliers (N, n), residuals (N, n), mu and
its clamp per lane, and `step_scale` broadcastable to x ((N, 1, 1)).
The objective returns the lanes' sum, whose gradient is each lane's.

Guards (`repro_torch.analysis.sanitize`): with a `sanitizer`, the loop
records non-finite checks on the initial carry, on every generic step's
gradient and iterate, on the iterate after each `fused_inner` call and
on the multipliers after each round, on the sanitizer's device flag
(the JAX package's checkify sites and order). Telemetry
(`cfg.telemetry_every = k`): every k-th inner step of the generic loop
writes its scalars into preallocated device buffers (`aux["telemetry"]`).
Neither reads a device value on the host, and neither changes the
iterates: with both on, the solve is bitwise the solve with both off.

Fleet meshes (`al_minimize_sharded`): every process of a
`torch.distributed` group runs `al_minimize` on its own row block of a
row-separable problem and the blocks are all-gathered afterwards.
Nothing collective enters the objective: each process differentiates
its partial sum, which for row-separable problems is exactly the
global gradient on its rows; global normalizers are the caller's,
computed on the whole fleet before it is split. Only the telemetry is
all-reduced, after the loop. A lane-stacked state shards the same way,
its rows on dim 1 (a sweep's or an ensemble's lanes on one block).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.analysis.sanitize import Sanitizer, check_all_finite

Tensor = torch.Tensor
# objective(x, hyper) -> scalar; residual(x, hyper) -> (n,) vector.
Objective = Callable[[Tensor, Any], Tensor]
Residual = Callable[[Tensor, Any], Tensor]

@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Knobs for the projected-Adam / augmented-Lagrangian loop."""

    inner_steps: int = 400     # Adam steps per multiplier round
    outer_steps: int = 1       # multiplier rounds (1 = plain projected Adam)
    lr: float = 0.05           # step size, scaled by the caller's step_scale
    mu0: float = 10.0          # initial quadratic constraint weight
    mu_growth: float = 2.0     # mu multiplier per outer round
    mu_max: float = 1e6        # cap: keeps chained warm re-solves finite
    beta1: float = 0.9
    beta2: float = 0.999
    eps: float = 1e-8
    # Storage dtype of the Adam moments: "float32" or "bfloat16". x stays
    # a float32 master copy and all arithmetic runs in float32.
    moment_dtype: str = "float32"
    # Convergence telemetry: sample (AL objective, squared gradient norm,
    # max constraint violation, mean |Δx|, mu) every `telemetry_every`
    # inner steps into device buffers, returned as `aux["telemetry"]`.
    # 0 (default) records nothing. Generic inner loop only: the fused
    # kernel's k-step calls are opaque.
    telemetry_every: int = 0


@dataclasses.dataclass(frozen=True)
class EngineState:
    """Reusable solver carry: primal point + AL multipliers + penalty
    weight, all tensors on the solve's device."""

    x: Tensor           # primal iterate (the previous solution)
    lam_eq: Tensor      # (n_eq,) equality multipliers
    lam_in: Tensor      # (n_in,) inequality multipliers (>= 0)
    mu: Tensor          # scalar quadratic penalty weight
    # A lane-stacked state (N solves) leads every field with N: mu (N,).

    @property
    def lanes(self) -> int | None:
        """N for a lane-stacked state, None for one solve's."""
        return self.mu.shape[0] if self.mu.dim() == 1 else None

    def lane(self, i: int) -> "EngineState":
        """Lane i of a lane-stacked state (views, not copies)."""
        return EngineState(x=self.x[i], lam_eq=self.lam_eq[i],
                           lam_in=self.lam_in[i], mu=self.mu[i])

    @classmethod
    def cold(cls, x0: Tensor, n_eq: int = 0, n_in: int = 0,
             mu0: float = EngineConfig.mu0) -> "EngineState":
        """Zero-multiplier start: the classic cold solve."""
        kw = dict(dtype=x0.dtype, device=x0.device)
        return cls(x=x0, lam_eq=torch.zeros((n_eq,), **kw),
                   lam_in=torch.zeros((n_in,), **kw),
                   mu=torch.full((), mu0, **kw))

    def shifted(self, hours: int = 1, fill: float = 0.0) -> "EngineState":
        """Roll the primal along its trailing (time) axis by `hours`, the
        rolling-horizon warm start. Vacated trailing hours get `fill`;
        multipliers and mu attach to workloads, not hours, and carry."""
        x = torch.roll(self.x, -hours, dims=-1)
        if hours > 0:
            x[..., -hours:] = fill
        return dataclasses.replace(self, x=x)


def al_minimize(objective: Objective, project: Callable[[Tensor], Tensor],
                x0: Tensor, *, hyper: Any = None,
                eq_residual: Residual | None = None,
                ineq_residual: Residual | None = None,
                step_scale: Tensor | float = 1.0,
                grad_transform: Callable[[Tensor], Tensor] | None = None,
                cfg: EngineConfig = EngineConfig(),
                init: EngineState | None = None,
                fused_inner: Callable[[Tensor, Tensor, Tensor, Tensor],
                                      Tensor] | None = None,
                sanitizer: Sanitizer | None = None,
                ) -> tuple[Tensor, dict[str, Any]]:
    """Minimize objective(x, hyper) s.t. eq(x)=0, ineq(x)>=0, x = project(x).

    Returns (x, aux) with the final multipliers in aux and `aux["state"]`,
    an `EngineState` to warm-start the next solve. `init` warm-starts the
    whole carry (x0 is then ignored and `init.x` projected); without it the
    residual sizes come from one evaluation at x0.

    `fused_inner(x, lam_eq, lam_in, mu) -> x` replaces the generic inner
    Adam loop; it must run exactly `cfg.inner_steps` projected-Adam steps
    from zero moments. The multiplier updates between rounds stay here.

    `sanitizer` records the checks `al-init` (x0, lam_eq, lam_in, mu),
    `al-inner` (grad, x), `al-fused-inner` (x) and `al-multipliers`
    (lam_eq, lam_in) on its flag; the caller reads it
    (`Sanitizer.throw`).

    Telemetry (`cfg.telemetry_every = k > 0`) samples global inner steps
    k, 2k, ... (counted over all rounds from 1): the Lagrangian at the
    pre-step iterate (the forward pass autograd already runs), the sum
    of g² after `grad_transform`, max(|h|, relu(−g)) at the post-step
    iterate, the mean |Δx| and mu. `aux["telemetry"]` holds them as
    (n_samples,) device tensors beside the host `step` array and the
    mean `step_scale`. Refused with `fused_inner` and with a
    lane-stacked `init` (the JAX package takes telemetry to its loop
    lane).
    """
    lanes = init is not None and init.lanes is not None
    tel_every = cfg.telemetry_every
    if tel_every and fused_inner is not None:
        raise ValueError(
            "EngineConfig.telemetry_every is incompatible with "
            "fused_inner: the fused al_step kernel runs all inner steps "
            "in opaque calls, so per-step telemetry cannot be captured — "
            "drop the kernel or the telemetry for this solve")
    if tel_every and lanes:
        raise ValueError(
            "EngineConfig.telemetry_every needs a one-solve init: a "
            "lane-stacked state has no per-solve trace (sweeps and "
            "ensembles take telemetry to their loop lane)")

    def flat(r: Tensor) -> Tensor:
        return r.reshape(r.shape[0], -1) if lanes \
            else torch.atleast_1d(r).reshape(-1)

    def eq_vec(x: Tensor) -> Tensor:
        return flat(eq_residual(x, hyper))

    def ineq_vec(x: Tensor) -> Tensor:
        return flat(ineq_residual(x, hyper))

    def per_lane(mu: Tensor) -> Tensor:
        """mu against (N, n) residuals."""
        return mu[:, None] if lanes else mu

    if init is None:
        with torch.no_grad():
            n_eq = 0 if eq_residual is None else eq_vec(x0).numel()
            n_in = 0 if ineq_residual is None else ineq_vec(x0).numel()
        init = EngineState.cold(x0, n_eq, n_in, cfg.mu0)
    n_eq, n_in = init.lam_eq.numel(), init.lam_in.numel()

    def lagrangian(x, lam_eq, lam_in, mu):
        val = objective(x, hyper)
        if n_eq:
            h = eq_vec(x)
            if lanes:
                val = val + (lam_eq * h).sum() \
                    + 0.5 * (mu * (h * h).sum(-1)).sum()
            else:
                val = val + lam_eq @ h + 0.5 * mu * (h @ h)
        if n_in:
            # AL for g(x) >= 0: (mu/2)·[max(0, lam/mu − g)² − (lam/mu)²]
            g = ineq_vec(x)
            r = lam_in / per_lane(mu)
            s = torch.maximum(r - g, torch.zeros_like(g))
            if lanes:
                val = val + 0.5 * (mu * (s * s - r * r).sum(-1)).sum()
            else:
                val = val + 0.5 * mu * (s @ s - r @ r)
        return val

    mdt = getattr(torch, cfg.moment_dtype)
    dt = init.x.dtype
    with torch.no_grad():
        x = project(init.x)
        lam_eq, lam_in = init.lam_eq.to(dt), init.lam_in.to(dt)
        mu = torch.as_tensor(init.mu, dtype=dt, device=x.device)
    # Filled on the device, not copied from the host: a CUDA graph can
    # capture the loop (`core/daygraph.py`).
    b1 = torch.full((), cfg.beta1, dtype=dt, device=x.device)
    b2 = torch.full((), cfg.beta2, dtype=dt, device=x.device)
    if sanitizer is not None:
        check_all_finite(sanitizer, "al-init", x0=x, lam_eq=lam_eq,
                         lam_in=lam_in, mu=mu)

    def max_violation(x: Tensor) -> Tensor:
        """Worst constraint residual: max(|h|, relu(−g)); 0 when none."""
        v = torch.zeros((), dtype=dt, device=x.device)
        if n_eq:
            v = torch.maximum(v, eq_vec(x).abs().max())
        if n_in:
            v = torch.maximum(v, torch.clamp(-ineq_vec(x), min=0.0).max())
        return v

    total = cfg.outer_steps * cfg.inner_steps
    if tel_every:
        # Rows: objective, grad_sq, violation, dx, mu; one per sample.
        tel = torch.zeros((5, total // tel_every), dtype=dt, device=x.device)

    for r in range(cfg.outer_steps):
        if fused_inner is not None:
            with torch.no_grad():
                x = fused_inner(x, lam_eq, lam_in, mu)
                if sanitizer is not None:
                    check_all_finite(sanitizer, "al-fused-inner", x=x)
        else:
            m = torch.zeros(x.shape, dtype=mdt, device=x.device)
            v = torch.zeros(x.shape, dtype=mdt, device=x.device)
            for t in range(1, cfg.inner_steps + 1):
                xg = x.detach().requires_grad_(True)
                with torch.enable_grad():
                    L = lagrangian(xg, lam_eq, lam_in, mu)
                    (g,) = torch.autograd.grad(L, xg)
                with torch.no_grad():
                    if grad_transform is not None:
                        g = grad_transform(g)
                    m = cfg.beta1 * m.to(dt) + (1.0 - cfg.beta1) * g
                    v = cfg.beta2 * v.to(dt) + (1.0 - cfg.beta2) * g * g
                    mhat = m / (1.0 - b1 ** t)
                    vhat = v / (1.0 - b2 ** t)
                    x_prev = x
                    x = project(x - cfg.lr * step_scale * mhat
                                / (torch.sqrt(vhat) + cfg.eps))
                    m, v = m.to(mdt), v.to(mdt)
                    if sanitizer is not None:
                        check_all_finite(sanitizer, "al-inner", grad=g, x=x)
                    s = r * cfg.inner_steps + t
                    if tel_every and s % tel_every == 0:
                        i = s // tel_every - 1
                        tel[0, i] = L.detach()
                        tel[1, i] = (g * g).sum()
                        tel[2, i] = max_violation(x)
                        tel[3, i] = (x - x_prev).abs().mean()
                        tel[4, i] = mu
        with torch.no_grad():
            if n_eq:
                lam_eq = lam_eq + per_lane(mu) * eq_vec(x)
            if n_in:
                lam_in = torch.clamp(lam_in - per_lane(mu) * ineq_vec(x),
                                     min=0.0)
            if sanitizer is not None and (n_eq or n_in):
                check_all_finite(sanitizer, "al-multipliers",
                                 lam_eq=lam_eq, lam_in=lam_in)
            mu = torch.clamp(mu * cfg.mu_growth, max=cfg.mu_max)
    state = EngineState(x=x, lam_eq=lam_eq, lam_in=lam_in, mu=mu)
    aux = {"lam_eq": lam_eq, "lam_in": lam_in, "mu": mu, "state": state}
    if tel_every:
        ss = (step_scale.to(dt).mean() if isinstance(step_scale, Tensor)
              else torch.full((), step_scale, dtype=dt, device=x.device))
        aux["telemetry"] = {
            # drlint: disable=host-copy-in-capture -- static host steps
            "step": np.arange(tel_every, total + 1, tel_every,
                              dtype=np.int32),
            "objective": tel[0], "grad_sq": tel[1], "violation": tel[2],
            "dx": tel[3], "mu": tel[4], "step_scale": ss}
    return x, aux


# How each telemetry row combines over the fleet's row blocks: the
# objective and the squared gradient norm are partial sums (row-separable
# problems), the worst violation a max. The mean |dx| and a per-row
# step_scale are means over the fleet's true rows (`_telemetry_allreduce`).
# `step`, `mu` and a replicated step_scale are the same on every process
# and pass through.
_TEL_REDUCE = {"objective": "sum", "grad_sq": "sum", "violation": "max",
               "dx": "sum"}


def gather_rows(mesh, t: Tensor, dim: int = 0) -> Tensor:
    """All-gather every process's equal row block of `t` along `dim` (0,
    or 1 for lane-stacked tensors) into the padded global tensor, blocks
    in the mesh's order (`launch.mesh.fleet_ranks`), on `t`'s device;
    every process gets the same tensor. The list form of `all_gather`,
    which gloo takes for CPU and CUDA tensors alike."""
    from repro_torch.launch.mesh import fleet_ranks
    ranks = fleet_ranks(mesh)
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in ranks]
    dist.all_gather(parts, t)
    return torch.cat([parts[r] for r in ranks], dim=dim)


def _all_reduce(t: Tensor, how: str) -> Tensor:
    buf = t.clone()
    dist.all_reduce(buf, op=dist.ReduceOp.MAX if how == "max"
                    else dist.ReduceOp.SUM)
    return buf


def _telemetry_allreduce(tel: dict, keep: Tensor, true_rows: int,
                         step_scale) -> dict:
    """Merge the blocks' telemetry into the fleet's traces. A block's
    mean |dx| is over its n rows, pad rows included, which never move
    (box [0, 0]): its sum over the blocks times n / true_rows is the
    mean over the fleet's true rows. A per-row `step_scale` ((n, ...))
    is averaged over the true rows (`keep`, (n, 1)); a replicated one
    passes through."""
    out = {k: _all_reduce(v, _TEL_REDUCE[k]) if k in _TEL_REDUCE else v
           for k, v in tel.items()}
    n = keep.shape[0]
    out["dx"] = out["dx"] * (n / true_rows)
    if isinstance(step_scale, Tensor) and step_scale.dim() \
            and step_scale.shape[0] == n:
        ss = step_scale.to(out["step_scale"].dtype).reshape(n, -1)
        out["step_scale"] = _all_reduce(
            torch.where(keep, ss, 0.0).mean(1).sum(), "sum") / true_rows
    return out


def al_minimize_sharded(objective: Objective,
                        project: Callable[[Tensor], Tensor],
                        init: EngineState, *, mesh, rows: slice,
                        true_rows: int | None = None,
                        cfg: EngineConfig = EngineConfig(),
                        **pieces) -> tuple[Tensor, dict[str, Any]]:
    """`al_minimize` over a fleet mesh, SPMD: every process of the mesh
    calls it with the same global `init` and its own block's pieces.

    Args:
      objective, project, pieces: `al_minimize`'s pieces (`hyper`,
        `eq_residual`, `ineq_residual`, `step_scale`, `grad_transform`,
        `fused_inner`) built on this process's row block
        (`fleet_solver.row_block`) with the whole fleet's normalizers.
      init: the padded global state, the same on every process: x and
        the multipliers with one entry a row are cut to the block, mu is
        replicated.
      rows: this process's block of the padded rows, one of equal blocks
        in the mesh's order (`launch.mesh.fleet_ranks`).
      true_rows: the fleet's W before padding (default: no pad rows).
        With telemetry on, the pad rows' gradient is masked to zero, so
        that the trace's grad_sq is the true fleet's (their box is
        [0, 0]: the iterates do not move), and the trace's means are over
        the true rows.

    A lane-stacked `init` (x (N, W_pad, T), lam_eq (N, W_pad) or (N, 0),
    mu (N,)) runs N solves on the block at once, rows on dim 1; telemetry
    stays refused on lanes (`al_minimize`).

    Returns (x, aux) as `al_minimize`, with x, the row multipliers and
    `aux["state"]` all-gathered to padded global tensors and the
    telemetry all-reduced (`_telemetry_allreduce`): the same on every
    process. Over the true rows, the trace is the unsharded solve's.
    """
    dim = 0 if init.lanes is None else 1
    W_pad = init.x.shape[dim]
    n = rows.stop - rows.start
    true_rows = W_pad if true_rows is None else true_rows

    def rowed(a: Tensor, size: int) -> bool:
        return a.dim() > dim and a.shape[dim] == size

    def block(a: Tensor) -> Tensor:
        return a[(slice(None),) * dim + (rows,)] if rowed(a, W_pad) else a

    local = EngineState(x=block(init.x), lam_eq=block(init.lam_eq),
                        lam_in=block(init.lam_in), mu=init.mu)
    if cfg.telemetry_every:
        keep = (torch.arange(rows.start, rows.stop, device=init.x.device)
                < true_rows)[:, None]
    if cfg.telemetry_every and rows.stop > true_rows:
        zero = torch.zeros((), dtype=init.x.dtype, device=init.x.device)
        inner = pieces.get("grad_transform")
        pieces["grad_transform"] = lambda g: torch.where(
            keep, g if inner is None else inner(g), zero)
    x, aux = al_minimize(objective, project, local.x, init=local, cfg=cfg,
                         **pieces)

    def gather(a: Tensor) -> Tensor:
        return gather_rows(mesh, a, dim) if rowed(a, n) else a

    x, lam_eq, lam_in = (gather(a) for a in (x, aux["lam_eq"],
                                             aux["lam_in"]))
    out = {"lam_eq": lam_eq, "lam_in": lam_in, "mu": aux["mu"],
           "state": EngineState(x=x, lam_eq=lam_eq, lam_in=lam_in,
                                mu=aux["mu"])}
    if cfg.telemetry_every:
        out["telemetry"] = _telemetry_allreduce(
            aux["telemetry"], keep, true_rows, pieces.get("step_scale"))
    return x, out
