"""Cross-region migration of deferrable load (spatial demand response).

The multi-region solve prices each region's curtailment on its own carbon
trace; this module adds the spatial lever: move deferrable (batch) load
that a region's plan leaves running and run it in a cleaner region the
same hour, within the `RegionTopology` network (per-link bandwidth caps,
a per-unit toll, per-region power ceilings).

It runs after the solve, on (R, T) region aggregates of the committed plan
(`region_aggregates`): `movable` (batch load per region-hour) and
`headroom` (region ceiling minus post-DR draw). That is a small problem,
R in the tens and T in the hundreds: the engine (`engine.al_minimize`)
solves it in one call on the problem's device, and an exact repair in
float64 numpy on the host (`_repair`) then makes the plan meet every cap
exactly (the AL solution is only eps-feasible).

`api.solve`/`sweep` apply it whenever the problem has a topology with a
positive bandwidth: the carbon saved, net of the toll, is credited into
`carbon_reduction_pct` and the `MigrationPlan` rides
`result.extras["migration"]`. `SolveContext(coupled_migration=True)`
refines curtailment and flows jointly instead (`api._coupled_migrate`),
with this module's repair and aggregates.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.engine import EngineConfig, al_minimize
from repro_torch.core.regional import region_totals
from repro_torch.kernels.dispatch import resolve_device

__all__ = ["MigrationPlan", "fleet_migration", "plan_migration",
           "positive_links", "region_aggregates"]

f32 = torch.float32


@dataclasses.dataclass(frozen=True)
class MigrationPlan:
    """Feasible cross-region migration schedule and its carbon accounting.

    `y[r, s, t]` is deferrable load (NP) moved from region r to region s
    in hour t. `carbon_saved` is the gross carbon differential captured,
    `migration_cost` the toll paid; the net credit is `net_saved`.
    """
    y: np.ndarray              # (R, R, T) feasible migration flows
    carbon_saved: float        # sum y * (mci_from - mci_to)
    migration_cost: float      # sum y * cost[from, to]
    moved_total: float         # sum y

    @property
    def net_saved(self) -> float:
        return self.carbon_saved - self.migration_cost

    def by_region(self) -> np.ndarray:
        """(R,) net outflow per region (moved out minus moved in)."""
        return self.y.sum(axis=(1, 2)) - self.y.sum(axis=(0, 2))


def _zero_plan(R: int, T: int) -> MigrationPlan:
    return MigrationPlan(y=np.zeros((R, R, T)), carbon_saved=0.0,
                         migration_cost=0.0, moved_total=0.0)


def _repair(y: np.ndarray, margin: np.ndarray, cap: np.ndarray,
            movable: np.ndarray, headroom: np.ndarray) -> np.ndarray:
    """Deterministic projection of an eps-feasible AL iterate onto the
    exact constraint set. Order matters: dropping unprofitable links and
    clipping to caps only shrink flows, outflow scaling keeps the link
    caps, and inflow scaling (shrinking again) keeps both, so the output
    meets every constraint at once."""
    y = np.where(margin > 0.0, np.clip(y, 0.0, cap), 0.0)
    out = y.sum(axis=1)                                   # (R, T)
    with np.errstate(divide="ignore", invalid="ignore"):
        f = np.where(out > movable, movable / np.maximum(out, 1e-300), 1.0)
    y = y * np.minimum(f, 1.0)[:, None, :]
    inn = y.sum(axis=0)                                   # (R, T)
    with np.errstate(divide="ignore", invalid="ignore"):
        g = np.where(inn > headroom,
                     np.maximum(headroom, 0.0) / np.maximum(inn, 1e-300),
                     1.0)
    return y * np.minimum(g, 1.0)[None, :, :]


def plan_migration(mci: np.ndarray, movable: np.ndarray,
                   headroom: np.ndarray, topology, *, inner_steps: int = 250,
                   outer_steps: int = 4,
                   device: str | torch.device | None = None,
                   ) -> MigrationPlan:
    """Solve the (R, R, T) migration transport problem

      maximize   sum_{r,s,t} y[r,s,t] (mci[r,t] - mci[s,t] - cost[r,s])
      subject to 0 <= y[r,s,t] <= bandwidth[r,s]          (link caps)
                 sum_s y[r,s,t] <= movable[r,t]           (supply)
                 sum_r y[r,s,t] <= headroom[s,t]          (absorption)

    with the engine in float32 on `device` (None = the CUDA device): link
    caps in the projection, supply and absorption as inequality
    residuals. Then the exact repair on the host. Zero-bandwidth or
    nowhere-profitable topologies give the zero plan without a solve."""
    mci = np.asarray(mci, float)
    R, T = mci.shape
    cost = np.asarray(topology.cost, float)
    bw = np.asarray(topology.bandwidth, float).copy()
    np.fill_diagonal(bw, 0.0)
    movable = np.maximum(np.asarray(movable, float), 0.0)
    headroom = np.asarray(headroom, float)

    margin = mci[:, None, :] - mci[None, :, :] - cost[:, :, None]  # (R,R,T)
    cap = np.broadcast_to(bw[:, :, None], (R, R, T))
    profitable = (margin > 0.0) & (cap > 0.0)
    if not profitable.any() or movable.max() <= 0.0:
        return _zero_plan(R, T)

    # Uncapped regions absorb at most everything movable that hour.
    total_movable = movable.sum(axis=0)                   # (T,)
    head_eff = np.where(np.isfinite(headroom), np.maximum(headroom, 0.0),
                        total_movable[None, :] * np.ones((R, 1)))

    device = resolve_device(device)
    scale = float(max(movable.max(), 1.0))
    mscale = float(max(np.abs(margin[profitable]).max(), 1e-6))

    def t(a):
        return torch.as_tensor(np.asarray(a), dtype=f32, device=device)

    margin_t = t(margin / mscale)
    cap_t = t(np.where(np.isfinite(cap), cap, scale))
    movable_t, head_t = t(movable), t(head_eff)

    def objective(y, _):
        return -(y * margin_t).sum()

    def project(y):
        return torch.clamp(y, torch.zeros_like(cap_t), cap_t)

    def ineq(y, _):
        supply = (movable_t - y.sum(dim=1)) / scale
        absorb = (head_t - y.sum(dim=0)) / scale
        return torch.cat([supply.reshape(-1), absorb.reshape(-1)])

    cfg = EngineConfig(inner_steps=inner_steps, outer_steps=outer_steps,
                       lr=0.05, mu0=10.0, mu_growth=3.0)
    y, _ = al_minimize(objective, project,
                       torch.zeros((R, R, T), dtype=f32, device=device),
                       ineq_residual=ineq, step_scale=0.1 * scale, cfg=cfg)
    y = _repair(y.cpu().numpy().astype(float), margin, cap, movable,
                head_eff)

    grad = mci[:, None, :] - mci[None, :, :]
    return MigrationPlan(
        y=y, carbon_saved=float((y * grad).sum()),
        migration_cost=float((y * cost[:, :, None]).sum()),
        moved_total=float(y.sum()))


def region_aggregates(p, D: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(movable, headroom), both (R, T), of a committed plan `D` on the
    host: `movable[r, t]` is the batch load left running in region r
    (deferrable by construction; RTS load is latency-bound and stays),
    `headroom[r, t]` the region ceiling minus the fleet's post-DR draw
    (+inf without a ceiling). Both migration stages price flows against
    these."""
    region = np.asarray(p.region)
    R, T = p.R, p.T
    residual = np.asarray(p.usage, float) - np.asarray(D, float)  # (W, T)
    is_batch = np.asarray(p.is_batch, bool)
    movable = region_totals(region[is_batch],
                            np.maximum(residual[is_batch], 0.0), R)
    ceiling = None if p.topology is None else p.topology.ceiling
    if ceiling is None:
        headroom = np.full((R, T), np.inf)
    else:
        load = region_totals(region, residual, R)
        ceil = np.asarray(ceiling, float)
        if ceil.ndim == 1:
            ceil = np.broadcast_to(ceil[:, None], (R, T))
        headroom = ceil - load
    return movable, headroom


def positive_links(topology) -> tuple[np.ndarray, np.ndarray, np.ndarray,
                                      np.ndarray]:
    """A topology's usable directed links as `(fr, to, bw, cost)` vectors
    over the off-diagonal entries with positive bandwidth: the flow
    variables of the coupled migration solve."""
    bw = np.asarray(topology.bandwidth, float).copy()
    np.fill_diagonal(bw, 0.0)
    fr, to = np.nonzero(bw > 0.0)
    cost = np.asarray(topology.cost, float)[fr, to]
    return fr, to, bw[fr, to], cost


def fleet_migration(p, D: np.ndarray, **plan_kwargs) -> MigrationPlan:
    """Migration post-stage for a solved multi-region `FleetProblem`: the
    region aggregates of the committed plan `D`, then `plan_migration`
    (`plan_kwargs` pass through, `device` among them). The plan moves load
    without changing any workload's curtailment D, so total curtailment
    and every penalty are untouched; only where the load burns carbon
    changes."""
    if not p.is_multiregion or p.topology is None:
        return _zero_plan(p.R, p.T)
    movable, headroom = region_aggregates(p, D)
    return plan_migration(np.asarray(p.mci, float), movable, headroom,
                          p.topology, **plan_kwargs)
