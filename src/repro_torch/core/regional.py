"""Per-region reductions: the CR1/CR2 normalizers, CR3's regularizer scale
and the host-side region totals, single- and multi-region.

Multi-region fleets price every region on its own normalizers. A
single-region problem gets the fleet-global scalars (0-d tensors); a
multi-region one gets their per-region twins scattered back to rows, so
that with zero migration bandwidth the joint solve decomposes into R
independent single-region solves:

  * on the device: `region_rows` (each row's region id, carbon trace and
    region row count), `segment_sum` (per-region sums of rows, (R,) +
    trailing shape, differentiable) and `region_sum` (a per-region sum
    of a (W,) quantity gathered back to rows), `cr1_norms`, `cr2_norms`
    and `cr3_reg_scale`. The sums repeat bit for bit: a fixed reduction
    order, no atomics (`index_add_` and `scatter_add_` on floats take
    atomics on the card). `region_sum` gathers each region's rows in
    ascending order with `index_select` on the view's `RegionIndex`
    (found once on the host), so a region's total is the sum its
    standalone single-region fleet takes, and nothing reads a device
    value on the host: the CR1/CR2 norms run inside a captured day;
  * on the host, exact float64 numpy: `region_totals`, CR3's Eq.-6
    fiscal sums and the migration aggregates.

Under a fleet mesh the norms are the whole fleet's: computed once on
the unpadded fleet, then `pad_row_norms` pads the per-row twins to the
padded W with inert fills (`CR1_NORM_FILLS`, `CR2_NORM_FILLS`) and each
process takes its row block. The JAX package's `norm_specs` has no
counterpart: there are no PartitionSpecs.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.fleet_solver import (FleetProblem, RegionIndex,
                                           _bounds)

Tensor = torch.Tensor
f32 = torch.float32

#: Pad fills for `pad_row_norms` keeping pad rows inert: weights 0 (pad
#: rows contribute nothing), step and scale divisors 1 (nothing blows
#: up). Order as the norms tuples.
CR1_NORM_FILLS = (0.0, 0.0, 1.0)   # (pen_norm, car_norm, step_scale)
CR2_NORM_FILLS = (0.0, 1.0, 1.0)   # (car_norm, scale, step_scale)


class RegionReductions(NamedTuple):
    """Per-row region view of a multi-region fleet (see `region_rows`)."""
    region: Tensor   #: (W,) int64, each row's region id
    wmci: Tensor     #: (W, T), each row's region carbon trace
    counts: Tensor   #: (W,), the row count of each row's region


def region_masks(region: Tensor, R: int) -> Tensor:
    """(R, W) bool: row w lies in region r."""
    return region[None, :] == torch.arange(R, device=region.device)[:, None]


def segment_sum(x: Tensor, region: Tensor, R: int) -> Tensor:
    """Per-region sums of the rows of `x` (W, ...) -> (R, ...): one masked
    sum over the rows per region, differentiable, with no atomics."""
    masks = region_masks(region, R).reshape((R, -1) + (1,) * (x.dim() - 1))
    return torch.where(masks, x[None], torch.zeros((), dtype=x.dtype,
                                                   device=x.device)).sum(1)


def region_sum(x: Tensor, region: Tensor, index: RegionIndex) -> Tensor:
    """Per-row view of a per-region sum of `x` (W,): each region's rows
    gathered in ascending order (`index`) and summed, the sum a
    standalone fleet of those rows takes (and the sum of `x[mask]`, the
    same elements in the same order), gathered back to rows by
    `region`."""
    sums = torch.stack([x.index_select(0, rows).sum()
                        for rows in index.rows()])
    return sums[region]


def region_rows(p: FleetProblem) -> RegionReductions:
    """`(region, wmci, counts)` of a multi-region device view `p`, with
    `wmci[w] = mci[region[w]]` and `counts[w]` the row count of w's
    region."""
    region, index = p.region, p.region_index
    if index is None:
        raise ValueError("a multi-region view needs its region_index: "
                         "make it with fleet_solver.device_view")
    ones = torch.ones(region.shape, dtype=f32, device=region.device)
    return RegionReductions(region, p.mci[region],
                            region_sum(ones, region, index))


def region_totals(region, weights, R: int) -> np.ndarray:
    """Exact host-side per-region totals of per-row weights: (W,) weights
    give an (R,) total, (W, T) weights an (R, T) total. `region` may be a
    masked row subset index-aligned with `weights` (`region[is_batch]`
    with `residual[is_batch]`)."""
    region = np.asarray(region)
    w = np.asarray(weights, float)
    if w.ndim == 1:
        return np.bincount(region, weights=w, minlength=R)
    out = np.zeros((R,) + w.shape[1:])
    np.add.at(out, region, w)
    return out


def _step_rows(p: FleetProblem, lo: Tensor, hi: Tensor, region: Tensor,
               counts: Tensor) -> Tensor:
    """(W, 1) per-region step scale: the mean over its rows of each row's
    mean box width, the JAX package's per-region twin of the scalar."""
    rowmeans = torch.clamp(hi - lo, min=1e-6).mean(dim=1)
    return (region_sum(rowmeans, region, p.region_index) / counts)[:, None]


def cr1_norms(p: FleetProblem):
    """(pen_norm, car_norm, step_scale): CR1's reductions on the device of
    `p`'s tensors. Single-region: 0-d float32 tensors. Multi-region (a
    device view with `region`): per-region twins on rows, (W,), (W,) and
    (W, 1)."""
    lo, hi = _bounds(p)
    dev = lo.device
    mci = torch.as_tensor(p.mci, dtype=f32, device=dev)
    usage = torch.as_tensor(p.usage, dtype=f32, device=dev)
    ent = torch.as_tensor(p.entitlement, dtype=f32, device=dev)
    if p.region is not None:
        region, wmci, counts = region_rows(p)
        index = p.region_index
        return (100.0 / region_sum(ent, region, index),
                100.0 / region_sum((usage * wmci).sum(1), region, index),
                _step_rows(p, lo, hi, region, counts))
    return (100.0 / ent.sum(),
            100.0 / (usage.sum(0) * mci).sum(),
            torch.clamp(hi - lo, min=1e-6).mean())


def cr2_norms(p: FleetProblem, refs: Tensor):
    """(car_norm, scale, step_scale): CR2's reductions (the carbon
    normalizer, the equality-residual scale, the step scale); per-region
    twins on rows for a multi-region view, as `cr1_norms`."""
    lo, hi = _bounds(p)
    dev = lo.device
    mci = torch.as_tensor(p.mci, dtype=f32, device=dev)
    usage = torch.as_tensor(p.usage, dtype=f32, device=dev)
    if p.region is not None:
        region, wmci, counts = region_rows(p)
        index = p.region_index
        return (100.0 / region_sum((usage * wmci).sum(1), region, index),
                torch.clamp(region_sum(refs, region, index) / counts,
                            min=1e-3),
                _step_rows(p, lo, hi, region, counts))
    return (100.0 / (usage.sum(0) * mci).sum(),
            torch.clamp(refs.mean(), min=1e-3),
            torch.clamp(hi - lo, min=1e-6).mean())


def cr3_reg_scale(p: FleetProblem) -> Tensor:
    """CR3's per-row regularizer normalizer for a multi-region device view:
    1e-3/(W_region·T) on rows, (W, 1), so that each region's market
    regularizes as its standalone single-region market does."""
    region = p.region.cpu().numpy()
    counts = np.bincount(region, minlength=p.R)
    return torch.as_tensor((1e-3 / (counts * p.T))[region][:, None],
                           dtype=f32, device=p.region.device)


def pad_row_norms(norms, W_pad: int, fills) -> tuple[Tensor, ...]:
    """Pad a multi-region fleet's per-row norm tensors ((W,) or (W, 1))
    to the padded W with `fills` (`CR1_NORM_FILLS`, `CR2_NORM_FILLS`)."""
    out = []
    for a, f in zip(norms, fills):
        pad = W_pad - a.shape[0]
        out.append(a if pad == 0 else torch.cat(
            [a, torch.full((pad,) + tuple(a.shape[1:]), f, dtype=a.dtype,
                           device=a.device)]))
    return tuple(out)
