"""Fairness and efficiency metrics (paper §VI-E).

Shannon entropy over capacity-scaled shares: p_i ∝ C_i/E_i (performance) or
CF_i/E_i (carbon). Max entropy = log2(W) (= 2 for the paper's 4 workloads)
when losses are exactly proportional to capacity entitlements.
"""
from __future__ import annotations

import numpy as np


def capacity_scaled_entropy(values: np.ndarray, entitlements: np.ndarray,
                            ) -> float:
    """−Σ p log2 p with p_i ∝ max(values_i, 0)/E_i, normalized to sum 1.

    Returns max entropy when `values` is zero everywhere (no DR = trivially
    fair), matching the paper's convention that equal treatment is fair.
    """
    shares = np.maximum(np.asarray(values, float), 0.0) / np.asarray(
        entitlements, float)
    total = shares.sum()
    n = shares.shape[0]
    if total <= 1e-12:
        return float(np.log2(n))
    pnz = shares / total
    pnz = pnz[pnz > 1e-15]
    return float(-(pnz * np.log2(pnz)).sum())


def entropy_over_sweep(results, entitlements: np.ndarray,
                       ) -> dict[str, np.ndarray]:
    """Per-result entropies for a hyperparameter sweep (Fig. 10 box data)."""
    pen = np.asarray([capacity_scaled_entropy(r.per_penalty, entitlements)
                      for r in results])
    car = np.asarray([capacity_scaled_entropy(r.per_carbon, entitlements)
                      for r in results])
    return {"penalty_entropy": pen, "carbon_entropy": car}


def _poison_nonfinite(x: np.ndarray, axis: int,
                      out: np.ndarray) -> np.ndarray:
    """NaN-propagate a fairness reduction: any non-finite share along
    `axis` makes that slice's index NaN. Without this, a NaN share falls
    out of the `den > eps` comparison (NaN compares False) and the
    metric silently reads 1.0 — "perfectly fair" — for a corrupted
    plan."""
    bad = ~np.isfinite(x).all(axis=axis)
    return np.where(bad, np.nan, out)


def jain_index(values: np.ndarray, entitlements: np.ndarray,
               axis: int = -1) -> np.ndarray | float:
    """Jain fairness index (Σx)²/(n·Σx²) over capacity-scaled shares
    x_i = max(values_i, 0)/E_i, along `axis` (ensemble risk reports pass
    (S, W) stacks and get one index per scenario).

    1.0 = perfectly proportional losses; 1/n = one workload bears all.

    Degenerate inputs (reachable from `EnsembleReport` when a scenario
    curtails nothing): all-zero shares (no DR) are trivially fair ->
    1.0; an *empty* axis (zero workloads) likewise -> 1.0; non-finite
    shares (a diverged solve) propagate -> NaN, never a fair-looking
    1.0."""
    x = np.maximum(np.asarray(values, float), 0.0) \
        / np.asarray(entitlements, float)
    n = x.shape[axis]
    if n == 0:
        out = np.ones(np.sum(x, axis=axis).shape)
        return float(out) if np.ndim(out) == 0 else out
    num = x.sum(axis=axis) ** 2
    den = n * (x * x).sum(axis=axis)
    # errstate: non-finite shares make num/den garbage here; the poison
    # mask below overwrites those slots with NaN deliberately.
    with np.errstate(invalid="ignore", divide="ignore"):
        out = np.where(den > 1e-24, num / np.maximum(den, 1e-24), 1.0)
    out = _poison_nonfinite(x, axis, out)
    return float(out) if np.ndim(out) == 0 else out


def max_min_ratio(values: np.ndarray, entitlements: np.ndarray,
                  axis: int = -1) -> np.ndarray | float:
    """Max/min capacity-scaled share along `axis` — the worst-treated vs
    best-treated workload (1.0 = equal treatment; large = concentrated
    burden). Shares are floored at 1e-4 of the max share, capping the
    dispersion at 1e4: zero-loss workloads read as "≥10000x", not inf.

    Degenerate inputs match `jain_index`: all-zero shares -> 1.0, an
    empty axis -> 1.0 (instead of numpy's zero-size reduction
    ValueError), non-finite shares -> NaN."""
    x = np.maximum(np.asarray(values, float), 0.0) \
        / np.asarray(entitlements, float)
    if x.shape[axis] == 0:
        out = np.ones(np.sum(x, axis=axis).shape)
        return float(out) if np.ndim(out) == 0 else out
    top = x.max(axis=axis)
    bot = np.maximum(x.min(axis=axis), 1e-4 * np.maximum(top, 1e-30))
    with np.errstate(invalid="ignore", divide="ignore"):
        out = np.where(top > 1e-24, top / bot, 1.0)
    out = _poison_nonfinite(x, axis, out)
    return float(out) if np.ndim(out) == 0 else out


def box_stats(x: np.ndarray) -> dict[str, float]:
    """1st/2nd/3rd quartiles + min/max (Fig. 10 box-and-whisker)."""
    return {
        "min": float(np.min(x)), "q1": float(np.percentile(x, 25)),
        "median": float(np.median(x)), "q3": float(np.percentile(x, 75)),
        "max": float(np.max(x)),
    }


def pareto_frontier(carbon_pct: np.ndarray, penalty_pct: np.ndarray,
                    ) -> np.ndarray:
    """Indices of non-dominated (max carbon, min penalty) points, sorted by
    carbon reduction (Fig. 8 frontiers)."""
    order = np.argsort(carbon_pct)
    best = np.inf
    keep = []
    for i in order[::-1]:
        if penalty_pct[i] < best - 1e-12:
            keep.append(i)
            best = penalty_pct[i]
    return np.asarray(keep[::-1], dtype=int)
