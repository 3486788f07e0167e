"""Lasso regression on tensors (paper §IV-A2, Table V).

The paper fits batch penalty models with Lasso, choosing the l1 weight
alpha by 10-fold cross validation. FISTA (accelerated proximal gradient)
on the standardized design matrix, in float32 as the JAX package runs it;
the CV grid solves every (alpha × fold) problem at once as one batch.

objective:  (1/2n)||y - Xw - b||² + alpha * ||w||₁
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from repro_torch.kernels.dispatch import resolve_device

Tensor = torch.Tensor


def soft_threshold(x: Tensor, thr: Tensor) -> Tensor:
    return torch.sign(x) * torch.maximum(torch.abs(x) - thr,
                                         torch.zeros_like(x))


def _fista(Xc: Tensor, yc: Tensor, ntr: Tensor, alpha: Tensor,
           iters: int) -> Tensor:
    """FISTA over a batch of problems. Xc (..., n, F), yc (..., n),
    ntr and alpha broadcast over the batch dims -> w (..., F)."""
    L = torch.linalg.matrix_norm(Xc, ord=2) ** 2 / ntr + 1e-12
    step = (1.0 / L)[..., None]
    thr = step * alpha[..., None]
    w = torch.zeros(Xc.shape[:-2] + Xc.shape[-1:], dtype=Xc.dtype,
                    device=Xc.device)
    z = w
    t = torch.tensor(1.0, dtype=Xc.dtype, device=Xc.device)
    Xt = Xc.transpose(-1, -2)
    for _ in range(iters):
        r = (Xc @ z[..., None])[..., 0] - yc
        grad = (Xt @ r[..., None])[..., 0] / ntr[..., None]
        w_next = soft_threshold(z - step * grad, thr)
        t_next = 0.5 * (1.0 + torch.sqrt(1.0 + 4.0 * t * t))
        z = w_next + ((t - 1.0) / t_next) * (w_next - w)
        w, t = w_next, t_next
    return w


def lasso_fista(X: Tensor, y: Tensor, alpha, iters: int = 500
                ) -> tuple[Tensor, Tensor]:
    """FISTA for standardized X (zero-mean columns). Returns (w, intercept);
    the intercept is closed form, b = mean(y), when X is centered."""
    ymean = y.mean()
    n = torch.tensor(float(X.shape[0]), dtype=X.dtype, device=X.device)
    alpha = torch.as_tensor(alpha, dtype=X.dtype, device=X.device)
    return _fista(X, y - ymean, n, alpha, iters), ymean


@dataclasses.dataclass(frozen=True)
class LassoFit:
    """Fitted Lasso model in the ORIGINAL (unstandardized) feature space."""

    coef: np.ndarray          # (F,) original-scale coefficients
    intercept: float
    alpha: float
    selected: tuple[int, ...]  # indices of non-zero coefficients
    cv_mae_mean: float
    cv_mae_var: float
    r2: float

    def predict(self, X: np.ndarray) -> np.ndarray:
        return np.asarray(X) @ self.coef + self.intercept


def _standardize(X: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    mu = X.mean(axis=0)
    sd = X.std(axis=0)
    sd = np.where(sd < 1e-12, 1.0, sd)
    return (X - mu) / sd, mu, sd


def fit_lasso_cv(X: np.ndarray, y: np.ndarray,
                 alphas: Sequence[float] | None = None,
                 folds: int = 10, iters: int = 800, seed: int = 0,
                 device: str | torch.device | None = None) -> LassoFit:
    """10-fold CV over an alpha grid, then refit on all data (paper
    method). All (alpha × fold) problems solve as one batch on `device`
    (None = the CUDA device)."""
    device = resolve_device(device)
    X = np.asarray(X, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    n, F = X.shape
    Xs, mu, sd = _standardize(X)
    if alphas is None:
        amax = float(np.abs(Xs.T @ (y - y.mean())).max() / n)
        alphas = list(amax * np.logspace(0, -3, 12))
    alphas_arr = np.asarray(alphas)

    rng = np.random.default_rng(seed)
    perm = rng.permutation(n)
    fold_id = np.arange(n) % folds
    fold_of = np.empty(n, dtype=int)
    fold_of[perm] = fold_id

    f32 = torch.float32
    Xt = torch.as_tensor(Xs, dtype=f32, device=device)
    yt = torch.as_tensor(y, dtype=f32, device=device)
    # Validation rows are zero-weighted (static shapes), each fold centred
    # on its own training rows: (K, n) weights -> (K, n, F) designs.
    wgt = torch.as_tensor(np.stack([fold_of != k for k in range(folds)]),
                          dtype=f32, device=device)
    ntr = wgt.sum(1)
    xmean = (Xt * wgt[..., None]).sum(1) / ntr[:, None]
    ymean = (yt * wgt).sum(1) / ntr
    Xc = (Xt - xmean[:, None, :]) * wgt[..., None]
    yc = (yt - ymean[:, None]) * wgt
    a = torch.as_tensor(alphas_arr, dtype=f32, device=device)[:, None]
    w = _fista(Xc, yc, ntr, a, iters)                     # (A, K, F)
    b = ymean - (xmean * w).sum(-1)
    fits = torch.cat([w, b[..., None]], dim=-1).cpu().numpy()

    # Validation MAE per (alpha, fold).
    maes = np.zeros((len(alphas_arr), folds))
    for ai in range(len(alphas_arr)):
        for k in range(folds):
            wk, bk = fits[ai, k, :F], fits[ai, k, F]
            val = fold_of == k
            pred = Xs[val] @ wk + bk
            maes[ai, k] = np.abs(pred - y[val]).mean()
    mae_mean = maes.mean(axis=1)
    best = int(np.argmin(mae_mean))
    alpha = float(alphas_arr[best])

    # Refit on all data.
    w, b = lasso_fista(Xt, yt, alpha, iters=iters)
    w = w.cpu().numpy()
    b = float(b)
    pred = Xs @ w + b
    ss_res = float(((y - pred) ** 2).sum())
    ss_tot = float(((y - y.mean()) ** 2).sum()) + 1e-12
    coef = w / sd
    intercept = b - float(mu @ coef)
    selected = tuple(int(i) for i in np.nonzero(np.abs(w) > 1e-8)[0])
    return LassoFit(coef=coef, intercept=intercept, alpha=alpha,
                    selected=selected,
                    cv_mae_mean=float(mae_mean[best]),
                    cv_mae_var=float(maes[best].var()),
                    r2=1.0 - ss_res / ss_tot)
