"""S-Map: locally weighted linear forecasting (cppEDM parity).

S-Map is the other core EDM method beside simplex and the standard EDM
nonlinearity test: skill rising with the locality θ means state-dependent,
nonlinear dynamics. The entry points here are thin wrappers over the
batched engine (``core/smap_engine.py``); ``smap_predict_seed`` keeps the
per-query least-squares fit as the oracle.
"""

from __future__ import annotations

import torch

from repro_torch.core.embedding import embed_offset, pred_rows
from repro_torch.core.smap_engine import (DEFAULT_THETAS, smap_fit,
                                          smap_theta_sweep)
from repro_torch.kernels import ops
from repro_torch.kernels.ref import delay_embed, pearson_rows_tree, sqrt_rn


def smap_predict_seed(x: torch.Tensor, *, E: int, tau: int = 1, Tp: int = 1,
                      theta: float = 0.0):
    """Seed S-Map: one least-squares fit per query row (the oracle).

    For each query j: weights w_i = exp(−θ d_ij / d̄_j) over all library
    points i (self excluded), then a weighted ridge-free fit
    ŷ = [1, z_j]·b with b = argmin Σ w_i (y_i − [1, z_i]·b)², by
    ``torch.linalg.lstsq`` on √w-scaled copies of the design matrix.
    Returns (pred, truth), both (rows,).
    """
    x = x.float()
    rows = pred_rows(x.shape[-1], E, tau, Tp)
    off = embed_offset(E, tau, Tp)
    Z = delay_embed(x, E, tau)
    y = x[off:off + rows]
    A = torch.cat([torch.ones((rows, 1), dtype=torch.float32,
                              device=x.device), Z[:rows]], dim=1)
    D = ops.pairwise_distances(x, E=E, tau=tau, impl="ref")
    d = sqrt_rn(torch.clamp(D[:rows, :rows], min=0.0))
    pred = torch.empty(rows, dtype=torch.float32, device=x.device)
    for j in range(rows):
        dj = d[j]
        dbar = torch.clamp(dj.mean(), min=1e-30)
        w = torch.exp(-theta * dj / dbar)
        w[j] = 0.0  # leave-one-out
        sw = torch.sqrt(w)[:, None]
        b = torch.linalg.lstsq(A * sw, (y * sw[:, 0])[:, None]).solution
        pred[j] = A[j] @ b[:, 0]
    return pred, y


def smap_predict(x: torch.Tensor, *, E: int, tau: int = 1, Tp: int = 1,
                 theta: float = 0.0, ridge: float = 1e-6,
                 impl: str = "auto"):
    """Leave-one-out S-Map forecasts → (pred, truth), both (rows,)."""
    pred, _ = smap_fit(x, x[None], E=E, tau=tau, Tp=Tp,
                       thetas=(float(theta),), ridge=ridge, impl=impl)
    rows = pred_rows(x.shape[-1], E, tau, Tp)
    off = embed_offset(E, tau, Tp)
    return pred[0, 0], x.float()[off:off + rows]


def smap_skill(x: torch.Tensor, *, E: int, tau: int = 1, Tp: int = 1,
               theta: float = 0.0, ridge: float = 1e-6,
               impl: str = "auto") -> torch.Tensor:
    """ρ of the leave-one-out S-Map forecast at one θ."""
    pred, truth = smap_predict(x, E=E, tau=tau, Tp=Tp, theta=theta,
                               ridge=ridge, impl=impl)
    return pearson_rows_tree(pred[None, :], truth[None, :])[0]


def nonlinearity_test(x: torch.Tensor, *, E: int, tau: int = 1, Tp: int = 1,
                      thetas=DEFAULT_THETAS, ridge: float = 1e-6,
                      impl: str = "auto") -> torch.Tensor:
    """ρ(θ) curve — skill rising with θ indicates nonlinear dynamics.
    One engine call for the whole θ grid."""
    return smap_theta_sweep(x[None, :], E=E, tau=tau, Tp=Tp,
                            thetas=tuple(float(t) for t in thetas),
                            ridge=ridge, impl=impl)[0]
