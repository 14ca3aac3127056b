"""Simplex projection: leave-one-out forecasting and optimal-E search.

Forecast skill ρ(E) comes from predicting ``x(t + Tp)`` from the
E-dimensional manifold with the point itself excluded (leave-one-out), as
in cppEDM's ``EmbedDimension``. These are the session's primitives for
``cache=False``: prefer ``repro_torch.edm.EDM.optimal_E`` / ``.simplex``,
which run one multi-E pass per panel and reuse its tables.
"""

from __future__ import annotations

import torch

from repro_torch.core.embedding import embed_offset, num_embedded, pred_rows
from repro_torch.core.knn import all_knn
from repro_torch.kernels import ops


def simplex_predict(x: torch.Tensor, *, E: int, tau: int = 1, Tp: int = 1,
                    impl: str = "auto") -> tuple[torch.Tensor, torch.Tensor]:
    """Leave-one-out Tp-ahead predictions for one series.

    Returns (pred, truth), both (Lp - Tp,): pred[j] forecasts the value at
    time j + (E-1)tau + Tp. One pairwise, one top-k and one lookup launch.
    """
    L = x.shape[-1]
    Lp = num_embedded(L, E, tau)
    rows = pred_rows(L, E, tau, Tp)
    off = embed_offset(E, tau, Tp)
    # Neighbours must themselves have a Tp-ahead value inside the series.
    table = all_knn(x, E=E, tau=tau, k=E + 1, exclude_self=True,
                    max_idx=Lp - 1 - Tp, impl=impl)
    w = table.weights[:rows]
    idx = table.idx[:rows]
    pred = ops.lookup(x[None, :], idx, w, offset=off, impl=impl)[0]
    return pred, x[off:off + rows]


def simplex_skill(x: torch.Tensor, *, E: int, tau: int = 1, Tp: int = 1,
                  impl: str = "auto") -> torch.Tensor:
    """Forecast skill ρ for one (series, E), a 0-d tensor."""
    pred, truth = simplex_predict(x, E=E, tau=tau, Tp=Tp, impl=impl)
    return ops.pearson_rows(pred[None, :], truth[None, :])[0]


def optimal_E_sweep_seed(x: torch.Tensor, *, E_max: int = 20, tau: int = 1,
                         Tp: int = 1, impl: str = "auto") -> torch.Tensor:
    """ρ(E) via one full pairwise + top-k + lookup per E — kEDM's ``edim``
    structure, O(ΣE·Lp²). The baseline of the multi-E engine below."""
    return torch.stack([simplex_skill(x, E=E, tau=tau, Tp=Tp, impl=impl)
                        for E in range(1, E_max + 1)])


def rho_curve(x: torch.Tensor, *, E_max: int = 20, tau: int = 1, Tp: int = 1,
              impl: str = "auto") -> torch.Tensor:
    """ρ(E) for E = 1..E_max from one multi-E all-kNN launch → (E_max,).

    The distance recurrence D_E = D_{E-1} + one lag term makes the sweep
    O(E_max·Lp²); each E's lookup reads a slice of the stacked tables.
    """
    L = x.shape[-1]
    # Neighbours must themselves have a Tp-ahead value inside the series.
    mx = tuple(num_embedded(L, E, tau) - 1 - Tp for E in range(1, E_max + 1))
    d, i = ops.all_knn_multi_e(x, E_max=E_max, tau=tau, exclude_self=True,
                               max_idx=mx, impl=impl)
    rhos = []
    for E in range(1, E_max + 1):
        rows = pred_rows(L, E, tau, Tp)
        off = embed_offset(E, tau, Tp)
        w = ops.make_weights(d[E - 1, :rows, :E + 1])
        rhos.append(ops.lookup_rho(x[None, :], i[E - 1, :rows, :E + 1], w,
                                   offset=off, impl=impl)[0])
    return torch.stack(rhos)


def optimal_E(x: torch.Tensor, *, E_max: int = 20, tau: int = 1, Tp: int = 1,
              impl: str = "auto") -> tuple[int, torch.Tensor]:
    """Sweep E = 1..E_max → (best E, ρ per E), one engine call."""
    rhos = rho_curve(x, E_max=E_max, tau=tau, Tp=Tp, impl=impl)
    return int(torch.argmax(rhos)) + 1, rhos


def optimal_E_batch(X: torch.Tensor, *, E_max: int = 20, tau: int = 1,
                    Tp: int = 1, impl: str = "auto"
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-series optimal E of an (N, L) panel → (E_opt (N,) int32,
    ρ (N, E_max)).

    One multi-E launch per series, in turn (the reference's sequential
    ``lax.map``), so peak memory stays at one series' tables.
    """
    rho = torch.stack([rho_curve(x, E_max=E_max, tau=tau, Tp=Tp, impl=impl)
                       for x in X])
    return (torch.argmax(rho, dim=1) + 1).to(torch.int32), rho
