"""Arithmetic shared by the reference's checks: embeddings, distances by
products, simplex weights, Pearson ρ, and the precision they run in."""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch

#: Distances under this make a weight ratio divide by it (the port's
#: ``make_weights`` floor), so a duplicate point takes all the weight.
EPS = 1e-30


@contextlib.contextmanager
def precision(name: str):
    """Run the block in ``"float64"`` or ``"tf32"`` (float32 data, TF32
    matrix products); yields the dtype."""
    if name not in ("float64", "tf32"):
        raise ValueError(f"unknown precision {name!r}")
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    tf32 = name == "tf32"
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield torch.float32 if tf32 else torch.float64
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def embed(x: torch.Tensor, E: int, tau: int) -> torch.Tensor:
    """Delay embedding (Lp, E): row i is x[i], x[i + τ], …, x[i + (E−1)τ]."""
    Lp = x.shape[-1] - (E - 1) * tau
    return torch.stack([x[k * tau:k * tau + Lp] for k in range(E)], dim=-1)


def sq_dists(Zq: torch.Tensor, Zc: torch.Tensor) -> torch.Tensor:
    """Squared Euclidean distances (q, c) of delay vectors.

    In float64, the lags' squared differences summed (duplicate points lie
    at exactly 0). In float32 — the control — ‖a‖² + ‖b‖² − 2⟨a, b⟩ with
    the cross term a matrix product, which ``precision("tf32")`` runs in
    TF32: the tensor-core distance a faster program would be tempted by.
    """
    if Zq.dtype == torch.float64:
        D = torch.zeros((Zq.shape[0], Zc.shape[0]), dtype=Zq.dtype,
                        device=Zq.device)
        for lag in range(Zq.shape[1]):
            D += (Zq[:, None, lag] - Zc[None, :, lag]) ** 2
        return D
    nq = (Zq * Zq).sum(-1)
    nc = (Zc * Zc).sum(-1)
    return torch.clamp(nq[:, None] + nc[None, :] - 2.0 * (Zq @ Zc.T),
                       min=0.0)


def select(D: torch.Tensor, k: int):
    """The k smallest of each row in (value, index) order — equal
    distances go to the lower index, kEDM's and the port's stated tie
    rule (a periodic series has many points at distance 0) → (squared
    distances, indices). ``torch.topk`` keeps no order among ties, so rows
    whose k-th value is tied past k are sorted stably instead."""
    d2, idx = torch.topk(D, k, dim=1, largest=False, sorted=True)
    tied = ((D <= d2[:, -1:]).sum(1) > k).nonzero().squeeze(1)
    if tied.numel():
        sv, si = torch.sort(D[tied], dim=1, stable=True)
        d2[tied], idx[tied] = sv[:, :k], si[:, :k]
    return d2, idx


def knn(Zq: torch.Tensor, Zc: torch.Tensor, k: int):
    """k nearest candidates of each query, self (the diagonal) excluded →
    (distances ascending, indices)."""
    D = sq_dists(Zq, Zc)
    n = min(D.shape)
    D[torch.arange(n), torch.arange(n)] = math.inf
    d2, idx = select(D, k)
    return torch.sqrt(d2), idx


def simplex_weights(d: torch.Tensor) -> torch.Tensor:
    """w_i = exp(−d_i / d_min), normalised to sum 1 (Sugihara & May)."""
    w = torch.exp(-d / torch.clamp(d[:, :1], min=EPS))
    return w / w.sum(-1, keepdim=True)


def pearson(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Row-wise Pearson correlation, two-pass; 0 where a variance is 0."""
    am = a - a.mean(-1, keepdim=True)
    bm = b - b.mean(-1, keepdim=True)
    denom = torch.sqrt((am * am).sum(-1) * (bm * bm).sum(-1))
    return torch.where(denom > 0, (am * bm).sum(-1) / denom,
                       torch.zeros_like(denom))


def worst_gap(kept: list, ref: np.ndarray) -> float:
    """Largest |program − reference| over every kept call; inf where a
    call's part has another shape or a non-finite entry."""
    worst = 0.0
    if not kept:
        return math.inf
    for part in kept:
        part = np.asarray(part, np.float64)
        if part.shape != ref.shape or not np.isfinite(part).all():
            return math.inf
        worst = max(worst, float(np.max(np.abs(part - ref))))
    return worst
