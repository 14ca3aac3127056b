"""Batched S-Map engine: weighted normal equations + one batched Cholesky.

The counterpart of ``repro.core.smap_engine``:

1. ``ops.smap_gram`` accumulates, for every (query row, θ) pair, the
   weighted Gram matrix G = AᵀWA (shape (E+1, E+1)) and the moment
   vectors M = AᵀWy — on a CUDA tensor in one kernel launch
   (``kernels/csrc/smap_gram.cu``), on the CPU two products per θ.
2. All rows·|θ|·N ridge-regularized systems (G + εI) b = m are solved by
   one batched Cholesky (``torch.linalg.cholesky_ex``) and two batched
   triangular solves. ε = ridge·tr(G)/(E+1) + 1e-20 is relative
   to the Gram's own scale, so near-singular neighbourhoods (large θ,
   constant series, collinear lags) shrink instead of failing; a system
   whose factorization still fails gives NaN, as the reference's Cholesky
   does, and never raises.

κ(AᵀWA) = κ(√W·A)², so float32 loses about twice the digits a QR route
would. Two accumulations of G in different orders are then equally right
and still give predictions that differ visibly at large θ: the tests hold
ρ to tolerances that grow with θ, and G and M to a bound relative to
Σ|terms|.

Where the reference maps over libraries or series with ``lax.map``, the
port batches them into one kernel launch (``smap_group``) or into chunks
under a memory budget (``smap_predict_batch``). Each library's G and M,
its solve and its ρ (Pearson by fixed-order sums, ``ref.sum_tree``) are
the same bits at any batch size.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.ccm import auto_batch_libs
from repro_torch.core.embedding import embed_offset, pred_rows
from repro_torch.kernels import ops
from repro_torch.kernels.ref import pearson_rows_tree, sum_last

#: The classic nonlinearity-test locality grid (cppEDM's PredictNonlinear).
DEFAULT_THETAS = (0.0, 0.1, 0.3, 0.5, 1.0, 2.0, 4.0, 8.0)

_ABS_RIDGE = 1e-20  # floor so an all-zero Gram (no valid weight) stays SPD


def _ridge_solve(G: torch.Tensor, M: torch.Tensor,
                 ridge: float) -> torch.Tensor:
    """Solve (G + εI) b = m for every (row, θ, target) → (…, E+1, N).

    ε = ridge·tr(G)/(E+1) + 1e-20. Where the Cholesky factorization fails
    (``info`` ≠ 0) the solution is NaN, as ``jnp.linalg.cholesky`` gives.
    """
    E1 = G.shape[-1]
    tr = torch.diagonal(G, dim1=-2, dim2=-1).sum(-1)
    lam = ridge * (tr / E1) + _ABS_RIDGE
    eye = torch.eye(E1, dtype=G.dtype, device=G.device)
    c, info = torch.linalg.cholesky_ex(G + lam[..., None, None] * eye)
    # cho_solve as JAX writes it: a forward then a backward triangular
    # solve. ``torch.cholesky_solve`` takes MAGMA's batched path on the
    # card and is several times slower at this engine's shapes
    # (chip_smoke.py times both).
    z = torch.linalg.solve_triangular(c, M.transpose(-1, -2), upper=False)
    sol = torch.linalg.solve_triangular(c.transpose(-1, -2), z, upper=True)
    return torch.where((info != 0)[..., None, None],
                       torch.full_like(sol, float("nan")), sol)


def _design_rows(x: torch.Tensor, *, E: int, tau: int,
                 rows: int) -> torch.Tensor:
    """A = [1 | delay_embed(x)] restricted to the prediction rows
    (…, rows, E+1)."""
    Z = ops.delay_embed(x.float(), E, tau)[..., :rows, :]
    return torch.cat([torch.ones_like(Z[..., :1]), Z], dim=-1)


def _fit(x, Y, *, E, tau, Tp, thetas, ridge, exclude_self, impl):
    """(pred (…, N, T, rows), coef (…, N, T, rows, E+1)); ``x`` (L,) or
    (B, L), ``Y`` as ``ops.smap_gram`` takes it."""
    rows = pred_rows(x.shape[-1], E, tau, Tp)
    G, M = ops.smap_gram(x, Y, E=E, tau=tau, Tp=Tp, thetas=thetas,
                         exclude_self=exclude_self, impl=impl)
    Bs = _ridge_solve(G, M, ridge)  # (…, rows, T, E+1, N)
    A = _design_rows(x, E=E, tau=tau, rows=rows)  # (…, rows, E+1)
    # pred[n, t, j] = Σ_p A[j, p]·B[j, t, p, n], summed left to right in p
    # (the reference's einsum "jp,jtpn->ntj").
    terms = A[..., :, None, :, None] * Bs  # (…, rows, T, E+1, N)
    pred = sum_last(terms.transpose(-1, -2))  # (…, rows, T, N)
    pred = pred.movedim(-3, -1).movedim(-2, -3)  # (…, N, T, rows)
    coef = Bs.movedim(-1, -4).transpose(-3, -2)  # (…, N, T, rows, E+1)
    return pred, coef


def _thetas(thetas) -> tuple[float, ...]:
    return tuple(float(t) for t in thetas)


def smap_fit(x: torch.Tensor, Y: torch.Tensor, *, E: int, tau: int = 1,
             Tp: int = 1, thetas=DEFAULT_THETAS, ridge: float = 1e-6,
             exclude_self: bool = True, impl: str = "auto"):
    """Fit S-Map on ``x``'s manifold, predict the (N, L) panel ``Y``.

    Returns (pred, coef): pred (N, T, rows) leave-one-out forecasts of each
    target at every θ; coef (N, T, rows, E+1) the fitted local
    coefficients — coef[..., 0] is the intercept, coef[..., 1:] the per-row
    Jacobian ∂ŷ(t+Tp)/∂x(t−kτ) (Deyle & Sugihara's S-Map Jacobian).
    """
    return _fit(x, Y, E=E, tau=tau, Tp=Tp, thetas=_thetas(thetas),
                ridge=ridge, exclude_self=exclude_self, impl=impl)


def _series_per_launch(S: int, rows: int, T: int, E: int,
                       device: torch.device) -> int:
    """Series per θ-sweep launch: G, M and the solution of one chunk under
    the device's batch budget (``core.ccm.auto_batch_libs``' rule)."""
    E1 = E + 1
    return auto_batch_libs(rows, S, device=device,
                           per_series_bytes=4 * rows * T * (E1 * E1 + 2 * E1))


def smap_predict_batch(X: torch.Tensor, *, E: int, tau: int = 1,
                       Tp: int = 1, thetas=DEFAULT_THETAS,
                       ridge: float = 1e-6, impl: str = "auto"):
    """Self-prediction θ-sweep for an (S, L) panel.

    Returns (pred (S, T, rows), truth (S, rows)): leave-one-out forecasts
    of every series at every θ. The series go through the engine in
    chunks, each one launch with every series its own target; a chunk's
    G, M and solution stay under the device's batch budget, and a series'
    forecasts do not depend on the chunking.
    """
    if X.ndim != 2:
        raise ValueError(f"X must be (S, L), got {tuple(X.shape)}")
    S, L = X.shape
    rows = pred_rows(L, E, tau, Tp)
    off = embed_offset(E, tau, Tp)
    thetas = _thetas(thetas)
    Xf = X.float()
    step = _series_per_launch(S, rows, len(thetas), E, X.device)
    preds = []
    for a in range(0, S, step):
        chunk = Xf[a:a + step]
        pred, _ = _fit(chunk, chunk[:, None, :], E=E, tau=tau, Tp=Tp,
                       thetas=thetas, ridge=ridge, exclude_self=True,
                       impl=impl)
        preds.append(pred[:, 0])  # (s, T, rows)
    pred = preds[0] if len(preds) == 1 else torch.cat(preds)
    return pred, Xf[:, off:off + rows]


def smap_theta_sweep(X: torch.Tensor, *, E: int, tau: int = 1, Tp: int = 1,
                     thetas=DEFAULT_THETAS, ridge: float = 1e-6,
                     impl: str = "auto") -> torch.Tensor:
    """ρ(θ) curves for an (S, L) panel → (S, T)."""
    preds, truth = smap_predict_batch(X, E=E, tau=tau, Tp=Tp, thetas=thetas,
                                      ridge=ridge, impl=impl)
    return pearson_rows_tree(preds, truth[:, None, :])


def _cross_map_rho(lib, targets, *, E, tau, Tp, thetas, ridge, impl):
    """ρ of every target cross-mapped from the library(ies) ``lib`` →
    (T, N), or (B, T, N) for a (B, L) stack of libraries."""
    pred, _ = _fit(lib, targets, E=E, tau=tau, Tp=Tp, thetas=thetas,
                   ridge=ridge, exclude_self=True, impl=impl)  # (…, N, T, rows)
    rows = pred_rows(lib.shape[-1], E, tau, Tp)
    off = embed_offset(E, tau, Tp)
    truth = targets.float()[:, off:off + rows]  # (N, rows)
    return pearson_rows_tree(pred.transpose(-3, -2), truth)


def smap_cross_map(lib: torch.Tensor, targets: torch.Tensor, *, E: int,
                   tau: int = 1, Tp: int = 0, theta: float = 1.0,
                   thetas=None, ridge: float = 1e-6,
                   impl: str = "auto") -> torch.Tensor:
    """S-Map cross-mapping: fit on ``lib``'s manifold, predict the targets.

    The S-Map analog of ``core.ccm.cross_map`` (high ρ(target, target̂ |
    M_lib) is evidence "target causes lib"), with the locality θ exposed —
    at θ = 0 it is a global linear autoregression, so the ρ(θ) difference
    separates nonlinear coupling from shared linear structure.

    targets: (N, L) (a 1-D series is promoted). Returns (N,) ρ at
    ``theta``, or (T, N) when a ``thetas`` grid is given.
    """
    squeeze = targets.ndim == 1
    if squeeze:
        targets = targets[None, :]
    grid = (float(theta),) if thetas is None else _thetas(thetas)
    rho = _cross_map_rho(lib, targets, E=E, tau=tau, Tp=Tp, thetas=grid,
                         ridge=ridge, impl=impl)
    if thetas is None:
        rho = rho[0]  # (N,)
    return rho[..., 0] if squeeze else rho


def smap_group(libs: torch.Tensor, targets: torch.Tensor, *, E: int,
               tau: int = 1, Tp: int = 0, theta: float = 1.0,
               ridge: float = 1e-6, impl: str = "auto") -> torch.Tensor:
    """Batched S-Map CCM block: every library × every target → (Nl, Nt) ρ.

    One ``smap_gram`` launch for all libraries against the shared targets
    and one batched solve; each library's row is the same as a
    single-library call's. The caller bounds the batch (``EDM.xmap`` cuts
    the library axis by ``batch_libs``).
    """
    if targets.ndim == 1:
        targets = targets[None, :]
    return _cross_map_rho(libs, targets, E=E, tau=tau, Tp=Tp,
                          thetas=(float(theta),), ridge=ridge,
                          impl=impl)[:, 0]


def smap_matrix(X, E_opt=None, *, tau: int = 1, Tp: int = 0,
                theta: float = 1.0, ridge: float = 1e-6, impl: str = "auto",
                device: str = "cuda") -> np.ndarray:
    """All-pairs S-Map cross-map skill matrix, shape (N_lib, N_target).

    Entry (l, t) is the skill of cross-mapping series t from series l's
    manifold at locality θ, the library embedded at t's optimal E (an
    int, a per-series (N,) array, or ``None`` to compute it). A thin
    wrapper over ``repro_torch.edm.EDM.xmap(method="smap")``; a session
    keeps its state across calls, so prefer it.
    """
    from repro_torch.edm import EDM, EDMConfig

    X = np.asarray(X.cpu() if isinstance(X, torch.Tensor) else X,
                   np.float32)
    if E_opt is not None:
        E_opt = np.broadcast_to(np.asarray(E_opt, dtype=np.int32),
                                (X.shape[0],))
    sess = EDM(X, EDMConfig(tau=tau, Tp_cross=Tp, theta=float(theta),
                            ridge=ridge, impl=impl, device=device,
                            E_max=int(np.max(E_opt)) if E_opt is not None
                            else 20))
    return sess.xmap(method="smap", E_opt=E_opt)


def smap_jacobian(x: torch.Tensor, *, E: int, tau: int = 1, Tp: int = 1,
                  theta: float = 1.0, ridge: float = 1e-6,
                  impl: str = "auto") -> torch.Tensor:
    """Per-row S-Map Jacobian ∂x̂(t+Tp)/∂x(t−kτ), shape (rows, E).

    The fitted local linear coefficients, intercept dropped — at large θ
    they track the dynamics' state-dependent Jacobian (Deyle & Sugihara).
    """
    _, coef = smap_fit(x, x[None], E=E, tau=tau, Tp=Tp,
                       thetas=(float(theta),), ridge=ridge, impl=impl)
    return coef[0, 0, :, 1:]
