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
   constant series, collinear lags) shrink instead of failing.
3. A rank-deficient library — a periodic series whose delay vectors take
   fewer than E+1 affinely independent values, such as a period-3 orbit
   at E = 3 — has a Gram whose least eigenvalue (its transient's spread,
   about 1e-9·tr(G)) lies far below float32's rounding of G (up to
   1.6e-6·tr(G), more than ε): the Cholesky fails, or factors a matrix
   whose least direction is rounding. Neither that G's eigendecomposition
   nor its factorization in float64 recovers what the float32 sums lost.
   And where a library repeats its points (any periodic orbit), each
   repeat's forecast carries the same rounding, which passes into ρ whole
   instead of averaging out over distinct points. So the systems float32
   cannot solve — a failed factorization, or G + εI with an eigenvalue
   within ``REFIT_KAPPA``·tr(G) of 0 — and those of repeated points have
   their G and M accumulated again from the series in float64 and are
   solved there with the same ε (``_refit64``; one solve a distinct
   point and θ). Every other system keeps its float32 bits: a chaotic
   library's systems lie far from the bound and its points do not
   repeat, so its results are unchanged. A system float64 cannot solve
   either (a NaN in the data) gives NaN and never raises.

   Here the port departs from ``repro.core.smap_engine`` on purpose: the
   reference's Cholesky gives NaN on such a library, so ρ 0 for every
   target, where the float64 S-Map gives 1.0 for the series itself.
   Where float32 solves every system and no point repeats, both give
   the same answers.

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

from repro_torch import telemetry
from repro_torch.core.ccm import auto_batch_libs
from repro_torch.core.embedding import embed_offset, pred_rows
from repro_torch.kernels import ops
from repro_torch.kernels.ref import pearson_rows_tree, sum_last

#: The classic nonlinearity-test locality grid (cppEDM's PredictNonlinear).
DEFAULT_THETAS = (0.0, 0.1, 0.3, 0.5, 1.0, 2.0, 4.0, 8.0)

_ABS_RIDGE = 1e-20  # floor so an all-zero Gram (no valid weight) stays SPD


#: Where float32 cannot solve a system: G + εI has an eigenvalue within
#: ``REFIT_KAPPA``·tr(G) of 0 (or the factorization failed). A float32
#: Gram carries rounding of up to 1.6e-6·tr(G) (the least eigenvalue of
#: rank-deficient Grams on the card and on the plain path at 82 × 10,608),
#: so such a system's solution is more than 4 % rounding; the systems of
#: chaotic libraries lie at 8.1e-5·tr(G) and above at θ 1 (the least of 6
#: seeds × 869,692 systems on the card).
REFIT_KAPPA = 4e-5
#: Keys (a distinct point and θ) a block of the float64 refit: each holds
#: a row of distances and weights over the library's rows.
REFIT_BLOCK = 2048


def _ridge_eps(G: torch.Tensor, ridge: float):
    """(tr(G), ε = ridge·tr(G)/(E+1) + 1e-20) of every system."""
    tr = torch.diagonal(G, dim1=-2, dim2=-1).sum(-1)
    return tr, ridge * (tr / G.shape[-1]) + _ABS_RIDGE


def _cholesky_solve(G: torch.Tensor, M: torch.Tensor, lam: torch.Tensor):
    """(solution (…, E+1, N), Cholesky factor, ``info`` (…)) of
    (G + εI) b = m; a system with ``info`` ≠ 0 holds no solution."""
    eye = torch.eye(G.shape[-1], dtype=G.dtype, device=G.device)
    c, info = torch.linalg.cholesky_ex(G + lam[..., None, None] * eye)
    # cho_solve as JAX writes it: a forward then a backward triangular
    # solve. ``torch.cholesky_solve`` takes MAGMA's batched path on the
    # card and is several times slower at this engine's shapes
    # (chip_smoke.py times both).
    z = torch.linalg.solve_triangular(c, M.transpose(-1, -2), upper=False)
    sol = torch.linalg.solve_triangular(c.transpose(-1, -2), z, upper=True)
    return sol, c, info


def _unsolvable(G, c, info, tr):
    """Systems float32 cannot solve: ``info`` ≠ 0, or 1/tr((G + εI)⁻¹) —
    between a quarter of G + εI's least eigenvalue and all of it — below
    ``REFIT_KAPPA``·tr(G)."""
    eye = torch.eye(G.shape[-1], dtype=G.dtype, device=G.device)
    inv_tr = torch.linalg.solve_triangular(c, eye, upper=False).square() \
        .sum((-2, -1))
    return (info != 0) | (inv_tr * (REFIT_KAPPA * tr) > 1.0)


def _repeats(Z: torch.Tensor):
    """Of each delay vector of Z (…, rows, E): the first row that holds
    it, and whether another row does too (…, rows) each. A stable sort
    on each lag from the last puts equal vectors side by side, in row
    order."""
    rows = Z.shape[-2]
    order = torch.arange(rows, device=Z.device).expand(Z.shape[:-1])
    for k in reversed(range(Z.shape[-1])):
        key = torch.gather(Z[..., k], -1, order)
        order = torch.gather(order, -1, torch.sort(key, stable=True)[1])
    S = torch.gather(Z, -2, order[..., None].expand(Z.shape))
    same = (S[..., 1:, :] == S[..., :-1, :]).all(-1)
    pad = torch.zeros_like(same[..., :1])
    at = torch.arange(rows, device=Z.device)
    start = torch.where(torch.cat([~pad, ~same], -1), at, 0).cummax(-1)[0]
    first = torch.gather(order, -1, start)
    repeated = torch.cat([pad, same], -1) | torch.cat([same, pad], -1)
    return (torch.empty_like(first).scatter_(-1, order, first),
            torch.empty_like(repeated).scatter_(-1, order, repeated))


def _ridge_solve(G: torch.Tensor, M: torch.Tensor, ridge: float,
                 refit=None, redo=None) -> torch.Tensor:
    """Solve (G + εI) b = m for every (row, θ, target) → (…, E+1, N).

    ε = ridge·tr(G)/(E+1) + 1e-20. Every system goes through the batched
    float32 Cholesky. Without ``refit`` a system whose factorization fails
    is NaN, as ``jnp.linalg.cholesky`` gives. With it — ``refit(index)``
    → the solutions of the systems at ``index`` (a tuple of index tensors
    over G's batch axes), accumulated again from the data and solved in
    float64 — the systems float32 cannot solve (``_unsolvable``) and those
    ``redo`` marks (a bool mask broadcast over G's batch axes) take those,
    found with one host sync; every other system keeps its bits.
    Counters: ``edm_smap_systems`` (every system),
    ``edm_smap_ridge_fallbacks`` (those solved again).
    """
    tr, lam = _ridge_eps(G, ridge)
    sol, c, info = _cholesky_solve(G, M, lam)
    telemetry.counter("edm_smap_systems").inc(info.numel())
    if refit is None:
        return sol.masked_fill((info != 0)[..., None, None], float("nan"))
    again = _unsolvable(G, c, info, tr)
    if redo is not None:
        again = again | redo
    index = again.nonzero(as_tuple=True)
    if index[0].numel():
        sol[index] = refit(index)
        telemetry.counter("edm_smap_ridge_fallbacks").inc(index[0].numel())
    return sol


def _refit64(X, Y, lib, j, t, first, *, E, tau, Tp, thetas, exclude_self,
             ridge):
    """float32 solutions (F, E+1, N) of the F systems (library ``lib``,
    query row ``j``, θ index ``t``) of the libraries X (B, L) against Y
    (N, L) shared or (B, N, L): ``kernels.ref.smap_gram``'s G and M and
    their ridge solve, worked out again in float64 for those systems
    alone; NaN where even float64 cannot factor.

    Equal delay vectors have equal weights and equal A (``first`` (B,
    rows): the first row of each row's vector), so one key — a library's
    distinct point q and a θ — serves all its systems. Over every row,
    the point's own included (exp(0) = 1), it sums G_k and M_k; then G_j =
    G_k − A_qA_qᵀ, the same for the key's systems, and M_j = M_k − y_j⊗A_q,
    so one solve of G_j + εI against [M_k, A_q] gives each b_j = X_M −
    y_j⊗X_A.
    """
    rows, T, N = first.shape[-1], len(thetas), Y.shape[-2]
    off = embed_offset(E, tau, Tp)
    code = (lib * rows + first.reshape(-1)[lib * rows + j]) * T + t
    keys, key = torch.unique(code, return_inverse=True)  # library-major
    libs, counts = torch.unique_consecutive(keys // (rows * T),
                                            return_counts=True)
    Xk = torch.empty((len(keys), E + 1, N + 1), dtype=torch.float64,
                     device=X.device)
    a = 0
    for b, n in zip(libs.tolist(), counts.tolist()):
        k = keys[a:a + n] % (rows * T)
        Xk[a:a + n] = _key_solve64(
            X[b], Y[b] if Y.ndim == 3 else Y, k // T, k % T, rows=rows,
            E=E, tau=tau, off=off, thetas=thetas,
            exclude_self=exclude_self, ridge=ridge)
        a += n
    Xj = Xk[key]
    if not exclude_self:
        return Xj[..., :N].float()
    y = Y[lib, :, off + j] if Y.ndim == 3 else Y[:, off + j].T  # (F, N)
    return (Xj[..., :N] - Xj[..., N:] * y.double()[:, None, :]).float()


def _key_solve64(x, Y, q, t, *, rows, E, tau, off, thetas, exclude_self,
                 ridge):
    """[X_M | X_A] (K, E+1, N+1) of keys (row q holding the point, θ
    index t) of one library series x (L,): ``_refit64``'s solves."""
    E1, N = E + 1, Y.shape[-2]
    Z = ops.delay_embed(x.double(), E, tau)[:rows]            # (rows, E)
    A = torch.cat([torch.ones_like(Z[:, :1]), Z], dim=1)
    AA = (A[:, :, None] * A[:, None, :]).reshape(rows, -1)
    yA = (Y.double()[:, off:off + rows].T[:, :, None]
          * A[:, None, :]).reshape(rows, -1)                   # (rows, N·E1)
    th = torch.tensor(thetas, dtype=torch.float64, device=x.device)
    out = torch.empty((len(q), E1, N + 1), dtype=torch.float64,
                      device=x.device)
    for a in range(0, len(q), REFIT_BLOCK):
        qb, tb = q[a:a + REFIT_BLOCK], t[a:a + REFIT_BLOCK]
        zq = Z[qb]
        d = (zq[:, None, 0] - Z[None, :, 0]).square_()
        for lag in range(1, E):
            d += (zq[:, None, lag] - Z[None, :, lag]).square_()
        d.sqrt_()
        dbar = d.mean(1, keepdim=True)
        d *= (-th[tb])[:, None] / torch.where(dbar > 1e-30, dbar,
                                              torch.ones_like(dbar))
        W = d.exp_()
        G = (W @ AA).view(-1, E1, E1)
        if exclude_self:
            G -= AA[qb].view(-1, E1, E1)
        R = torch.cat([(W @ yA).view(-1, N, E1), A[qb, None, :]], dim=1)
        _, lam = _ridge_eps(G, ridge)
        sol, _, info = _cholesky_solve(G, R, lam)
        out[a:a + len(qb)] = sol.masked_fill((info != 0)[:, None, None],
                                             float("nan"))
    return out


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
    with telemetry.device_span("smap.gram", x.device,
                               B=x.shape[0] if x.ndim == 2 else 1,
                               rows=rows, N=Y.shape[-2], T=len(thetas)):
        G, M = ops.smap_gram(x, Y, E=E, tau=tau, Tp=Tp, thetas=thetas,
                             exclude_self=exclude_self, impl=impl)
    X = x.reshape(-1, x.shape[-1])
    A = _design_rows(x, E=E, tau=tau, rows=rows)  # (…, rows, E+1)
    with telemetry.device_span("smap.solve", x.device):
        # a repeated point's forecast error recurs in every repeat and
        # passes into ρ whole, where distinct points' errors average out
        first, repeated = _repeats(A[..., 1:])

        def refit(index):
            lib = index[0] if x.ndim == 2 else torch.zeros_like(index[0])
            return _refit64(X, Y, lib, index[-2], index[-1], first,
                            E=E, tau=tau, Tp=Tp, thetas=thetas,
                            exclude_self=exclude_self, ridge=ridge)

        Bs = _ridge_solve(G, M, ridge, refit, repeated[..., None])
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
