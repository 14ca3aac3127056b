"""Check of ``EDM.xmap(method="smap")``: sampled library rows of ρ.

Entry (l, t) cross-maps target t from library l's delay manifold by S-Map
(Sugihara 1994), leave one out: for each embedded point j of l, the
linear map [1, z] ↦ y fitted over l's points by least squares with
weights w_ij = exp(−θ·d_ij/d̄_j) — d_ij the Euclidean distance of the
delay vectors, d̄_j its mean over the library's points (j's own 0
included), w_jj = 0 — and regularized by ridge: (G + εI) b = m, G = AᵀWA,
m = AᵀWy, ε = ridge·tr(G)/(E+1) + 1e-20, A's rows [1, z_i]. The forecast
is ŷ_j = [1, z_j]·b, of the target's value Tp_cross ahead of the
embedding's last lag, and ρ is Pearson's over the points.

In float64 a period-3 library's rank-3 Gram keeps its least eigenvalue
near 0, above −ε, so the system is solved as written and the series
cross-maps itself with ρ 1.
"""

from __future__ import annotations

import numpy as np
import torch

from edmbench.reference import common

#: Libraries a block (each holds its (rows, rows) distances and weights;
#: 900 MB apiece in float64 at 10,606 rows).
LIB_BLOCK = 4


def keep(out, sample):
    return np.asarray(out)[sample].copy()


def as_output(part, sample, n):
    """The sampled rows in the place of a call's (n, n) output, the other
    rows NaN (the control: the reference put in the program's place)."""
    out = np.full((n, part.shape[1]), np.nan)
    out[sample] = part
    return out


def sq_dists(Z: torch.Tensor) -> torch.Tensor:
    """(b, n, n) squared distances of a block's delay vectors (b, n, E):
    in float64 the lags' squared differences summed; in float32 — the
    control — ‖a‖² + ‖b‖² − 2⟨a, b⟩, the cross term a (TF32) product."""
    if Z.dtype == torch.float64:
        D = torch.zeros((Z.shape[0], Z.shape[1], Z.shape[1]), dtype=Z.dtype,
                        device=Z.device)
        for lag in range(Z.shape[2]):
            D += (Z[:, :, None, lag] - Z[:, None, :, lag]) ** 2
        return D
    n = (Z * Z).sum(-1)
    return torch.clamp(n[:, :, None] + n[:, None, :]
                       - 2.0 * (Z @ Z.transpose(1, 2)), min=0.0)


def _block(P, libs, *, E, tau, Tp, theta, ridge):
    """ρ (b, N) of the libraries ``libs`` against every series of P."""
    L = P.shape[1]
    Lp = L - (E - 1) * tau
    rows, off = Lp - Tp, (E - 1) * tau + Tp
    E1 = E + 1
    Z = torch.stack([common.embed(P[int(lib)], E, tau)[:rows]
                     for lib in libs])                       # (b, rows, E)
    W = torch.sqrt(sq_dists(Z))
    dbar = W.mean(-1, keepdim=True)
    W = torch.exp(-theta * W / torch.where(dbar > 0, dbar,
                                           torch.ones_like(dbar)))
    W.diagonal(dim1=1, dim2=2).zero_()
    A = torch.cat([torch.ones_like(Z[..., :1]), Z], dim=-1)  # (b, rows, E1)
    Y = P[:, off:off + rows]                                 # (N, rows)
    AA = (A[..., :, None] * A[..., None, :]).reshape(len(libs), rows, -1)
    G = (W @ AA).reshape(len(libs), rows, E1, E1)
    del AA
    out = torch.empty((len(libs), P.shape[0]), dtype=P.dtype,
                      device=P.device)
    eye = torch.eye(E1, dtype=P.dtype, device=P.device)
    tr = torch.diagonal(G, dim1=-2, dim2=-1).sum(-1)
    Gr = G + (ridge * tr / E1 + 1e-20)[..., None, None] * eye
    for r in range(len(libs)):
        yA = (Y.T[:, :, None] * A[r][:, None, :]).reshape(rows, -1)
        m = (W[r] @ yA).reshape(rows, -1, E1)                # (rows, N, E1)
        b = torch.linalg.solve(Gr[r], m.transpose(1, 2))     # (rows, E1, N)
        pred = (A[r][:, :, None] * b).sum(1).T               # (N, rows)
        out[r] = common.pearson(pred, Y)
    return out


def expected(panel, sample, params, *, device, precision):
    E, tau, Tp = int(params["E"]), int(params["tau"]), int(params["Tp_cross"])
    theta, ridge = float(params["theta"]), float(params["ridge"])
    with common.precision(precision) as dt:
        P = torch.as_tensor(panel, device=device).to(dt)
        out = np.empty((len(sample), P.shape[0]), np.float64)
        for a in range(0, len(sample), LIB_BLOCK):
            libs = sample[a:a + LIB_BLOCK]
            out[a:a + len(libs)] = _block(
                P, libs, E=E, tau=tau, Tp=Tp, theta=theta,
                ridge=ridge).double().cpu().numpy()
    return out


def readings(kept, ref):
    return {"rho_gap": common.worst_gap(kept, ref)}
