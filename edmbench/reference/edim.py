"""Check of ``EDM.optimal_E()``: sampled series' ρ(E) curves and E_opt.

For E = 1..E_max, each series forecasts itself Tp ahead by simplex
(E + 1 nearest neighbours among the points whose Tp-ahead value exists,
itself excluded, exponential weights); ρ(E) is Pearson's between the
forecasts and the truth, and E_opt the E of the largest ρ(E).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from edmbench.reference import common


def keep(out, sample):
    E_opt, rho = out
    return (np.asarray(E_opt)[sample].copy(), np.asarray(rho)[sample].copy())


def as_output(part, sample, n):
    """The sampled series in the place of a call's (E_opt, ρ(E)) output,
    the others 0 and NaN (the control: the reference in the program's
    place)."""
    E_part, rho_part = part
    E_opt = np.zeros(n, np.int64)
    E_opt[sample] = E_part
    rho = np.full((n, rho_part.shape[1]), np.nan)
    rho[sample] = rho_part
    return E_opt, rho


def expected(panel, sample, params, *, device, precision):
    E_max, tau, Tp = (int(params["E_max"]), int(params["tau"]),
                      int(params["Tp"]))
    with common.precision(precision) as dt:
        P = torch.as_tensor(panel, device=device).to(dt)
        rho = np.empty((len(sample), E_max), np.float64)
        for r, s in enumerate(sample):
            x = P[int(s)]
            D = None  # float64: the squared distances grow a lag a level
            for E in range(1, E_max + 1):
                Z = common.embed(x, E, tau)
                n = Z.shape[0] - Tp           # rows = candidates
                off = (E - 1) * tau + Tp
                if dt == torch.float64:
                    lag = Z[:n, E - 1]
                    D = ((lag[:, None] - lag[None, :]) ** 2 if D is None
                         else D[:n, :n] + (lag[:, None] - lag[None, :]) ** 2)
                    Dm = D.clone()
                else:
                    Dm = common.sq_dists(Z[:n], Z[:n])
                Dm.fill_diagonal_(math.inf)
                d2, idx = common.select(Dm, E + 1)
                del Dm
                w = common.simplex_weights(torch.sqrt(d2))
                pred = (x[idx + off] * w).sum(-1)
                rho[r, E - 1] = float(common.pearson(
                    pred[None], x[None, off:off + n])[0])
            del D
    E_opt = (np.argmax(rho, axis=1) + 1).astype(np.int64)
    return E_opt, rho


def readings(kept, ref):
    """``rho_gap``: the widest ρ(E) gap; ``e_opt_regret``: how far below
    the reference's best ρ the reference's ρ at the program's E_opt lies
    (0 where the program picked the reference's E_opt)."""
    _, ref_rho = ref
    gap = common.worst_gap([k[1] for k in kept], ref_rho)
    regret = 0.0 if kept else np.inf
    best = ref_rho.max(axis=1)
    for E_opt, _ in kept:
        E_opt = np.asarray(E_opt)
        if E_opt.shape != best.shape or not (
                (E_opt >= 1) & (E_opt <= ref_rho.shape[1])).all():
            return {"rho_gap": gap, "e_opt_regret": np.inf}
        at = ref_rho[np.arange(len(E_opt)), E_opt - 1]
        regret = max(regret, float(np.max(best - at)))
    return {"rho_gap": gap, "e_opt_regret": regret}
