"""Check of ``EDM.xmap()`` (simplex): sampled library rows of ρ.

Entry (l, t) cross-maps target t from library l's delay manifold: for
each embedded point of l, its E + 1 nearest neighbours in l's manifold
(itself excluded), exponential weights, and the target's values at the
neighbours' times, Tp_cross ahead; ρ is Pearson's over the points.
"""

from __future__ import annotations

import numpy as np
import torch

from edmbench.reference import common

#: Targets per block of the lookup (bounds the gathered (blk, rows, k)).
TARGET_BLOCK = 2048


def keep(out, sample):
    return np.asarray(out)[sample].copy()


def as_output(part, sample, n):
    """The sampled rows in the place of a call's (n, n) output, the other
    rows NaN (the control: the reference put in the program's place)."""
    out = np.full((n, part.shape[1]), np.nan)
    out[sample] = part
    return out


def expected(panel, sample, params, *, device, precision):
    E, tau, Tp = int(params["E"]), int(params["tau"]), int(params["Tp_cross"])
    with common.precision(precision) as dt:
        P = torch.as_tensor(panel, device=device).to(dt)
        L = P.shape[1]
        Lp = L - (E - 1) * tau
        rows, off = Lp - Tp, (E - 1) * tau + Tp
        out = np.empty((len(sample), P.shape[0]), np.float64)
        for r, lib in enumerate(sample):
            Z = common.embed(P[int(lib)], E, tau)
            d, idx = common.knn(Z[:rows], Z[:Lp - Tp], E + 1)
            w = common.simplex_weights(d)
            cols = idx + off
            for a in range(0, P.shape[0], TARGET_BLOCK):
                T = P[a:a + TARGET_BLOCK]
                pred = (T[:, cols] * w).sum(-1)
                out[r, a:a + T.shape[0]] = common.pearson(
                    pred, T[:, off:off + rows]).double().cpu().numpy()
    return out


def readings(kept, ref):
    return {"rho_gap": common.worst_gap(kept, ref)}
