"""Surrogate-series ensembles for CCM significance testing.

A CCM score alone is not evidence: weak coupling, shared seasonality or
plain autocorrelation can all give ρ > 0. The standard gate is a surrogate
ensemble: cross-map many null versions of the target and report the rank
of the real score as a p-value (``EDM.surrogate_test``).

* ``"shuffle"``  — a full random permutation, which destroys all temporal
  structure;
* ``"seasonal"`` — values permuted only within the same phase of a cycle
  of ``period`` samples, so shared periodic forcing survives into the null.

Generation is host-side numpy, O(M·L); from ``default_rng(seed)`` the
ensembles are those of ``repro.edm.surrogates`` value for value.
"""

from __future__ import annotations

import numpy as np

#: Surrogate null models understood by ``make_surrogates``.
METHODS = ("shuffle", "seasonal")


def make_surrogates(y, num: int, *, method: str = "shuffle",
                    period: int | None = None, seed: int = 0) -> np.ndarray:
    """``num`` surrogate copies of a series → (num, L) float32.

    ``method="seasonal"`` requires ``period`` (in samples). Deterministic
    for a given ``seed``.
    """
    if method not in METHODS:
        raise ValueError(f"unknown method {method!r}; expected {METHODS}")
    if num < 1:
        raise ValueError(f"num must be >= 1, got {num}")
    y = np.asarray(y, np.float32)
    if y.ndim != 1:
        raise ValueError(f"y must be 1-D, got shape {y.shape}")
    L = y.shape[0]
    rng = np.random.default_rng(seed)
    out = np.empty((num, L), np.float32)
    if method == "shuffle":
        for m in range(num):
            out[m] = y[rng.permutation(L)]
        return out
    if period is None or period < 1:
        raise ValueError(
            f"seasonal surrogates need period >= 1, got {period}")
    for m in range(num):
        perm = np.arange(L)
        for p in range(min(period, L)):
            phase = np.arange(p, L, period)
            perm[phase] = rng.permutation(phase)
        out[m] = y[perm]
    return out
