"""The benchmark's panel: a seeded network of forced logistic maps.

A frozen copy of the port's ``forced_network_panel`` generator (coupled
logistic maps in a star topology, Sugihara et al. 2012), kept here so
that a change to the program cannot change the benchmark's data. The
adjacency matrix the original also returns is left out: no cell reads
it. The recordings of kEDM's Table 1 are not public in this repository,
so every cell runs on this synthetic panel at the published shape.
"""

from __future__ import annotations

import numpy as np


def logistic_network(n_series: int, n_steps: int, *, seed: int,
                     n_drivers: int = 2, coupling: float = 0.08,
                     discard: int = 100) -> np.ndarray:
    """(n_series, n_steps) float32 panel; the first ``n_drivers`` series
    force every other one with per-(driver, follower) weights.

    The same seed gives the same panel bit for bit (numpy's PCG64 seeded
    with the whole integer, so seeds past 2**32 are distinct).
    """
    rng = np.random.default_rng(seed)
    n = n_steps + discard
    r = rng.uniform(3.6, 3.9, size=n_series)
    x = rng.uniform(0.2, 0.8, size=n_series)
    w = rng.uniform(0.5, 1.5, size=(n_drivers, n_series))
    out = np.empty((n_series, n), np.float32)
    for t in range(n):
        out[:, t] = x
        force = coupling * (w * x[:n_drivers, None]).sum(axis=0)
        x_new = x * (r - r * x)
        x_new[n_drivers:] = x[n_drivers:] * (
            r[n_drivers:] - r[n_drivers:] * x[n_drivers:]
            - force[n_drivers:])
        x = np.clip(x_new, 1e-6, 1.0 - 1e-6)
    return out[:, discard:]
