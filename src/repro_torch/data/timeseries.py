"""Synthetic dynamical systems for EDM validation and benchmarks (numpy).

These replace the paper's microscopy datasets (not shippable here) with
systems whose causal structure / embedding dimension is known analytically,
so the paper's claims can be validated rather than eyeballed:

* coupled logistic maps (Sugihara et al. 2012, the canonical CCM system)
  with tunable one-way or two-way forcing;
* the Lorenz-63 attractor (known E≈3 embedding);
* tent-map panels for throughput benchmarks shaped like the paper's
  datasets (Table 1) and synthetic sweeps (Figs. 2–5).
"""

from __future__ import annotations

import numpy as np


def coupled_logistic(
    n_steps: int,
    *,
    r_x: float = 3.8,
    r_y: float = 3.5,
    b_xy: float = 0.02,
    b_yx: float = 0.1,
    x0: float = 0.4,
    y0: float = 0.2,
    discard: int = 100,
    seed: int | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Two coupled logistic maps.

    x(t+1) = x(t)·(r_x − r_x·x(t) − b_xy·y(t))
    y(t+1) = y(t)·(r_y − r_y·y(t) − b_yx·x(t))

    With b_xy=0, b_yx>0: X forces Y (only), so CCM skill of cross-mapping
    X from Y's manifold is high and the converse low — Sugihara 2012 Fig 3.
    """
    if seed is not None:
        rng = np.random.default_rng(seed)
        x0 = float(rng.uniform(0.1, 0.9))
        y0 = float(rng.uniform(0.1, 0.9))
    n = n_steps + discard
    x = np.empty(n, np.float64)
    y = np.empty(n, np.float64)
    x[0], y[0] = x0, y0
    for t in range(n - 1):
        x[t + 1] = x[t] * (r_x - r_x * x[t] - b_xy * y[t])
        y[t + 1] = y[t] * (r_y - r_y * y[t] - b_yx * x[t])
    return (x[discard:].astype(np.float32), y[discard:].astype(np.float32))


def logistic_map(n_steps: int, *, r: float = 3.8, x0: float = 0.23,
                 discard: int = 100) -> np.ndarray:
    """Chaotic 1-D logistic map (true embedding dimension 1–2)."""
    x, _ = coupled_logistic(n_steps, r_x=r, b_xy=0.0, b_yx=0.0, x0=x0,
                            discard=discard)
    return x


def lorenz63(
    n_steps: int,
    *,
    dt: float = 0.02,
    sigma: float = 10.0,
    rho: float = 28.0,
    beta: float = 8.0 / 3.0,
    discard: int = 500,
) -> np.ndarray:
    """Lorenz-63 trajectory, RK4, returns (3, n_steps) float32."""
    n = n_steps + discard
    out = np.empty((n, 3), np.float64)
    s = np.array([1.0, 1.0, 1.0])

    def f(s):
        x, y, z = s
        return np.array([sigma * (y - x), x * (rho - z) - y, x * y - beta * z])

    for t in range(n):
        out[t] = s
        k1 = f(s)
        k2 = f(s + 0.5 * dt * k1)
        k3 = f(s + 0.5 * dt * k2)
        k4 = f(s + dt * k3)
        s = s + (dt / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)
    return out[discard:].T.astype(np.float32)


def tent_map_panel(n_series: int, n_steps: int, *, seed: int = 0,
                   discard: int = 64) -> np.ndarray:
    """(N, L) panel of independent chaotic tent maps — benchmark filler
    shaped like the paper's synthetic sweeps (10⁵ series × 10⁴ steps)."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(0.01, 0.99, size=n_series)
    n = n_steps + discard
    out = np.empty((n_series, n), np.float32)
    mu = 1.9999
    for t in range(n):
        out[:, t] = x
        x = mu * np.minimum(x, 1.0 - x)
        # fold numerical escape back into (0, 1)
        x = np.clip(x, 1e-9, 1.0 - 1e-9)
    return out[:, discard:]


def forced_network_panel(
    n_series: int,
    n_steps: int,
    *,
    n_drivers: int = 2,
    coupling: float = 0.08,
    seed: int = 0,
    discard: int = 100,
) -> tuple[np.ndarray, np.ndarray]:
    """Panel of logistic maps where the first ``n_drivers`` series force all
    others (star topology) — ground truth for all-pairs CCM matrices.

    Returns (panel (N, L) float32, adjacency (N, N) bool) with
    adjacency[i, j] = True iff series i forces series j.
    """
    rng = np.random.default_rng(seed)
    n = n_steps + discard
    r = rng.uniform(3.6, 3.9, size=n_series)
    x = rng.uniform(0.2, 0.8, size=n_series)
    # per-(driver, follower) coupling weights: identical common drive would
    # synchronize the followers and confound CCM (common-cause effect)
    w = rng.uniform(0.5, 1.5, size=(n_drivers, n_series))
    out = np.empty((n_series, n), np.float32)
    adj = np.zeros((n_series, n_series), bool)
    for d in range(n_drivers):
        adj[d, n_drivers:] = True
    for t in range(n):
        out[:, t] = x
        force = coupling * (w * x[:n_drivers, None]).sum(axis=0)
        x_new = x * (r - r * x)
        x_new[n_drivers:] = x[n_drivers:] * (
            r[n_drivers:] - r[n_drivers:] * x[n_drivers:]
            - force[n_drivers:]
        )
        x = np.clip(x_new, 1e-6, 1.0 - 1e-6)
    return out[:, discard:], adj
