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


def _sq32(a, b) -> np.float32:
    """fl(fl(a − b)²) in float32, as the strict distance chain's first term."""
    d = np.float32(a) - np.float32(b)
    return np.float32(d * d)


def _root32(v) -> np.float32:
    """The correctly rounded float32 square root (through float64)."""
    return np.float32(np.sqrt(np.float64(v)))


def root_collision_panel(n_series: int, L_old: int, dt: int, *,
                         seed: int = 0) -> np.ndarray:
    """(N, L_old + dt) float32 panel whose new column ties a stored
    neighbour's root but not its value.

    At E = 2 (τ = 1) in series s, old row i's nearest column j and the
    column c = L_old − 1, new at that level, lie at squared distances one
    float32 ulp apart that share one correctly rounded root: the new
    column's is the smaller in even series, the larger in odd ones. (At
    E = 1 no two squared distances share a root: sqrt_rn(fl(d²)) = |d|.)
    Every other value is far away (uniform in [100, 200)). A kNN master
    kept as roots cannot order the two without their values: the append
    kernel's case for recomputing on equal roots.
    """
    if dt < 1 or L_old < 8:
        raise ValueError(f"need L_old >= 8 and dt >= 1, got {L_old}, {dt}")
    rng = np.random.default_rng(seed)
    out = rng.uniform(100.0, 200.0, size=(n_series, L_old + dt))
    out = out.astype(np.float32)
    c = L_old - 1
    for s in range(n_series):
        for _ in range(1000):
            xj = np.float32(rng.uniform(0.25, 0.75))
            v0 = _sq32(-xj, xj)  # the first lag's term, both columns
            up = np.nextafter(v0, np.float32(np.inf))
            b = np.float32(np.sqrt(np.float64(up - v0)))  # second lag
            if (np.float32(v0 + _sq32(b, 0.0)) == up
                    and _root32(up) == _root32(v0)):
                break
        else:
            raise RuntimeError("no root collision found")
        # The new column takes the larger value in odd series.
        bj, bc = (b, np.float32(0.0)) if s % 2 == 0 else (np.float32(0.0), b)
        i, j = 0, 0
        while abs(i - j) < 2:  # rows i, i + 1, j, j + 1 all distinct
            i, j = rng.choice(c - 2, size=2)
        out[s, [i, i + 1, j, j + 1, c, c + 1]] = (-xj, 0.0, xj, bj, xj, bc)
    return out
