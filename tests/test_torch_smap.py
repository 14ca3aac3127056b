"""Port vs reference: the S-Map Gram engine and its entry points.

The same numpy inputs go through ``repro`` (JAX on the CPU, ``impl="ref"``)
and ``repro_torch`` on CPU tensors (the plain versions of the CUDA kernel).

Tolerances, and why:

- Distances are bit-equal (the strict chain and a correctly rounded root).
- G and M are float32 sums of ~rows terms that XLA and PyTorch order
  differently: each entry is held within ``GRAM_RTOL`` of Σ|terms|
  (``ref.smap_gram_abs``); measured ≤ 1.9e-6.
- Predictions and ρ come out of a Cholesky solve of AᵀWA, whose condition
  number is κ(√W·A)²; at large θ the effective sample collapses, so two
  equally right Gram sums give visibly different forecasts. Measured on
  these inputs: ρ ≤ 1.7e-5 apart up to θ = 4 and ≤ 4.1e-4 at θ = 8,
  predictions ≤ 1.8e-4 up to θ = 4 and ≤ 8.3e-3 at θ = 8; coefficients,
  relative to |c| + 1, ≤ 9.5e-5 up to θ = 2, ≤ 1.2e-3 at θ = 4 and
  ≤ 2.8e-2 at θ = 8 (where they reach |c| = 57). ``rho_tol``,
  ``pred_tol`` and ``coef_tol`` give each θ its bound.
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import smap as jsmap
from repro.core import smap_engine as jeng
from repro.data import timeseries as ts
from repro.kernels import ref as jref
from repro_torch import core, telemetry
from repro_torch.core import smap_engine as teng
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref

GRAM_RTOL = 1e-5


def rho_tol(theta: float) -> float:
    return 1e-4 if theta <= 4.0 else 3e-3


def pred_tol(theta: float) -> float:
    return 2e-4 if theta <= 2.0 else 1e-3 if theta <= 4.0 else 3e-2


def coef_tol(theta: float) -> float:
    """Bound on |Δc| / (|c| + 1)."""
    return 1e-3 if theta <= 2.0 else 1e-2 if theta <= 4.0 else 1e-1


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, np.float32))


def _noisy_logistic(L: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return (np.asarray(ts.logistic_map(L))
            + 0.01 * rng.standard_normal(L)).astype(np.float32)


def _rho_np(pred, truth) -> np.ndarray:
    return tref.pearson_rows(_t(pred), _t(truth)).numpy()


# ------------------------------------------------------------ kernels/ref


@pytest.mark.parametrize("E,tau", [(1, 1), (2, 1), (3, 2), (5, 1)])
def test_smap_distances_bit_equal_and_ratio(E, tau):
    x = np.random.default_rng(E * 10 + tau).standard_normal(160).astype(
        np.float32)
    rows = 160 - (E - 1) * tau - 1
    dj = jnp.sqrt(jnp.maximum(
        jref.pairwise_distances(jnp.asarray(x), E=E, tau=tau)[:rows, :rows],
        0.0))
    dt = tref._sorted_roots(
        tref.pairwise_distances(_t(x), E=E, tau=tau)[:rows, :rows])
    np.testing.assert_array_equal(dt.numpy(), np.asarray(dj))
    rj = np.asarray(jref.smap_ratio(jnp.asarray(x), E=E, tau=tau, rows=rows))
    rt = tref.smap_ratio(_t(x), E=E, tau=tau, rows=rows).numpy()
    # d̄ is a float32 mean in another order: a relative error of a few ULPs.
    np.testing.assert_allclose(rt, rj, rtol=1e-6, atol=0)


@pytest.mark.parametrize("E,tau,Tp,excl,N", [
    (1, 1, 0, False, 1), (1, 2, 1, True, 3), (2, 1, 0, True, 3),
    (2, 2, 3, False, 1), (3, 1, 1, True, 1), (3, 2, 3, True, 3),
    (5, 1, 1, False, 3), (5, 2, 0, True, 1),
])
def test_smap_gram_matches_reference(E, tau, Tp, excl, N):
    rng = np.random.default_rng(E * 100 + tau * 10 + Tp)
    x = rng.standard_normal(150).astype(np.float32)
    Y = rng.standard_normal((N, 150)).astype(np.float32)
    kw = dict(E=E, tau=tau, Tp=Tp, thetas=(0.0, 0.5, 2.0, 8.0),
              exclude_self=excl)
    Gj, Mj = jref.smap_gram(jnp.asarray(x), jnp.asarray(Y), **kw)
    Gt, Mt = tref.smap_gram(_t(x), _t(Y), **kw)
    Ga, Ma = tref.smap_gram_abs(_t(x), _t(Y), **kw)
    rows = 150 - (E - 1) * tau - Tp
    assert Gt.shape == (rows, 4, E + 1, E + 1) and Mt.shape == (rows, 4, N,
                                                                E + 1)
    for got, want, scale in ((Gt, Gj, Ga), (Mt, Mj, Ma)):
        err = np.abs(got.numpy() - np.asarray(want))
        assert (err <= GRAM_RTOL * scale.numpy()).all(), err.max()


def test_ops_smap_gram_library_axis_and_counter():
    rng = np.random.default_rng(3)
    X = _t(rng.standard_normal((3, 120)))
    Y = _t(rng.standard_normal((2, 120)))
    kw = dict(E=2, tau=1, Tp=1, thetas=(0.0, 1.0))
    with telemetry.record() as rec:
        G, M = ops.smap_gram(X, Y, **kw)
        Gs, Ms = ops.smap_gram(X, X[:, None, :], **kw)  # each its own target
    assert rec.counter_delta("edm_ops_smap_gram_calls") == 2
    assert G.shape == (3, 118, 2, 3, 3) and M.shape == (3, 118, 2, 2, 3)
    for b in range(3):
        g, m = ops.smap_gram(X[b], Y, **kw)
        assert torch.equal(G[b], g) and torch.equal(M[b], m)
        g, m = ops.smap_gram(X[b], X[b][None], **kw)
        assert torch.equal(Gs[b], g) and torch.equal(Ms[b], m)


@pytest.mark.parametrize("rows,E,N,T,B", [
    (1597, 3, 154, 1, 154),  # the fixed-E S-Map xmap: libraries in slices
    (297, 3, 1, 8, 154),     # a θ-sweep batch that fits whole
    (9995, 5, 1, 8, 1),      # θ-sweep at L = 10,000, E = 5: rows in slices
    (29997, 3, 154, 1, 2),   # an xmap library at L = 30,000
    (53980, 20, 1, 8, 3),    # E + 1 = 21 at L ≈ 54,000
])
def test_smap_gram_scratch_plan_stays_within_its_bound(rows, E, N, T, B):
    from repro_torch.kernels import smap_gram
    C = (E + 1) ** 2 + N * (E + 1)
    nb, nj = smap_gram.slices(rows, C, T, B)
    assert 1 <= nb <= B and 1 <= nj <= rows
    assert nb == 1 or nj == rows
    assert nj == rows or nj % smap_gram.ROW_STEP == 0
    need = 4 * nb * smap_gram.scratch_floats(rows, C, T, nj)
    assert need <= smap_gram.SCRATCH_BYTES
    if nj < rows:  # one more step of rows would pass the bound
        assert 4 * smap_gram.scratch_floats(
            rows, C, T, nj + smap_gram.ROW_STEP) > smap_gram.SCRATCH_BYTES


@pytest.mark.parametrize("n", [1, 2, 3, 1597])
def test_sum_tree_and_pearson_rows_tree_are_batch_invariant(n):
    rng = np.random.default_rng(n)
    a = _t(rng.standard_normal((6, 2, n)))
    b = _t(rng.standard_normal((6, 2, n)))
    s = tref.sum_tree(a)
    np.testing.assert_allclose(s.numpy(), a.double().sum(-1).numpy(),
                               rtol=1e-6, atol=1e-5)
    rho = tref.pearson_rows_tree(a, b)
    if n > 1:
        np.testing.assert_allclose(rho.numpy(),
                                   tref.pearson_rows(a, b).numpy(), atol=1e-6)
    for i in (0, 5):  # a row's bits do not depend on the other rows
        assert torch.equal(tref.sum_tree(a[i:i + 1]), s[i:i + 1])
        assert torch.equal(tref.pearson_rows_tree(a[i:i + 1, :1],
                                                  b[i:i + 1, :1]),
                           rho[i:i + 1, :1])


def test_constant_series_dbar_guard():
    """d̄ = 0 for a constant series: weights 1, not NaN; the ridge solve
    shrinks toward the constant; zero-variance truth gives ρ = 0."""
    xc = np.full(80, 0.7, np.float32)
    for theta in (0.0, 4.0):
        pred, truth = core.smap_predict(_t(xc), E=2, theta=theta)
        assert torch.isfinite(pred).all()
        np.testing.assert_allclose(pred.numpy(), 0.7, atol=1e-3)
        pj, _ = jsmap.smap_predict(jnp.asarray(xc), E=2, theta=theta,
                                   impl="ref")
        np.testing.assert_allclose(pred.numpy(), np.asarray(pj), rtol=0,
                                   atol=1e-5)
    rho = core.smap_theta_sweep(_t(xc)[None], E=2, thetas=(0.0, 2.0))
    assert torch.equal(rho, torch.zeros_like(rho))


# --------------------------------------------------------- the ridge solve


def test_ridge_solve_matches_reference():
    rng = np.random.default_rng(5)
    A = rng.standard_normal((40, 7, 4, 4)).astype(np.float32)
    G = A @ np.swapaxes(A, -1, -2) + 0.1 * np.eye(4, dtype=np.float32)
    M = rng.standard_normal((40, 7, 3, 4)).astype(np.float32)
    want = np.asarray(jeng._ridge_solve(jnp.asarray(G), jnp.asarray(M), 1e-6))
    got = teng._ridge_solve(_t(G), _t(M), 1e-6).numpy()
    assert got.shape == (40, 7, 4, 3)
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4)


def test_ridge_solve_nan_where_cholesky_fails():
    G = np.stack([np.eye(3), -np.eye(3), np.zeros((3, 3))]).astype(np.float32)
    M = np.ones((3, 2, 3), np.float32)
    M[2] = 0.0  # an all-zero Gram with zero moments: no valid weight
    got = teng._ridge_solve(_t(G), _t(M), 1e-6).numpy()
    want = np.asarray(jeng._ridge_solve(jnp.asarray(G), jnp.asarray(M), 1e-6))
    assert np.isnan(got[1]).all() and np.isnan(want[1]).all()
    assert np.isfinite(got[[0, 2]]).all()
    np.testing.assert_allclose(got[[0, 2]], want[[0, 2]], rtol=1e-6, atol=0)
    assert (got[2] == 0).all()  # 1e-20 keeps the zero Gram factorizable


# --------------------------------------------------------- engine entries


@pytest.mark.parametrize("theta", [0.0, 0.5, 2.0, 8.0])
def test_smap_fit_predictions_and_coefficients(theta):
    x = _noisy_logistic(200, seed=1)
    Y = np.stack([x, np.random.default_rng(2).standard_normal(200).astype(
        np.float32)])
    pj, cj = jeng.smap_fit(jnp.asarray(x), jnp.asarray(Y), E=2, Tp=1,
                           thetas=(theta,), impl="ref")
    pt, ct = core.smap_fit(_t(x), _t(Y), E=2, Tp=1, thetas=(theta,))
    assert pt.shape == (2, 1, 198) and ct.shape == (2, 1, 198, 3)
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=0,
                               atol=pred_tol(theta))
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj),
                               rtol=coef_tol(theta), atol=coef_tol(theta))


@pytest.mark.parametrize("E,tau,Tp", [(1, 1, 1), (2, 1, 0), (3, 2, 1),
                                      (2, 2, 3)])
def test_smap_theta_sweep_matches_reference(E, tau, Tp):
    panel, _ = ts.forced_network_panel(3, 180, seed=E + tau + Tp)
    X = np.asarray(panel, np.float32)
    thetas = core.DEFAULT_THETAS
    want = np.asarray(jeng.smap_theta_sweep(jnp.asarray(X), E=E, tau=tau,
                                            Tp=Tp, thetas=thetas,
                                            impl="ref"))
    got = core.smap_theta_sweep(_t(X), E=E, tau=tau, Tp=Tp,
                                thetas=thetas).numpy()
    assert got.shape == (3, len(thetas))
    for t, theta in enumerate(thetas):
        np.testing.assert_allclose(got[:, t], want[:, t], rtol=0,
                                   atol=rho_tol(theta))


def test_smap_predict_batch_invariant_in_chunking(monkeypatch):
    panel, _ = ts.forced_network_panel(4, 150, seed=6)
    X = _t(panel)
    whole = core.smap_predict_batch(X, E=2, thetas=(0.0, 2.0))
    monkeypatch.setattr(teng, "_series_per_launch", lambda *a: 1)
    with telemetry.record() as rec:
        chunked = core.smap_predict_batch(X, E=2, thetas=(0.0, 2.0))
    assert rec.counter_delta("edm_ops_smap_gram_calls") == 4
    assert torch.equal(whole[0], chunked[0])
    assert torch.equal(whole[1], chunked[1])


def test_nonlinearity_test_and_skill_match_reference():
    x = np.asarray(ts.logistic_map(220), np.float32)
    thetas = (0.0, 0.5, 2.0, 8.0)
    want = np.asarray(jsmap.nonlinearity_test(jnp.asarray(x), E=2,
                                              thetas=thetas, impl="ref"))
    got = core.nonlinearity_test(_t(x), E=2, thetas=thetas).numpy()
    for t, theta in enumerate(thetas):
        assert abs(got[t] - want[t]) <= rho_tol(theta)
    sk = float(core.smap_skill(_t(x), E=2, theta=2.0))
    assert abs(sk - float(jsmap.smap_skill(jnp.asarray(x), E=2, theta=2.0,
                                           impl="ref"))) <= rho_tol(2.0)


def test_smap_cross_map_single_theta_and_grid():
    xs, ys = ts.coupled_logistic(300, b_xy=0.0, b_yx=0.32, seed=3)
    x, y = np.asarray(xs, np.float32), np.asarray(ys, np.float32)
    for theta in (0.0, 2.0):
        want = float(jeng.smap_cross_map(jnp.asarray(y), jnp.asarray(x), E=2,
                                         theta=theta, impl="ref"))
        got = core.smap_cross_map(_t(y), _t(x), E=2, theta=theta)
        assert got.shape == () and abs(float(got) - want) <= rho_tol(theta)
    thetas = (0.0, 1.0, 4.0, 8.0)
    tg = np.stack([x, y])
    want = np.asarray(jeng.smap_cross_map(jnp.asarray(y), jnp.asarray(tg),
                                          E=2, thetas=thetas, impl="ref"))
    got = core.smap_cross_map(_t(y), _t(tg), E=2, thetas=thetas).numpy()
    assert got.shape == (4, 2)
    for t, theta in enumerate(thetas):
        np.testing.assert_allclose(got[t], want[t], rtol=0,
                                   atol=rho_tol(theta))
    # X forces Y: cross-mapping X from Y's manifold beats the converse.
    assert got[2, 0] > float(core.smap_cross_map(_t(x), _t(y), E=2,
                                                 theta=4.0)) + 0.1


@pytest.mark.parametrize("theta", [0.0, 1.5, 8.0])
def test_smap_group_matches_reference(theta):
    panel, _ = ts.forced_network_panel(5, 160, seed=8)
    X = np.asarray(panel, np.float32)
    want = np.asarray(jeng.smap_group(jnp.asarray(X), jnp.asarray(X[1:4]),
                                      E=3, theta=theta, impl="ref"))
    got = core.smap_group(_t(X), _t(X[1:4]), E=3, theta=theta).numpy()
    assert got.shape == (5, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=rho_tol(theta))
    for b in range(5):  # each library's row is its own single call's
        one = core.smap_group(_t(X[b:b + 1]), _t(X[1:4]), E=3, theta=theta)
        assert torch.equal(one[0], torch.from_numpy(got[b]))


@pytest.mark.parametrize("E,theta", [(2, 1.0), (2, 8.0), (3, 8.0)])
def test_smap_group_at_full_length_matches_reference(E, theta):
    """40 × 40 cross-maps at Fish1_Normo's length L = 1600: the tail of
    the ρ differences over many pairs stays inside the θ-dependent bound
    (measured max: 3.4e-5 at θ = 1; 1.3e-3 (E = 2) and 6.4e-4 (E = 3) at
    θ = 8)."""
    panel = ts.forced_network_panel(40, 1600, seed=0)[0].astype(np.float32)
    got = core.smap_group(_t(panel), _t(panel), E=E, theta=theta).numpy()
    want = np.asarray(jeng.smap_group(jnp.asarray(panel), jnp.asarray(panel),
                                      E=E, theta=theta, impl="ref"))
    np.testing.assert_allclose(got, want, rtol=0, atol=rho_tol(theta))


def test_smap_matrix_groups_by_E():
    panel, _ = ts.forced_network_panel(4, 200, seed=2)
    E_opt = np.array([2, 3, 2, 3], np.int32)
    got = core.smap_matrix(panel, E_opt, theta=1.0, device="cpu")
    want = jeng.smap_matrix(jnp.asarray(panel), E_opt, theta=1.0, impl="ref")
    assert got.shape == (4, 4)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0,
                               atol=rho_tol(1.0))


def test_smap_jacobian_matches_reference_and_tracks_derivative():
    r = 3.8
    x = np.asarray(ts.logistic_map(400, r=r), np.float32)
    J = core.smap_jacobian(_t(x), E=1, theta=8.0).numpy()
    Jj = np.asarray(jeng.smap_jacobian(jnp.asarray(x), E=1, theta=8.0,
                                       impl="ref"))
    assert J.shape == (399, 1)
    np.testing.assert_allclose(J, Jj, rtol=coef_tol(8.0),
                               atol=coef_tol(8.0))
    truth = r - 2 * r * x[:399]
    assert np.corrcoef(J[:, 0], truth)[0, 1] > 0.95


@pytest.mark.parametrize("theta", [0.0, 2.0, 8.0])
def test_smap_predict_seed_matches_reference(theta):
    x = np.asarray(ts.logistic_map(120), np.float32)
    pt, tt = core.smap_predict_seed(_t(x), E=2, theta=theta)
    pj, tj = jsmap.smap_predict_seed(jnp.asarray(x), E=2, theta=theta)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(tj))
    # Two least-squares drivers on √w-scaled rows: QR (torch gelsy) vs SVD.
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=0,
                               atol=pred_tol(theta))
    # The engine agrees with the seed oracle.
    pe, _ = core.smap_predict(_t(x), E=2, theta=theta)
    assert abs(_rho_np(pe[None], tt[None])[0]
               - _rho_np(pt[None], tt[None])[0]) <= rho_tol(theta)


# ---------------------------------------------- float64 lstsq oracle (θ ≤ 4)


def _numpy_smap(x, Y, *, E, tau, Tp, theta, exclude_self=True):
    """Explicit per-query weighted lstsq in float64 — the brute-force oracle.

    Returns (pred (N, rows), truth (N, rows), coef (N, rows, E+1)).
    """
    x = np.asarray(x, np.float64)
    Y = np.asarray(Y, np.float64)
    L = x.shape[-1]
    Lp = L - (E - 1) * tau
    rows = Lp - max(Tp, 0)
    off = (E - 1) * tau + Tp
    Z = np.stack([x[k * tau:k * tau + Lp] for k in range(E)], axis=1)[:rows]
    A = np.concatenate([np.ones((rows, 1)), Z], axis=1)
    d = np.sqrt(((Z[:, None, :] - Z[None, :, :]) ** 2).sum(-1))
    yv = Y[:, off:off + rows]
    N = Y.shape[0]
    pred = np.zeros((N, rows))
    coef = np.zeros((N, rows, E + 1))
    for j in range(rows):
        dbar = d[j].mean()
        w = np.exp(-theta * d[j] / max(dbar, 1e-30))
        if exclude_self:
            w[j] = 0.0
        sw = np.sqrt(w)[:, None]
        for n in range(N):
            b, *_ = np.linalg.lstsq(A * sw, yv[n] * sw[:, 0], rcond=None)
            pred[n, j] = A[j] @ b
            coef[n, j] = b
    return pred, yv, coef


@pytest.mark.parametrize("E,tau,Tp,theta", [
    (E, tau, Tp, theta) for (E, tau, Tp), theta in itertools.product(
        [(1, 1, 1), (2, 1, 0), (3, 2, 1), (4, 1, 2)], [0.0, 0.5, 4.0])])
def test_engine_matches_float64_lstsq_oracle(E, tau, Tp, theta):
    """ρ of the float32 engine within 1e-4 of a float64 per-query lstsq."""
    x = _noisy_logistic(130, seed=E + Tp)
    want_p, truth, _ = _numpy_smap(x, x[None], E=E, tau=tau, Tp=Tp,
                                   theta=theta)
    got_p, got_t = core.smap_predict(_t(x), E=E, tau=tau, Tp=Tp, theta=theta)
    np.testing.assert_allclose(got_t.numpy(), truth[0], rtol=1e-6, atol=0)
    np.testing.assert_allclose(got_p.numpy(), want_p[0], rtol=1e-2,
                               atol=1e-3)
    assert abs(_rho_np(got_p[None], truth[:1])[0]
               - _rho_np(want_p[:1], truth[:1])[0]) <= 1e-4
