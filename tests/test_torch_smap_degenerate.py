"""S-Map cross mapping on a rank-deficient library: a period-3 series.

Where a series settles on a period-3 orbit, its delay vectors (E 3) take
three values, so its library's Gram AᵀWA has rank 3 but for the
transient's tiny spread, and float32 cannot solve its ridge systems: the
Cholesky fails, or factors a matrix that is mostly rounding.
``core.smap_engine`` solves those systems again from the data in float64
(``_ridge_solve``'s ``refit``). The JAX reference returns ρ 0 for the
whole library row there (ROADMAP §3, "Choices, not faults"), so the port
is held here against the benchmark's float64 plain reference
(``edmbench/reference/smap_xmap.py``) on the CPU plain path, at 6 × 400
(seeds 7000000027 and 7000000012 of ``edmbench/data.py``: series 0, a
forcing series, is period-3).

Tolerances, and why:

- The period-3 series' row: the re-solved systems are float64 from the
  series on, and ρ's float32 sums add about 1e-7 (measured 2.6e-7 and
  8.1e-8), so ``SERIES_TOL`` 1e-5.
- The other rows are float32 solves of chaotic libraries, held as
  ``tests/test_torch_smap.py`` holds ρ up to θ 4 (``rho_tol``): 1e-4
  (measured ≤ 1.27e-5).
"""

import numpy as np
import pytest
import torch

from edmbench import data
from edmbench.reference import smap_xmap
from repro_torch import telemetry
from repro_torch.core import smap_engine as teng
from repro_torch.edm import EDM
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref

PERIOD3 = [7000000027, 7000000012]
CHAOTIC = 7000000001  # no forcing series in a periodic window at 6 × 400
PARAMS = {"E": 3, "tau": 1, "Tp_cross": 0, "theta": 1.0, "ridge": 1e-6}
SERIES_TOL = 1e-5
ROW_TOL = 1e-4


def _xmap(X):
    return EDM(X, E=3, device="cpu", ridge=PARAMS["ridge"]).xmap(
        method="smap", theta=PARAMS["theta"])


def _nan_on_failure(G, M, ridge, refit=None, redo=None):
    """The solve with no re-solve, built from ``_ridge_solve``'s parts:
    NaN wherever the float32 Cholesky fails, as the JAX reference gives."""
    _, lam = teng._ridge_eps(G, ridge)
    sol, _, info = teng._cholesky_solve(G, M, lam)
    return torch.where((info != 0)[..., None, None],
                       torch.full_like(sol, float("nan")), sol)


@pytest.mark.parametrize("seed", PERIOD3)
def test_period3_series_matches_the_float64_reference(seed):
    X = data.logistic_network(6, 400, seed=seed)
    with telemetry.record() as rec:
        got = _xmap(X)
    want = smap_xmap.expected(X, np.arange(6), PARAMS, device="cpu",
                              precision="float64")
    assert np.isfinite(got).all()
    assert got[0, 0] == pytest.approx(1.0, abs=SERIES_TOL)
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=SERIES_TOL)
    np.testing.assert_allclose(got[1:], want[1:], rtol=0, atol=ROW_TOL)
    assert rec.counter_delta("edm_smap_ridge_fallbacks") > 0


def test_period3_series_row_by_a_second_witness():
    # numpy float64 S-Map with the same conventions, to four digits
    X = data.logistic_network(6, 400, seed=7000000027)
    row = _xmap(X)[0]
    np.testing.assert_allclose(
        row, [1.0, -0.1639, 0.2556, 0.1055, 0.1242, 0.1415], atol=1e-4)


def test_without_a_periodic_series_nothing_is_solved_again(monkeypatch):
    X = data.logistic_network(6, 400, seed=CHAOTIC)
    with telemetry.record() as rec:
        got = _xmap(X)
    assert rec.counter_delta("edm_smap_ridge_fallbacks") == 0
    assert rec.counter_delta("edm_smap_systems") == 6 * 398
    monkeypatch.setattr(teng, "_ridge_solve", _nan_on_failure)
    assert np.array_equal(_xmap(X), got)


@pytest.mark.parametrize("seed", PERIOD3)
def test_systems_float32_solves_keep_their_bits(seed):
    X = torch.from_numpy(data.logistic_network(6, 400, seed=seed))
    G, M = ops.smap_gram(X, X, E=3, tau=1, Tp=0, thetas=(1.0,), impl="ref")
    first, repeated = teng._repeats(
        teng._design_rows(X, E=3, tau=1, rows=398)[..., 1:])
    repeats = repeated[..., None]
    seen = []

    def refit(index):
        seen.append(index)
        return teng._refit64(X, X, *index, first, E=3, tau=1, Tp=0,
                             thetas=(1.0,), exclude_self=True, ridge=1e-6)

    got = teng._ridge_solve(G, M, 1e-6, refit, repeats)
    old = _nan_on_failure(G, M, 1e-6)
    redone = torch.zeros(G.shape[:-2], dtype=torch.bool)
    redone[seen[0]] = True
    _, lam = teng._ridge_eps(G, 1e-6)
    _, _, info = teng._cholesky_solve(G, M, lam)
    assert len(seen) == 1 and redone[0].all()  # the period-3 series' library
    assert not redone[1:].any()
    assert (redone | (info == 0)).all()  # every failure solved again
    assert (redone | ~repeats).all()  # and every repeated point
    assert torch.equal(got[~redone], old[~redone])
    assert torch.isfinite(got).all()


def test_repeats_name_each_vectors_first_row():
    # rows 0, 2 and 5 hold one vector, 1 and 4 another, 3 its own
    Z = torch.tensor([[1.0, 2.0], [0.5, 2.0], [1.0, 2.0], [1.0, 3.0],
                      [0.5, 2.0], [1.0, 2.0]])
    first, repeated = teng._repeats(torch.stack([Z, Z.flip(0)]))
    assert first[0].tolist() == [0, 1, 0, 3, 1, 0]
    assert repeated[0].tolist() == [True, True, True, False, True, True]
    assert first[1].tolist() == [0, 1, 2, 0, 1, 0]
    assert repeated[1].tolist() == [True, True, False, True, True, True]


def _solve_by_rows(x, Y, *, E, Tp, theta, exclude_self, ridge):
    """Each row's float64 ridge solution from its own weights (N, rows,
    E+1): no repeated point shared, no own term taken off after."""
    x, Y = x.double(), Y.double()
    rows = x.shape[-1] - (E - 1) - Tp
    Z = torch.stack([x[k:k + rows] for k in range(E)], dim=1)
    A = torch.cat([torch.ones(rows, 1, dtype=torch.float64), Z], dim=1)
    y = Y[:, E - 1 + Tp:E - 1 + Tp + rows]
    d = torch.cdist(Z, Z)
    W = torch.exp(-theta * d / d.mean(1, keepdim=True))
    if exclude_self:
        W.fill_diagonal_(0.0)
    G = torch.einsum("ji,ip,iq->jpq", W, A, A)
    G += (ridge * G.diagonal(dim1=1, dim2=2).sum(-1) / (E + 1)
          + 1e-20)[:, None, None] * torch.eye(E + 1, dtype=torch.float64)
    m = torch.einsum("ji,ni,ip->jpn", W, y, A)
    return torch.linalg.solve(G, m)  # (rows, E+1, N)


@pytest.mark.parametrize("exclude_self", [True, False])
def test_float64_refit_is_the_float64_ridge_solution(exclude_self):
    # series 0 repeats (a period-3 orbit after its transient), series 2
    # does not; θ 0 (equal weights), 1 and 8
    X = torch.from_numpy(data.logistic_network(3, 300, seed=7000000027))
    thetas = (0.0, 1.0, 8.0)
    j = torch.arange(297).repeat_interleave(3)
    t = torch.arange(3).repeat(297)
    first, _ = teng._repeats(
        teng._design_rows(X, E=3, tau=1, rows=297)[..., 1:])
    for b in (0, 2):
        got = teng._refit64(X, X, torch.full_like(j, b), j, t, first, E=3,
                            tau=1, Tp=1, thetas=thetas,
                            exclude_self=exclude_self,
                            ridge=1e-6).reshape(297, 3, 4, 3)
        for i, theta in enumerate(thetas):
            want = _solve_by_rows(X[b], X, E=3, Tp=1, theta=theta,
                                  exclude_self=exclude_self, ridge=1e-6)
            # the float32 cast of each solution: ≤ 5.5e-8 of |b| + 1
            err = (got[:, i].double() - want).abs() / (want.abs() + 1)
            assert err.max() <= 2e-7


@pytest.mark.gpu
def test_period3_series_at_fly80xy_size_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: smap_gram has no CPU mode")
    seed = 7000000033  # series 0's transient spans ~500 of 10,606 rows
    X = data.logistic_network(82, 10608, seed=seed)
    Xc = torch.from_numpy(X).cuda()
    got = teng.smap_group(Xc[:1], Xc, E=3, Tp=0, theta=1.0).cpu().numpy()
    want = smap_xmap.expected(X, np.arange(1), PARAMS, device="cuda",
                              precision="float64")
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=ROW_TOL)
