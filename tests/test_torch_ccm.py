"""Port vs reference: CCM convergence, significance and the session's
``ccm`` / ``surrogate_test`` / ``ccm_batch`` fallback.

The same numpy panel goes through ``repro`` (JAX on the CPU,
``impl="ref"``) and ``repro_torch`` on CPU tensors. Neighbour tables are
bit-equal (tests/test_torch_topk.py); ρ goes through float32 sums ordered
differently by XLA and PyTorch, so ρ and null ρ are held to atol 1e-5, and
p-values must be equal except where a null ρ lies within 2e-5 of the real
ρ (there the ≥ comparison may flip). Within the port, the convergence
engine equals the per-size seed loop and the master-derived route equals
the engine bit for bit.
"""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ccm as jccm
from repro.data import timeseries as ts
from repro.edm import EDM as JEDM
from repro.edm.surrogates import make_surrogates as j_make_surrogates
from repro_torch import telemetry
from repro_torch.core import (ccm_convergence, ccm_convergence_caps,
                              ccm_matrix, cross_map, cross_map_sizes_seed,
                              normalize_lib_sizes)
from repro_torch.edm import EDM, make_surrogates
from repro_torch.edm.plan import ccm_convergence_from_master

ATOL = 1e-5
P_MARGIN = 2e-5
E_MAX = 5
SIZES = (15, 40, 41, 100, 250)


def _panel() -> np.ndarray:
    net, _ = ts.forced_network_panel(5, 260, seed=7)
    return net.astype(np.float32)


@pytest.fixture(scope="module")
def sessions():
    panel = _panel()
    js = JEDM(panel, impl="ref", E_max=E_MAX)
    tsess = EDM(panel, E_max=E_MAX, device="cpu")
    js.optimal_E()
    tsess.optimal_E()
    return panel, js, tsess


def test_normalize_lib_sizes_matches_reference():
    for sizes in ((10, 50, 200), (50, 10, 10, 999), (1,)):
        with warnings.catch_warnings(record=True) as wj:
            warnings.simplefilter("always")
            cj, ij = jccm.normalize_lib_sizes(sizes, Lp=200, Tp=1)
        with warnings.catch_warnings(record=True) as wt:
            warnings.simplefilter("always")
            ct, it = normalize_lib_sizes(sizes, Lp=200, Tp=1)
        assert ct == cj
        np.testing.assert_array_equal(it, ij)
        assert [str(w.message) for w in wt] == [str(w.message) for w in wj]
    for bad in ((), (0, 5)):
        with pytest.raises(ValueError):
            normalize_lib_sizes(bad, Lp=200)


@pytest.mark.parametrize("E,tau,Tp", [(2, 1, 0), (3, 2, 1)])
def test_cross_map_and_convergence_match_reference(E, tau, Tp):
    X = _panel()
    lib, tg = X[0], X[1:]
    want = jccm.cross_map(jnp.asarray(lib), jnp.asarray(tg), E=E, tau=tau,
                          Tp=Tp, impl="ref")
    got = cross_map(torch.from_numpy(lib), torch.from_numpy(tg), E=E,
                    tau=tau, Tp=Tp)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL)
    one = cross_map(torch.from_numpy(lib), torch.from_numpy(tg[0]), E=E,
                    tau=tau, Tp=Tp)
    assert one.ndim == 0 and torch.equal(one, got[0])
    sizes = (40, 15, 250, 100)  # unsorted: one warning, caller's order kept
    with pytest.warns(UserWarning, match="unsorted"):
        cj = jccm.ccm_convergence(jnp.asarray(lib), jnp.asarray(tg), E=E,
                                  tau=tau, Tp=Tp, lib_sizes=sizes,
                                  impl="ref")
    with pytest.warns(UserWarning, match="unsorted"):
        ct = ccm_convergence(torch.from_numpy(lib), torch.from_numpy(tg),
                             E=E, tau=tau, Tp=Tp, lib_sizes=sizes)
    assert ct.shape == (len(sizes), len(tg))
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), rtol=0, atol=ATOL)


def test_convergence_engine_equals_seed_loop_with_one_multi_cap_pass():
    X = torch.from_numpy(_panel())
    with telemetry.record() as rec:
        eng = ccm_convergence(X[2], X, E=3, lib_sizes=SIZES)
    assert rec.counter_delta("edm_ops_pairwise_distances_calls") == 1
    assert rec.counter_delta("edm_ops_topk_select_sizes_calls") == 1
    assert rec.counter_delta("edm_ops_topk_select_calls") == 0
    seed = cross_map_sizes_seed(X[2], X, E=3, lib_sizes=SIZES)
    assert torch.equal(eng, seed)
    # The full usable library (Lp = L - 2 points at E = 3) is the plain
    # cross map.
    full = ccm_convergence(X[2], X, E=3, lib_sizes=(X.shape[1] - 2,))
    assert torch.equal(full[0], cross_map(X[2], X, E=3))


def test_session_ccm_both_routes_match_reference(sessions):
    _, js, tsess = sessions
    with telemetry.record() as rec:
        got = tsess.ccm(0, 1, lib_sizes=SIZES)  # small caps: the engine
    assert rec.counter_delta("edm_ops_topk_select_sizes_calls") == 1
    np.testing.assert_allclose(got, js.ccm(0, 1, lib_sizes=SIZES), rtol=0,
                               atol=ATOL)
    with telemetry.record() as rec:
        full = tsess.ccm(3, 2, E=3)  # one full-library cap: the master
    assert rec.counter_delta("edm_ops_pairwise_distances_calls") == 0
    assert rec.counter_delta("edm_knn_master_hits") == 1
    assert abs(float(full) - float(js.ccm(3, 2, E=3))) <= ATOL
    assert "multi-cap" in tsess.plan("ccm").detail


def test_master_derived_curves_equal_engine_where_slack_covers(sessions):
    panel, _, tsess = sessions
    X = torch.from_numpy(panel)
    _, iM, k_m, _ = tsess._cache["master"]
    E = 2
    Lp = panel.shape[1] - (E - 1)
    caps = tuple(Lp - 1 - s for s in range(k_m - E - 1, -1, -1))
    eng = ccm_convergence_caps(X[1], X, E=E, tau=1, Tp=0, caps=caps,
                               exclude_self=True, impl="auto")
    der = ccm_convergence_from_master(X[1], iM[1, E - 1], X, E=E, tau=1,
                                      Tp=0, caps=caps, k=E + 1, impl="auto")
    assert len(caps) > 1 and torch.equal(der, eng)


def test_make_surrogates_identical_to_reference():
    y = _panel()[0]
    for kw in (dict(method="shuffle"), dict(method="seasonal", period=12)):
        np.testing.assert_array_equal(make_surrogates(y, 7, seed=3, **kw),
                                      j_make_surrogates(y, 7, seed=3, **kw))
    with pytest.raises(ValueError, match="period"):
        make_surrogates(y, 2, method="seasonal")


def _assert_pvalues(got, want):
    near = np.abs(want.surrogate_rho - np.asarray(want.rho)[..., None])
    flips = (near <= P_MARGIN).any(axis=-1)
    same = np.asarray(got.pvalue) == np.asarray(want.pvalue)
    assert (same | flips).all()


@pytest.mark.parametrize("lib_sizes", [None, (30, 120, 250)],
                         ids=["full", "sweep"])
def test_surrogate_test_matches_reference(sessions, lib_sizes):
    _, js, tsess = sessions
    kw = dict(num_surrogates=25, lib_sizes=lib_sizes, seed=2)
    want = js.surrogate_test(4, 0, **kw)
    got = tsess.surrogate_test(4, 0, **kw)
    assert np.shape(got.rho) == np.shape(want.rho)
    assert got.surrogate_rho.shape == want.surrogate_rho.shape
    np.testing.assert_allclose(got.rho, want.rho, rtol=0, atol=ATOL)
    np.testing.assert_allclose(got.surrogate_rho, want.surrogate_rho,
                               rtol=0, atol=ATOL)
    _assert_pvalues(got, want)
    np.testing.assert_array_equal(got.significant, got.pvalue < 0.05)
    seasonal = tsess.surrogate_test(4, 0, num_surrogates=5,
                                    method="seasonal", period=10)
    assert seasonal.method == "seasonal" and 0 < seasonal.pvalue <= 1


def test_ccm_batch_falls_back_to_per_pair_ccm_without_a_master():
    panel = _panel()
    pairs = [(0, 1), (3, 2), (4, 4)]
    js = JEDM(panel, impl="ref", E_max=E_MAX, cache=False)
    tsess = EDM(panel, E_max=E_MAX, cache=False, device="cpu")
    got = tsess.ccm_batch(pairs, E=3)
    assert "master" not in tsess._cache
    np.testing.assert_allclose(got, js.ccm_batch(pairs, E=3), rtol=0,
                               atol=ATOL)
    for j, (l, t) in enumerate(pairs):
        assert got[j] == tsess.ccm(l, t, E=3)


def test_masked_pairs_give_nan_without_engine_runs():
    panel = _panel()
    panel[2, 9] = np.nan
    tsess = EDM(panel, E_max=E_MAX, on_invalid="mask", device="cpu")
    assert np.isnan(tsess.ccm(2, 0, E=2))
    assert np.isnan(tsess.ccm(0, 2, E=2, lib_sizes=(20, 50))).all()
    res = tsess.surrogate_test(0, 2, num_surrogates=4, E=2)
    assert np.isnan(res.rho) and np.isnan(res.surrogate_rho).all()


def test_ccm_matrix_wraps_the_session_xmap():
    panel = _panel()
    E_opt = np.array([2, 3, 2, 1, 3], np.int32)
    got = ccm_matrix(panel, E_opt, device="cpu")
    want = EDM(panel, E_max=3, device="cpu").xmap(E_opt=E_opt)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(got, jccm.ccm_matrix(panel, E_opt, impl="ref"),
                               rtol=0, atol=ATOL)


@pytest.mark.parametrize("E,tau,Tp", [(2, 1, 0), (3, 2, 1), (5, 1, 0)])
def test_ccm_group_per_series_matches_reference_and_engine(E, tau, Tp):
    """The legacy per-series block: each library's neighbour indices equal
    the JAX pipeline's, ρ within 1e-5 of ``repro``'s ``lax.map`` form
    (itself ~1 ULP from its own engine), and bit-equal to the port's
    batched engine (its B = 1 oracle)."""
    from repro.kernels import ops as jops

    from repro_torch.core import ccm_group, ccm_group_batched
    from repro_torch.core.embedding import num_embedded
    from repro_torch.kernels import ops

    panel = _panel()
    X = torch.as_tensor(panel)
    got = ccm_group(X, X, E=E, tau=tau, Tp=Tp)
    want = jccm.ccm_group(jnp.asarray(panel), jnp.asarray(panel), E=E,
                          tau=tau, Tp=Tp, impl="ref")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL)
    np.testing.assert_array_equal(
        got.numpy(), ccm_group_batched(X, X, E=E, tau=tau, Tp=Tp,
                                       batch_libs=2))
    hard_max = num_embedded(panel.shape[1], E, tau) - 1 - Tp
    for x, jx in zip(X, jnp.asarray(panel)):
        _, i = ops.topk_select(ops.pairwise_distances(x, E=E, tau=tau),
                               k=E + 1, exclude_self=True, max_idx=hard_max)
        _, ji = jops.topk_select(
            jops.pairwise_distances(jx, E=E, tau=tau, impl="ref"), k=E + 1,
            exclude_self=True, max_idx=hard_max, impl="ref")
        np.testing.assert_array_equal(i.numpy(), np.asarray(ji))


@pytest.mark.parametrize("E", [2, 4])
def test_ccm_group_from_master_matches_reference_and_engine(sessions, E):
    from repro.edm import plan as jplan

    from repro_torch.core import ccm_group
    from repro_torch.edm.plan import (_derive_idx, ccm_group_from_master,
                                      ccm_group_from_master_batched)

    panel, js, tsess = sessions
    X = torch.as_tensor(panel)
    iM = tsess._master(E)[1][:, E - 1]
    jiM = js._master(E)[1][:, E - 1]
    np.testing.assert_array_equal(iM.numpy(), np.asarray(jiM))
    kw = dict(E=E, tau=1, Tp=0, k=E + 1)
    got = ccm_group_from_master(X, iM, X, impl="auto", **kw)
    want = jplan.ccm_group_from_master(jnp.asarray(panel), jiM,
                                       jnp.asarray(panel), impl="ref", **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL)
    np.testing.assert_array_equal(
        got.numpy(), ccm_group_from_master_batched(X, iM, X, impl="auto",
                                                   batch_libs=2, **kw))
    # the master-derived tables are the capped top-k: the same bits
    np.testing.assert_array_equal(got.numpy(), ccm_group(X, X, E=E).numpy())
    Lp = panel.shape[1] - (E - 1)
    ik, _ = _derive_idx(iM[:, :Lp], k=E + 1, max_idx=Lp - 1)
    jik, _ = jplan._derive_idx(jiM[:, :Lp], k=E + 1, max_idx=Lp - 1)
    np.testing.assert_array_equal(ik.numpy(), np.asarray(jik))


# ------------------------------------------------- the direct engine's B
# kEDM's Table-1 shapes at E 3 (k 4): Fly80XY 82 × 10,608, Subject6's cell
# 4,096 × 3,780. The kernel path is chosen by the device and impl alone,
# so a "cuda" device string reaches its model without a card.

FLY, SUBJECT6 = (82, 10_608), (4_096, 3_780)


def _direct_B(shape, **kw):
    from repro_torch.core.ccm import direct_batch_libs
    N, L = shape
    return direct_batch_libs(N, L, N, E=3, tau=1, Tp=0, k=4, **kw)


@pytest.mark.parametrize("shape,B,launches", [(FLY, 82, 1),
                                              (SUBJECT6, 76, 54)],
                         ids=["fly80xy", "subject6"])
def test_direct_batch_on_the_kernel_path_counts_its_tables(shape, B,
                                                           launches):
    from repro_torch.core.ccm import direct_batch_bytes
    got = _direct_B(shape, impl="auto", device="cuda")
    assert (got, -(-shape[0] // got)) == (B, launches)
    # the (Lp, k) tables and temporaries, far under one (Lp, Lp) matrix
    per = direct_batch_bytes(shape[1], shape[0], E=3, tau=1, Tp=0, k=4,
                             kernel=True)
    Lp = shape[1] - 2
    assert 1_000_000 < per < 4 * Lp * Lp // 16


@pytest.mark.parametrize("device,impl", [("cpu", "auto"), ("cpu", "ref"),
                                         ("cuda", "ref")])
@pytest.mark.parametrize("shape,B", [(FLY, 1), (SUBJECT6, 4)],
                         ids=["fly80xy", "subject6"])
def test_direct_batch_on_the_plain_path_keeps_the_distance_rule(
        shape, B, device, impl):
    from repro_torch.core.ccm import auto_batch_libs
    Lp = shape[1] - 2
    assert _direct_B(shape, impl=impl, device=device, budget_mb=256) == B
    assert (_direct_B(shape, impl=impl, device=device)
            == auto_batch_libs(Lp, shape[0], device=device))


@pytest.mark.parametrize("device,impl", [("cuda", "auto"), ("cpu", "auto"),
                                         ("cuda", "ref")])
def test_direct_batch_explicit_batch_libs_wins(device, impl):
    for asked, want in ((1, 1), (7, 7), (10_000, SUBJECT6[0])):
        assert _direct_B(SUBJECT6, impl=impl, device=device,
                         batch_libs=asked, budget_mb=1) == want


@pytest.mark.parametrize("device,impl", [("cuda", "auto"), ("cpu", "auto")],
                         ids=["kernel", "plain"])
def test_direct_batch_grows_with_the_budget(device, impl):
    Bs = [_direct_B(SUBJECT6, impl=impl, device=device, budget_mb=mb)
          for mb in (16, 64, 256, 1024, 4096)]
    assert Bs == sorted(Bs) and Bs[0] < Bs[-1]
