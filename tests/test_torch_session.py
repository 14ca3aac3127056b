"""Port vs reference: the ``EDM`` session's main path on the CPU.

The same numpy panel is bound to ``repro.edm.EDM`` (JAX on the CPU,
``impl="ref"``) and to ``repro_torch.edm.EDM(device="cpu")``, whose CPU
tensors run the plain versions of the CUDA kernels. kNN tables are
bit-equal (tests/test_torch_knn.py), so E_opt must be equal; every ρ goes
through float32 reductions ordered differently by XLA and PyTorch, so ρ is
held to atol 1e-5.
"""

import numpy as np
import pytest
import torch

from repro.core.ccm import ccm_group_batched as j_group_batched
from repro.core.smap_engine import DEFAULT_THETAS
from repro.data import timeseries as ts
from repro.edm import EDM as JEDM
from repro_torch import telemetry
from repro_torch.core import smap_group, smap_theta_sweep
from repro_torch.core.ccm import ccm_group_batched
from repro_torch.edm import EDM, Dataset, EDMConfig, carry_session_cache

ATOL = 1e-5
E_MAX = 6


def smap_rho_tol(theta: float) -> float:
    """S-Map ρ bound against JAX: two float32 Gram sums in different
    orders go through an ill-conditioned solve at large θ (the measurement
    is in tests/test_torch_smap.py)."""
    return 1e-4 if theta <= 4.0 else 3e-3


def _assert_smap_close(got, want, thetas):
    assert got.shape == want.shape == (got.shape[0], len(thetas))
    for t, theta in enumerate(thetas):
        np.testing.assert_allclose(got[:, t], want[:, t], rtol=0,
                                   atol=smap_rho_tol(theta))


def _panel(seed: int) -> np.ndarray:
    """Six series whose optimal E differs (logistic, tent and Lorenz)."""
    net, _ = ts.forced_network_panel(6, 200, seed=seed)
    return np.concatenate([net[:4], ts.tent_map_panel(1, 200, seed=seed),
                           ts.lorenz63(200)[:1]]).astype(np.float32)


@pytest.fixture(scope="module", params=[4, 9])
def pair(request):
    panel = _panel(request.param)
    js = JEDM(panel, impl="ref", E_max=E_MAX)
    ts_ = EDM(panel, E_max=E_MAX, device="cpu")
    return panel, js, ts_


def test_optimal_E_equal_reference(pair):
    _, js, ts_ = pair
    E_j, rho_j = js.optimal_E()
    E_t, rho_t = ts_.optimal_E()
    top2 = np.sort(rho_j, axis=1)[:, -2:]
    # No near-tie between the best two E: the equality below is not vacuous.
    assert (top2[:, 1] - top2[:, 0]).min() >= ATOL
    assert len(set(E_j.tolist())) > 1  # more than one E-group
    np.testing.assert_array_equal(E_t, E_j)
    np.testing.assert_allclose(rho_t, rho_j, rtol=0, atol=ATOL)
    np.testing.assert_allclose(ts_.simplex(), js.simplex(), rtol=0,
                               atol=ATOL)


def test_xmap_master_route_matches_reference(pair):
    _, js, ts_ = pair
    js.optimal_E()
    ts_.optimal_E()
    direct = ts_.stats["xmap_direct_runs"]
    np.testing.assert_allclose(ts_.xmap(), js.xmap(), rtol=0, atol=ATOL)
    assert ts_.stats["xmap_direct_runs"] == direct  # cached master used


def test_simplex_and_ccm_batch_match_reference(pair):
    _, js, ts_ = pair
    np.testing.assert_allclose(ts_.simplex(E=2), js.simplex(E=2), rtol=0,
                               atol=ATOL)
    pairs = [(0, 1), (4, 5), (5, 0), (2, 2)]
    np.testing.assert_allclose(ts_.ccm_batch(pairs, E=3),
                               js.ccm_batch(pairs, E=3), rtol=0, atol=ATOL)


def test_xmap_fixed_E_direct_route_matches_reference():
    panel = _panel(4)
    ts_ = EDM(panel, E=3, device="cpu")
    got = ts_.xmap()
    assert ts_.stats["xmap_direct_runs"] == 1 and "master" not in ts_._cache
    want = JEDM(panel, impl="ref", E=3).xmap()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("E", [None, 3], ids=["master", "direct"])
def test_xmap_bit_invariant_in_batch_size(E):
    panel = _panel(9)
    outs = []
    for B in (1, 2, panel.shape[0]):
        sess = EDM(panel, E=E, E_max=E_MAX, batch_libs=B, device="cpu")
        outs.append(sess.xmap())
    for m in outs[1:]:
        np.testing.assert_array_equal(m, outs[0])


def test_carried_master_gives_reference_xmap():
    panel = _panel(9)
    js = JEDM(panel, impl="ref", E_max=E_MAX)
    js.optimal_E()
    cache = {"master": tuple(np.asarray(v) if not isinstance(v, int) else v
                             for v in js._cache["master"]),
             "rho": js._cache["rho"]}
    ts_ = carry_session_cache(EDM(panel, E_max=E_MAX, device="cpu"), cache)
    got = ts_.xmap()
    assert ts_.stats["knn_master_builds"] == 0
    np.testing.assert_allclose(got, js.xmap(), rtol=0, atol=ATOL)


def test_carry_rejects_mismatched_master():
    sess = EDM(_panel(4), E_max=E_MAX, device="cpu")
    bad = (np.zeros((6, 2, 199, 4), np.float32),
           np.zeros((6, 2, 199, 4), np.int32), 4, 2)
    with pytest.raises(ValueError, match="do not match"):
        carry_session_cache(sess, {"master": bad})


def test_counters_and_plan():
    sess = EDM(_panel(4), E_max=E_MAX, device="cpu")
    with telemetry.record() as rec:
        sess.optimal_E()
        sess.xmap()
    assert rec.counter_delta("edm_ops_all_knn_multi_e_calls") == 1
    assert rec.counter_delta("edm_knn_master_builds") == 1
    assert rec.counter_delta("edm_ops_lookup_rho_calls") >= E_MAX
    assert sess.plan("xmap").reuse == ("master", "rho")
    assert sess.plan("optimal_E").impl == "ref"


def test_submit_panel_flush_matches_sessions():
    a, b = _panel(4), _panel(9)
    sess = EDM(a, E_max=E_MAX, device="cpu")
    ta = sess.submit_panel(a, tasks=("optimal_E", "xmap"))
    tb = sess.submit_panel(b, tasks=("optimal_E", "xmap"))
    res = sess.flush()
    for t, p in ((ta, a), (tb, b)):
        direct = EDM(p, E_max=E_MAX, device="cpu")
        E_opt, _ = direct.optimal_E()
        np.testing.assert_array_equal(res[t].E_opt, E_opt)
        np.testing.assert_array_equal(res[t].xmap, direct.xmap())


def test_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert EDMConfig().device == "cuda"
    with pytest.raises(RuntimeError, match="not available"):
        EDM(_panel(4))


def test_dataset_defaults_to_the_card_and_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="not available"):
        Dataset(_panel(4))
    ds = Dataset(_panel(4), device="cpu")
    assert ds.panel.device.type == "cpu"
    sess = EDM(ds, E_max=3, device="cpu")
    assert sess.data is ds and sess.device.type == "cpu"


def test_mesh_config_refusals_and_append():
    panel = _panel(4)
    sess = EDM(panel[:, :190], E_max=E_MAX, device="cpu")
    # mesh= is ported: what is not a DeviceMesh, or a mesh without the
    # config's axes, raises ValueError (tests/test_torch_sharded*.py run it)
    with pytest.raises(ValueError, match="DeviceMesh"):
        EDMConfig(mesh=object(), device="cpu")
    from torch import distributed as dist
    from repro_torch.distributed import make_ccm_mesh
    mesh = make_ccm_mesh((1,), ("data",), device_type="cpu")
    try:
        with pytest.raises(ValueError, match="missing 'model'"):
            EDMConfig(mesh=mesh, device="cpu")
    finally:
        dist.destroy_process_group()
    # append is ported: it grows the panel as the reference's does.
    js = JEDM(panel[:, :190], impl="ref", E_max=E_MAX)
    assert sess.append(panel[:, 190:]) == js.append(panel[:, 190:]) == []
    assert sess.data.L == 200
    np.testing.assert_array_equal(sess.data.panel.numpy(),
                                  np.asarray(js.data.panel))


def test_invalid_series_policies():
    panel = _panel(4)
    panel[1, 5] = np.nan
    with pytest.raises(ValueError, match="series 1"):
        EDM(panel, device="cpu")
    masked = EDM(panel, E_max=E_MAX, on_invalid="mask", device="cpu")
    m = masked.xmap()
    assert np.isnan(m[1]).all() and np.isnan(m[:, 1]).all()
    assert np.isfinite(np.delete(np.delete(m, 1, 0), 1, 1)).all()
    dropped = EDM(panel, E_max=E_MAX, on_invalid="drop", device="cpu")
    assert dropped.data.N == 5


def test_ccm_group_batched_matches_reference():
    panel = _panel(9)
    want = j_group_batched(panel[:4], panel, E=2, impl="ref", batch_libs=3)
    got = ccm_group_batched(torch.from_numpy(panel[:4]),
                            torch.from_numpy(panel), E=2, batch_libs=3)
    assert got.shape == (4, panel.shape[0])
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


# ------------------------------------------------------------------ S-Map


def test_smap_fixed_and_per_series_match_reference(pair):
    _, js, ts_ = pair
    _assert_smap_close(ts_.smap(E=2), js.smap(E=2), DEFAULT_THETAS)
    np.testing.assert_array_equal(ts_.optimal_E()[0], js.optimal_E()[0])
    _assert_smap_close(ts_.smap(), js.smap(), DEFAULT_THETAS)
    thetas = (0.0, 2.0)
    _assert_smap_close(ts_.smap(thetas=thetas), js.smap(thetas=thetas),
                       thetas)


def test_smap_bit_equal_to_core_theta_sweep():
    panel = _panel(9)
    thetas = (0.0, 0.5, 2.0)
    sess = EDM(panel, E_max=E_MAX, thetas=thetas, device="cpu")
    X = torch.from_numpy(panel)
    np.testing.assert_array_equal(
        sess.smap(E=2), smap_theta_sweep(X, E=2, thetas=thetas).numpy())
    E_opt, _ = sess.optimal_E()
    want = np.zeros((panel.shape[0], len(thetas)), np.float32)
    for E in sorted(set(E_opt.tolist())):
        m = np.nonzero(E_opt == E)[0]
        want[m] = smap_theta_sweep(X[m], E=int(E), thetas=thetas).numpy()
    np.testing.assert_array_equal(sess.smap(), want)


def test_xmap_smap_matches_reference_with_masked_series():
    panel = _panel(4)
    panel[1, 5] = np.nan
    got = EDM(panel, E_max=E_MAX, on_invalid="mask",
              device="cpu").xmap(method="smap", theta=1.5)
    want = JEDM(panel, impl="ref", E_max=E_MAX,
                on_invalid="mask").xmap(method="smap", theta=1.5)
    assert np.isnan(got[1]).all() and np.isnan(got[:, 1]).all()
    assert np.isfinite(np.delete(np.delete(got, 1, 0), 1, 1)).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=smap_rho_tol(1.5))


def test_xmap_smap_bit_equal_to_core_smap_group():
    panel = _panel(9)
    X = torch.from_numpy(panel)
    sess = EDM(panel, E_max=E_MAX, device="cpu")
    E_opt, _ = sess.optimal_E()
    got = sess.xmap(method="smap", theta=1.5)
    want = np.zeros((panel.shape[0],) * 2, np.float32)
    for E in sorted(set(E_opt.tolist())):
        m = np.nonzero(E_opt == E)[0]
        want[:, m] = smap_group(X, X[m], E=int(E), theta=1.5).numpy()
    np.testing.assert_array_equal(got, want)
    fixed = EDM(panel, E=2, theta=1.5, device="cpu").xmap(method="smap")
    np.testing.assert_array_equal(fixed, smap_group(X, X, E=2,
                                                    theta=1.5).numpy())


@pytest.mark.parametrize("E", [None, 3], ids=["per-series", "fixed"])
def test_xmap_smap_bit_invariant_in_batch_size(E):
    panel = _panel(4)
    outs = [EDM(panel, E=E, E_max=E_MAX, batch_libs=B,
                device="cpu").xmap(method="smap")
            for B in (1, 4, panel.shape[0])]
    for m in outs[1:]:
        np.testing.assert_array_equal(m, outs[0])


def test_plan_smap_matches_reference():
    panel = _panel(4)
    for kw in ({}, {"E": 3}):
        got = EDM(panel, E_max=E_MAX, device="cpu", **kw).plan("smap")
        want = JEDM(panel, impl="ref", E_max=E_MAX, **kw).plan("smap")
        for field in ("task", "placement", "E", "Tp", "reuse", "builds",
                      "detail"):
            assert getattr(got, field) == getattr(want, field), field
    assert EDM(panel, device="cpu").plan("smap", E=2).E == "fixed:2"


def test_submit_panel_smap_flush_matches_reference_and_sessions():
    a, b = _panel(4), _panel(9)
    thetas = (0.0, 1.0, 4.0)
    sess = EDM(a, E_max=E_MAX, thetas=thetas, device="cpu")
    jsess = JEDM(a, impl="ref", E_max=E_MAX, thetas=thetas)
    tickets = [(sess.submit_panel(p, tasks=("optimal_E", "smap")),
                jsess.submit_panel(p, tasks=("optimal_E", "smap")), p)
               for p in (a, b)]
    res, jres = sess.flush(), jsess.flush()
    for t, jt, p in tickets:
        direct = EDM(p, E_max=E_MAX, thetas=thetas, device="cpu")
        np.testing.assert_array_equal(res[t].E_opt, direct.optimal_E()[0])
        np.testing.assert_array_equal(res[t].smap, direct.smap())
        np.testing.assert_array_equal(res[t].E_opt, jres[jt].E_opt)
        _assert_smap_close(res[t].smap, jres[jt].smap, thetas)
    with pytest.raises(ValueError, match="unknown task"):
        sess.submit_panel(a, tasks=("nope",))


@pytest.mark.parametrize("path,budget_mb,B", [("kernel", 0.1, 3),
                                              ("plain", 0.4, 2)])
@pytest.mark.parametrize("caller", ["session", "ccm_group_batched",
                                    "local_block"])
def test_direct_engine_callers_pick_one_batch(monkeypatch, caller, path,
                                              budget_mb, B):
    """The session's direct branch, ``ccm_group_batched`` and the sharded
    engine's ``_local_block`` size their launches by one rule: on the CPU,
    with the rule asked for the kernel path's model where ``path`` says."""
    from repro_torch.core import ccm
    from repro_torch.core.embedding import embed_offset, pred_rows
    from repro_torch.distributed import sharded_ccm
    from repro_torch.edm import session as session_mod

    panel = _panel(4)
    N, L = panel.shape
    real, seen = ccm.direct_batch_libs, []

    def spy(*args, device, **kw):
        seen.append(real(*args, device="cuda" if path == "kernel"
                         else device, **kw))
        return seen[-1]

    for mod in (ccm, sharded_ccm, session_mod):
        monkeypatch.setattr(mod, "direct_batch_libs", spy)
    X = torch.from_numpy(panel)
    knn = telemetry.counter("edm_ops_all_knn_batch_calls")
    before = knn.value
    if caller == "session":
        EDM(panel, E=3, cache=False, batch_budget_mb=budget_mb,
            device="cpu").xmap()
    elif caller == "ccm_group_batched":
        ccm_group_batched(X, X, E=3, budget_mb=budget_mb)
    else:
        sharded_ccm._local_block(
            X, X, E=3, tau=1, Tp=0, rows=pred_rows(L, 3, 1, 0),
            off=embed_offset(3, 1, 0), hard_max=L - 3, impl="auto",
            budget_mb=budget_mb)
    assert seen == [B]
    assert telemetry.gauge("edm_batch_libs_effective").value == B
    assert knn.value - before == -(-N // B)
