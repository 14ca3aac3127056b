"""Port vs reference: simplex projection and the optimal-E search.

The same numpy series go through ``repro.core.simplex`` (JAX on the CPU,
``impl="ref"``) and ``repro_torch.core.simplex`` on CPU tensors. The kNN
tables are bit-equal (tests/test_torch_topk.py, test_torch_knn.py); ρ goes
through float32 sums that XLA and PyTorch order differently, so ρ is held
to atol 1e-5 and E_opt must be equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import simplex as jsimplex
from repro.data import timeseries as ts
from repro.edm import EDM as JEDM
from repro_torch import telemetry
from repro_torch.core import (KnnTable, all_knn, optimal_E, optimal_E_batch,
                              optimal_E_sweep_seed, rho_curve,
                              simplex_predict, simplex_skill)
from repro_torch.edm import EDM
from repro_torch.kernels import ops

ATOL = 1e-5
E_MAX = 6


def _panel() -> np.ndarray:
    """Series whose optimal E differs (logistic network, tent, Lorenz)."""
    net, _ = ts.forced_network_panel(3, 240, seed=4)
    return np.concatenate([net, ts.tent_map_panel(1, 240, seed=4),
                           ts.lorenz63(240)[:1]]).astype(np.float32)


@pytest.mark.parametrize("E,tau,Tp", [(2, 1, 1), (4, 2, 1), (3, 1, 2)])
def test_simplex_predict_and_skill_match_reference(E, tau, Tp):
    x = _panel()[0]
    pj, tj = jsimplex.simplex_predict(jnp.asarray(x), E=E, tau=tau, Tp=Tp,
                                      impl="ref")
    pt, tt = simplex_predict(torch.from_numpy(x), E=E, tau=tau, Tp=Tp)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(tj))
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=0, atol=ATOL)
    rj = jsimplex.simplex_skill(jnp.asarray(x), E=E, tau=tau, Tp=Tp,
                                impl="ref")
    rt = simplex_skill(torch.from_numpy(x), E=E, tau=tau, Tp=Tp)
    assert abs(float(rt) - float(rj)) <= ATOL


def test_knn_table_weights_and_fields():
    x = torch.from_numpy(_panel()[1])
    t = all_knn(x, E=3, max_idx=200)
    assert isinstance(t, KnnTable) and (t.E, t.tau, t.k) == (3, 1, 4)
    assert t.dists.shape == t.idx.shape == (238, 4)
    assert torch.equal(t.weights, ops.make_weights(t.dists))


def test_rho_curve_and_sweep_seed_match_reference():
    x = _panel()[2]
    rj = np.asarray(jsimplex.rho_curve(jnp.asarray(x), E_max=E_MAX,
                                       impl="ref"))
    rt = rho_curve(torch.from_numpy(x), E_max=E_MAX).numpy()
    np.testing.assert_allclose(rt, rj, rtol=0, atol=ATOL)
    seed = optimal_E_sweep_seed(torch.from_numpy(x), E_max=E_MAX).numpy()
    np.testing.assert_allclose(seed, rt, rtol=0, atol=ATOL)
    E_best, rhos = optimal_E(torch.from_numpy(x), E_max=E_MAX)
    assert E_best == int(np.argmax(rj)) + 1
    assert torch.equal(rhos, torch.from_numpy(rt))


def test_optimal_E_batch_matches_reference():
    X = _panel()
    Ej, rj = jsimplex.optimal_E_batch(jnp.asarray(X), E_max=E_MAX,
                                      impl="ref")
    top2 = np.sort(np.asarray(rj), axis=1)[:, -2:]
    assert (top2[:, 1] - top2[:, 0]).min() >= ATOL  # equality not vacuous
    with telemetry.record() as rec:
        Et, rt = optimal_E_batch(torch.from_numpy(X), E_max=E_MAX)
    assert rec.counter_delta("edm_ops_all_knn_multi_e_calls") == X.shape[0]
    assert Et.dtype == torch.int32
    np.testing.assert_array_equal(Et.numpy(), np.asarray(Ej))
    assert len(set(Et.tolist())) > 1
    np.testing.assert_allclose(rt.numpy(), np.asarray(rj), rtol=0, atol=ATOL)


def test_uncached_session_optimal_E_and_simplex_match_reference():
    panel = _panel()
    js = JEDM(panel, impl="ref", E_max=E_MAX, cache=False)
    ts_ = EDM(panel, E_max=E_MAX, cache=False, device="cpu")
    assert ts_.plan("optimal_E").builds == ("rho",)
    E_j, rho_j = js.optimal_E()
    E_t, rho_t = ts_.optimal_E()
    np.testing.assert_array_equal(E_t, E_j)
    np.testing.assert_allclose(rho_t, rho_j, rtol=0, atol=ATOL)
    assert "master" not in ts_._cache
    with telemetry.record() as rec:
        got = ts_.simplex(E=3)
    assert rec.counter_delta("edm_ops_pairwise_distances_calls") == len(panel)
    assert rec.counter_delta("edm_ops_lookup_calls") == len(panel)
    np.testing.assert_allclose(got, js.simplex(E=3), rtol=0, atol=ATOL)
    assert "simplex_skill" in ts_.plan("simplex", E=3).detail
