"""Each CUDA kernel against its plain version, on the card.

Marked ``gpu``: each test decides inside itself whether a CUDA device is
present and skips with the reason when it is not (the CPU tests cover the
plain versions against the JAX reference). Run them on a GPU machine with
``PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py``.
"""

import numpy as np
import pytest
import torch

from repro_torch.data import timeseries as ts

pytestmark = pytest.mark.gpu


def _cuda_panel(N=12, L=400, seed=0):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.as_tensor(ts.forced_network_panel(N, L, seed=seed)[0],
                           device="cuda")


@pytest.mark.parametrize("kw", [
    dict(E_max=8, tau=1, k=None, max_idx=None),
    dict(E_max=20, tau=1, k=22, max_idx=None),
    dict(E_max=5, tau=2, k=40, max_idx=[300, 50, 280, 9, 120]),
])
def test_knn_multi_e_kernel_equals_plain(kw):
    from repro_torch.kernels import knn_multi_e
    X = _cuda_panel()
    got = knn_multi_e.all_knn_multi_e(X, **kw)
    want = knn_multi_e.plain(X, **kw)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("kw", [
    dict(E=3, tau=1, k=4, max_idx=None),
    dict(E=2, tau=3, k=70, max_idx=30),
])
def test_knn_batch_kernel_equals_plain(kw):
    from repro_torch.kernels import knn_batch
    X = _cuda_panel()
    got = knn_batch.all_knn_batch(X, **kw)
    want = knn_batch.plain(X, **kw)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("own", [False, True], ids=["all", "own"])
def test_lookup_rho_kernel_matches_plain(own):
    from repro_torch.kernels import knn_batch, lookup, ref
    X = _cuda_panel()
    d, i = knn_batch.all_knn_batch(X, E=3, k=4)
    w = ref.make_weights(d)
    got = lookup.lookup_rho(X, i, w, offset=2, own=own)
    want = (lookup.plain_own if own else lookup.plain)(X, i, w, offset=2)
    assert torch.allclose(got, want, rtol=0, atol=1e-5)


def test_session_on_gpu_matches_plain_session():
    from repro_torch.edm import EDM
    panel = _cuda_panel().cpu().numpy()
    E_k, rho_k = EDM(panel, E_max=8).optimal_E()
    E_p, rho_p = EDM(panel, E_max=8, impl="ref").optimal_E()
    np.testing.assert_array_equal(E_k, E_p)
    np.testing.assert_allclose(rho_k, rho_p, rtol=0, atol=1e-5)


def _ties_series(L=400, seed=1):
    """A series with a repeated stretch: exact distance ties."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    x = np.random.default_rng(seed).standard_normal(L).astype(np.float32)
    x[200:260] = x[20:80]
    x[::7] = 0.25
    return torch.as_tensor(x, device="cuda")


@pytest.mark.parametrize("E,tau", [(1, 1), (3, 1), (4, 2), (20, 1)])
def test_pairwise_dist_kernel_equals_plain(E, tau):
    from repro_torch.kernels import pairwise_dist
    x = _ties_series()
    assert torch.equal(pairwise_dist.pairwise_distances(x, E=E, tau=tau),
                       pairwise_dist.plain(x, E=E, tau=tau))


@pytest.mark.parametrize("k,max_idx,exclude_self", [
    (4, None, True), (70, None, True), (70, 30, True), (9, 120, False),
    (1, 0, True),
])
def test_topk_select_kernel_equals_plain(k, max_idx, exclude_self):
    from repro_torch.kernels import pairwise_dist, topk
    D = pairwise_dist.plain(_ties_series(), E=3, tau=2)
    got = topk.topk_select(D, k=k, max_idx=max_idx,
                           exclude_self=exclude_self)
    want = topk.plain_select(D, k=k, max_idx=max_idx,
                             exclude_self=exclude_self)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("k,caps,exclude_self", [
    (4, (31, 32, 33, 63, 64, 100, 395), True),   # caps at batch edges
    (70, (2, 40, 40, 200, 10_000), True),        # caps < k, equal, past Lp
    (5, (150,), True),                           # a single cap
    (3, (0, 1, 95, 390), False),
])
def test_topk_select_sizes_kernel_equals_plain(k, caps, exclude_self):
    from repro_torch.kernels import pairwise_dist, topk
    D = pairwise_dist.plain(_ties_series(), E=3, tau=2)
    got = topk.topk_select_sizes(D, k=k, max_idxs=caps,
                                 exclude_self=exclude_self)
    want = topk.plain_sizes(D, k=k, max_idxs=caps, exclude_self=exclude_self)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("k", [1, 4, 21])
def test_lookup_kernel_equals_plain(k):
    from repro_torch.kernels import lookup, ref, topk
    X = _cuda_panel()
    D = ref.pairwise_distances(X[0], E=3, tau=1)
    d, i = topk.plain_select(D, k=k, max_idx=300)
    w = ref.make_weights(d)
    i = i.clone()
    i[::5, -1] = -1  # invalid slots as the master derivation leaves them
    got = lookup.lookup(X, i, w, offset=3)
    assert torch.equal(got, lookup.plain_lookup(X, i, w, offset=3))


def test_session_ccm_and_surrogates_on_gpu_match_plain_session():
    from repro_torch.edm import EDM
    panel = _cuda_panel(N=6, L=500).cpu().numpy()
    runs = []
    for impl in ("auto", "ref"):
        sess = EDM(panel, E_max=6, impl=impl)
        sess.optimal_E()
        runs.append((sess.ccm(0, 1, lib_sizes=(20, 40, 100, 400)),
                     sess.ccm(2, 3),
                     sess.surrogate_test(1, 4, num_surrogates=30,
                                         lib_sizes=(50, 300)).surrogate_rho,
                     EDM(panel, E=3, cache=False, impl=impl).simplex()))
    for got, want in zip(*runs):
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
