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
