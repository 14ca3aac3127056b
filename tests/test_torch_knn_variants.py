"""Port vs reference: the two all-kNN variants on the CPU.

``variant="mxu"`` (norm-expansion distances of the mean-centered
embedding) is held against the reference's Pallas ``_kernel_mxu`` in
interpret mode, at ``tests/test_kernels_pairwise.py``'s shapes, within
``pairwise_dist.MXU_RTOL`` of ‖zᵢ‖² + ‖zⱼ‖²: the cross term is a float32
sum taken in another order (the reference pads E to 128 zeros for its
matrix unit). Its kNN indices equal the strict-chain ones wherever the
k-th and (k+1)-th distances are further apart than twice that tolerance.

``fused=True`` does not mean-center (the reference's fused wrapper does),
so the port's fused tables are bit-equal to the two-kernel path and to
the reference's ``ops.all_knn(impl="ref")``, at
``tests/test_kernels_knn_fused.py``'s shapes, ``max_idx`` included.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import pairwise_dist as jpairwise
from repro_torch import core, telemetry
from repro_torch.kernels import ops, pairwise_dist

PAIRWISE_CASES = [  # (L, E, tau), tests/test_kernels_pairwise.py
    (64, 1, 1), (100, 2, 1), (137, 4, 2), (128, 20, 3), (257, 7, 5),
    (96, 3, 1),
]
FUSED_CASES = [  # (L, E, tau, k), tests/test_kernels_knn_fused.py
    (137, 4, 2, 5), (200, 1, 1, 2), (96, 20, 1, 21), (257, 7, 3, 8),
]


def _within_mxu_tol(got, want, x, E, tau):
    scale = pairwise_dist.mxu_scale(x, E=E, tau=tau)
    err = (torch.tensor(np.asarray(want), dtype=torch.float64)
           - got.double()).abs()
    assert got.shape == scale.shape
    assert bool((err <= pairwise_dist.MXU_RTOL * scale).all()), \
        float((err / scale).max())


@pytest.mark.parametrize("L,E,tau", PAIRWISE_CASES)
def test_mxu_distances_match_reference_kernel(rng, L, E, tau):
    x = rng.normal(size=L).astype(np.float32)
    want = jpairwise.pairwise_distances(jnp.asarray(x), E=E, tau=tau,
                                        variant="mxu", interpret=True)
    xt = torch.from_numpy(x)
    got = ops.pairwise_distances(xt, E=E, tau=tau, variant="mxu")
    _within_mxu_tol(got, want, xt, E, tau)
    # ...and the strict-chain distances, to the same tolerance.
    _within_mxu_tol(got, ops.pairwise_distances(xt, E=E, tau=tau).numpy(),
                    xt, E, tau)
    assert bool((got >= 0).all())


def test_mxu_survives_a_large_offset(rng):
    """Centering keeps the expansion's cancellation small at x ≈ 1000."""
    x = (rng.normal(size=120) + 1000.0).astype(np.float32)
    xt = torch.from_numpy(x)
    want = jpairwise.pairwise_distances(jnp.asarray(x), E=5, tau=1,
                                        variant="mxu", interpret=True)
    got = ops.pairwise_distances(xt, E=5, tau=1, variant="mxu")
    _within_mxu_tol(got, want, xt, 5, 1)


@pytest.mark.parametrize("L,E,tau,k", FUSED_CASES)
def test_mxu_knn_indices_equal_vpu_where_the_gap_allows(rng, L, E, tau, k):
    x = torch.from_numpy(rng.normal(size=L).astype(np.float32))
    got = core.all_knn(x, E=E, tau=tau, k=k, variant="mxu")
    want = core.all_knn(x, E=E, tau=tau, k=k)
    D = ops.pairwise_distances(x, E=E, tau=tau).double()
    D.fill_diagonal_(float("inf"))
    srt, order = torch.sort(D, dim=1, stable=True)
    # Each of the k-th and (k+1)-th distances may move by its tolerance.
    tol = pairwise_dist.MXU_RTOL * torch.gather(
        pairwise_dist.mxu_scale(x, E=E, tau=tau), 1, order[:, k - 1:k + 1])
    clear = (srt[:, k] - srt[:, k - 1]) > 2 * tol.max(dim=1).values
    assert bool(clear.float().mean() > 0.5)  # the check is not vacuous
    assert torch.equal(torch.sort(got.idx[clear], dim=1).values,
                       torch.sort(want.idx[clear], dim=1).values)


@pytest.mark.parametrize("L,E,tau,k", FUSED_CASES)
@pytest.mark.parametrize("exclude_self", [True, False])
def test_fused_and_two_kernel_bit_equal_reference(rng, L, E, tau, k,
                                                  exclude_self):
    x = rng.normal(size=L).astype(np.float32)
    dj, ij = jops.all_knn(jnp.asarray(x), E=E, tau=tau, k=k,
                          exclude_self=exclude_self, impl="ref")
    xt = torch.from_numpy(x)
    for fused in (True, False):
        d, i = ops.all_knn(xt, E=E, tau=tau, k=k, exclude_self=exclude_self,
                           fused=fused)
        np.testing.assert_array_equal(np.asarray(dj), d.numpy())
        np.testing.assert_array_equal(np.asarray(ij), i.numpy())


def test_fused_max_idx_bit_equal_reference(rng):
    x = rng.normal(size=150).astype(np.float32)
    dj, ij = jops.all_knn(jnp.asarray(x), E=3, tau=1, k=4, max_idx=40,
                          impl="ref")
    table = core.all_knn(torch.from_numpy(x), E=3, tau=1, k=4, max_idx=40,
                         fused=True)
    assert int(table.idx.max()) <= 40
    np.testing.assert_array_equal(np.asarray(dj), table.dists.numpy())
    np.testing.assert_array_equal(np.asarray(ij), table.idx.numpy())


def test_variant_arguments_and_counters(rng):
    x = torch.from_numpy(rng.normal(size=80).astype(np.float32))
    with pytest.raises(ValueError, match="unknown variant"):
        ops.pairwise_distances(x, E=3, variant="wgmma")
    with pytest.raises(ValueError, match="fused"):
        ops.all_knn(x, E=3, fused=True, variant="mxu")
    with telemetry.record() as rec:
        ops.all_knn(x, E=3, fused=True)
        ops.all_knn(x, E=3, variant="mxu")
    assert rec.counter_delta("edm_ops_all_knn_calls") == 2
    # fused is one op; the mxu path is the distances then the top-k.
    assert rec.counter_delta("edm_ops_pairwise_distances_calls") == 1
    assert rec.counter_delta("edm_ops_topk_select_calls") == 1
