"""Port vs reference: the per-series kNN pipeline (distance matrix, top-k,
multi-cap top-k) and the simplex lookup.

The same numpy series go through ``repro.kernels.ref`` (JAX on the CPU)
and the port's ``ops`` on CPU tensors (the plain versions the CUDA kernels
are held bit-equal to on the card). Both pin the strict two-rounding
distance chain and the (value, index) selection order, so distances and
indices are bit-equal — ties, τ = 2, rows with fewer valid candidates
than k and single caps included. The lookup's k-sum is ordered otherwise
by XLA, so predictions are held to atol 1e-6 (a few float32 ULPs of
values of order 1).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import ops, pairwise_dist, ref

LOOKUP_ATOL = 1e-6


def _series(kind: str, L: int, seed: int) -> np.ndarray:
    x = np.random.default_rng(seed).standard_normal(L).astype(np.float32)
    if kind == "ties":  # a duplicated manifold stretch: exact distance ties
        x[L // 2:L // 2 + 40] = x[10:50]
        x[::7] = 0.25
    return x


def _equal(a, b):
    np.testing.assert_array_equal(np.asarray(a), b.numpy())


@pytest.fixture(scope="module", params=[("ties", 3, 1), ("random", 4, 2),
                                        ("ties", 1, 1)],
                ids=["ties-E3", "tau2-E4", "ties-E1"])
def dists(request):
    kind, E, tau = request.param
    x = _series(kind, 260, seed=E)
    Dj = jref.pairwise_distances(jnp.asarray(x), E=E, tau=tau)
    Dt = ops.pairwise_distances(torch.from_numpy(x), E=E, tau=tau)
    return x, E, tau, Dj, Dt


def test_pairwise_distances_bit_equal_reference(dists):
    _, _, _, Dj, Dt = dists
    _equal(Dj, Dt)


@pytest.mark.parametrize("k,max_idx,exclude_self", [
    (4, None, True), (9, 120, True), (12, 5, True),  # 12 > the 5 valid
    (3, None, False),
])
def test_topk_select_bit_equal_reference(dists, k, max_idx, exclude_self):
    _, _, _, Dj, Dt = dists
    dj, ij = jref.topk_select(Dj, k=k, max_idx=max_idx,
                              exclude_self=exclude_self)
    dt, it = ops.topk_select(Dt, k=k, max_idx=max_idx,
                             exclude_self=exclude_self)
    _equal(dj, dt)
    _equal(ij, it)


SIZES_CASES = [
    (4, (31, 32, 33, 64, 200)),   # caps on and across 32-column batches
    (6, (150,)),                  # a single cap
    (8, (3, 3, 40, 10_000)),      # a cap < k, an equal pair, one past Lp
]


@pytest.mark.parametrize("k,caps", SIZES_CASES)
def test_topk_select_sizes_bit_equal_reference(dists, k, caps):
    _, _, _, Dj, Dt = dists
    dj, ij = jref.topk_select_sizes(Dj, k=k, max_idxs=caps)
    dt, it = ops.topk_select_sizes(Dt, k=k, max_idxs=caps)
    assert dt.shape == (len(caps), Dt.shape[0], k)
    _equal(dj, dt)
    _equal(ij, it)


@pytest.mark.parametrize("k,caps", SIZES_CASES)
def test_multi_cap_equals_per_cap_topk_on_valid_slots(dists, k, caps):
    _, _, _, _, D = dists
    dS, iS = ops.topk_select_sizes(D, k=k, max_idxs=caps)
    for s, m in enumerate(caps):
        d, i = ops.topk_select(D, k=min(k, D.shape[0]), max_idx=m)
        ok = torch.isfinite(dS[s])
        assert torch.equal(ok, torch.isfinite(d))
        assert torch.equal(dS[s][ok], d[ok])
        assert torch.equal(iS[s][ok], i[ok])
        assert (iS[s][~ok] == ref.PAD_IDX).all()


def test_all_knn_matches_reference_and_names_unported_variants():
    from repro.kernels import ops as jops
    x = _series("ties", 150, seed=5)
    dj, ij = jops.all_knn(jnp.asarray(x), E=3, tau=2, max_idx=100,
                          impl="ref")
    dt, it = ops.all_knn(torch.from_numpy(x), E=3, tau=2, max_idx=100)
    _equal(dj, dt)
    _equal(ij, it)
    xt = torch.from_numpy(x)
    # The variants are ported: fused gives the same bits, mxu the same
    # distances within its tolerance; an unknown variant is refused.
    df, if_ = ops.all_knn(xt, E=3, tau=2, max_idx=100, fused=True)
    _equal(dj, df)
    _equal(ij, if_)
    Dm = ops.pairwise_distances(xt, E=3, tau=2, variant="mxu")
    Dv = ops.pairwise_distances(xt, E=3, tau=2)
    scale = pairwise_dist.mxu_scale(xt, E=3, tau=2)
    assert ((Dm - Dv).abs() <= pairwise_dist.MXU_RTOL * scale).all()
    dm, _ = ops.all_knn(xt, E=3, tau=2, max_idx=100, variant="mxu")
    assert dm.shape == dt.shape
    with pytest.raises(ValueError, match="unknown variant"):
        ops.all_knn(xt, E=3, variant="tpu")
    with pytest.raises(ValueError, match="unknown variant"):
        ops.pairwise_distances(xt, E=3, variant="tpu")


def test_delay_embed_and_caps_checks_match_reference():
    x = _series("random", 40, seed=2)
    _equal(jref.delay_embed(jnp.asarray(x), 4, 3),
           ops.delay_embed(torch.from_numpy(x), 4, 3))
    assert ref.check_sizes_caps([5, 5, 9]) == jref.check_sizes_caps([5, 5, 9])
    for bad in ([], [-1, 3], [9, 5]):
        with pytest.raises(ValueError):
            ref.check_sizes_caps(bad)
        with pytest.raises(ValueError):
            jref.check_sizes_caps(bad)


@pytest.mark.parametrize("k,off", [(4, 3), (1, 1), (7, 2)])
def test_lookup_matches_reference(k, off):
    rng = np.random.default_rng(k)
    L, N = 180, 4
    rows = L - off
    Y = rng.standard_normal((N, L)).astype(np.float32)
    idx = rng.integers(0, rows, size=(rows, k)).astype(np.int32)
    w = rng.uniform(0.0, 1.0, size=(rows, k)).astype(np.float32)
    idx[::6, -1] = -1  # invalid slots carry weight 0
    w[::6, -1] = 0.0
    want = jref.lookup(jnp.asarray(Y), jnp.asarray(idx), jnp.asarray(w),
                       offset=off)
    got = ops.lookup(torch.from_numpy(Y), torch.from_numpy(idx),
                     torch.from_numpy(w), offset=off)
    assert got.shape == (N, rows)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=LOOKUP_ATOL)


def test_plain_lookup_sums_in_fixed_k_order():
    """The k products are summed left to right, one rounding each — the
    order the CUDA kernel repeats — whatever the batch of targets."""
    rng = np.random.default_rng(3)
    Y = torch.from_numpy(rng.standard_normal((5, 90)).astype(np.float32))
    idx = torch.from_numpy(rng.integers(0, 80, size=(80, 9)).astype(np.int32))
    w = torch.from_numpy(rng.uniform(0, 1, size=(80, 9)).astype(np.float32))
    got = ref.lookup(Y, idx, w, offset=2)
    g = Y[:, idx.long() + 2]
    want = g[..., 0] * w[:, 0]
    for q in range(1, 9):
        want = want + g[..., q] * w[:, q]
    assert torch.equal(got, want)
    for n in range(5):
        assert torch.equal(ref.lookup(Y[n:n + 1], idx, w, offset=2)[0],
                           got[n])
