"""Port vs reference: the all-kNN engines (multi-E and library-batched).

The same numpy inputs go through ``repro.kernels.ref`` (JAX on the CPU)
and ``repro_torch.kernels.ops`` on CPU tensors (the plain versions the
CUDA kernels are held against on the card). Both pin the strict
two-rounding distance chain and the (value, index) selection order, so
indices AND distances must be bit-equal — ties, capped candidates and
rows with fewer valid candidates than k included.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import ops


def _series(kind: str, L: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(L).astype(np.float32)
    if kind == "ties":  # repeated values and a periodic stretch: exact ties
        x[::3] = 0.5
        x[L // 4:L // 4 + 12] = np.tile(np.float32([0.1, -0.2, 0.3]), 4)
    return x


def _equal(a, b):
    np.testing.assert_array_equal(np.asarray(a), b.numpy())


MULTI_E_CASES = [
    dict(L=120, E_max=5, tau=1, k=None, max_idx=None, kind="random"),
    dict(L=150, E_max=6, tau=2, k=None, max_idx=None, kind="ties"),
    dict(L=90, E_max=4, tau=1, k=7, max_idx=None, kind="ties"),
    # capped, non-monotone caps (masks not sticky) and uniform k
    dict(L=80, E_max=4, tau=1, k=6, max_idx=[60, 10, 70, 30], kind="random"),
    # k greater than the valid candidates of every row (cap 3 → ≤ 4 valid)
    dict(L=40, E_max=3, tau=1, k=9, max_idx=3, kind="ties"),
]


@pytest.mark.parametrize("case", MULTI_E_CASES,
                         ids=lambda c: f"L{c['L']}-E{c['E_max']}-{c['kind']}")
def test_multi_e_tables_bit_equal_reference(case):
    kw = {k: v for k, v in case.items() if k not in ("L", "kind")}
    x = _series(case["kind"], case["L"], seed=case["L"])
    dj, ij = jref.all_knn_multi_e(jnp.asarray(x), **kw)
    dt, it = ops.all_knn_multi_e(torch.from_numpy(x), **kw)
    _equal(dj, dt)
    _equal(ij, it)


def test_multi_e_panel_equals_per_series_calls():
    X = np.stack([_series("ties", 70, s) for s in range(3)])
    d, i = ops.all_knn_multi_e(torch.from_numpy(X), E_max=4, k=6)
    assert d.shape == (3, 4, 70, 6)
    for s in range(3):
        ds, is_ = ops.all_knn_multi_e(torch.from_numpy(X[s]), E_max=4, k=6)
        assert torch.equal(d[s], ds) and torch.equal(i[s], is_)


BATCH_CASES = [
    dict(E=3, tau=1, k=None, max_idx=None, kind="random"),
    dict(E=2, tau=2, k=5, max_idx=None, kind="ties"),
    dict(E=4, tau=1, k=6, max_idx=40, kind="ties"),
    # k greater than the valid candidates of every row
    dict(E=2, tau=1, k=8, max_idx=4, kind="random"),
]


@pytest.mark.parametrize("case", BATCH_CASES,
                         ids=lambda c: f"E{c['E']}-k{c['k']}-{c['kind']}")
def test_batch_tables_bit_equal_reference(case):
    kw = {k: v for k, v in case.items() if k != "kind"}
    X = np.stack([_series(case["kind"], 100, s) for s in range(4)])
    dj, ij = jref.all_knn_batch(jnp.asarray(X), **kw)
    dt, it = ops.all_knn_batch(torch.from_numpy(X), **kw)
    _equal(dj, dt)
    _equal(ij, it)


def test_batch_tables_invariant_in_B():
    X = torch.from_numpy(np.stack([_series("ties", 90, s) for s in range(5)]))
    d, i = ops.all_knn_batch(X, E=3, k=4, max_idx=80)
    for b in range(5):
        db, ib = ops.all_knn_batch(X[b:b + 1], E=3, k=4, max_idx=80)
        assert torch.equal(d[b], db[0]) and torch.equal(i[b], ib[0])


def test_knn_rejects_k_beyond_candidates():
    x = torch.zeros(10)
    with pytest.raises(ValueError, match="exceeds"):
        ops.all_knn_multi_e(x + torch.arange(10.0), E_max=2, k=11)
    with pytest.raises(ValueError, match="exceeds"):
        ops.all_knn_batch((x + torch.arange(10.0))[None], E=2, k=10)
