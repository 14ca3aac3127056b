"""The top-k selection kernels' order of work, emulated on the CPU.

``csrc/topk.cu``'s selection kernels (k ≤ 32) do not keep a sorted list
as the columns arrive: a warp takes a row in chunks, bounds each segment
between caps by the k-th of its lanes' smallest values, buffers the keys
under the bound (four groups of 32 columns voted at once) and sorts the
buffer down to its k first only now and then, and each level is the k
first at its cap. ``repro_torch.kernels.topk._emulate`` repeats that order
step for step (no path calls it). This file holds it bit-equal to the
port's plain ``ref.topk_select`` / ``ref.topk_select_sizes`` and to the
reference's ``repro.kernels.ref`` ones (JAX on the CPU), fed the same numpy
matrix from a seed, over k in {1, 4, 21, 32}, caps of 0, below k, equal
and past Lp − 1, both ``exclude_self``, exact ties (a duplicated stretch),
infinite values, rows with fewer than k valid candidates, and chunks of
32, 64 and 512 columns (so that caps and bounds fall in every place of a
chunk).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.kernels import ref as jref
from repro_torch.kernels import ref, topk

KS = [1, 4, 21, 32]


def _matrix(L: int, E: int, seed: int, ties: bool) -> np.ndarray:
    """A squared-distance matrix from a seeded series (a duplicated stretch
    and a repeated value for exact ties), as numpy float32."""
    x = np.random.default_rng(seed).standard_normal(L).astype(np.float32)
    if ties:
        x[L // 2:L // 2 + L // 5] = x[3:3 + L // 5]
        x[::7] = 0.25
    return np.array(jref.pairwise_distances(jnp.asarray(x), E=E, tau=1))


def _equal(got, want):
    np.testing.assert_array_equal(np.asarray(got[0]), want[0].numpy())
    np.testing.assert_array_equal(np.asarray(got[1]), want[1].numpy())


def _held_select(Dn, k, max_idx, exclude_self, **kw):
    D = torch.from_numpy(Dn)
    got = topk._emulate(D, k=k, max_idx=max_idx, exclude_self=exclude_self,
                        **kw)
    _equal(ref.topk_select(D, k=k, max_idx=max_idx,
                           exclude_self=exclude_self), got)
    _equal(jref.topk_select(jnp.asarray(Dn), k=k, max_idx=max_idx,
                            exclude_self=exclude_self), got)


def _held_sizes(Dn, k, caps, exclude_self, **kw):
    D = torch.from_numpy(Dn)
    got = topk._emulate(D, k=k, max_idxs=caps, exclude_self=exclude_self,
                        **kw)
    _equal(ref.topk_select_sizes(D, k=k, max_idxs=caps,
                                 exclude_self=exclude_self), got)
    _equal(jref.topk_select_sizes(jnp.asarray(Dn), k=k, max_idxs=caps,
                                  exclude_self=exclude_self), got)


@pytest.mark.parametrize("k", KS)
@settings(max_examples=8, deadline=None, derandomize=True)
@given(L=st.sampled_from([70, 140, 300]), seed=st.integers(0, 2**16),
       ties=st.booleans(), exclude_self=st.booleans(),
       cap=st.sampled_from([None, 0, 3, 20, 33, 120, 10_000]),
       chunk=st.sampled_from([32, 64, 128, 512]))
def test_emulated_select_equals_both_plain_versions(k, L, seed, ties,
                                                    exclude_self, cap, chunk):
    Dn = _matrix(L, 3, seed, ties)
    _held_select(Dn, k, cap, exclude_self, chunk_cols=chunk)


@pytest.mark.parametrize("k", KS)
@settings(max_examples=8, deadline=None, derandomize=True)
@given(L=st.sampled_from([70, 140, 300]), seed=st.integers(0, 2**16),
       ties=st.booleans(), exclude_self=st.booleans(),
       caps=st.lists(st.sampled_from([0, 1, 3, 20, 31, 32, 64, 100, 150,
                                      200, 10_000]),
                     min_size=1, max_size=7).map(sorted),
       chunk=st.sampled_from([32, 64, 128, 512]))
def test_emulated_sizes_equals_both_plain_versions(k, L, seed, ties,
                                                   exclude_self, caps, chunk):
    Dn = _matrix(L, 3, seed, ties)
    _held_sizes(Dn, k, tuple(caps), exclude_self, chunk_cols=chunk)


@pytest.mark.parametrize("k,max_idx", [
    (32, 5),     # 6 valid columns: the fill, lowest masked indices first
    (21, 0),     # one valid column
    (4, -1),     # none: every slot is a masked column at +inf
    (1, None),
])
@pytest.mark.parametrize("chunk", [32, 64, 128, 512])
def test_emulated_select_fills_rows_short_of_k(k, max_idx, chunk):
    Dn = _matrix(120, 2, seed=7, ties=True)
    _held_select(Dn, k, max_idx, True, chunk_cols=chunk)


@pytest.mark.parametrize("caps", [
    (0,), (0, 0, 2), (3, 3, 3), (1, 30, 31, 32, 33, 500),
    (20, 20, 21, 119), (118, 119, 200),
])
@pytest.mark.parametrize("chunk", [32, 64, 128, 512])
def test_emulated_sizes_at_edge_caps(caps, chunk):
    Dn = _matrix(120, 2, seed=9, ties=True)
    for k in (4, 32):
        _held_sizes(Dn, k, caps, True, chunk_cols=chunk)


def test_emulated_selection_with_infinite_values():
    """+inf entries among the valid columns tie with the masked ones and
    order by index; in the sizes form they are empty slots."""
    Dn = _matrix(150, 3, seed=3, ties=True)
    Dn[4, 10:70] = np.inf
    Dn[9, :] = np.inf
    for chunk in (32, 512):
        _held_select(Dn, 21, 100, True, chunk_cols=chunk)
        _held_sizes(Dn, 21, (5, 60, 147), False, chunk_cols=chunk)


def test_emulated_selection_over_several_default_chunks():
    """1,100 columns: three 512-column chunks, the bound carried from one
    to the next, caps inside and across them."""
    Dn = _matrix(1102, 3, seed=11, ties=True)
    stats = {}
    D = torch.from_numpy(Dn)
    got = topk._emulate(D, k=4, max_idx=1098, stats=stats)
    _equal(ref.topk_select(D, k=4, max_idx=1098), got)
    # The bound lets few keys through (about k a chunk), and a row is
    # sorted at most twice: at the second chunk (for the k-th key that
    # bounds the rest) and at its end.
    assert stats["appended"] < 12 * D.shape[0]
    assert stats["compactions"] <= 2 * D.shape[0]
    _held_sizes(Dn, 4, (49, 99, 511, 512, 700, 1099), True)


def test_route():
    assert topk.route(32) == "select" and topk.route(33) == "insert"
    assert topk.route(4, topk.MAX_LEVELS) == "select"
    assert topk.route(4, topk.MAX_LEVELS + 1) == "insert"


def test_wrappers_refuse_cpu_tensors():
    D = torch.from_numpy(_matrix(40, 2, seed=1, ties=False))
    with pytest.raises(ValueError, match="CUDA tensor"):
        topk.topk_select(D, k=4)
    with pytest.raises(ValueError, match="CUDA tensor"):
        topk.topk_select_sizes(D, k=4, max_idxs=(10, 20))
