"""The pairwise-distance and simplex-lookup kernels' decompositions on the
CPU, against both packages' plain versions.

``pairwise_dist._emulate`` repeats ``csrc/pairwise_dist.cu`` tile by tile
and store by store in both designs (32 × 128 tiles; the vector design
writes each row as a head, aligned 16-byte groups built across lanes and
a tail, the word design word by word): it is held bit-equal to the
port's plain version under hypothesis (every Lp mod 4, Lp below a tile
and Lp = 1, E 1/3/20, τ 1/2, exact ties, both designs), and to the JAX
package's ``ref.pairwise_distances`` at a fixed handful of shapes (each
new shape recompiles the JAX function).

The port's ``ops.lookup`` on CPU tensors (the plain version the CUDA
kernel is held bit-equal to on the card) is held to the JAX package's
Pallas kernel in interpret mode and to its plain ``ref.lookup`` within
``LOOKUP_ATOL`` (XLA orders the k-sum its own way), invalid slots
(index −1, weight 0) included.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import example, given, settings
from hypothesis import strategies as st

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import lookup, ops, pairwise_dist, ref

LOOKUP_ATOL = 1e-6


def _series(L: int, seed: int, ties: bool) -> np.ndarray:
    x = np.random.default_rng(seed).standard_normal(L).astype(np.float32)
    if ties and L >= 8:  # a duplicated stretch: exact distance ties
        n = L // 4
        x[L - n:] = x[:n]
    return x


@settings(max_examples=40, deadline=None, derandomize=True)
@given(Lp=st.one_of(st.integers(1, 63), st.integers(64, 300)),
       E=st.sampled_from([1, 3, 20]), tau=st.sampled_from([1, 2]),
       ties=st.booleans(), seed=st.integers(0, 2**16),
       kind=st.sampled_from(["vector", "word"]))
@example(Lp=1, E=3, tau=1, ties=False, seed=0, kind="vector")
@example(Lp=256, E=3, tau=1, ties=True, seed=1, kind="vector")   # Lp % 4: 0
@example(Lp=257, E=1, tau=2, ties=True, seed=2, kind="vector")   # 1
@example(Lp=258, E=20, tau=1, ties=True, seed=3, kind="vector")  # 2
@example(Lp=259, E=3, tau=2, ties=False, seed=4, kind="vector")  # 3
@example(Lp=63, E=20, tau=2, ties=True, seed=5, kind="word")
@example(Lp=259, E=3, tau=1, ties=True, seed=6, kind="word")
def test_emulate_bit_equal_plain(Lp, E, tau, ties, seed, kind):
    x = torch.from_numpy(_series(Lp + (E - 1) * tau, seed, ties))
    got = pairwise_dist._emulate(x, E=E, tau=tau, kind=kind)
    assert torch.equal(got, ref.pairwise_distances(x, E=E, tau=tau))


@pytest.mark.parametrize("L,E,tau", [
    (259, 3, 1),   # Lp 257: Lp % 4 == 1
    (300, 3, 1),   # 298: 2
    (261, 1, 1),   # 261: 1 again, E = 1
    (137, 4, 2),   # 131: 3
    (300, 5, 2),   # 292: 0
    (200, 20, 1),  # 181: 1, E = 20
    (45, 20, 1),   # 26: below a tile
], ids=["Lp257", "Lp298", "Lp261-E1", "Lp131-tau2", "Lp292-tau2",
        "Lp181-E20", "Lp26-E20"])
def test_emulate_bit_equal_reference(L, E, tau):
    x = _series(L, seed=L + E, ties=True)
    want = np.asarray(jref.pairwise_distances(jnp.asarray(x), E=E, tau=tau))
    for kind in ("vector", "word"):
        got = pairwise_dist._emulate(torch.from_numpy(x), E=E, tau=tau,
                                     kind=kind)
        np.testing.assert_array_equal(want, got.numpy())


@pytest.mark.parametrize("L,E,tau", [(512 + 2, 3, 1), (1600, 3, 1),
                                     (300, 20, 2)])
def test_emulate_writes_aligned_groups(L, E, tau):
    """The vector design: every entry is written once (checked inside
    ``_emulate``); a row segment of a tile takes at most 6 word stores (a
    head of ≤ 3 and a tail of ≤ 3) beside its 16-byte groups, and none
    where rows are aligned and the tiles whole (Lp = 512)."""
    x = torch.from_numpy(_series(L, seed=7, ties=False))
    stats = {}
    D = pairwise_dist._emulate(x, E=E, tau=tau, kind="vector", stats=stats)
    Lp = D.shape[0]
    segments = Lp * -(-Lp // pairwise_dist.TILE_COLS)
    assert stats["words"] <= 6 * segments
    assert 16 * stats["v4"] + 4 * stats["words"] == 4 * Lp * Lp
    if Lp % pairwise_dist.TILE_COLS == 0:
        assert stats["words"] == 0


def test_pairwise_kernel_routes_by_E_and_raises_on_cpu():
    assert [pairwise_dist.route(E) for E in (1, 6, 7, 20)] == [
        "vector", "vector", "word", "word"]
    x = torch.zeros(300)
    with pytest.raises(ValueError, match="CUDA"):
        pairwise_dist.pairwise_distances(x, E=3)
    assert pairwise_dist.vpu_smem_bytes(3, 1) < 48 * 1024
    span = pairwise_dist.SMEM_MAX // 32  # past a block's shared memory
    assert pairwise_dist.vpu_smem_bytes(span + 1, 1) > pairwise_dist.SMEM_MAX


def _table(L, E, k, seed, invalid):
    """A simplex table as the per-series path makes it: k neighbours of
    each row under the Tp = 1 cap, rows Lp − 1; every fifth row's last
    slot invalid (index −1, weight 0) when asked."""
    x = torch.from_numpy(_series(L, seed, ties=False))
    Lp = L - (E - 1)
    d, i = ref.topk_select(ref.pairwise_distances(x, E=E, tau=1), k=k,
                           max_idx=Lp - 2)
    w = ref.make_weights(d)
    i, w = i[:Lp - 1].clone(), w[:Lp - 1].clone()
    if invalid:
        i[::5, -1] = -1
        w[::5, -1] = 0.0
    return i, w


@pytest.mark.parametrize("N", [1, 3])
@pytest.mark.parametrize("k", [1, 4, 21, 33])
@pytest.mark.parametrize("offset", ["zero", "E"])
def test_lookup_matches_reference_and_pallas(N, k, offset):
    L, E = 90, 3
    off = 0 if offset == "zero" else E
    i, w = _table(L, E, k, seed=k, invalid=k > 1)
    Y = np.random.default_rng(N).standard_normal((N, L)).astype(np.float32)
    got = ops.lookup(torch.from_numpy(Y), i, w, offset=off)
    assert got.shape == (N, i.shape[0])
    assert torch.equal(got, lookup.plain_lookup(torch.from_numpy(Y), i, w,
                                                offset=off))
    ij, wj = jnp.asarray(i.numpy()), jnp.asarray(w.numpy())
    want = jref.lookup(jnp.asarray(Y), ij, wj, offset=off)
    pallas = jops.lookup(jnp.asarray(Y), ij, wj, offset=off,
                         impl="interpret")
    for other in (want, pallas):
        np.testing.assert_allclose(got.numpy(), np.asarray(other), rtol=0,
                                   atol=LOOKUP_ATOL)


def test_lookup_kernel_raises_on_cpu():
    i, w = _table(60, 3, 4, seed=0, invalid=False)
    with pytest.raises(ValueError, match="CUDA"):
        lookup.lookup(torch.zeros(1, 60), i, w, offset=3)
