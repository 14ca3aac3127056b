"""Port vs reference: ``core.stats`` — the Schubert–Gertz co-moments and
the two-pass ``pearson_rows`` export.

The same numpy batches go through ``repro.core.stats`` (JAX on the CPU)
and ``repro_torch.core.stats`` on CPU tensors; both sum in float32 in
orders their libraries pick, so every moment and ρ is held to atol 1e-6
(scaled by the moment's size where it is a sum of squares).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import stats as jstats
from repro_torch import core
from repro_torch.core.stats import CoMoments, pearson_rows

ATOL = 1e-6
FIELDS = ("n", "mean_a", "mean_b", "m2_a", "m2_b", "c_ab")


def _batches(seed: int, shape=(3, 64)):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal(shape).astype(np.float32)
    b = (0.6 * a + 0.4 * rng.standard_normal(shape)).astype(np.float32)
    return a, b


def _assert_moments_close(got: CoMoments, want) -> None:
    for f in FIELDS:
        g = getattr(got, f).numpy()
        w = np.asarray(getattr(want, f))
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=ATOL * max(1.0, np.abs(w).max()),
                                   err_msg=f)


def test_core_exports_stats():
    assert core.CoMoments is CoMoments
    assert core.pearson_rows is pearson_rows


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_from_batch_and_pearson_match_reference(seed):
    a, b = _batches(seed)
    got = CoMoments.from_batch(torch.as_tensor(a), torch.as_tensor(b))
    want = jstats.CoMoments.from_batch(jnp.asarray(a), jnp.asarray(b))
    _assert_moments_close(got, want)
    np.testing.assert_allclose(got.pearson.numpy(), np.asarray(want.pearson),
                               rtol=0, atol=ATOL)
    # the two-pass export agrees with the co-moments' ρ
    np.testing.assert_allclose(
        pearson_rows(torch.as_tensor(a), torch.as_tensor(b)).numpy(),
        np.asarray(jstats.pearson_rows(jnp.asarray(a), jnp.asarray(b))),
        rtol=0, atol=ATOL)


def test_masked_from_batch_matches_reference():
    a, b = _batches(3)
    where = np.random.default_rng(3).random(a.shape) > 0.3
    got = CoMoments.from_batch(torch.as_tensor(a), torch.as_tensor(b),
                               where=torch.as_tensor(where))
    want = jstats.CoMoments.from_batch(jnp.asarray(a), jnp.asarray(b),
                                       where=jnp.asarray(where))
    _assert_moments_close(got, want)
    np.testing.assert_allclose(got.pearson.numpy(), np.asarray(want.pearson),
                               rtol=0, atol=ATOL)


@pytest.mark.parametrize("split", [5, 32, 59])
def test_merge_matches_reference_and_the_whole_batch(split):
    a, b = _batches(4)
    ta, tb = torch.as_tensor(a), torch.as_tensor(b)
    merged = CoMoments.from_batch(ta[:, :split], tb[:, :split]).merge(
        CoMoments.from_batch(ta[:, split:], tb[:, split:]))
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    jmerged = jstats.CoMoments.from_batch(ja[:, :split], jb[:, :split]).merge(
        jstats.CoMoments.from_batch(ja[:, split:], jb[:, split:]))
    _assert_moments_close(merged, jmerged)
    np.testing.assert_allclose(merged.pearson.numpy(),
                               np.asarray(jmerged.pearson), rtol=0, atol=ATOL)
    whole = CoMoments.from_batch(ta, tb)
    np.testing.assert_allclose(merged.pearson.numpy(), whole.pearson.numpy(),
                               rtol=0, atol=ATOL)


def test_zeros_is_the_merge_identity():
    a, b = _batches(5, shape=(2, 40))
    m = CoMoments.from_batch(torch.as_tensor(a), torch.as_tensor(b))
    z = CoMoments.zeros((2,))
    jz = jstats.CoMoments.zeros((2,))
    _assert_moments_close(z, jz)
    for f in FIELDS:
        assert torch.equal(getattr(z.merge(m), f), getattr(m, f)), f
    # constant batches have zero variance: ρ is 0, not NaN
    flat = CoMoments.from_batch(torch.ones(2, 8), torch.as_tensor(a[:, :8]))
    assert torch.equal(flat.pearson, torch.zeros(2))
