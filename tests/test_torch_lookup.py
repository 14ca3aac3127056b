"""Port vs reference: fused simplex lookup + Pearson ρ.

``repro.kernels.ref.lookup_rho`` (JAX on the CPU) and the port's
``ops.lookup_rho`` on CPU tensors get the same numpy tables and targets.
Tolerance atol 1e-5: the prediction sum over k and the Pearson sums are
float32 reductions whose order differs between XLA and PyTorch, and the
CUDA kernel is held to the same bound on the card; 1e-5 is a few float32
ULPs of a correlation ≤ 1 after ~200-term sums.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import ops, ref

ATOL = 1e-5


def _tables(rows: int, k: int, L: int, off: int, seed: int):
    """Sorted-distance tables with some invalid (-1, weight 0) slots."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, L - off, size=(rows, k)).astype(np.int32)
    d = np.sort(rng.uniform(0.01, 2.0, size=(rows, k)), axis=1)
    d = d.astype(np.float32)
    idx[::5, -1] = -1          # a missing last neighbour on every 5th row
    d[::5, -1] = np.inf
    idx[7, :] = -1             # a row with no valid neighbour at all
    d[7, :] = np.inf
    return idx, d


@pytest.mark.parametrize("k,off", [(4, 3), (7, 0), (2, 1)])
def test_lookup_rho_matches_reference(k, off):
    L, N = 160, 5
    rows = L - off
    rng = np.random.default_rng(k)
    Y = rng.standard_normal((N, L)).astype(np.float32)
    Y[2] = 0.5                 # a constant target: ρ ≈ 0 in both
    idx, d = _tables(rows, k, L, off, seed=k + off)
    w_j = jref.make_weights(jnp.asarray(d))
    w_t = ops.make_weights(torch.from_numpy(d))
    np.testing.assert_allclose(np.asarray(w_j), w_t.numpy(), rtol=0,
                               atol=1e-6)
    rho_j = np.asarray(jref.lookup_rho(jnp.asarray(Y), jnp.asarray(idx), w_j,
                                       offset=off))
    rho_t = ops.lookup_rho(torch.from_numpy(Y), torch.from_numpy(idx), w_t,
                           offset=off).numpy()
    assert rho_t.shape == (N,) and np.isfinite(rho_t).all()
    assert abs(rho_j[2]) <= ATOL and abs(rho_t[2]) <= ATOL
    np.testing.assert_allclose(rho_t, rho_j, rtol=0, atol=ATOL)


def test_batched_and_own_target_forms_equal_single_calls():
    L, N, B, k, off = 120, 4, 3, 4, 2
    rng = np.random.default_rng(0)
    Y = torch.from_numpy(rng.standard_normal((N, L)).astype(np.float32))
    tabs = [_tables(L - off, k, L, off, seed=s) for s in range(B)]
    idx = torch.from_numpy(np.stack([t[0] for t in tabs]))
    w = ops.make_weights(torch.from_numpy(np.stack([t[1] for t in tabs])))
    batch = ops.lookup_rho(Y, idx, w, offset=off)
    own = ops.lookup_rho_own(Y[:B], idx, w, offset=off)
    assert batch.shape == (B, N) and own.shape == (B,)
    for b in range(B):
        single = ops.lookup_rho(Y, idx[b], w[b], offset=off)
        assert torch.equal(batch[b], single)
        assert own[b] == ops.lookup_rho(Y[b:b + 1], idx[b], w[b],
                                        offset=off)[0]


def test_weights_are_batch_invariant():
    d = torch.from_numpy(_tables(50, 6, 80, 0, seed=3)[1])
    w = ref.make_weights(d[None].expand(4, -1, -1).contiguous())
    assert all(torch.equal(w[b], ref.make_weights(d)) for b in range(4))
