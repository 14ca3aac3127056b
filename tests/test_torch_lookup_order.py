"""The CUDA ``lookup_rho`` kernel's moment order, emulated on the CPU.

``csrc/lookup_rho.cu`` takes Pearson's moments in an order fixed by the
number of rows alone: tiles of 32 rows with two-pass float32 moments (each
tile summed as four slot partials), merged in float64 by the
Chan/Schubert–Gertz formula as a tree into chunks of 256 rows, the chunks
merged in chunk order. ``repro_torch.kernels.lookup._emulate`` repeats that
arithmetic operation for operation (no path calls it). This file holds it
against the reference's plain ``repro.kernels.ref.lookup_rho`` and against
its Pallas ``lookup_rho`` in interpret mode, on numpy inputs made from a
seed, within ``ATOL`` = 1e-5 (the bound the kernel is held to on the card:
the two sides' float32 sums run in other orders over a few hundred rows);
shows that a (b, n) result has the same bits at B = 1 and at B = all, in
both target forms, for one row, a chunk exactly and a ragged last chunk;
and that E_opt from the emulated ρ(E) equals ``repro.core.optimal_E_batch``
on a small panel.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import core as jcore
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core.embedding import embed_offset, num_embedded, pred_rows
from repro_torch.data import timeseries as ts
from repro_torch.kernels import lookup, ops, ref

ATOL = 1e-5


def _case(B, N, rows, k, off, seed):
    """(Y (N, L), idx (B, rows, k), w (B, rows, k)) from a seed: weights
    from sorted distances, some invalid (-1, weight 0) slots."""
    rng = np.random.default_rng(seed)
    L = rows + off
    Y = rng.standard_normal((N, L)).astype(np.float32)
    Y[1] = 0.25 * Y[0] + 0.01 * Y[1]  # a target that tracks another
    idx = rng.integers(0, L - off, size=(B, rows, k)).astype(np.int32)
    d = np.sort(rng.uniform(0.01, 2.0, size=(B, rows, k)), axis=-1)
    d = d.astype(np.float32)
    idx[:, ::7, -1] = -1
    d[:, ::7, -1] = np.inf
    w = ref.make_weights(torch.from_numpy(d))
    return torch.from_numpy(Y), torch.from_numpy(idx), w


@pytest.mark.parametrize("rows,k,off", [
    (1, 3, 2),       # one row
    (31, 4, 1),      # one ragged tile
    (256, 4, 2),     # a chunk exactly
    (700, 5, 3),     # two full chunks and a ragged third
    (513, 2, 0),     # a last chunk of one row
])
def test_emulated_order_matches_the_reference(rows, k, off):
    B, N = 3, 5
    Y, idx, w = _case(B, N, rows, k, off, seed=rows + k)
    got = lookup._emulate(Y, idx, w, offset=off)
    assert got.shape == (B, N) and bool(torch.isfinite(got).all())
    Yj = jnp.asarray(Y.numpy())
    for b in range(B):
        ij, wj = jnp.asarray(idx[b].numpy()), jnp.asarray(w[b].numpy())
        want = np.asarray(jref.lookup_rho(Yj, ij, wj, offset=off))
        np.testing.assert_allclose(got[b].numpy(), want, rtol=0, atol=ATOL)
        if rows >= 8:  # the Pallas kernel's tile needs 8 rows
            pallas = np.asarray(jops.lookup_rho(Yj, ij, wj, offset=off,
                                                impl="interpret",
                                                block=(64, 8)))
            np.testing.assert_allclose(got[b].numpy(), pallas, rtol=0,
                                       atol=ATOL)


@pytest.mark.parametrize("rows", [1, 256, 300])
def test_result_bits_do_not_depend_on_the_batch(rows):
    """(b, n) at B = 1 equals (b, n) at B = all, bit for bit, in both
    forms; the own form's (b, b) equals the all-targets form's."""
    B, k, off = 4, 4, 2
    Y, idx, w = _case(B, B, rows, k, off, seed=rows)
    full = lookup._emulate(Y, idx, w, offset=off)
    own = lookup._emulate(Y, idx, w, offset=off, own=True)
    for b in range(B):
        one = lookup._emulate(Y, idx[b:b + 1], w[b:b + 1], offset=off)[0]
        assert torch.equal(one, full[b])
        alone = lookup._emulate(Y[b:b + 1], idx[b:b + 1], w[b:b + 1],
                                offset=off, own=True)[0]
        assert torch.equal(alone, own[b]) and torch.equal(own[b], full[b, b])
        # one target alone (the kernel's Nt = 1 route) keeps the bits too
        tgt = lookup._emulate(Y[b:b + 1], idx, w, offset=off)[:, 0]
        assert torch.equal(tgt, full[:, b])


def test_row_sliced_tables_give_the_same_bits():
    """A row-sliced view (the callers' ``i[:, :rows]``) reads the same
    values as its contiguous copy, and the emulation agrees with the
    plain versions within ATOL on it."""
    Y, idx, w = _case(3, 4, 300, 4, 2, seed=9)
    rows = 260
    v_i, v_w = idx[:, :rows], w[:, :rows]
    assert not v_i.is_contiguous()
    got = lookup._emulate(Y, v_i, v_w, offset=2)
    assert torch.equal(got, lookup._emulate(Y, v_i.contiguous(),
                                            v_w.contiguous(), offset=2))
    want = ops.lookup_rho(Y, v_i, v_w, offset=2)
    assert torch.allclose(got, want, rtol=0, atol=ATOL)


def test_constant_target_gives_zero():
    Y, idx, w = _case(2, 3, 120, 3, 1, seed=4)
    Y[2] = 0.75
    got = lookup._emulate(Y, idx, w, offset=1)
    assert bool((got[:, 2] == 0).all())


def test_emulated_optimal_E_equals_the_reference():
    """ρ(E) through the emulated kernel order on the port's plain multi-E
    tables: E_opt equal to ``repro.core.optimal_E_batch``, ρ within ATOL."""
    X = ts.forced_network_panel(6, 300, seed=2)[0]
    E_max, L = 8, X.shape[1]
    Xt = torch.from_numpy(X)
    mx = tuple(num_embedded(L, E, 1) - 2 for E in range(1, E_max + 1))
    rho = torch.zeros((X.shape[0], E_max))
    for s in range(X.shape[0]):
        d, i = ops.all_knn_multi_e(Xt[s], E_max=E_max, max_idx=mx)
        for E in range(1, E_max + 1):
            rows = pred_rows(L, E, 1, 1)
            w = ops.make_weights(d[E - 1, :rows, :E + 1])
            rho[s, E - 1] = lookup._emulate(
                Xt[s:s + 1], i[E - 1, :rows, :E + 1][None], w[None],
                offset=embed_offset(E, 1, 1), own=True)[0]
    E_j, rho_j = jcore.optimal_E_batch(jnp.asarray(X), E_max=E_max,
                                       impl="ref")
    np.testing.assert_allclose(rho.numpy(), np.asarray(rho_j), rtol=0,
                               atol=ATOL)
    assert np.array_equal((rho.argmax(1) + 1).numpy(), np.asarray(E_j))
