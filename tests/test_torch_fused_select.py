"""The CUDA ``knn_fused`` selection kernel's walk, emulated on the CPU.

``csrc/knn_fused.cu``'s selection kernel (k ≤ 32, E ≤ 32) gives a warp R
rows i0 + rτ (``knn_fused.rows_per_warp``; rows split by residue mod τ)
and one of S slices (``knn_fused.slices``) of the diagonals b, lane b
taking column b + rτ of row r (so that one lane's squares serve all R
rows), streams the diagonals through tiles of ``TILE_COLS``, and selects
in two passes: a threshold for each row from the 64 diagonals around the
warp's rows (the k-th of their values, index unbounded), then a walk that
buffers only keys under the threshold, 32 diagonals at a time, and cuts a
buffer past 64 keys to its k first — the new threshold is then its k-th
key. At the end a row's S slice lists are merged and the k first kept.
This file runs that walk in numpy on the
strict-chain distances (each subtraction, square and sum rounded to
float32) and holds the tables bit-equal to the reference's plain
``topk_select(pairwise_distances(x))`` (``repro.kernels.ref``, JAX on the
CPU): ``hypothesis`` over quantized series full of tied distances,
``exclude_self``, ``max_idx`` caps, k from 1 to 32, and tiles that cut
the column walk (and the rows' lag windows) at every tile edge.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.kernels import ref as jref
from repro_torch.kernels import knn_fused

K_EMPTY = 0x7FFFFFFF  # kbest::kEmpty
BUF = knn_fused.SELECT_BUF


def _distances(x, E, tau):
    """(Lp, Lp) strict-chain squared distances, every operation rounded to
    float32 (numpy float32 arithmetic is IEEE, one rounding an op)."""
    x = x.astype(np.float32)
    Lp = x.shape[0] - (E - 1) * tau
    acc = np.zeros((Lp, Lp), np.float32)
    for e in range(E):
        xe = x[e * tau:e * tau + Lp]
        d = xe[:, None] - xe[None, :]
        acc = acc + d * d
    return acc


def _first32(keys):
    """The 32 first (value, index) keys, padded with (inf, kEmpty)."""
    keys = sorted(keys)[:32]
    return keys + [(math.inf, K_EMPTY)] * (32 - len(keys))


def emulate(x, *, E, tau, k, exclude_self, max_idx, tile_cols):
    """The selection kernel's tables (sqrt dists, idx), both (Lp, k), and
    the number of compactions it made."""
    L = x.shape[0]
    Lp = L - (E - 1) * tau
    mx = Lp - 1 if max_idx is None else min(int(max_idx), Lp - 1)
    R = knn_fused.rows_per_warp(E)
    S = knn_fused.slices(Lp, E, tau)
    pre = (R - 1) * tau  # diagonals b run over [-pre, Lp)
    C = tile_cols
    G = C // (32 * S)
    M = -(-(-(-Lp // tau)) // R)
    D = _distances(x, E, tau)
    cols = np.arange(Lp)
    out_d = np.zeros((Lp, k), np.float32)
    out_i = np.zeros((Lp, k), np.int32)
    flushes = 0
    for q in range(tau * M):
        i0 = q // M + (q % M) * R * tau  # the group's rows: i0 + rτ
        w0 = max(-pre, min(i0 - 32, Lp - 64))
        for r in range(R):
            i = i0 + r * tau
            if i >= Lp:
                break
            row = D[i].astype(np.float64)
            masked = (cols > mx) | ((cols == i) if exclude_self else False)
            row = np.where(masked, math.inf, row)

            def col(b):  # row r's column on diagonal b
                return b + r * tau

            win = [row[col(b)] if 0 <= col(b) < Lp else math.inf
                   for b in range(w0, w0 + 64)]
            tv0 = sorted(win)[k - 1]
            lists = []
            for s in range(S):
                tv, ti, buf = tv0, K_EMPTY, []
                for t in range(-(-(Lp + pre) // C)):
                    for g in range(G):
                        jb = t * C + (s * G + g) * 32 - pre
                        if jb >= Lp:
                            break
                        for b in range(jb, jb + 32):
                            c = col(b)
                            if 0 <= c < Lp and (row[c], c) < (tv, ti):
                                buf.append((row[c], c))
                        if len(buf) > BUF - 32:
                            buf = sorted(buf)[:k]
                            tv, ti = buf[k - 1]
                            flushes += 1
                lists.append(_first32(buf))
            keys = sorted(key for lst in lists for key in lst)[:k]
            out_d[i] = [np.sqrt(np.float64(np.float32(v))) for v, _ in keys]
            out_i[i] = [j for _, j in keys]
    return out_d.astype(np.float32), out_i, flushes


def _reference(x, *, E, tau, k, exclude_self, max_idx):
    D = jref.pairwise_distances(jnp.asarray(x), E=E, tau=tau)
    d, i = jref.topk_select(D, k=k, exclude_self=exclude_self,
                            max_idx=max_idx)
    return np.asarray(d), np.asarray(i)


def _held(x, **kw):
    tile_cols = kw.pop("tile_cols")
    got_d, got_i, flushes = emulate(x, tile_cols=tile_cols, **kw)
    want_d, want_i = _reference(x, **kw)
    assert np.array_equal(got_i, want_i)
    assert np.array_equal(got_d.view(np.int32), want_d.view(np.int32))
    return flushes


def _series(L, step, seed):
    """A smooth series rounded to ``step``: many exactly tied distances."""
    rng = np.random.default_rng(seed)
    t = np.arange(L)
    x = (np.sin(0.3 * t) + 0.5 * np.sin(0.071 * t + 1)
         + 0.3 * rng.standard_normal(L))
    return (np.round(x / step) * step).astype(np.float32)


@pytest.mark.parametrize("L,E,tau,k,excl,max_idx,tile_cols", [
    (300, 3, 1, 1, True, None, 256),       # k = 1
    (300, 4, 2, 32, True, None, 256),      # k = 32, tiles cut the lag windows
    (257, 20, 1, 21, True, None, 256),     # the session's E = 20, R = 6
    (300, 24, 1, 25, False, None, 256),    # R = 4, self kept
    (300, 3, 3, 6, True, 250, 256),        # τ = 3: rows by residue
    (300, 3, 1, 9, True, 120, 256),        # a cap inside the walk
    (300, 2, 1, 8, True, 5, 256),          # a cap below k: +inf fill
    (60, 2, 3, 5, True, None, 256),        # fewer than 64 columns
    (1700, 3, 1, 4, True, None, 1024),     # the kernel's own tile, S = 8
])
def test_emulated_walk_equals_the_reference(L, E, tau, k, excl, max_idx,
                                            tile_cols):
    x = _series(L, 0.25, seed=L + E)
    _held(x, E=E, tau=tau, k=k, exclude_self=excl, max_idx=max_idx,
          tile_cols=tile_cols)


def test_the_walk_compacts_on_a_noise_series():
    """White noise quantized coarsely: the window's threshold is loose, so
    the buffers fill and are cut many times, and the bits still hold."""
    x = (np.round(np.random.default_rng(3).standard_normal(1500) * 2) / 2
         ).astype(np.float32)
    flushes = _held(x, E=2, tau=1, k=20, exclude_self=True, max_idx=None,
                    tile_cols=256)
    assert flushes > 0


@settings(max_examples=30, deadline=None)
@given(L=st.integers(40, 330), E=st.integers(1, 8), tau=st.integers(1, 3),
       k=st.integers(1, 32), excl=st.booleans(),
       cap=st.one_of(st.none(), st.integers(0, 400)),
       step=st.sampled_from([0.5, 0.25, 0.125]), seed=st.integers(0, 99),
       tiles=st.sampled_from([1, 2]))
def test_emulated_walk_equals_the_reference_on_ties(L, E, tau, k, excl, cap,
                                                    step, seed, tiles):
    Lp = L - (E - 1) * tau
    if Lp < k or Lp < 2:
        return
    S = knn_fused.slices(Lp, E, tau)
    _held(_series(L, step, seed), E=E, tau=tau, k=k, exclude_self=excl,
          max_idx=cap, tile_cols=32 * S * tiles)


def test_plan_fills_the_card_and_fits_a_block():
    """S from the shape alone: the variants path's L = 1600 takes 8
    slices, L = 10,000 and 65,536 one (each launch 12 warps an SM or
    more); every selection shape's block fits Hopper's shared memory."""
    assert knn_fused.slices(1581, 20) == 8
    assert knn_fused.slices(1598, 3) == 8
    assert knn_fused.slices(9981, 20) == 1
    assert knn_fused.slices(65_517, 20) == 1
    assert knn_fused.route(65_536, 20, 1, 21) == "select"
    assert knn_fused.route(1600, 3, 1, 33) == "insert"
    assert knn_fused.route(1600, 33, 1, 4) == "insert"
    assert knn_fused.select_smem(32, 1) <= knn_fused.SMEM_MAX


@pytest.mark.parametrize("E,tau,k,excl,max_idx", [
    (20, 1, 21, True, None), (3, 2, 4, False, 150), (1, 1, 1, True, None),
])
def test_plain_rows_equal_the_plain_table(E, tau, k, excl, max_idx):
    """``ref.all_knn_rows`` (the check of a series too long for an (Lp, Lp)
    matrix) gives the rows of the plain ``all_knn`` table, bit for bit."""
    import torch

    from repro_torch.kernels import ref
    x = torch.from_numpy(_series(400, 0.125, seed=E))
    rows = [0, 1, 57, 200, 400 - (E - 1) * tau - 1]
    kw = dict(E=E, tau=tau, k=k, exclude_self=excl, max_idx=max_idx)
    d, i = ref.all_knn(x, **kw)
    dr, ir = ref.all_knn_rows(x, rows, **kw)
    assert torch.equal(dr, d[rows]) and torch.equal(ir, i[rows])
