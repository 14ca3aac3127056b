"""The append kernel's root rule, emulated on the CPU against both plain
versions.

The CUDA ``knn_append`` stream kernel merges a stored kNN list, which
keeps only roots r = sqrt_rn(v), with the new columns without recomputing
the stored squared distances: sqrt_rn is monotone, so r_a < r_b ⇒ v_a <
v_b and r_a > r_b ⇒ v_a > v_b, and only equal roots need the values,
which it then recomputes by the strict chain. A new column is first held
against a bound on the k-th slot's value taken from its root alone,
fl↑(r²) three ulps up (sqrt_rn(v) = r ⇒ v < r² + 2·ulp(r²)); only those
under it are rooted and placed, by a binary search under the same rule.
This file runs that rule in float32 on the CPU (``ref.sqrt_rn``, the
chain's bits from ``ref.append_candidates``) and holds the grown tables
equal, index for index, to the port's ``kernels.ref.master_append`` and
to the JAX ``repro.kernels.ref.master_append``: on tied panels (values
rounded to 1/8), on an unordered master, and on ``root_collision_panel``,
where a new column's squared distance and a stored one differ by one ulp
under one root. It counts those collisions and needs more than zero, and
checks the bound against every stored value it stands for.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.data import root_collision_panel
from repro_torch.kernels import ref

SENTINEL = 1 << 30  # a garbage slot's index, as csrc/knn_append.cu


def _root(v: float) -> float:
    return float(ref.sqrt_rn(torch.tensor([v], dtype=torch.float32))[0])


def _bound(r: float) -> float:
    """fl↑(r²) three float32 ulps up: the kernel's ``root_bound``."""
    if not r < math.inf:
        return math.inf
    sq = r * r  # exact in float64
    f = np.float32(sq)
    if float(f) < sq:
        f = np.nextafter(f, np.float32(np.inf))
    bits = int(f.view(np.int32)) + 3
    return math.inf if bits >= 0x7F800000 else float(
        np.int32(bits).view(np.float32))


def _merge_row(stored, new, row, count):
    """One old row's merge by the root rule: ``stored`` [(root, index,
    value)] of k slots, ``new`` [(value, column)] ascending in column."""
    ent = [(r, j, v) if math.isfinite(r) else (math.inf, SENTINEL + q,
                                                 math.inf)
           for q, (r, j, v) in enumerate(stored)]

    def before(a, b):  # (root, index, value) keys
        if a[0] != b[0]:
            return a[0] < b[0]
        count["equal_roots"] += 1
        if a[2] != b[2]:
            count["collisions"] += 1
        return (a[2], a[1]) < (b[2], b[1])

    for q in range(1, len(ent)):  # an unordered list, sorted by insertion
        key, p = ent[q], q
        while p > 0 and before(key, ent[p - 1]):
            p -= 1
        ent.insert(p, ent.pop(q))
    for v, c in new:
        if not v <= _bound(ent[-1][0]):  # past the k-th by its root alone
            continue
        cand = (_root(v), c, v)
        if not before(cand, ent[-1]):
            continue
        lo, hi = 0, len(ent) - 1  # entries below lo precede it
        while lo < hi:
            mid = (lo + hi) // 2
            if before(ent[mid], cand):
                lo = mid + 1
            else:
                hi = mid
        ent.insert(lo, cand)
        ent.pop()
    nfin = sum(math.isfinite(r) for r, _, _ in ent)
    return ([r for r, _, _ in ent],
            [j if q < nfin else (row if q == nfin else q)
             for q, (_, j, _) in enumerate(ent)])


def root_rule_append(X, dists, idx, *, tau=1):
    """The grown (N, E_max, L_new, k) tables: old rows by the root rule,
    new rows by a stable sort of their candidates; and the counts."""
    N, E_max, L_old, k = dists.shape
    L_new = X.shape[-1]
    out_d = torch.full((N, E_max, L_new, k), math.inf)
    out_i = torch.full((N, E_max, L_new, k), -1, dtype=torch.int32)
    count = {"equal_roots": 0, "collisions": 0}
    for e in range(E_max):
        Lp_old, Lp_new = L_old - e * tau, L_new - e * tau
        old, _, new = ref.append_candidates(X, dists, idx, tau=tau, e=e)
        for s in range(N):
            for i in range(Lp_old):
                vals = old[s, i].tolist()
                stored = list(zip(dists[s, e, i].tolist(),
                                  idx[s, e, i].tolist(), vals[:k]))
                fresh = [(vals[k + t], Lp_old + t)
                         for t in range(Lp_new - Lp_old)]
                d, j = _merge_row(stored, fresh, i, count)
                out_d[s, e, i] = torch.tensor(d)
                out_i[s, e, i] = torch.tensor(j, dtype=torch.int32)
        sv, pos = torch.sort(new, dim=-1, stable=True)
        out_d[:, e, Lp_old:Lp_new] = ref.sqrt_rn(sv[..., :k])
        out_i[:, e, Lp_old:Lp_new] = pos[..., :k].to(torch.int32)
    return out_d, out_i, count


def _master(X, L_old, E_max, tau, k):
    return ref.all_knn_multi_e(X[:, :L_old], E_max=E_max, tau=tau, k=k)


def _held(X, d0, i0, tau):
    """Root-rule tables equal to both plain versions; returns the counts."""
    got_d, got_i, count = root_rule_append(X, d0, i0, tau=tau)
    want = ref.master_append(X, d0, i0, tau=tau)
    assert torch.equal(got_d, want[0]) and torch.equal(got_i, want[1])
    for s in range(X.shape[0]):
        jd, ji = jref.master_append(jnp.asarray(X[s].numpy()),
                                    jnp.asarray(d0[s].numpy()),
                                    jnp.asarray(i0[s].numpy()), tau=tau)
        np.testing.assert_array_equal(np.asarray(jd), got_d[s].numpy())
        np.testing.assert_array_equal(np.asarray(ji), got_i[s].numpy())
    return count


@pytest.mark.parametrize("L_new,E_max,tau,dt,k", [
    (100, 3, 1, 1, 8),
    (120, 4, 2, 7, 10),
    (90, 6, 1, 16, 9),
    (24, 4, 2, 3, 20),   # garbage slots: fewer candidates than k
])
def test_root_rule_equals_plain_on_tied_panels(L_new, E_max, tau, dt, k):
    rng = np.random.default_rng(L_new + dt)
    X = torch.from_numpy(np.round(rng.standard_normal((3, L_new)) * 8)
                         .astype(np.float32) / 8)
    d0, i0 = _master(X, L_new - dt, E_max, tau, k)
    count = _held(X, d0, i0, tau)
    assert count["equal_roots"] > 0  # ties took the recompute


def test_root_rule_sorts_an_unordered_master():
    rng = np.random.default_rng(7)
    X = torch.from_numpy(rng.standard_normal((3, 110)).astype(np.float32))
    d0, i0 = _master(X, 100, 4, 1, 9)
    perm = torch.from_numpy(rng.permutation(9))
    _held(X, d0[..., perm].contiguous(), i0[..., perm].contiguous(), 1)


def test_root_rule_recomputes_on_a_root_collision():
    L_old, dt = 120, 3
    X = torch.from_numpy(root_collision_panel(8, L_old, dt, seed=2))
    d0, i0 = _master(X, L_old, 3, 1, 6)
    count = _held(X, d0, i0, 1)
    assert count["collisions"] > 0


@pytest.mark.parametrize("kind", ["tie", "rand"])
def test_root_bound_covers_every_stored_value(kind):
    rng = np.random.default_rng(11)
    X = rng.standard_normal((4, 150)).astype(np.float32)
    if kind == "tie":
        X = np.round(X * 8) / 8
    X = torch.from_numpy(X)
    d0, i0 = _master(X, 140, 5, 1, 12)
    checked = 0
    for e in range(5):
        old, _, _ = ref.append_candidates(X, d0, i0, tau=1, e=e)
        roots = d0[:, e, :old.shape[1]]
        fin = torch.isfinite(roots)
        for r, v in zip(roots[fin].tolist(), old[..., :12][fin].tolist()):
            assert _root(v) == r and v <= _bound(r)
            checked += 1
    assert checked > 0
