"""Port vs reference: the streaming append path on the CPU.

The same numpy series go through ``repro`` (JAX on the CPU, the
reference's plain versions) and the port's CPU tensors (the plain versions
the ``knn_append`` CUDA kernel is held bit-equal to on the card). A grown
master must be indistinguishable from a cold rebuild — every distance
bit, every index, every tie, every garbage slot — in both packages, so
the port is held bit-equal to the reference's ``master_append`` and to
its own cold ``all_knn_multi_e``. The grid is the reference's
(``tests/test_master_append.py``). Screening, ``Dataset.append`` and
``EDM.append`` are compared record for record and bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.edm import EDM as JEDM
from repro.edm import Dataset as JDataset
from repro.edm import dataset as jdataset
from repro.edm import plan as jplan
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch import telemetry
from repro_torch.edm import EDM, Dataset, carry_session_cache
from repro_torch.edm import dataset as tdataset
from repro_torch.edm import plan as tplan
from repro_torch.kernels import ops, ref


def _series(rng, L, kind):
    x = rng.normal(size=L).astype(np.float32)
    if kind == "tie":  # heavy value collisions: exercises the tie order
        x = np.round(x * 2) / 2
    return x


def _equal(want, got, msg=""):
    np.testing.assert_array_equal(np.asarray(want), got.numpy(),
                                  err_msg=msg)


def _grow_both(x, *, L_old, E_max, tau, k):
    """(reference grown, port grown, port cold) tables of one series."""
    d0, i0 = jref.all_knn_multi_e(jnp.asarray(x[:L_old]), E_max=E_max,
                                  tau=tau, k=k)
    want = jref.master_append(jnp.asarray(x), d0, i0, tau=tau)
    got = ops.master_append(torch.from_numpy(x),
                            torch.tensor(np.asarray(d0)),
                            torch.tensor(np.asarray(i0)), tau=tau)
    cold = ref.all_knn_multi_e(torch.from_numpy(x), E_max=E_max, tau=tau,
                               k=k)
    return want, got, cold


def _assert_all_equal(want, got, cold, msg):
    for a, b, c, what in zip(want, got, cold, ("distances", "indices")):
        _equal(a, b, f"{what} vs reference {msg}")
        assert torch.equal(b, c), f"{what} vs cold rebuild {msg}"


@pytest.mark.parametrize("L_new,E_max,tau,dt", [
    (100, 3, 1, 1),
    (100, 3, 1, 17),
    (154, 4, 2, 7),     # Lp not a multiple of anything convenient
    (211, 6, 1, 64),    # deep levels, big tick
    (40, 3, 2, 7),      # thin levels after the slice
    (400, 1, 1, 32),    # E_max = 1: no delay structure at all
])
@pytest.mark.parametrize("kind", ["rand", "tie"])
def test_append_bit_equal_reference_and_cold(rng, L_new, E_max, tau, dt,
                                             kind):
    x = _series(rng, L_new, kind)
    L_old = L_new - dt
    Lp1 = L_old - (E_max - 1) * tau
    k = min(Lp1 + 3, 20, L_old - 1)
    _assert_all_equal(*_grow_both(x, L_old=L_old, E_max=E_max, tau=tau,
                                  k=k),
                      f"(L={L_new}, E={E_max}, tau={tau}, dt={dt}, {kind})")


@pytest.mark.parametrize("L_new,E_max,tau,dt,k", [
    (30, 4, 2, 2, 25),   # k_m exceeds deep levels' candidate count:
    (24, 6, 1, 3, 20),   # garbage (inf) slots before and after the
    (20, 3, 2, 4, 16),   # append, in the cold build's pattern
])
def test_append_garbage_slots_match_reference_and_cold(rng, L_new, E_max,
                                                       tau, dt, k):
    x = _series(rng, L_new, "rand")
    want, got, cold = _grow_both(x, L_old=L_new - dt, E_max=E_max, tau=tau,
                                 k=k)
    assert not bool(torch.isfinite(cold[0]).all()), \
        "regime check: this grid is meant to produce garbage slots"
    _assert_all_equal(want, got, cold, "(garbage regime)")


def test_slab_and_garbage_helpers_match_reference(rng):
    x = _series(rng, 90, "tie")
    want = jref.append_new_row_slab(jnp.asarray(x), dt=9, E_max=4, tau=2)
    got = ref.append_new_row_slab(torch.from_numpy(x)[None], dt=9, E_max=4,
                                  tau=2)[0]
    _equal(-np.asarray(want), got)  # the reference's is negated
    vals = np.array([[0.5, 1.0, np.inf, np.inf], [0.2, np.inf, np.inf,
                                                  np.inf]], np.float32)
    ik = np.array([[7, 3, 9, 11], [4, 8, 2, 6]], np.int32)
    rows = np.array([5, 6], np.int32)
    _equal(jref.normalize_garbage(-jnp.asarray(vals), jnp.asarray(ik),
                                  jnp.asarray(rows)),
           ref.normalize_garbage(torch.from_numpy(vals),
                                 torch.from_numpy(ik),
                                 torch.from_numpy(rows)))


def test_multi_tick_append_equals_one_cold_build(rng):
    """Append history does not leak into the table: many small ticks land
    on the single cold build of the final series, as in the reference."""
    x = _series(rng, 163, "rand")
    xt = torch.from_numpy(x)
    d, i = ref.all_knn_multi_e(xt[:100], E_max=3, tau=1, k=8)
    dj, ij = jref.all_knn_multi_e(jnp.asarray(x[:100]), E_max=3, tau=1, k=8)
    for stop in (101, 108, 131, 163):
        d, i = ops.master_append(xt[:stop], d, i, tau=1)
        dj, ij = jops.master_append(jnp.asarray(x[:stop]), dj, ij, tau=1,
                                    impl="ref")
    cold = ref.all_knn_multi_e(xt, E_max=3, tau=1, k=8)
    _assert_all_equal((dj, ij), (d, i), cold, "(4 ticks)")


def test_panel_append_matches_panel_master_and_reference(rng):
    X = rng.normal(size=(6, 120)).astype(np.float32)
    Xt = torch.from_numpy(X)
    dM, iM = tplan.panel_master(Xt[:, :100], E_max=4, tau=1, k=7,
                                impl="auto")
    before = telemetry.counter("edm_ops_master_append_calls").value
    grown = tplan.panel_master_append(Xt, dM, iM, tau=1, impl="auto")
    assert telemetry.counter("edm_ops_master_append_calls").value \
        == before + 1  # one call for the whole panel
    cold = tplan.panel_master(Xt, E_max=4, tau=1, k=7, impl="auto")
    jd, ji = jplan.panel_master(jnp.asarray(X[:, :100]), E_max=4, tau=1,
                                k=7, impl="ref")
    want = jplan.panel_master_append(jnp.asarray(X), jd, ji, tau=1,
                                     impl="ref")
    _assert_all_equal(want, grown, cold, "(panel)")


def test_append_args_validated(rng):
    x = torch.from_numpy(_series(rng, 50, "rand"))
    d, i = ref.all_knn_multi_e(x, E_max=3, tau=1, k=5)
    xj = jnp.asarray(x.numpy())
    dj, ij = jnp.asarray(d.numpy()), jnp.asarray(i.numpy())
    bad = [(x, d, i, xj, dj, ij),                       # dt < 1
           (x[:40], d, i, xj[:40], dj, ij),             # shrunk series
           (torch.cat([x, x[:4]]), d, i[:, :-1],        # dists/idx mismatch
            jnp.concatenate([xj, xj[:4]]), dj, ij[:, :-1])]
    for xt, dt_, it, xa, da, ia in bad:
        with pytest.raises(ValueError):
            ops.master_append(xt, dt_, it, tau=1)
        with pytest.raises(ValueError):
            jops.master_append(xa, da, ia, tau=1, impl="ref")
    with pytest.raises(ValueError, match="series"):  # panel of another N
        ops.master_append(torch.stack([x, x]), d[None], i[None], tau=1)


# ------------------------------------------------------- delta screening


def _dirty_panel(rng):
    full = rng.normal(size=(6, 80)).astype(np.float32)
    full[1, 70] = np.nan            # the fault arrives in the delta
    full[3, :] = 2.5                # constant throughout
    full[4, 66] = np.inf            # another delta fault
    return full


def test_screen_panel_delta_mode_matches_full_screen_and_reference(rng):
    full = _dirty_panel(rng)
    prior = tdataset.series_stats(full[:, :64])
    got = tdataset.screen_panel(full[:, 64:], prior=prior)
    want = jdataset.screen_panel(full[:, 64:],
                                 prior=jdataset.series_stats(full[:, :64]))
    assert got == want
    assert [r["index"] for r in got] == \
        [r["index"] for r in tdataset.screen_panel(full)] == [1, 3, 4]
    assert "appended delta" in got[0]["reason"]
    assert got[1]["reason"] == "constant series"
    with pytest.raises(ValueError, match="prior stats"):
        tdataset.screen_panel(full[:3, 64:], prior=prior)


def _assert_dataset_equal(t: Dataset, j: JDataset):
    np.testing.assert_array_equal(t.panel.numpy(), np.asarray(j.panel))
    np.testing.assert_array_equal(t.valid, j.valid)
    assert t.names == j.names
    assert t.invalid_report == j.invalid_report


@pytest.mark.parametrize("policy", ["raise", "mask", "drop"])
def test_dataset_append_matches_reference(rng, policy):
    panel = rng.normal(size=(5, 60)).astype(np.float32)
    names = list("vwxyz")
    clean = rng.normal(size=(5, 4)).astype(np.float32)
    bad = rng.normal(size=(5, 3)).astype(np.float32)
    bad[2, 0] = np.nan
    bad[4, 2] = -np.inf
    t = Dataset(panel, names=names, on_invalid=policy, device="cpu")
    j = JDataset(panel, names=names, on_invalid=policy)
    assert t.append(clean) == j.append(clean) == []
    _assert_dataset_equal(t, j)
    if policy == "raise":
        with pytest.raises(ValueError, match="series x"):
            t.append(bad)
        assert t.L == 64 and t.valid.all() and not t.invalid_report
        return
    recs = t.append(torch.from_numpy(bad))
    assert recs == j.append(bad)
    assert [r["index"] for r in recs] == [2, 4]  # pre-append indices
    assert [r["name"] for r in recs] == ["x", "z"]
    _assert_dataset_equal(t, j)
    assert bool(torch.isfinite(t.panel).all())
    if policy == "drop":
        assert t.N == 3 and t.names == ["v", "w", "y"]
    else:
        assert list(t.valid) == [True, True, False, True, False]
    with pytest.raises(ValueError, match="delta must be"):
        t.append(np.zeros((t.N + 1, 2), np.float32))


def test_dataset_append_constant_series_can_become_valid(rng):
    panel = rng.normal(size=(2, 50)).astype(np.float32)
    panel[1, :] = 7.0
    ds = Dataset(panel, on_invalid="mask", device="cpu")
    assert not ds.is_valid(1)
    assert ds.append(rng.normal(size=(2, 6)).astype(np.float32)) == []
    assert ds.is_valid(1)  # variation arrived: now usable


# ---------------------------------------------------------------- sessions


def test_session_append_master_bit_equal_reference_and_cold(rng):
    full = rng.normal(size=(5, 130)).astype(np.float32)
    warm = EDM(full[:, :100], E_max=4, device="cpu")
    jwarm = JEDM(full[:, :100], E_max=4, impl="ref")
    warm.optimal_E()                       # builds and caches the master
    jwarm.optimal_E()
    warm.append(full[:, 100:])
    jwarm.append(full[:, 100:])
    for a, b in zip(jwarm._cache["master"][:2], warm._cache["master"][:2]):
        _equal(a, b, "grown session master vs reference")
    cold = EDM(full, E_max=4, device="cpu")
    cold._master(warm._cache["master"][3])
    for a, b in zip(warm._cache["master"][:2], cold._cache["master"][:2]):
        assert torch.equal(a, b)
    assert "rho" not in warm._cache        # invalidated, master kept
    E_w, rho_w = warm.optimal_E()
    E_c, rho_c = cold.optimal_E()
    np.testing.assert_array_equal(E_w, E_c)
    np.testing.assert_array_equal(rho_w, rho_c)
    np.testing.assert_array_equal(warm.xmap(), cold.xmap())
    assert warm.stats["knn_master_appends"] == 1
    assert warm.stats["knn_master_builds"] == 1
    assert warm.stats["appends"] == 1


def test_session_append_spans_and_counters(rng):
    sess = EDM(rng.normal(size=(3, 80)).astype(np.float32), E_max=3,
               device="cpu")
    sess._master(3)
    with telemetry.record() as rec:
        sess.append(rng.normal(size=(3, 5)).astype(np.float32))
    assert len(rec.spans("session.append")) == 1
    assert rec.spans("session.master_append")[0]["attrs"]["dt"] == 5
    assert rec.counter_delta("edm_appends") == 1
    assert rec.counter_delta("edm_knn_master_appends") == 1
    assert rec.counter_delta("edm_ops_master_append_calls") == 1


def test_session_append_without_master_stays_lazy(rng):
    sess = EDM(rng.normal(size=(4, 90)).astype(np.float32), E_max=3,
               device="cpu")
    sess.append(rng.normal(size=(4, 5)).astype(np.float32))
    assert "master" not in sess._cache
    assert sess.stats.get("knn_master_appends", 0) == 0
    assert sess.data.L == 95 and sess.master_nbytes() == 0


def test_session_append_drop_compacts_master_rows(rng):
    full = rng.normal(size=(5, 110)).astype(np.float32)
    bad = full[:, 100:].copy()
    bad[2, 3] = np.nan
    sess = EDM(Dataset(full[:, :100], on_invalid="drop", device="cpu"),
               E_max=3, device="cpu")
    jsess = JEDM(JDataset(full[:, :100], on_invalid="drop"), E_max=3,
                 impl="ref")
    sess._master(3)
    jsess._master(3)
    assert sess.append(bad) == jsess.append(bad)
    keep = [0, 1, 3, 4]
    cold = EDM(full[keep], E_max=3, device="cpu")
    cold._master(3)
    for a, b, c in zip(jsess._cache["master"][:2], sess._cache["master"][:2],
                       cold._cache["master"][:2]):
        _equal(a, b, "drop compaction vs reference")
        assert torch.equal(b, c)


def test_evict_master_then_rebuild_is_bit_identical(rng):
    full = rng.normal(size=(4, 120)).astype(np.float32)
    kept = EDM(full[:, :100], E_max=4, device="cpu")
    evicted = EDM(full[:, :100], E_max=4, device="cpu")
    jsess = JEDM(full[:, :100], E_max=4, impl="ref")
    for s in (kept, evicted, jsess):
        s.optimal_E()
    assert evicted.master_nbytes() == jsess.master_nbytes() > 0
    assert evicted.evict_master() == jsess.master_nbytes()
    assert evicted.master_nbytes() == 0 and evicted.evict_master() == 0
    assert evicted.stats["knn_master_evictions"] == 1
    for s in (kept, evicted):
        s.append(full[:, 100:])
    evicted.optimal_E()                     # lazily rebuilt on the grown panel
    for a, b in zip(kept._cache["master"][:2], evicted._cache["master"][:2]):
        assert torch.equal(a, b)
    np.testing.assert_array_equal(kept.xmap(), evicted.xmap())


def test_carried_reference_master_grows_to_reference_bits(rng):
    """A JAX session's master, carried into the port, then the same delta
    appended in both packages: the same grown tables."""
    full = rng.normal(size=(5, 140)).astype(np.float32)
    jsess = JEDM(full[:, :120], E_max=5, impl="ref")
    jsess.optimal_E()
    dM, iM, k_m, lv = jsess._cache["master"]
    sess = carry_session_cache(
        EDM(full[:, :120], E_max=5, device="cpu"),
        {"master": (np.asarray(dM), np.asarray(iM), k_m, lv)})
    jsess.append(full[:, 120:])
    sess.append(full[:, 120:])
    for a, b in zip(jsess._cache["master"][:2], sess._cache["master"][:2]):
        _equal(a, b, "carried then grown master")
    np.testing.assert_array_equal(sess.optimal_E()[0], jsess.optimal_E()[0])
