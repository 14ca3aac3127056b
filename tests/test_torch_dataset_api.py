"""The port's ``Dataset.series`` / ``Dataset.embedding``, its exported
screening statistics, and the journal's snapshots.

``series``, the cached ``embedding`` and the cache dropped by ``append``
(under every ``on_invalid`` policy) are held against ``repro.edm.Dataset``
on the CPU, exactly: both packages copy the same float32 values. The
snapshots of ``edm.runner.MatrixRunner`` are written on the launch thread,
one a cadence step, none repeated by ``finalize`` or a preemption, each
holding its commit's rows; a failed write surfaces unchanged.
"""

import os
import json
import signal
import threading

import numpy as np
import pytest

from repro.edm.dataset import Dataset as JDataset
from repro.edm.dataset import merge_stats as jmerge_stats
from repro.edm.dataset import series_stats as jseries_stats
from repro_torch.checkpoint import CheckpointManager
from repro_torch.core import ccm
from repro_torch.data import timeseries as ts
from repro_torch.edm import (EDM, PREEMPTED_EXIT, Dataset, EDMConfig,
                             merge_stats, series_stats)


def _panel(n=5, steps=90, seed=4) -> np.ndarray:
    return ts.forced_network_panel(n, steps, seed=seed)[0]


def _pair(panel, **kw):
    return JDataset(panel, **kw), Dataset(panel, device="cpu", **kw)


def _np(a) -> np.ndarray:
    return np.asarray(a.detach().cpu().numpy() if hasattr(a, "detach")
                      else a)


# ------------------------------------------------------------ Dataset API


@pytest.mark.parametrize("key", [0, 3, "s2", "s4"])
def test_series_equals_reference(key):
    names = [f"s{i}" for i in range(5)]
    jd, td = _pair(_panel(), names=names)
    got = td.series(key)
    assert tuple(got.shape) == (90,) and got.device.type == "cpu"
    np.testing.assert_array_equal(_np(got), _np(jd.series(key)))


@pytest.mark.parametrize("E,tau", [(1, 1), (3, 1), (4, 2), (6, 3)])
def test_embedding_equals_reference_and_is_cached(E, tau):
    jd, td = _pair(_panel())
    emb = td.embedding(E, tau)
    Lp = 90 - (E - 1) * tau
    assert tuple(emb.shape) == (5, Lp, E)
    assert emb.device == td.panel.device
    assert td.embedding(E, tau) is emb          # the cached object
    np.testing.assert_array_equal(_np(emb), _np(jd.embedding(E, tau)))
    # entry (i, t, k) is x_i[t + k·τ]
    x = _np(td.panel)
    np.testing.assert_array_equal(_np(emb)[2, 7], x[2, 7:7 + E * tau:tau])


@pytest.mark.parametrize("policy", ["raise", "mask", "drop"])
def test_append_clears_the_embedding_cache(policy):
    panel = _panel()
    rng = np.random.default_rng(9)
    delta = rng.standard_normal((5, 4)).astype(np.float32)
    if policy != "raise":
        delta[1, 2] = np.nan                    # invalidates series 1
    jd, td = _pair(panel, on_invalid=policy)
    old = td.embedding(3)
    jd.embedding(3)
    assert td._embeddings and jd._embeddings
    jrec, trec = jd.append(delta), td.append(delta)
    assert trec == jrec
    assert td._embeddings == {} and jd._embeddings == {}
    new = td.embedding(3)
    assert new is not old and tuple(new.shape) == (td.N, td.L - 2, 3)
    np.testing.assert_array_equal(_np(new), _np(jd.embedding(3)))


def test_rejected_append_keeps_the_cache_as_reference():
    delta = np.ones((5, 2), np.float32)
    delta[0, 0] = np.inf
    jd, td = _pair(_panel())
    emb = td.embedding(2)
    jd.embedding(2)
    for d in (jd, td):
        with pytest.raises(ValueError, match="append rejected"):
            d.append(delta)
    assert td.embedding(2) is emb and len(jd._embeddings) == 1


def test_series_stats_and_merge_stats_equal_reference():
    rng = np.random.default_rng(2)
    a = rng.standard_normal((6, 40)).astype(np.float32)
    b = rng.standard_normal((6, 7)).astype(np.float32)
    a[1, 3], b[2, 0], b[4, 5] = np.nan, np.inf, -np.inf
    a[5] = 3.0                                  # constant
    for got, want in ((series_stats(a), jseries_stats(a)),
                      (series_stats(b), jseries_stats(b)),
                      (merge_stats(series_stats(a), series_stats(b)),
                       jmerge_stats(jseries_stats(a), jseries_stats(b)))):
        assert sorted(got) == sorted(want) == ["cnt", "hi", "lo"]
        for k in got:
            np.testing.assert_array_equal(got[k], want[k])
            assert got[k].dtype == want[k].dtype


# ------------------------------------------------- the journal's snapshots


def _cfg(**kw) -> EDMConfig:
    return EDMConfig(device="cpu", E=3, batch_libs=1, checkpoint_every=1,
                     checkpoint_keep=100, **kw)


def _steps(run) -> dict:
    """Every retained snapshot of a run dir: step → leaves' bytes."""
    ck = CheckpointManager(os.path.join(run, "state"), keep=100)
    out = {}
    for s in ck.steps():
        d = ck._step_dir(s)
        out[s] = [np.load(os.path.join(d, f)).tobytes()
                  for f in sorted(os.listdir(d)) if f.endswith(".npy")]
    return out


def _record_saves(monkeypatch, fail_on=None, exc=None):
    """Wrap ``CheckpointManager.save``: log each call's (thread, step),
    raise ``exc`` at the ``fail_on``-th call."""
    orig = CheckpointManager.save
    log = []

    def save(self, step, state):
        log.append((threading.current_thread().name, step))
        if fail_on is not None and len(log) == fail_on:
            raise exc
        return orig(self, step, state)

    monkeypatch.setattr(CheckpointManager, "save", save)
    return log


def test_snapshots_are_written_once_a_step_on_the_launch_thread(
        tmp_path, monkeypatch):
    X = _panel(n=6)
    plain = EDM(X, _cfg()).xmap()
    log = _record_saves(monkeypatch)
    run = str(tmp_path / "run")
    np.testing.assert_array_equal(EDM(X, _cfg()).xmap(run_dir=run), plain)
    # six cadence snapshots; the last holds every row, so finalize
    # writes no other
    main = threading.current_thread().name
    assert log == [(main, s) for s in range(1, 7)]
    assert sorted(_steps(run)) == [1, 2, 3, 4, 5, 6]


def test_each_snapshot_holds_exactly_its_commits_rows(tmp_path):
    X = _panel(n=6)
    plain = EDM(X, _cfg()).xmap()
    run = str(tmp_path / "run")
    np.testing.assert_array_equal(EDM(X, _cfg()).xmap(run_dir=run), plain)
    steps = _steps(run)
    assert sorted(steps) == [1, 2, 3, 4, 5, 6]
    for s, (done, rho) in steps.items():
        mask = np.frombuffer(done, bool).reshape(1, 6)[0]
        got = np.frombuffer(rho, np.float32).reshape(6, 6)
        assert mask.sum() == s
        np.testing.assert_array_equal(got[mask], plain[mask])
        assert not got[~mask].any()


def test_preemption_saves_no_state_twice_and_resumes_bit_identically(
        tmp_path, monkeypatch):
    X = _panel(n=6)
    plain = EDM(X, _cfg()).xmap()
    log = _record_saves(monkeypatch)
    orig = ccm._group_step
    n = {"launches": 0}

    def sigterm_at_3(*a, **k):
        n["launches"] += 1
        if n["launches"] == 3:
            os.kill(os.getpid(), signal.SIGTERM)
        return orig(*a, **k)

    monkeypatch.setattr(ccm, "_group_step", sigterm_at_3)
    run = str(tmp_path / "run")
    with pytest.raises(SystemExit) as exc:
        EDM(X, _cfg()).xmap(run_dir=run)
    assert exc.value.code == PREEMPTED_EXIT
    # tiles 0 and 1 were snapshotted at their commits; the preemption
    # found the second already on disk and wrote no third.
    assert [step for _, step in log] == [1, 2]
    assert sorted(_steps(run)) == [1, 2]
    monkeypatch.setattr(ccm, "_group_step", orig)
    sess = EDM(X, _cfg())
    np.testing.assert_array_equal(sess.xmap(run_dir=run), plain)
    assert sess.stats["rows_resumed"] == 2


@pytest.mark.parametrize("where", ["first", "last"])
@pytest.mark.parametrize("error", [OSError("No space left on device"),
                                   PermissionError("read-only file system")],
                         ids=["oserror", "permissionerror"])
def test_a_failed_write_surfaces_and_is_not_retried(tmp_path, monkeypatch,
                                                    where, error):
    """A snapshot write that fails raises its own error out of ``xmap``
    — never swallowed, never taken for an OOM."""
    X = _panel(n=6)
    _record_saves(monkeypatch, fail_on=1 if where == "first" else 6,
                  exc=error)
    run = str(tmp_path / "run")
    with pytest.raises(type(error)) as exc:
        EDM(X, _cfg()).xmap(run_dir=run)
    assert exc.value is error
    with open(os.path.join(run, "run.json")) as f:
        assert json.load(f)["status"] == "running"
    if os.path.exists(os.path.join(run, "report.json")):
        with open(os.path.join(run, "report.json")) as f:
            assert json.load(f)["oom_backoff"] == []
