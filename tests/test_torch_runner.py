"""The port's journaled matrix runs (``repro_torch.edm.runner``) on the CPU.

The cases of the reference's fault-tolerance and run-telemetry tests, on
``device="cpu"`` sessions: ``drive_batched``'s hooks, the straggler
monitor, the OOM classification (a ``torch.cuda.OutOfMemoryError`` by its
type) and the halve-B ladder, the run key (perf knobs out; device type and
package in), journaled ≡ plain bit for bit, short-circuit, stale-journal
refusal, the single-writer lock, preempt → resume in-process and across
processes, checkpoint restore hygiene, the run artifacts and the inspector.
Within the port every equality is bit for bit; against the JAX session
(``impl="ref"``) ρ is held to atol 1e-5.
"""

import gc
import json
import os
import pathlib
import signal
import subprocess
import sys
import textwrap
import weakref

import numpy as np
import pytest
import torch

from repro.edm import EDM as JEDM
from repro.edm import runner as jrunner
from repro_torch import telemetry
from repro_torch.checkpoint import CheckpointManager
from repro_torch.core import ccm
from repro_torch.data import timeseries as ts
from repro_torch.distributed.fault import StragglerMonitor
from repro_torch.edm import (EDM, PREEMPTED_EXIT, EDMConfig, MatrixRunner,
                             run_key)
from repro_torch.edm import inspect as edm_inspect
from repro_torch.edm import runner as runner_mod
from repro_torch.telemetry import schema

ROOT = pathlib.Path(__file__).resolve().parent.parent
ATOL = 1e-5
SIG = ("xmap", "simplex", None, ((3, 6),))
OOM_ERRORS = {
    "resource_exhausted": lambda: RuntimeError(
        "RESOURCE_EXHAUSTED: out of memory"),
    "torch_cuda_oom": lambda: torch.cuda.OutOfMemoryError(
        "CUDA out of memory. Tried to allocate 2.00 GiB. GPU 0 has a total "
        "capacity of 79.19 GiB of which 1.06 GiB is free."),
}


def _panel(n=6, steps=220, seed=3) -> np.ndarray:
    return ts.forced_network_panel(n, steps, seed=seed)[0]


def _cfg(**kw) -> EDMConfig:
    return EDMConfig(device="cpu", **kw)


def _report(run) -> dict:
    return json.loads((run / "report.json").read_text())


# --------------------------------------------------- drive_batched hooks


def test_drive_batched_start_and_on_block():
    """start= skips committed rows; on_block sees exactly the landed
    tiles in order, unpadded."""
    calls, blocks = [], []

    def launch(a, b, B):
        calls.append((a, b, B))
        return torch.arange(a, a + B, dtype=torch.float32)[:, None]

    out = ccm.drive_batched(7, 3, launch, start=3,
                            on_block=lambda a, b, blk: blocks.append(
                                (a, b, blk.copy())))
    assert calls == [(3, 6, 3), (6, 7, 3)]
    assert [(a, b) for a, b, _ in blocks] == [(3, 6), (6, 7)]
    np.testing.assert_array_equal(blocks[1][2][:, 0], [6.0])  # pad dropped
    np.testing.assert_array_equal(out[3:, 0], np.arange(3, 7))
    # nothing left to drive: no launches, None result
    assert ccm.drive_batched(4, 2, launch, start=4) is None
    assert len(calls) == 2


def test_drive_batched_monitor_counts_tiles():
    mon = StragglerMonitor()
    ccm.drive_batched(6, 2, lambda a, b, B: torch.zeros((B, 1)), monitor=mon)
    rep = mon.report()
    assert rep["steps"] == 3 and rep["median_s"] is not None


def test_drive_batched_without_hooks_unchanged():
    calls = []

    def launch(a, b, B):
        calls.append((a, b, B))
        return torch.full((B, 2), float(a))

    out = ccm.drive_batched(5, 2, launch)
    assert calls == [(0, 2, 2), (2, 4, 2), (4, 5, 2)]
    np.testing.assert_array_equal(out[:, 0], [0, 0, 2, 2, 4])


# ------------------------------------------------------- backoff helpers


def test_is_oom_error_markers():
    assert runner_mod.is_oom_error(RuntimeError("RESOURCE_EXHAUSTED: foo"))
    assert runner_mod.is_oom_error(Exception("Out of memory allocating"))
    assert runner_mod.is_oom_error(MemoryError())
    assert runner_mod.is_oom_error(
        RuntimeError("Execution failed: RESOURCE_EXHAUSTED: oom"))
    assert not runner_mod.is_oom_error(ValueError("shape mismatch"))
    # mentions memory mid-sentence ≠ an allocation failure: the anchored
    # match must not burn backoff retries on these
    assert not runner_mod.is_oom_error(
        ValueError("option 'out of memory handler' is unknown"))
    assert not runner_mod.is_oom_error(
        RuntimeError("watchdog saw the job run out of memory budget"))


def test_torch_cuda_oom_classified_by_type():
    """PyTorch's OOM message fails the anchored markers ("CUDA out of
    memory." is not "Out of memory"); its type makes it an OOM. The
    reference's classifier would call it unclassified."""
    e = OOM_ERRORS["torch_cuda_oom"]()
    assert isinstance(e, RuntimeError)
    assert runner_mod.is_oom_error(e)
    assert not jrunner.is_oom_error(e)
    # a kernel's own cudaErrorMemoryAllocation raises the same type
    from repro_torch.kernels import _build
    with pytest.raises(torch.cuda.OutOfMemoryError) as exc:
        _build.check(_build.CUDA_ERROR_MEMORY_ALLOCATION, "knn_batch_launch")
    assert runner_mod.is_oom_error(exc.value)
    with pytest.raises(RuntimeError, match="cudaError_t 700") as exc:
        _build.check(700, "knn_batch_launch")
    assert not runner_mod.is_oom_error(exc.value)


def test_halved_batch_equalizes():
    # cap 8 over 20 remaining rows → 3 launches of ceil(20/3)=7
    assert runner_mod.halved_batch(16, 20) == 7
    assert runner_mod.halved_batch(2, 100) == 1  # floor
    assert runner_mod.halved_batch(8, 3) == 3    # cap clamps to remaining
    for B, rem in [(16, 20), (2, 100), (8, 3), (154, 128), (26, 1)]:
        assert runner_mod.halved_batch(B, rem) == \
            jrunner.halved_batch(B, rem)


def test_run_key_ignores_perf_knobs_only():
    """Resuming with a different batch size / snapshot cadence is legal
    (results are B-invariant); any numeric knob changes the key."""
    X = _panel()
    base = run_key(X, _cfg(E=3), SIG)
    assert run_key(X, _cfg(E=3, batch_libs=2, checkpoint_every=5,
                           oom_retries=1, run_tile_rows=2,
                           checkpoint_keep=7, batch_budget_mb=4.0),
                   SIG) == base
    assert run_key(X, _cfg(E=4), SIG) != base
    assert run_key(X, _cfg(E=3, tau=2), SIG) != base
    assert run_key(X * 2.0, _cfg(E=3), SIG) != base
    assert run_key(X, _cfg(E=3), ("xmap", "smap", 1.0, ((3, 6),))) != base
    # a tensor panel keys as its numpy bytes, wherever it lives
    assert run_key(torch.as_tensor(X), _cfg(E=3), SIG) == base


def test_run_key_separates_device_type_and_package():
    X = _panel()
    cpu = run_key(X, _cfg(E=3), SIG)
    cuda = run_key(X, EDMConfig(E=3, device="cuda"), SIG)
    assert cuda != cpu
    # by type only: the card's index does not change the bits
    assert run_key(X, EDMConfig(E=3, device="cuda:1"), SIG) == cuda
    assert "package='repro_torch'" in runner_mod.config_fingerprint(_cfg())
    assert "device='cpu'" in runner_mod.config_fingerprint(_cfg())
    # the reference's key of the same panel/config/task is another key
    from repro.edm import EDMConfig as JConfig
    assert jrunner.run_key(X, JConfig(E=3), SIG) not in (cpu, cuda)


def test_journal_of_the_other_device_refused(tmp_path):
    """A run_dir journaled under the CUDA key (the kernels' bits) is
    refused by a CPU session (the plain versions' bits)."""
    X = _panel()
    run = tmp_path / "run"
    e_table = np.full(6, 3, np.int32).tobytes()
    key = run_key(X, EDMConfig(E=3, batch_libs=2, device="cuda"),
                  ("xmap", "simplex", None, e_table))
    MatrixRunner(str(run), key=key, shape=(6, 6),
                 groups_sig=[[3, 6]]).close()
    with pytest.raises(ValueError, match="DIFFERENT run"):
        EDM(X, _cfg(E=3, batch_libs=2)).xmap(run_dir=str(run))


def test_journal_of_the_reference_package_refused(tmp_path):
    """A run_dir the JAX package journaled is never resumed by the port."""
    X = _panel()
    run = tmp_path / "run"
    JEDM(X, E=3, batch_libs=2, impl="ref").xmap(run_dir=str(run))
    with pytest.raises(ValueError, match="DIFFERENT run"):
        EDM(X, _cfg(E=3, batch_libs=2)).xmap(run_dir=str(run))


# ------------------------------------------------- journaled local runs


def test_journaled_xmap_bit_identical_and_reported(tmp_path):
    X = _panel()
    ref = EDM(X, _cfg(E=3, batch_libs=2)).xmap()
    run = tmp_path / "run"
    got = EDM(X, _cfg(E=3, batch_libs=2)).xmap(run_dir=str(run))
    np.testing.assert_array_equal(ref, got)
    rep = _report(run)
    assert rep["status"] == "complete"
    assert rep["rows_done"] == rep["rows_total"] == 6
    assert rep["stragglers"]["steps"] == 3  # ceil(6/2) launch timings
    assert len((run / "heartbeat").read_text().splitlines()) == 3
    manifest = json.loads((run / "run.json").read_text())
    assert manifest["status"] == "complete" and manifest["groups"] == [[3, 6]]


@pytest.mark.parametrize("method", ["simplex", "smap"])
def test_journaled_master_and_smap_routes_bit_identical(tmp_path, method):
    """The master route (E_opt from the session's sweep, one tile group
    per E) and the S-Map route journal to the plain matrices' bits."""
    X = _panel()
    sess = EDM(X, _cfg(E_max=4, batch_libs=4))
    sess.optimal_E()
    plain = sess.xmap(method=method)
    run = tmp_path / "run"
    got = sess.xmap(method=method, run_dir=str(run))
    np.testing.assert_array_equal(plain, got)
    fresh = EDM(X, _cfg(E_max=4)).xmap(method=method)
    np.testing.assert_array_equal(fresh, got)  # B-invariant too
    groups = json.loads((run / "run.json").read_text())["groups"]
    E_opt = sess.optimal_E()[0]
    assert groups == [[int(e), int((E_opt == e).sum())]
                      for e in np.unique(E_opt)]


def test_journaled_xmap_matches_reference_session(tmp_path):
    X = _panel()
    want = JEDM(X, E_max=4, impl="ref").xmap()
    got = EDM(X, _cfg(E_max=4)).xmap(run_dir=str(tmp_path / "run"))
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=ATOL)
    want3 = JEDM(X, E=3, impl="ref").xmap(method="smap")
    got3 = EDM(X, _cfg(E=3)).xmap(method="smap",
                                  run_dir=str(tmp_path / "smap"))
    np.testing.assert_allclose(got3, np.asarray(want3), rtol=0, atol=1e-4)


def test_completed_run_short_circuits_without_launches(tmp_path, monkeypatch):
    X = _panel()
    run = tmp_path / "run"
    ref = EDM(X, _cfg(E=3, batch_libs=2)).xmap(run_dir=str(run))

    def boom(*a, **k):  # any engine launch on the re-run is a failure
        raise AssertionError("completed journal must not recompute")

    monkeypatch.setattr(ccm, "_group_step", boom)
    sess = EDM(X, _cfg(E=3, batch_libs=2))
    with telemetry.record() as rec:
        np.testing.assert_array_equal(sess.xmap(run_dir=str(run)), ref)
    assert sess.stats["runs_short_circuited"] == 1
    assert rec.counter_delta("edm_launches") == 0


def test_stale_journal_refused(tmp_path):
    X = _panel()
    run = tmp_path / "run"
    EDM(X, _cfg(E=3, batch_libs=2)).xmap(run_dir=str(run))
    with pytest.raises(ValueError, match="DIFFERENT run"):
        EDM(X * 1.5, _cfg(E=3, batch_libs=2)).xmap(run_dir=str(run))
    with pytest.raises(ValueError, match="DIFFERENT run"):
        EDM(X, _cfg(E=4, batch_libs=2)).xmap(run_dir=str(run))


def test_changed_e_table_same_group_sizes_refused(tmp_path):
    """The run key hashes the FULL per-series E table: permuting E_opt
    while keeping group sizes (here {2:3, 3:3} both times) must key to
    a different run, not silently resume the stale journal."""
    X = _panel(6)
    cfg = _cfg(E=3, batch_libs=2)
    run = tmp_path / "run"
    EDM(X, cfg).xmap(E_opt=[2, 2, 2, 3, 3, 3], run_dir=str(run))
    with pytest.raises(ValueError, match="DIFFERENT run"):
        EDM(X, cfg).xmap(E_opt=[3, 3, 3, 2, 2, 2], run_dir=str(run))


def test_run_dir_single_writer_lock(tmp_path):
    """A second live MatrixRunner on the same run_dir fails fast; the
    lock releases on close() so a sequential resume still works."""
    d = str(tmp_path / "run")
    r1 = MatrixRunner(d, key="k", shape=(4, 4), groups_sig=[[2, 4]])
    with pytest.raises(RuntimeError, match="locked by another live run"):
        MatrixRunner(d, key="k", shape=(4, 4), groups_sig=[[2, 4]])
    r1.close()
    MatrixRunner(d, key="k", shape=(4, 4), groups_sig=[[2, 4]]).close()


def _sigterm_on_launch(monkeypatch, n_kill=2, target="_group_step",
                       module=ccm):
    """Wrap an engine step so that its ``n_kill``-th launch delivers
    SIGTERM to this process (tile 0 is then in flight, not committed)."""
    orig = getattr(module, target)
    n = {"launches": 0}

    def wrapped(*a, **k):
        n["launches"] += 1
        if n["launches"] == n_kill:
            os.kill(os.getpid(), signal.SIGTERM)
        return orig(*a, **k)

    monkeypatch.setattr(module, target, wrapped)
    return orig


def test_preempt_then_resume_recomputes_no_committed_tile(
        tmp_path, monkeypatch):
    """SIGTERM mid-run → snapshot + SystemExit(17); the rerun drives only
    the tiles the journal does not hold and is bit-identical."""
    X = _panel()
    cfg = _cfg(E=3, batch_libs=2)
    ref = EDM(X, cfg).xmap()
    run = tmp_path / "run"
    orig = _sigterm_on_launch(monkeypatch)
    with pytest.raises(SystemExit) as exc:
        EDM(X, cfg).xmap(run_dir=str(run))
    assert exc.value.code == PREEMPTED_EXIT
    assert signal.getsignal(signal.SIGTERM) == signal.SIG_DFL  # restored
    rep = _report(run)
    assert rep["status"] == "preempted" and 0 < rep["rows_done"] < 6

    resumed = {"launches": 0}

    def counting(*a, **k):
        resumed["launches"] += 1
        return orig(*a, **k)

    monkeypatch.setattr(ccm, "_group_step", counting)
    sess = EDM(X, cfg)
    got = sess.xmap(run_dir=str(run))
    np.testing.assert_array_equal(ref, got)
    assert resumed["launches"] == 2  # 3 tiles total, 1 was journaled
    rep = _report(run)
    assert rep["status"] == "complete" and rep["rows_resumed"] == 2
    assert sess.stats["rows_resumed"] == 2


def test_resume_at_another_batch_size_bit_identical(tmp_path, monkeypatch):
    """The master route, preempted at B = 2 and resumed at B = 3: rows are
    the journal's unit, so the resume re-tiles the remaining rows."""
    X = _panel()
    sess = EDM(X, _cfg(E=3, batch_libs=2))
    sess.optimal_E()
    iM = sess._master(3)[1]
    ref = sess.xmap()
    run = tmp_path / "run"
    import repro_torch.edm.plan as plan
    orig = _sigterm_on_launch(monkeypatch, target="_master_group_step",
                              module=plan)
    with pytest.raises(SystemExit):
        sess.xmap(run_dir=str(run))
    done = _report(run)["rows_done"]
    assert done == 2
    calls = []

    def counting(Xb, *a, **k):
        calls.append(Xb.shape[0])
        return orig(Xb, *a, **k)

    monkeypatch.setattr(plan, "_master_group_step", counting)
    sess2 = EDM(X, _cfg(E=3, batch_libs=3))
    sess2._cache["master"] = sess._cache["master"]
    assert sess2._master(3)[1] is iM
    np.testing.assert_array_equal(sess2.xmap(run_dir=str(run)), ref)
    assert calls == [3, 3]  # rows 2..5 at B = 3: 4 rows, 2 launches


@pytest.mark.parametrize("kind", sorted(OOM_ERRORS))
def test_oom_triggers_halve_b_retry(tmp_path, monkeypatch, kind):
    """An injected OOM halves B (equalized) and the run completes
    bit-identically, with the decision logged in the report."""
    X = _panel()
    ref = EDM(X, _cfg(E=3, batch_libs=2)).xmap()
    orig = ccm._group_step
    fail = {"armed": True}

    def oom_once(*a, **k):
        if fail["armed"]:
            fail["armed"] = False
            raise OOM_ERRORS[kind]()
        return orig(*a, **k)

    monkeypatch.setattr(ccm, "_group_step", oom_once)
    run = tmp_path / "run"
    got = EDM(X, _cfg(E=3, batch_libs=6)).xmap(run_dir=str(run))
    np.testing.assert_array_equal(ref, got)
    trail = _report(run)["oom_backoff"]
    assert [t["action"] for t in trail] == ["halve"]
    assert trail[0]["B"] == 6 and trail[0]["to_B"] == 3


def test_oom_retry_holds_no_tensor_of_the_failed_tiles(tmp_path,
                                                       monkeypatch):
    """The tile in flight when the OOM lands is released before the next
    rung's first launch, without a garbage collection."""
    X = _panel()
    orig = ccm._group_step
    refs, n = [], {"calls": 0}

    def step(*a, **k):
        n["calls"] += 1
        if n["calls"] == 2:  # tile 0 is in flight
            raise OOM_ERRORS["torch_cuda_oom"]()
        if n["calls"] == 3:  # the next rung's first launch
            assert refs[0]() is None, "the in-flight tile is still held"
        out = orig(*a, **k)
        refs.append(weakref.ref(out))
        return out

    monkeypatch.setattr(ccm, "_group_step", step)
    was_enabled = gc.isenabled()
    gc.disable()
    try:
        got = EDM(X, _cfg(E=3, batch_libs=2)).xmap(
            run_dir=str(tmp_path / "run"))
    finally:
        if was_enabled:
            gc.enable()
    assert n["calls"] == 8  # tile 0 lost, the OOM, 6 rows at B = 1
    monkeypatch.setattr(ccm, "_group_step", orig)
    np.testing.assert_array_equal(got, EDM(X, _cfg(E=3)).xmap())


def test_oom_retries_bounded(tmp_path, monkeypatch):
    X = _panel()

    def always_oom(*a, **k):
        raise RuntimeError("RESOURCE_EXHAUSTED: out of memory")

    monkeypatch.setattr(ccm, "_group_step", always_oom)
    run = tmp_path / "run"
    with pytest.raises(RuntimeError, match="RESOURCE_EXHAUSTED"):
        EDM(X, _cfg(E=3, batch_libs=4, oom_retries=2)).xmap(
            run_dir=str(run))
    trail = _report(run)["oom_backoff"]
    assert [t["action"] for t in trail] == ["halve", "halve", "give_up"]


def test_non_oom_errors_propagate_unretried(tmp_path, monkeypatch):
    X = _panel()
    calls = {"n": 0}

    def broken(*a, **k):
        calls["n"] += 1
        raise ValueError("not a memory problem")

    monkeypatch.setattr(ccm, "_group_step", broken)
    with pytest.raises(ValueError, match="not a memory problem"):
        EDM(X, _cfg(E=3, batch_libs=2)).xmap(run_dir=str(tmp_path / "run"))
    assert calls["n"] == 1


def test_memory_mention_unretried_but_recorded(tmp_path, monkeypatch):
    """An error that mentions memory without the anchored OOM markers
    propagates on the first launch (no halve-B retries burned) and the
    report's trail records it as unclassified."""
    X = _panel()
    calls = {"n": 0}

    def broken(*a, **k):
        calls["n"] += 1
        raise ValueError("plugin 'out of memory watcher' failed to load")

    monkeypatch.setattr(ccm, "_group_step", broken)
    run = tmp_path / "run"
    with pytest.raises(ValueError, match="failed to load"):
        EDM(X, _cfg(E=3, batch_libs=2, oom_retries=4)).xmap(
            run_dir=str(run))
    assert calls["n"] == 1
    trail = _report(run)["oom_backoff"]
    assert [t["action"] for t in trail] == ["unclassified"]


def test_runner_refuses_finalize_with_missing_group(tmp_path):
    r = MatrixRunner(str(tmp_path / "run"), key="k", shape=(4, 4),
                     groups_sig=[[2, 4]])
    try:
        with pytest.raises(RuntimeError, match="not driven"):
            r.finalize()
    finally:
        r.close()  # detach the run's telemetry sink + release the lock


def test_masked_session_journal_names_invalid_series(tmp_path):
    X = _panel(6).copy()
    X[1, 3] = np.nan
    X[4, :] = 1.0
    sess = EDM(X, _cfg(E=3, on_invalid="mask"))
    run = tmp_path / "run"
    rho = sess.xmap(run_dir=str(run))
    bad, good = [1, 4], [0, 2, 3, 5]
    assert np.isnan(rho[bad, :]).all() and np.isnan(rho[:, bad]).all()
    np.testing.assert_array_equal(rho, sess.xmap())
    assert [r["index"] for r in _report(run)["invalid_series"]] == bad
    clean = EDM(X[good], _cfg(E=3)).xmap()
    np.testing.assert_array_equal(rho[np.ix_(good, good)], clean)


# --------------------------------------------- checkpoint restore hygiene


def test_corrupt_checkpoint_leaf_named_in_error(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ck"), keep=2)
    state = {"rho": np.ones((3, 3), np.float32), "done": np.zeros(3, bool)}
    mgr.save(1, state)
    leaf = os.path.join(mgr._step_dir(1), "leaf_00000.npy")
    with open(leaf, "wb") as f:
        f.write(b"\x00" * 8)  # truncated garbage
    with pytest.raises(ValueError, match="leaf 0 is unreadable"):
        mgr.restore(state, step=1)


def test_swapped_checkpoint_leaf_fails_manifest_check(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ck"), keep=2)
    state = {"a": np.ones((3, 3), np.float32), "b": np.zeros(3, bool)}
    mgr.save(1, state)
    leaf = os.path.join(mgr._step_dir(1), "leaf_00000.npy")
    np.save(leaf, np.ones((2, 2), np.float32))  # wrong shape vs manifest
    with pytest.raises(ValueError, match="does not match its manifest"):
        mgr.restore(state, step=1)


def test_checkpoint_round_trip_tensors_and_retention(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ck"), keep=2)
    state = {"z": [torch.arange(4.0), (np.eye(2, dtype=np.float32),)],
             "a": torch.ones(2, 3, dtype=torch.int32)}
    for step in (1, 5, 9):
        mgr.save(step, state)
    assert mgr.steps() == [5, 9] and mgr.latest_step() == 9
    like = {"a": torch.zeros(2, 3, dtype=torch.int32),
            "z": [torch.zeros(4), (np.zeros((2, 2), np.float32),)]}
    out = mgr.restore(like)
    assert list(out) == ["a", "z"]
    assert torch.equal(out["a"], state["a"])
    assert torch.equal(out["z"][0], state["z"][0])
    assert isinstance(out["z"][1], tuple)
    np.testing.assert_array_equal(out["z"][1][0], np.eye(2))
    with pytest.raises(ValueError, match="leaves"):
        mgr.restore({"a": like["a"]})
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore(like)


# ------------------------------------------------- straggler threshold


def test_straggler_monitor_synthetic_clock_and_threshold():
    """Replay a timing sequence through an injected clock — six nominal
    1s launches then a 4× outlier. The outlier flips the flag at
    threshold 3, not at threshold 8, and the flag publishes both the
    counter and the straggler.flag event."""
    t = {"now": 0.0}

    def clock():
        return t["now"]

    def replay(mon):
        for step in range(6):
            mon.start()
            t["now"] += 1.0
            assert mon.stop(step) is False
        mon.start()
        t["now"] += 4.0
        return mon.stop(6)

    with telemetry.record() as rec:
        mon = StragglerMonitor(threshold=3.0, window=10, clock=clock)
        assert replay(mon) is True
    assert rec.counter_delta("edm_stragglers_flagged") == 1
    ev = rec.events_named("straggler.flag")[0]["attrs"]
    assert ev["step"] == 6 and ev["threshold"] == 3.0
    assert ev["seconds"] == pytest.approx(4.0)
    assert mon.report()["flagged"][0]["rolling_median_s"] == 1.0

    lax = StragglerMonitor(threshold=8.0, window=10, clock=clock)
    assert replay(lax) is False
    assert lax.report()["flagged"] == []


@pytest.mark.parametrize("field,value", [
    ("straggler_threshold", 0.0), ("checkpoint_keep", 0),
    ("checkpoint_every", 0), ("oom_retries", -1), ("run_tile_rows", 0)])
def test_journal_config_validation(field, value):
    from repro.edm import EDMConfig as JConfig
    with pytest.raises(ValueError) as want:
        JConfig(**{field: value})
    with pytest.raises(ValueError, match=str(want.value)):
        _cfg(**{field: value})


def test_straggler_threshold_keyed_out():
    with pytest.raises(ValueError):
        StragglerMonitor(threshold=-1.0)
    X = _panel()
    assert run_key(X, _cfg(E=3, straggler_threshold=9.0), SIG) \
        == run_key(X, _cfg(E=3), SIG)


# --------------------------------------- end-to-end run artifacts


def test_e2e_journaled_run_produces_all_telemetry_artifacts(tmp_path):
    """A journaled xmap emits the JSONL span log, folds Prometheus
    metrics into report.json, counts every pair exactly once, and the
    run inspector renders the result from artifacts alone."""
    X = _panel()
    run = tmp_path / "run"
    cfg = _cfg(E=3, batch_libs=2, straggler_threshold=5.0)
    with telemetry.record() as rec:
        got = EDM(X, cfg).xmap(run_dir=str(run))
    assert got.shape == (6, 6)
    assert rec.counter_delta("edm_pairs_total") == 36
    assert rec.counter_delta("edm_runs_started") == 1
    assert rec.spans("session.xmap") and rec.spans("engine.drive")
    assert rec.events_named("run.start") and rec.events_named("run.complete")

    log = run / "telemetry" / "events.jsonl"
    assert log.exists()
    assert schema.validate_events_file(str(log)) == []
    names = [json.loads(line)["name"]
             for line in log.read_text().splitlines()]
    assert "run.start" in names and "run.complete" in names
    assert "engine.drive" in names  # spans land in the on-disk log too

    rep = _report(run)
    assert rep["status"] == "complete"
    assert rep["rows_done"] == rep["rows_total"] == 6
    assert rep["pairs_done"] == 36 and rep["pairs_per_s"] > 0
    assert rep["tiles_committed"] == 3  # ceil(6/2)
    assert rep["stragglers"]["threshold"] == 5.0  # config threaded through
    prom = rep["metrics_prom"]
    assert "edm_pairs_total" in prom
    assert "edm_launch_latency_seconds_bucket" in prom
    assert "edm_launch_latency_seconds_count" in prom

    info = edm_inspect.inspect_run(str(run))
    assert info["status"] == "complete"
    assert info["rows_done"] == 6
    assert info["pairs_per_s"] == rep["pairs_per_s"]
    assert info["heartbeat_age_s"] is not None
    text = edm_inspect.format_summary(info)
    assert "status: complete" in text and "rows: 6/6" in text
    assert "run.complete" in text
    assert edm_inspect.main([str(run)]) == 0
    assert edm_inspect.main([str(tmp_path / "nope")]) == 2


def test_inspector_tolerates_partial_run_dir(tmp_path):
    info = edm_inspect.inspect_run(str(tmp_path))
    assert info["status"] is None and info["rows_done"] is None
    assert "no run.json" in edm_inspect.format_summary(info)


def test_inspector_and_schema_clis_as_modules(tmp_path):
    run = tmp_path / "run"
    EDM(_panel(), _cfg(E=3, batch_libs=2)).xmap(run_dir=str(run))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.edm.inspect", str(run)],
        env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert "status: complete" in res.stdout and "rows: 6/6" in res.stdout
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.telemetry.schema",
         str(run / "telemetry" / "events.jsonl")],
        env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0 and "schema OK" in res.stdout, res.stderr


def test_resume_lineage_in_manifest_and_report(tmp_path, monkeypatch):
    """Kill → resume: the manifest accumulates one attempt record per
    process, the final report names the prior attempt's run_id, keeps
    cumulative wall time across attempts, and the telemetry log holds
    both lifecycle events."""
    X = _panel()
    cfg = _cfg(E=3, batch_libs=2)
    ref = EDM(X, cfg).xmap()
    run = tmp_path / "run"
    orig = _sigterm_on_launch(monkeypatch)
    with pytest.raises(SystemExit) as exc:
        EDM(X, cfg).xmap(run_dir=str(run))
    assert exc.value.code == PREEMPTED_EXIT
    manifest = json.loads((run / "run.json").read_text())
    assert len(manifest["attempts"]) == 1
    first = manifest["attempts"][0]
    assert first["status"] == "preempted" and first["rows_resumed"] == 0
    rep1 = _report(run)
    assert rep1["status"] == "preempted" and rep1["prior_run_ids"] == []

    monkeypatch.setattr(ccm, "_group_step", orig)
    got = EDM(X, cfg).xmap(run_dir=str(run))
    np.testing.assert_array_equal(ref, got)
    manifest = json.loads((run / "run.json").read_text())
    assert len(manifest["attempts"]) == 2
    assert manifest["attempts"][0] == first  # history is append-only
    second = manifest["attempts"][1]
    assert second["status"] == "complete"
    assert second["run_id"] != first["run_id"]
    assert second["rows_resumed"] == rep1["rows_done"] > 0

    rep = _report(run)
    assert rep["status"] == "complete"
    assert rep["prior_run_ids"] == [first["run_id"]]
    assert rep["run_id"] == second["run_id"]
    assert rep["rows_resumed"] + rep["rows_this_attempt"] == 6
    assert rep["cumulative_elapsed_s"] >= rep["elapsed_s"]
    assert rep["cumulative_elapsed_s"] == pytest.approx(
        first["elapsed_s"] + rep["elapsed_s"], abs=1e-6)

    names = [json.loads(line)["name"] for line in
             (run / "telemetry" / "events.jsonl").read_text().splitlines()]
    assert "run.start" in names and "run.resume" in names
    text = edm_inspect.format_summary(edm_inspect.inspect_run(str(run)))
    assert "attempts: 2" in text


# ------------------------------------------- subprocess kill-and-resume


CHILD = textwrap.dedent("""
    import os, signal, sys
    import numpy as np
    from repro_torch.core import ccm
    from repro_torch.data import timeseries as ts
    from repro_torch.edm import EDM, EDMConfig
    panel, _ = ts.forced_network_panel(6, 220, seed=3)
    mode, run, B = sys.argv[1], sys.argv[2], int(sys.argv[3])
    cfg = EDMConfig(E=3, batch_libs=B, device="cpu")
    orig = ccm._group_step
    n = {"launches": 0}
    def wrapped(*a, **k):
        n["launches"] += 1
        if mode == "kill" and n["launches"] == 2:
            os.kill(os.getpid(), signal.SIGTERM)
        return orig(*a, **k)
    ccm._group_step = wrapped
    rho = EDM(panel, cfg).xmap(run_dir=run)
    np.save(os.path.join(run, f"{mode}.npy"), rho)
    print(f"LAUNCHES={n['launches']}")
""")


def test_subprocess_sigterm_kill_and_resume(tmp_path):
    """A real process: SIGTERM lands mid-run, the interpreter exits with
    PREEMPTED_EXIT, and a second process — at another batch size —
    resumes bit-identically while recomputing none of the committed
    tiles."""
    run = str(tmp_path / "run")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))

    def child(mode, path, B):
        return subprocess.run([sys.executable, "-c", CHILD, mode, path,
                               str(B)], env=env, capture_output=True,
                              text=True, timeout=120)

    kill = child("kill", run, 2)
    assert kill.returncode == PREEMPTED_EXIT, kill.stderr
    with open(os.path.join(run, "report.json")) as f:
        assert json.load(f)["status"] == "preempted"
    resume = child("resume", run, 4)
    assert resume.returncode == 0, resume.stderr
    assert "LAUNCHES=1" in resume.stdout  # rows 2..5 at B = 4
    fresh = child("fresh", str(tmp_path / "fresh"), 2)
    assert fresh.returncode == 0, fresh.stderr
    assert "LAUNCHES=3" in fresh.stdout
    np.testing.assert_array_equal(
        np.load(os.path.join(run, "resume.npy")),
        np.load(os.path.join(str(tmp_path / "fresh"), "fresh.npy")))
