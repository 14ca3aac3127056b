"""Chaos suite for the port's serving stack, on the CPU.

Seeded fault-injection scenarios (the reference's 20 seeds, rates and
size) drive randomized append and query traffic through a live
``repro_torch.serving.EDMServer`` with worker deaths, launch errors,
OOM-shaped errors, slow launches and WAL write failures, then check:

* **Liveness** — every accepted request resolves: a result or an allowed
  typed error. A future is hung only if ``concurrent.futures.wait`` runs
  out with it not done. ``DeadlineExceeded`` subclasses ``TimeoutError``,
  which since Python 3.11 is also ``concurrent.futures.TimeoutError``, so
  a future that resolved with it must not be mistaken for a hung one by
  ``except TimeoutError`` around ``fut.result(timeout=...)``.
* **Linearizability** — every successful ``ccm`` answer is bit-identical
  to a cold session after exactly the successful appends submitted before
  it, and every successful append's version is its rank among them.
  After ``close`` → ``recover`` the panel is at version = #successful
  appends and serves those bits.

Every append carries the same delta, so the state after k commits
depends only on k: one cold session per k answers for every schedule.
The fault injector's draws equal the reference's, point by point.
"""

import bisect
import concurrent.futures
import threading
import time

import numpy as np
import pytest

from repro.serving import FaultInjector as JFaultInjector
from repro_torch import telemetry
from repro_torch.data import timeseries as ts
from repro_torch.edm import EDM, EDMConfig
from repro_torch.serving import (DeadlineExceeded, Draining, EDMServer,
                                 FaultInjector, Overloaded, PanelQuarantined,
                                 WalError)
from repro_torch.serving.faultinject import (POINTS, InjectedFault,
                                             InjectedWalError,
                                             InjectedWorkerDeath)

N, L0, DL = 4, 120, 3
MAX_APPENDS = 8
WATCH = [(0, 1), (1, 2), (2, 3), (3, 0)]
ES = (2, 3)
CFG = dict(E_max=3, cache=True, device="cpu")
RESOLVE_S = 120

_DATA: dict = {}
_ORACLE: dict[int, dict] = {}


def _panel():
    if not _DATA:
        _DATA["panel"] = np.asarray(ts.forced_network_panel(N, L0, seed=5)[0],
                                    np.float32)
        _DATA["delta"] = np.random.default_rng(7).standard_normal(
            (N, DL)).astype(np.float32)
    return _DATA["panel"], _DATA["delta"]


def oracle(k: int) -> dict:
    """Singleton answers after ``k`` commits (a cold session)."""
    if k not in _ORACLE:
        panel, delta = _panel()
        grown = np.concatenate([panel] + [delta] * k, axis=1)
        sess = EDM(grown, EDMConfig(**CFG))
        _ORACLE[k] = {E: [np.float32(v) for v in sess.ccm_batch(WATCH, E=E)]
                      for E in ES}
    return _ORACLE[k]


def resolve(fut, timeout=RESOLVE_S):
    """(result, None) or (None, exception) of a future that resolved;
    fails the test if it did not resolve within ``timeout``."""
    done, _ = concurrent.futures.wait([fut], timeout=timeout)
    if fut not in done or not fut.done():
        pytest.fail(f"hung future: ticket {getattr(fut, 'ticket', '?')}")
    exc = fut.exception()
    return (None, exc) if exc is not None else (fut.result(), None)


# --------------------------------------------------- the fault injector


def test_fault_injector_draws_equal_the_reference_and_are_seeded():
    rates = {p: 0.5 for p in POINTS}
    seqs = {}
    for name, cls, seed in (("a", FaultInjector, 3), ("b", FaultInjector, 3),
                            ("c", FaultInjector, 4), ("j", JFaultInjector, 3)):
        fi = cls(seed=seed, rates=rates)
        seqs[name] = {p: [fi.fire(p) for _ in range(50)] for p in POINTS}
    assert seqs["a"] == seqs["b"] == seqs["j"]
    assert seqs["a"] != seqs["c"]
    d = FaultInjector(seed=3, rates=rates)       # streams are per point
    assert [d.fire("wal_write") for _ in range(50)] == \
        seqs["a"]["wal_write"]


def test_fault_injector_max_fires_counters_and_errors():
    fi = FaultInjector(seed=0, rates={"launch_error": 1.0}, max_fires=2)
    hits = [fi.fire("launch_error") for _ in range(10)]
    assert sum(hits) == 2 and hits[:2] == [True, True]
    assert fi.calls["launch_error"] == 10 and fi.fired["launch_error"] == 2
    with pytest.raises(InjectedFault, match="RESOURCE_EXHAUSTED"):
        FaultInjector(rates={"launch_oom": 1.0}).check("launch_oom")
    with pytest.raises(InjectedWalError, match="injected WAL"):
        FaultInjector(rates={"wal_write": 1.0}).check("wal_write")
    with pytest.raises(ValueError, match="unknown fault points"):
        FaultInjector(rates={"nope": 1.0})
    assert issubclass(InjectedWorkerDeath, BaseException)
    assert not issubclass(InjectedWorkerDeath, Exception)


# ------------------------------------------------------ chaos scenarios


def _allowed(exc: BaseException) -> bool:
    if isinstance(exc, (Overloaded, DeadlineExceeded, PanelQuarantined,
                        Draining, InjectedFault, OSError, WalError)):
        return True
    return (isinstance(exc, RuntimeError)
            and str(exc).startswith(("serve worker died",
                                     "scheduler closed")))


RATES = {"worker_death": 0.08, "launch_error": 0.08,
         "launch_oom": 0.05, "slow_launch": 0.10, "wal_write": 0.03}


@pytest.mark.parametrize("seed", range(20))
def test_chaos_scenario_liveness_and_linearizability(seed, tmp_path):
    panel, delta = _panel()
    rng = np.random.default_rng((20260808, seed))
    sd = str(tmp_path / "state")
    fi = FaultInjector(seed=seed, rates=RATES, slow_s=0.005)
    srv = EDMServer(state_dir=sd, compact_every=4, workers=2,
                    supervise=True, max_queue_depth=64,
                    quarantine_after=3, faults=fi,
                    revive_backoff_s=(0.01, 0.1))
    srv.scheduler.supervise_interval = 0.02
    submitted = []      # (kind, fut, ticket, j, E, deadline_zero)
    n_appends = 0
    try:
        srv.register_panel("cp", panel, **CFG)
        for _ in range(28):
            do_append = n_appends < MAX_APPENDS and rng.random() < 0.3
            try:
                if do_append:
                    n_appends += 1
                    f = srv.submit("append", "cp", delta=delta)
                    submitted.append(("append", f, f.ticket, None, None,
                                      False))
                else:
                    j = int(rng.integers(len(WATCH)))
                    E = int(rng.choice(ES))
                    kw = {}
                    if rng.random() < 0.1:
                        kw["deadline_s"] = 0.0   # guaranteed to expire
                    f = srv.submit("ccm", "cp", lib=WATCH[j][0],
                                   target=WATCH[j][1], E=E, **kw)
                    submitted.append(("ccm", f, f.ticket, j, E, bool(kw)))
            except Exception as exc:  # refused at admission
                assert _allowed(exc), f"submit raised {exc!r}"

        # ---- liveness: every accepted future resolves
        outcomes = []
        for kind, fut, ticket, j, E, zero in submitted:
            res, exc = resolve(fut)
            if exc is not None:
                assert _allowed(exc), \
                    f"ticket {ticket} ({kind}) failed with {exc!r}"
                if zero:
                    # a 0-second deadline expires unless the request's
                    # batch failed first as a whole
                    assert isinstance(exc, (DeadlineExceeded, RuntimeError,
                                            PanelQuarantined)), exc
            else:
                assert not zero, f"ticket {ticket} beat a 0 s deadline"
            outcomes.append((kind, ticket, j, E, res))

        # ---- linearizability against the commit-count oracle
        ok_appends = sorted(t for k, t, _, _, r in outcomes
                            if k == "append" and r is not None)
        for rank, t in enumerate(ok_appends):
            res = next(o[4] for o in outcomes if o[1] == t)
            assert res["version"] == rank + 1
        for kind, ticket, j, E, res in outcomes:
            if kind != "ccm" or res is None:
                continue
            k = bisect.bisect_left(ok_appends, ticket)
            assert np.float32(res) == oracle(k)[E][j], \
                f"ticket {ticket}: served bits diverge from oracle[{k}]"
    finally:
        srv.close()

    # ---- crash recovery: durable state = the successful appends
    n_committed = len(ok_appends)
    rec = EDMServer.recover(sd, autostart=False)
    try:
        assert rec.recovery_report["cp"]["version"] == n_committed
        futs = rec.submit_many("ccm", "cp", [
            {"lib": l, "target": t, "E": 3} for l, t in WATCH])
        while rec.scheduler.drain_once():
            pass
        assert [np.float32(f.result()) for f in futs] == \
            oracle(n_committed)[3]
    finally:
        rec.close()


# ---------------------------------------------- supervisor, drain, quarantine


def test_supervisor_revives_a_dead_worker_and_service_resumes():
    panel, _ = _panel()
    fi = FaultInjector(seed=1, rates={"worker_death": 1.0}, max_fires=1)
    with telemetry.record() as rec:
        srv = EDMServer(workers=1, supervise=True, faults=fi,
                        revive_backoff_s=(0.01, 0.05))
        srv.scheduler.supervise_interval = 0.01
        try:
            srv.register_panel("sp", panel, **CFG)
            f = srv.submit("ccm", "sp", lib=0, target=1, E=3)
            _, exc = resolve(f, 30)
            assert isinstance(exc, RuntimeError)
            assert str(exc).startswith("serve worker died")
            deadline = time.monotonic() + 10
            while not srv.health()["ok"]:
                assert time.monotonic() < deadline, "never revived"
                time.sleep(0.01)
            got = srv.call("ccm", "sp", lib=0, target=1, E=3, timeout=30)
            assert np.float32(got) == oracle(0)[3][0]
            assert fi.fired["worker_death"] == 1
        finally:
            srv.close()
    assert rec.counter_delta("serve_worker_revives") >= 1
    assert rec.counter_delta("serve_worker_deaths") == 1


def test_drain_stops_admission_and_empties_the_queues():
    panel, delta = _panel()
    srv = EDMServer(autostart=False, workers=1)
    try:
        srv.register_panel("dp", panel, **CFG)
        futs = [srv.submit("append", "dp", delta=delta) for _ in range(3)]
        done = {}
        t = threading.Thread(
            target=lambda: done.setdefault("ok", srv.drain(timeout=30)))
        t.start()
        deadline = time.monotonic() + 5
        while not srv.scheduler._draining:
            assert time.monotonic() < deadline
            time.sleep(0.005)
        with pytest.raises(Draining):
            srv.submit("ccm", "dp", lib=0, target=1, E=3)
        assert srv.health()["ok"] is False
        while srv.scheduler.drain_once():
            pass
        t.join(timeout=30)
        assert done.get("ok") is True
        assert [f.result()["version"] for f in futs] == [1, 2, 3]
    finally:
        srv.close()


def test_quarantine_after_repeated_worker_deaths_and_operator_reset():
    panel, _ = _panel()
    fi = FaultInjector(seed=0, rates={"worker_death": 1.0}, max_fires=3)
    with telemetry.record() as rec:
        srv = EDMServer(workers=1, supervise=True, quarantine_after=3,
                        faults=fi, revive_backoff_s=(0.01, 0.05))
        srv.scheduler.supervise_interval = 0.01
        try:
            srv.register_panel("qp", panel, **CFG)
            failures = 0
            deadline = time.monotonic() + 30
            while "qp" not in srv.scheduler.quarantined_panels():
                assert time.monotonic() < deadline, "never quarantined"
                try:
                    srv.call("ccm", "qp", lib=0, target=1, E=3, timeout=30)
                except (RuntimeError, PanelQuarantined):
                    failures += 1
                time.sleep(0.02)
            assert failures >= 3
            with pytest.raises(PanelQuarantined):
                srv.submit("ccm", "qp", lib=0, target=1, E=3)
            assert srv.clear_quarantine("qp") is True
            got = srv.call("ccm", "qp", lib=0, target=1, E=3, timeout=30)
            assert np.float32(got) == oracle(0)[3][0]
        finally:
            srv.close()
    assert rec.counter_delta("serve_quarantined") == 1
