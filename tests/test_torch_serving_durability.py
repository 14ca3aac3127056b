"""The port's durable serving (WAL + crash recovery), master eviction and
the LRU byte budget, on the CPU.

With ``EDMServer(state_dir=...)`` every registration and accepted append
is durable before its future resolves, and ``EDMServer.recover`` rebuilds
each panel bit-identically at its last durable version: after appends,
compaction, a torn tail, an evicted master, a masked panel, a failed WAL
write, and a ``kill -9`` of the serving process between append ticks (a
subprocess). Eviction and lazy rebuild, and the LRU budget, answer as a
never-evicted session. A state dir written by ``repro``, or recovered onto
another device type, is refused with ``WalError``. Oracles are cold port
sessions; every equality is bitwise.
"""

import json
import os
import pathlib
import signal
import subprocess
import sys
import time

import numpy as np
import pytest

from repro import serving as jserving
from repro_torch import telemetry
from repro_torch.data import timeseries as ts
from repro_torch.edm import EDM, EDMConfig
from repro_torch.serving import (EDMServer, FaultInjector, PanelQuarantined,
                                 WalError)

ROOT = pathlib.Path(__file__).resolve().parent.parent
N, L0, DL = 4, 120, 3
CFG = dict(E_max=3, cache=True, device="cpu")
E_REQ = 3
PAIRS = [(0, 1), (1, 2), (2, 3), (3, 0)]


@pytest.fixture(scope="module")
def panel():
    return np.asarray(ts.forced_network_panel(N, L0, seed=11)[0], np.float32)


@pytest.fixture(scope="module")
def deltas():
    rng = np.random.default_rng(23)
    return [rng.standard_normal((N, DL)).astype(np.float32)
            for _ in range(6)]


def _drain_all(srv):
    while srv.scheduler.drain_once():
        pass


def _grown(panel, deltas, k):
    return panel if k == 0 else np.concatenate([panel, *deltas[:k]], axis=1)


def _served_ccm(srv, name, pairs=PAIRS):
    futs = srv.submit_many("ccm", name, [{"lib": l, "target": t, "E": E_REQ}
                                         for l, t in pairs])
    _drain_all(srv)
    return [np.float32(f.result()) for f in futs]


def _oracle_ccm(grown, pairs=PAIRS):
    sess = EDM(grown, EDMConfig(**CFG))
    return [np.float32(v) for v in sess.ccm_batch(pairs, E=E_REQ)]


def _append_all(srv, name, ds):
    for d in ds:
        srv.submit("append", name, delta=d)
        _drain_all(srv)


# ------------------------------------------------------------- recovery


def test_recover_bit_identical_and_keeps_appending(tmp_path, panel, deltas):
    sd = str(tmp_path / "state")
    with EDMServer(state_dir=sd, autostart=False) as srv:
        srv.register_panel("p", panel, **CFG)
        _served_ccm(srv, "p")                   # warm master: appends merge
        _append_all(srv, "p", deltas[:3])
    rec = EDMServer.recover(sd, autostart=False)
    try:
        info = rec.recovery_report["p"]
        assert (info["version"], info["replayed"],
                info["torn_tail_bytes"]) == (3, 3, 0)
        assert rec.registry.get("p").version == 3
        ds = rec.registry.get("p").sess.data
        assert ds.panel.device.type == "cpu" and ds._embeddings == {}
        assert _served_ccm(rec, "p") == _oracle_ccm(_grown(panel, deltas, 3))
        f = rec.submit("append", "p", delta=deltas[3])
        _drain_all(rec)
        assert f.result()["version"] == 4
        assert _served_ccm(rec, "p") == _oracle_ccm(_grown(panel, deltas, 4))
    finally:
        rec.close()


def test_compaction_bounds_replay_and_gcs_segments(tmp_path, panel, deltas):
    sd = str(tmp_path / "state")
    with EDMServer(state_dir=sd, autostart=False, compact_every=2) as srv:
        srv.register_panel("p", panel, **CFG)
        _append_all(srv, "p", deltas[:5])
        pdir = srv.registry.get("p").wal.pdir
        names = sorted(os.listdir(pdir))
    assert "snap-0000000004" in names and "wal-0000000004.log" in names
    assert not any(n.startswith(("snap-0000000002", "wal-0000000000",
                                 "wal-0000000002")) for n in names)
    with np.load(os.path.join(pdir, "snap-0000000004", "state.npz")) as z:
        np.testing.assert_array_equal(z["panel"], _grown(panel, deltas, 4))
    rec = EDMServer.recover(sd, autostart=False)
    try:
        info = rec.recovery_report["p"]
        assert (info["snapshot"], info["replayed"], info["version"]) == \
            (4, 1, 5)
        assert _served_ccm(rec, "p") == _oracle_ccm(_grown(panel, deltas, 5))
    finally:
        rec.close()


def test_torn_wal_tail_recovers_to_the_last_record_and_warns(
        tmp_path, panel, deltas):
    sd = str(tmp_path / "state")
    with EDMServer(state_dir=sd, autostart=False, compact_every=100) as srv:
        srv.register_panel("p", panel, **CFG)
        _append_all(srv, "p", deltas[:3])
        pdir = srv.registry.get("p").wal.pdir
    wal = pathlib.Path(pdir) / "wal-0000000000.log"
    wal.write_bytes(wal.read_bytes()[:-7])
    with pytest.warns(UserWarning, match="torn tail"):
        rec = EDMServer.recover(sd, autostart=False)
    try:
        info = rec.recovery_report["p"]
        assert info["version"] == 2 and info["torn_tail_bytes"] > 0
        assert _served_ccm(rec, "p") == _oracle_ccm(_grown(panel, deltas, 2))
    finally:
        rec.close()
    rec2 = EDMServer.recover(sd, autostart=False)
    assert rec2.recovery_report["p"]["torn_tail_bytes"] == 0
    rec2.close()


def test_mask_policy_panel_recovers_field_for_field(tmp_path):
    rng = np.random.default_rng(3)
    dirty = rng.standard_normal((4, 120)).astype(np.float32)
    dirty[1, 10] = np.nan
    d0 = rng.standard_normal((4, 5)).astype(np.float32)
    d1 = rng.standard_normal((4, 5)).astype(np.float32)
    d1[2, 3] = np.inf
    sd = str(tmp_path / "state")
    with EDMServer(state_dir=sd, autostart=False, compact_every=1) as srv, \
            EDMServer(autostart=False) as live:
        for s in (srv, live):
            s.register_panel("p", dirty, on_invalid="mask", **CFG)
            _append_all(s, "p", (d0, d1))
        want = live.registry.get("p").sess.data
        rec = EDMServer.recover(sd, autostart=False)
        try:
            ds = rec.registry.get("p").sess.data
            assert ds.panel.numpy().tobytes() == want.panel.numpy().tobytes()
            assert np.array_equal(ds.valid, want.valid)
            for k in ("cnt", "lo", "hi"):
                assert np.array_equal(ds._stats[k], want._stats[k])
            assert ds.invalid_report == want.invalid_report
            assert ds.on_invalid == "mask" and ds._embeddings == {}
            got = _served_ccm(rec, "p")
            assert np.isnan(got[:3]).all() and np.isfinite(got[3])
            np.testing.assert_array_equal(got, _served_ccm(live, "p"))
        finally:
            rec.close()


def test_wal_write_failure_quarantines_the_panel(tmp_path, panel, deltas):
    fi = FaultInjector(seed=0, rates={"wal_write": 1.0})
    sd = str(tmp_path / "state")
    with telemetry.record() as rec:
        with EDMServer(state_dir=sd, autostart=False, faults=fi) as srv:
            srv.register_panel("p", panel, **CFG)
            f = srv.submit("append", "p", delta=deltas[0])
            _drain_all(srv)
            with pytest.raises(OSError, match="injected WAL"):
                f.result(timeout=5)
            with pytest.raises(PanelQuarantined):
                srv.submit("ccm", "p", lib=0, target=1, E=E_REQ)
    assert rec.counter_delta("serve_quarantined") == 1
    rec2 = EDMServer.recover(sd, autostart=False)
    try:
        assert rec2.recovery_report["p"]["version"] == 0
        assert _served_ccm(rec2, "p") == _oracle_ccm(panel)
    finally:
        rec2.close()


# --------------------------------------------------------- refused dirs


def test_tampered_base_panel_refused(tmp_path, panel):
    sd = str(tmp_path / "state")
    with EDMServer(state_dir=sd, autostart=False) as srv:
        srv.register_panel("p", panel, **CFG)
        pdir = srv.registry.get("p").wal.pdir
    base = np.load(os.path.join(pdir, "base.npy"))
    base[0, 0] += 1.0
    np.save(os.path.join(pdir, "base.npy"), base)
    with pytest.raises(WalError, match="fingerprint"):
        EDMServer.recover(sd, autostart=False)


def test_state_dir_of_the_reference_package_refused(tmp_path, panel,
                                                    deltas):
    sd = str(tmp_path / "state")
    with jserving.EDMServer(state_dir=sd, autostart=False) as srv:
        srv.register_panel("p", panel, E_max=3, cache=True)
        srv.submit("append", "p", delta=deltas[0])
        while srv.scheduler.drain_once():
            pass
    with pytest.raises(WalError, match="another package"):
        EDMServer.recover(sd, autostart=False)
    # with the reference's extra fields gone, the fingerprint still
    # refuses it: the port keys its package tag and the device type
    pdir = os.path.join(sd, "panels", os.listdir(os.path.join(
        sd, "panels"))[0])
    with open(os.path.join(pdir, "meta.json")) as f:
        meta = json.load(f)
    for k in ("pad", "lib_axes", "tgt_axes"):
        meta["config"].pop(k, None)
    meta["config"]["device"] = "cpu"
    with open(os.path.join(pdir, "meta.json"), "w") as f:
        json.dump(meta, f)
    with pytest.raises(WalError, match="fingerprint"):
        EDMServer.recover(sd, autostart=False)


@pytest.mark.parametrize("device", ["cuda", "cuda:0"])
def test_state_dir_recovered_onto_another_device_type_refused(
        tmp_path, panel, deltas, device):
    sd = str(tmp_path / "state")
    with EDMServer(state_dir=sd, autostart=False) as srv:
        srv.register_panel("p", panel, **CFG)
        _append_all(srv, "p", deltas[:1])
        meta = srv.registry.get("p").wal.meta()
    assert meta["config"]["device"] == "cpu"
    path = os.path.join(srv.registry.get("p").wal.pdir, "meta.json")
    _write_meta_device(path, device)
    with pytest.raises(WalError, match="device type"):
        EDMServer.recover(sd, autostart=False)
    _write_meta_device(path, "cpu")
    rec = EDMServer.recover(sd, autostart=False)
    assert rec.recovery_report["p"]["version"] == 1
    rec.close()


def _write_meta_device(path: str, device: str) -> None:
    with open(path) as f:
        meta = json.load(f)
    meta["config"]["device"] = device
    with open(path, "w") as f:
        json.dump(meta, f)


def test_reregister_into_an_existing_state_dir_refused(tmp_path, panel):
    sd = str(tmp_path / "state")
    with EDMServer(state_dir=sd, autostart=False) as srv:
        srv.register_panel("p", panel, **CFG)
    with EDMServer(state_dir=sd, autostart=False) as srv2:
        with pytest.raises(ValueError, match="recover"):
            srv2.register_panel("p", panel, **CFG)
        with pytest.raises(KeyError):
            srv2.registry.get("p")


# ------------------------------------------------- eviction and budget


@pytest.mark.parametrize("E,tau,dt", [(3, 1, 4), (2, 2, 1)])
def test_evict_rebuild_and_reappend_equal_never_evicted(E, tau, dt):
    full = np.asarray(ts.forced_network_panel(N, L0 + dt, seed=60 + E)[0],
                      np.float32)
    old, delta = full[:, :L0], full[:, L0:]
    cfg = dict(CFG, tau=tau)
    never = EDM(old, EDMConfig(**cfg))
    never.optimal_E()
    pre = [np.float32(never.ccm_batch([p], E=E)[0]) for p in PAIRS]
    never.append(delta)
    post = [np.float32(never.ccm_batch([p], E=E)[0]) for p in PAIRS]
    with telemetry.record() as rec, EDMServer(autostart=False) as srv:
        srv.register_panel("p", old, **cfg)
        srv.submit("optimal_E", "p")
        _drain_all(srv)
        entry = srv.registry.get("p")
        held = entry.master_nbytes()
        dM, iM = entry.sess._cache["master"][:2]
        assert held == dM.numel() * 4 + iM.numel() * 4 > 0
        assert srv.evict_panel("p") == held and entry.master_nbytes() == 0
        futs = [srv.submit("ccm", "p", lib=l, target=t, E=E)
                for l, t in PAIRS]
        _drain_all(srv)
        assert [np.float32(f.result()) for f in futs] == pre
        assert srv.evict_panel("p") > 0
        fa = srv.submit("append", "p", delta=delta)
        futs = [srv.submit("ccm", "p", lib=l, target=t, E=E)
                for l, t in PAIRS]
        _drain_all(srv)
        assert fa.result()["L"] == L0 + dt
        assert [np.float32(f.result()) for f in futs] == post
        assert entry.evictions == 2
    assert rec.counter_delta("serve_evictions") == 2


def test_lru_budget_evicts_the_coldest_master_bit_identically():
    panels = {f"p{i}": np.asarray(ts.forced_network_panel(
        N, L0, seed=40 + i)[0], np.float32) for i in range(3)}
    oracle = {n: [np.float32(v) for v in EDM(p, EDMConfig(**CFG))
                  .ccm_batch(PAIRS, E=3)] for n, p in panels.items()}
    with telemetry.record() as rec, EDMServer(autostart=False) as srv:
        for name, data in panels.items():
            srv.register_panel(name, data, **CFG)
            srv.submit("optimal_E", name)
        _drain_all(srv)
        one = srv.registry.get("p0").master_nbytes()
        assert srv.registry.master_bytes_total() == 3 * one
        srv.registry.set_budget(int(1.5 * one))
        for name in ["p0", "p1", "p2", "p0", "p2", "p1", "p0"]:
            assert _served_ccm(srv, name) == oracle[name]
            assert srv.registry.master_bytes_total() <= int(1.5 * one)
    assert rec.counter_delta("serve_evictions") >= 3


# ------------------------------------------------------------ kill -9

_CHILD = r"""
import os, sys, time
import numpy as np
from repro_torch.serving import EDMServer

state_dir, n_appends = sys.argv[1], int(sys.argv[2])
panel = np.load(os.path.join(state_dir, "panel.npy"))
delta = np.load(os.path.join(state_dir, "delta.npy"))
srv = EDMServer(state_dir=state_dir, workers=1)
srv.register_panel("kp", panel, E_max=3, cache=True, device="cpu")
srv.call("ccm", "kp", lib=0, target=1, E=3)   # warm master: appends merge
print("READY", flush=True)
for k in range(n_appends):
    r = srv.call("append", "kp", delta=delta)
    print(f"ACK {r['version']}", flush=True)
print("DONE", flush=True)
time.sleep(120)
"""


def test_kill9_between_append_ticks_recovers_bit_identically(
        tmp_path, panel, deltas):
    sd = str(tmp_path / "state")
    os.makedirs(sd)
    delta, n_appends = deltas[0], 6
    np.save(os.path.join(sd, "panel.npy"), panel)
    np.save(os.path.join(sd, "delta.npy"), delta)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.Popen([sys.executable, "-c", _CHILD, sd,
                             str(n_appends)], stdout=subprocess.PIPE,
                            text=True, env=env)
    acked = 0
    try:
        deadline = time.monotonic() + 120
        for line in proc.stdout:
            if line.startswith("ACK"):
                acked = int(line.split()[1])
                if acked >= 2:
                    break
            assert time.monotonic() < deadline, "child never acked twice"
        assert acked >= 2, "child exited before acking"
        os.kill(proc.pid, signal.SIGKILL)
        proc.wait(timeout=30)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
    assert proc.returncode == -signal.SIGKILL
    rec = EDMServer.recover(sd, autostart=False)
    try:
        v = rec.recovery_report["kp"]["version"]
        assert acked <= v <= n_appends
        grown = np.concatenate([panel] + [delta] * v, axis=1)
        assert rec.registry.get("kp").sess.data.L == grown.shape[1]
        assert _served_ccm(rec, "kp") == _oracle_ccm(grown)
    finally:
        rec.close()
