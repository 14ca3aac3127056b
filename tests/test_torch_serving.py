"""The port's EDM server (``repro_torch.serving``) on the CPU.

Against the JAX package: the same numpy panel and deltas go through
``repro.serving.EDMServer`` and ``repro_torch.serving.EDMServer``
(``device="cpu"``); served ``ccm`` ρ agree within ``ATOL``, library
versions and error types agree, and one delta's WAL frame is the same
bytes. Within the port every contract holds bit for bit: a coalesced
batch equals singleton ``ccm_batch`` calls (batch invariance), an append
equals a cold session on the grown panel, concurrent clients get the
quiesced answers, subscription ticks equal cold sessions, and the HTTP
front end serves the same bits with the reference's status codes.
Size: the chaos suite's, N = 4 series of L = 120.
"""

import concurrent.futures
import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from repro import serving as jserving
from repro.serving import durability as jdurability
from repro_torch import serving, telemetry
from repro_torch.data import timeseries as ts
from repro_torch.edm import EDM, EDMConfig
from repro_torch.serving import (DeadlineExceeded, EDMServer, serve_http)
from repro_torch.serving import durability
from repro_torch.serving.edm_server import _jsonable

N, L0, DL = 4, 120, 3
ATOL = 1e-5
PAIRS = [(0, 1), (1, 2), (2, 3), (3, 0), (0, 2), (1, 3)]
CFG = dict(E_max=3, cache=True)


@pytest.fixture(scope="module")
def panel():
    return np.asarray(ts.forced_network_panel(N, L0, seed=5)[0], np.float32)


@pytest.fixture(scope="module")
def deltas():
    rng = np.random.default_rng(7)
    return [rng.standard_normal((N, DL)).astype(np.float32)
            for _ in range(3)]


def _server(**kw) -> EDMServer:
    return EDMServer(**kw)


def _register(srv, name, panel, **kw):
    """Register under ``CFG`` (the port's server on the CPU)."""
    if isinstance(srv, EDMServer):
        kw.setdefault("device", "cpu")
    return srv.register_panel(name, panel, **dict(CFG, **kw))


def _cold(grown, E=3) -> EDM:
    return EDM(grown, EDMConfig(device="cpu", **CFG))


def _oracle(grown, pairs, E=3) -> list:
    sess = _cold(grown)
    return [np.float32(sess.ccm_batch([p], E=E)[0]) for p in pairs]


def _drain_all(srv) -> list[int]:
    sizes = []
    while True:
        n = srv.scheduler.drain_once()
        if not n:
            return sizes
        sizes.append(n)


# -------------------------------------------- parity with the JAX package


def _serve_script(srv, panel, deltas):
    """ccm at E = 2 and 3, then append, ccm, append, ccm (drained in
    order) → (per-phase ρ lists, append results)."""
    _register(srv, "p", panel)
    rhos, appends = [], []
    for d in [None, *deltas[:2]]:
        if d is not None:
            f = srv.submit("append", "p", delta=d)
            _drain_all(srv)
            r = f.result(timeout=30)
            appends.append((r["version"], r["N"], r["L"], r["records"]))
        futs = [srv.submit("ccm", "p", lib=l, target=t, E=E)
                for E in (2, 3) for l, t in PAIRS]
        _drain_all(srv)
        rhos.append(np.array([f.result(timeout=30) for f in futs],
                             np.float32))
    return rhos, appends


def test_served_ccm_and_versions_match_the_reference_server(panel, deltas):
    with jserving.EDMServer(autostart=False) as js, \
            _server(autostart=False) as ts_:
        jr, ja = _serve_script(js, panel, deltas)
        tr, ta = _serve_script(ts_, panel, deltas)
        assert ta == ja == [(1, N, L0 + DL, []), (2, N, L0 + 2 * DL, [])]
        for a, b in zip(jr, tr):
            np.testing.assert_allclose(b, a, rtol=0, atol=ATOL)
        assert [e["version"] for e in ts_.registry.infos()] == [2]
        assert ts_.registry.infos()[0]["L"] == js.registry.infos()[0]["L"]


def _error_cases(pkg, panel, deltas, tmp):
    """Each misuse of a server → the name of the error it raised."""
    got = {}

    def name_of(fn):
        try:
            fn()
        except BaseException as exc:  # noqa: BLE001
            return type(exc).__name__
        return None

    def resolved(fut):
        done, _ = concurrent.futures.wait([fut], timeout=60)
        assert fut in done, "hung future"
        exc = fut.exception()
        return None if exc is None else type(exc).__name__

    with pkg.EDMServer(autostart=False, max_queue_depth=2) as srv:
        _register(srv, "p", panel)
        got["unknown_panel"] = name_of(
            lambda: srv.submit("ccm", "ghost", lib=0, target=1))
        got["unknown_op"] = name_of(lambda: srv.submit("smap_all", "p"))
        got["duplicate"] = name_of(lambda: _register(srv, "p", panel))
        bad = deltas[0].copy()
        bad[2, 1] = np.nan
        f = srv.submit("append", "p", delta=bad)
        f2 = srv.submit("ccm", "p", lib=0, target=1, E=3, deadline_s=0.0)
        got["overloaded"] = name_of(
            lambda: srv.submit("ccm", "p", lib=1, target=2, E=3))
        _drain_all(srv)
        got["nan_delta"] = resolved(f)
        got["deadline"] = resolved(f2)
        got["version_after_rejected_append"] = srv.registry.get("p").version
        srv.drain(timeout=10)
        got["draining"] = name_of(
            lambda: srv.submit("ccm", "p", lib=0, target=1, E=3))
    fi = pkg.FaultInjector(seed=0, rates={"wal_write": 1.0})
    with pkg.EDMServer(autostart=False, state_dir=tmp, faults=fi) as srv:
        _register(srv, "q", panel)
        f = srv.submit("append", "q", delta=deltas[0])
        _drain_all(srv)
        got["wal_write"] = resolved(f)
        got["quarantined"] = name_of(
            lambda: srv.submit("ccm", "q", lib=0, target=1, E=3))
    return got


def test_error_types_match_the_reference_server(panel, deltas, tmp_path):
    want = _error_cases(jserving, panel, deltas, str(tmp_path / "j"))
    got = _error_cases(serving, panel, deltas, str(tmp_path / "t"))
    assert got == want
    assert want == {
        "unknown_panel": "KeyError", "unknown_op": "ValueError",
        "duplicate": "ValueError", "overloaded": "Overloaded",
        "nan_delta": "ValueError", "deadline": "DeadlineExceeded",
        "version_after_rejected_append": 0, "draining": "Draining",
        "wal_write": "InjectedWalError", "quarantined": "PanelQuarantined"}


def test_wal_frame_and_log_bytes_equal_the_reference(panel, deltas,
                                                     tmp_path):
    for v, d in enumerate(deltas, start=1):
        assert durability._frame_record(v, d) == \
            jdurability._frame_record(v, d)
    logs = []
    for pkg, name in ((jserving, "j"), (serving, "t")):
        sd = str(tmp_path / name)
        with pkg.EDMServer(state_dir=sd, autostart=False,
                           compact_every=100) as srv:
            _register(srv, "p", panel)
            for d in deltas:
                srv.submit("append", "p", delta=d)
                _drain_all(srv)
            pdir = srv.registry.get("p").wal.pdir
        with open(f"{pdir}/wal-0000000000.log", "rb") as f:
            wal = f.read()
        with open(f"{pdir}/base.npy", "rb") as f:
            logs.append((pdir.rsplit("/", 1)[1], wal, f.read()))
    assert logs[0] == logs[1]
    records, torn = durability._read_frames(f"{pdir}/wal-0000000000.log")
    assert torn == 0 and [v for v, _ in records] == [1, 2, 3]


# ------------------------------------------------- in-port, bit for bit


def test_coalesced_batch_equals_singleton_ccm_batch(panel):
    with telemetry.record() as rec, _server(autostart=False) as srv:
        _register(srv, "p", panel)
        srv.submit("optimal_E", "p")
        srv.scheduler.drain_once()
        futs = [srv.submit("ccm", "p", lib=l, target=t, E=3)
                for l, t in PAIRS]
        assert srv.scheduler.drain_once() == len(PAIRS)   # one batch
        got = [np.float32(f.result(timeout=5)) for f in futs]
    assert rec.counter_delta("serve_ccm_group_launches") == 1
    assert rec.counter_delta("serve_launches_saved") == len(PAIRS) - 1
    assert got == _oracle(panel, PAIRS)
    sess = _cold(panel)
    full = sess.ccm_batch(PAIRS, E=3)
    assert [np.float32(v) for v in full] == got           # any batch
    np.testing.assert_allclose(
        got, [sess.ccm(l, t, E=3) for l, t in PAIRS], rtol=0, atol=1e-6)


def test_fifo_across_mixed_signatures(panel):
    with telemetry.record() as rec, _server(autostart=False) as srv:
        _register(srv, "p", panel)
        srv.submit("ccm", "p", lib=0, target=2, E=3)
        srv.submit("ccm", "p", lib=1, target=3, E=2)   # different E
        srv.submit("simplex", "p", E=3)
        srv.submit("ccm", "p", lib=3, target=1, E=3)   # joins the head
        assert _drain_all(srv) == [2, 1, 1]
    batches = rec.spans("serve.batch")
    assert [b["attrs"]["op"] for b in batches] == ["ccm", "ccm", "simplex"]


def test_duplicate_whole_panel_ops_run_once(panel):
    with telemetry.record() as rec, _server(autostart=False) as srv:
        _register(srv, "p", panel)
        futs = [srv.submit("optimal_E", "p") for _ in range(4)]
        assert srv.scheduler.drain_once() == 4
        res = [f.result(timeout=5) for f in futs]
    assert rec.counter_delta("edm_knn_master_builds") == 1
    for E_opt, rho in res:
        np.testing.assert_array_equal(E_opt, res[0][0])
        np.testing.assert_array_equal(rho, res[0][1])


def test_append_is_a_version_barrier_equal_to_a_cold_rebuild(panel, deltas):
    grown = np.concatenate([panel, deltas[0]], axis=1)
    with telemetry.record() as rec, _server(autostart=False) as srv:
        _register(srv, "p", panel)
        srv.submit("optimal_E", "p")
        srv.scheduler.drain_once()
        pre = [srv.submit("ccm", "p", lib=l, target=t, E=3)
               for l, t in PAIRS[:3]]
        fa = srv.submit("append", "p", delta=deltas[0])
        post = [srv.submit("ccm", "p", lib=l, target=t, E=3)
                for l, t in PAIRS[:3]]
        assert _drain_all(srv) == [3, 1, 3]
        assert fa.result(timeout=5)["L"] == L0 + DL
        sess = srv.registry.get("p").sess
        dM, iM, _, _ = sess._cache["master"]
        cold = _cold(grown)
        cold.optimal_E()
        cdM, ciM, _, _ = cold._cache["master"]
        assert torch.equal(dM, cdM) and torch.equal(iM, ciM)
        np.testing.assert_array_equal(sess.optimal_E()[1],
                                      cold.optimal_E()[1])
    assert rec.counter_delta("edm_knn_master_appends") == 1
    assert [np.float32(f.result()) for f in pre] == _oracle(panel,
                                                            PAIRS[:3])
    assert [np.float32(f.result()) for f in post] == _oracle(grown,
                                                             PAIRS[:3])


def test_concurrent_clients_get_the_quiesced_answers(panel, deltas):
    want_pre = dict(zip(PAIRS, _oracle(panel, PAIRS)))
    grown = np.concatenate([panel, deltas[0]], axis=1)
    want_post = dict(zip(PAIRS, _oracle(grown, PAIRS)))
    with _server(workers=2) as srv:
        _register(srv, "p", panel)
        srv.call("optimal_E", "p", timeout=60)
        answers, errs = [], []

        def client(pair):
            try:
                answers.append((pair, np.float32(srv.call(
                    "ccm", "p", lib=pair[0], target=pair[1], E=3,
                    timeout=60))))
            except Exception as exc:  # noqa: BLE001
                errs.append(exc)

        threads = [threading.Thread(target=client, args=(p,))
                   for p in PAIRS * 2]
        for t in threads[:6]:
            t.start()
        fa = srv.submit("append", "p", delta=deltas[0])
        for t in threads[6:]:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not errs and fa.result(timeout=60)["version"] == 1
        for pair, rho in answers:
            assert rho in (want_pre[pair], want_post[pair]), pair
        for pair in PAIRS:
            assert np.float32(srv.call("ccm", "p", lib=pair[0],
                                       target=pair[1], E=3,
                                       timeout=60)) == want_post[pair]


def test_subscription_ticks_equal_cold_sessions(panel, deltas):
    watch = [(0, 1), (2, 3), (1, 0)]
    with _server(workers=1) as srv:
        _register(srv, "p", panel)
        sub = srv.subscribe("p", watch, E=3)
        assert [np.float32(v) for v in sub["rho"]] == _oracle(panel, watch)
        s = srv.subscription(sub["id"])
        assert len(s.poll(timeout=5)) == 1                  # the baseline
        grown = panel
        for k, d in enumerate(deltas[:2], start=1):
            srv.call("append", "p", delta=d, timeout=60)
            grown = np.concatenate([grown, d], axis=1)
            (tick,) = s.poll(timeout=30)
            assert tick["version"] == k and tick["L"] == grown.shape[1]
            assert [np.float32(v) for v in tick["rho"]] == \
                _oracle(grown, watch)
        srv.unsubscribe(sub["id"])
        assert s.closed and srv.health()["subscriptions"] == 0


def test_unknown_panel_op_and_duplicates_rejected(panel):
    with _server(autostart=False) as srv:
        with pytest.raises(KeyError, match="ghost"):
            srv.submit("ccm", "ghost", lib=0, target=1)
        _register(srv, "p", panel)
        with pytest.raises(ValueError, match="unknown op"):
            srv.submit("smap_all_the_things", "p")
        with pytest.raises(ValueError, match="already registered"):
            _register(srv, "p", panel)


def test_cuda_config_without_cuda_raises_naming_the_cpu(panel):
    if torch.cuda.is_available():
        pytest.skip("CUDA is available here: a cuda panel is legal")
    with _server(autostart=False) as srv:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            srv.register_panel("p", panel, **CFG)      # device="cuda"
        with pytest.raises(KeyError):
            srv.registry.get("p")


def test_jsonable_turns_tensors_and_nan_into_json():
    out = _jsonable({"a": torch.tensor([1.0, float("nan")]),
                     "b": (np.float32(2.5), np.int64(3), np.bool_(True)),
                     "c": np.array([[np.inf, 0.5]], np.float32)})
    assert out == {"a": [1.0, None], "b": [2.5, 3, True],
                   "c": [[None, 0.5]]}
    json.dumps(out, allow_nan=False)


# ------------------------------------------------------------------ HTTP


def _http(port, path, body=None, timeout=60):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data,
                                 {"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            raw = r.read()
            return r.status, dict(r.headers), raw
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def test_http_serves_the_same_bits(panel, deltas):
    grown = np.concatenate([panel, deltas[0]], axis=1)
    with _server(workers=2) as srv:
        httpd = serve_http(srv)
        port = httpd.server_address[1]
        try:
            code, _, body = _http(port, "/v1/register", {
                "panel": "p", "data": panel.tolist(), "device": "cpu",
                **CFG})
            assert code == 200 and json.loads(body)["result"]["L"] == L0
            code, _, body = _http(port, "/healthz")
            h = json.loads(body)
            assert code == 200 and h["ok"] and len(h["workers"]) == 2
            code, _, body = _http(port, "/v1/ccm", {
                "panel": "p", "lib": 0, "target": 2, "E": 3})
            assert np.float32(json.loads(body)["result"]) == \
                _oracle(panel, [(0, 2)])[0]
            code, _, body = _http(port, "/v1/append", {
                "panel": "p", "delta": deltas[0].tolist()})
            res = json.loads(body)["result"]
            assert (res["version"], res["L"]) == (1, L0 + DL)
            code, _, body = _http(port, "/v1/ccm", {
                "panel": "p", "lib": 0, "target": 2, "E": 3})
            assert np.float32(json.loads(body)["result"]) == \
                _oracle(grown, [(0, 2)])[0]
            code, _, body = _http(port, "/v1/ccm", {
                "panel": "ghost", "lib": 0, "target": 1})
            assert code == 400 and "ghost" in json.loads(body)["error"]
            code, _, body = _http(port, "/metrics")
            assert code == 200 and b"serve_requests" in body
            code, _, body = _http(port, "/panels")
            assert json.loads(body)["panels"][0]["version"] == 1
        finally:
            httpd.shutdown()


def test_http_status_codes_429_504_503(panel):
    with _server(autostart=False, max_queue_depth=1) as srv:
        _register(srv, "p", panel)
        fill = srv.submit("ccm", "p", lib=0, target=2, E=3)
        httpd = serve_http(srv, request_timeout_s=0.3)
        port = httpd.server_address[1]
        try:
            code, headers, body = _http(port, "/v1/ccm", {
                "panel": "p", "lib": 1, "target": 3, "E": 3})
            assert code == 429 and int(headers["Retry-After"]) >= 1
            _drain_all(srv)
            fill.result(timeout=5)
            code, _, body = _http(port, "/v1/ccm", {
                "panel": "p", "lib": 1, "target": 3, "E": 3})
            assert code == 503 and "timed out" in json.loads(body)["error"]
            _drain_all(srv)
            srv.scheduler.start()
            code, _, body = _http(port, "/v1/ccm", {
                "panel": "p", "lib": 0, "target": 2, "E": 3,
                "deadline_s": 0.0})
            assert code == 504 and "deadline" in json.loads(body)["error"]
            assert srv.drain(timeout=10) is True
            code, _, body = _http(port, "/v1/ccm", {
                "panel": "p", "lib": 1, "target": 3, "E": 3})
            assert code == 503 and "draining" in json.loads(body)["error"]
            assert _http(port, "/healthz")[0] == 503
        finally:
            httpd.shutdown()


def test_deadline_exceeded_is_a_timeout_error_told_from_a_hang(panel):
    """``DeadlineExceeded`` subclasses ``TimeoutError`` (as the
    reference's), which is also ``concurrent.futures.TimeoutError``: the
    resolved future is told from a hung one by ``wait`` + ``done``."""
    assert issubclass(DeadlineExceeded, TimeoutError)
    assert concurrent.futures.TimeoutError is TimeoutError
    with _server(workers=1) as srv:
        _register(srv, "p", panel)
        f = srv.submit("ccm", "p", lib=0, target=1, E=3, deadline_s=0.0)
        done, _ = concurrent.futures.wait([f], timeout=30)
        assert f in done and f.done()
        assert isinstance(f.exception(), DeadlineExceeded)
        with pytest.raises(TimeoutError):       # what a naive catch sees
            f.result(timeout=0)


def test_many_workers_and_a_short_switch_interval_keep_per_panel_order(
        panel, deltas):
    """Eight workers, two panels, eight client threads and the
    interpreter switching threads as often as it can: every answer is the
    oracle's at exactly the appends submitted before it on its panel."""
    import bisect
    import sys
    panels = {"a": panel, "b": np.ascontiguousarray(panel[::-1])}
    oracle = {}
    for name, x in panels.items():
        grown = x
        for k in range(3):
            oracle[name, k] = dict(zip(PAIRS, _oracle(grown, PAIRS)))
            if k < 2:
                grown = np.concatenate([grown, deltas[k]], axis=1)
    subs = []                       # (panel, kind, pair, future)
    lock = threading.Lock()

    def client(cid):
        name = "ab"[cid % 2]
        for j, pair in enumerate(PAIRS):
            f = srv.submit("ccm", name, lib=pair[0], target=pair[1], E=3)
            with lock:
                subs.append((name, "ccm", pair, f))
            if cid < 2 and j in (1, 4):
                f = srv.submit("append", name, delta=deltas[j // 4])
                with lock:
                    subs.append((name, "append", None, f))

    old = sys.getswitchinterval()
    with _server(workers=8) as srv:
        for name, x in panels.items():
            _register(srv, name, x)
        sys.setswitchinterval(1e-6)
        try:
            threads = [threading.Thread(target=client, args=(c,))
                       for c in range(8)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
            assert not any(t.is_alive() for t in threads)
            done, _ = concurrent.futures.wait([s[3] for s in subs],
                                              timeout=120)
        finally:
            sys.setswitchinterval(old)
        assert len(done) == len(subs)
    for name in panels:
        appends = sorted(f.ticket for p, kind, _, f in subs
                         if p == name and kind == "append")
        assert len(appends) == 2
        for rank, t in enumerate(appends):
            f = next(f for p, _, _, f in subs if f.ticket == t)
            assert f.result()["version"] == rank + 1
        for p, kind, pair, f in subs:
            if p == name and kind == "ccm":
                k = bisect.bisect_left(appends, f.ticket)
                assert np.float32(f.result()) == oracle[name, k][pair]


def test_run_until_terminated_drains_on_sigterm(panel):
    import os
    import signal

    from repro_torch.serving import run_until_terminated
    before = signal.getsignal(signal.SIGTERM)
    srv = _server(workers=1)
    _register(srv, "p", panel)
    httpd = serve_http(srv)
    fut = srv.submit("ccm", "p", lib=0, target=1, E=3)
    timer = threading.Timer(0.2, os.kill, (os.getpid(), signal.SIGTERM))
    timer.start()
    try:
        assert run_until_terminated(srv, httpd, poll_s=0.01) == 0
    finally:
        timer.join(timeout=10)
    assert np.float32(fut.result(timeout=0)) == _oracle(panel, [(0, 1)])[0]
    assert signal.getsignal(signal.SIGTERM) == before
    assert srv.scheduler._closed and srv.health()["ok"] is False
