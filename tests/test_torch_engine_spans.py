"""The spans of the port's xmap and optimal-E paths (``repro_torch``) on the
CPU: one ``engine.launch`` and one ``engine.land`` span a launch under
``session.xmap/engine.drive``, one ``session.assemble`` span an E-group,
``session.master_build`` and ``plan.derive`` on a caching session's
``optimal_E`` (no ``dev_s`` on the CPU), and no per-dispatch event while the
dispatch counters rise as before. The device-timed case runs on the card
(marked ``gpu``)."""

import numpy as np
import pytest
import torch

from repro_torch import telemetry
from repro_torch.core import ccm
from repro_torch.data import timeseries as ts
from repro_torch.edm import EDM

E_OPT = [2, 3, 3, 2, 4, 3, 2]


def _panel(n=7, steps=200, seed=0):
    return torch.as_tensor(ts.forced_network_panel(n, steps, seed=seed)[0])


def _deltas(before):
    after = telemetry.metrics_snapshot()
    return {k: v - before.get(k, 0) for k, v in after.items()
            if k.startswith("edm_ops_") or k == "edm_launches"}


@pytest.mark.parametrize("batch_libs", [1, 3, 7])
def test_traced_xmap_spans_a_launch_a_landing_an_assembly(batch_libs):
    sess = EDM(_panel(), device="cpu", E=3, cache=False,
               batch_libs=batch_libs)
    before = telemetry.metrics_snapshot()
    with telemetry.record() as rec:
        sess.xmap(E_opt=E_OPT)
    rise = rec.counter_delta("edm_launches")
    groups = len(set(E_OPT))
    assert rise == groups * -(-len(E_OPT) // batch_libs)
    for name in ("engine.launch", "engine.land"):
        spans = rec.spans(name)
        assert len(spans) == rise
        assert {s["path"] for s in spans} == {
            f"session.xmap/engine.drive/{name}"}
        assert all(type(s["attrs"][k]) is int
                   for s in spans for k in ("a", "b"))
    assert all(s["attrs"]["latency_s"] >= 0 for s in rec.spans("engine.land"))
    assemble = rec.spans("session.assemble")
    assert len(assemble) == groups
    assert {s["path"] for s in assemble} == {"session.xmap/session.assemble"}
    assert sorted(s["attrs"]["E"] for s in assemble) == [2, 3, 4]
    assert not [e for e in rec.events if e["name"].startswith("ops.")]
    assert not rec.events_named("engine.tile")
    # the dispatch counters rise as on an untraced call: one kNN and one
    # lookup dispatch a launch
    traced = _deltas(before)
    assert traced["edm_ops_all_knn_batch_calls"] == rise
    assert traced["edm_ops_lookup_rho_calls"] == rise
    before = telemetry.metrics_snapshot()
    sess.xmap(E_opt=E_OPT)
    assert _deltas(before) == traced


def test_engine_spans_cover_the_drive_and_on_block_follows_the_landing():
    order = []

    class Sink:
        def emit(self, ev):
            order.append((ev["type"], ev["name"]))

    def launch(a, b, B):
        return torch.arange(a * 2, a * 2 + B * 2,
                            dtype=torch.float32).reshape(B, 2)

    def on_block(a, b, block):
        order.append(("commit", a))

    sink = Sink()
    telemetry.add_sink(sink)
    try:
        with telemetry.record() as rec:
            out = ccm.drive_batched(5, 2, launch, on_block=on_block)
    finally:
        telemetry.remove_sink(sink)
    assert out.shape == (5, 2)
    assert [e for e in order if e[0] != "span" or e[1] != "engine.launch"] \
        == [("span", "engine.land"), ("commit", 0),
            ("span", "engine.land"), ("commit", 2),
            ("span", "engine.land"), ("commit", 4),
            ("span", "engine.drive")]
    drive = rec.spans("engine.drive")[0]["dur_s"]
    inner = sum(s["dur_s"] for s in rec.spans()
                if s["name"] in ("engine.launch", "engine.land"))
    assert 0 < inner <= drive
    assert [s["attrs"] for s in rec.spans("engine.launch")] == [
        {"a": 0, "b": 2}, {"a": 2, "b": 4}, {"a": 4, "b": 5}]


def test_untraced_drive_makes_no_span(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a span was made with tracing off")

    monkeypatch.setattr(telemetry, "_Span", refuse)
    assert not telemetry.active()
    out = ccm.drive_batched(4, 2, lambda a, b, B: torch.zeros(B, 1))
    assert out.shape == (4, 1)


def test_traced_optimal_E_times_master_build_and_derive_without_dev_s():
    sess = EDM(_panel(), device="cpu", E_max=6)
    with telemetry.record() as rec:
        sess.optimal_E()
    assert rec.counter_delta("edm_knn_master_builds") == 1
    build = rec.spans("session.master_build")
    derive = rec.spans("plan.derive")
    assert len(build) == 1 and len(derive) == 1
    assert build[0]["path"] == "session.optimal_E/session.master_build"
    assert derive[0]["path"] == "session.optimal_E/plan.derive"
    assert derive[0]["attrs"] == {"E_max": 6}
    assert set(build[0]["attrs"]) == {"E_levels", "k_master", "N"}
    assert "dev_s" not in build[0] and "dev_s" not in derive[0]


@pytest.mark.gpu
def test_master_build_and_derive_carry_device_time_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: device spans time CUDA events")
    X = torch.as_tensor(ts.forced_network_panel(12, 800, seed=1)[0],
                        device="cuda")
    sess = EDM(X, device="cuda", E_max=8)
    rec = telemetry.Recorder()
    telemetry.add_sink(rec)
    try:
        E_opt, _ = sess.optimal_E()
    finally:
        telemetry.remove_sink(rec)
    assert E_opt.shape == (12,)
    for name in ("session.master_build", "plan.derive"):
        spans = rec.spans(name)
        assert len(spans) == 1 and spans[0]["dev_s"] > 0
    assert np.isfinite(rec.spans("plan.derive")[0]["dev_s"])
