"""The port's telemetry: the reference's metric/span API on torch, with the
profiler bridge on ``torch.profiler.record_function``."""

import pytest
import torch

from repro_torch import telemetry


def test_spans_nest_and_counters_snapshot():
    c = telemetry.counter("edm_test_torch_counter")
    with telemetry.record() as rec:
        with telemetry.span("outer", N=3):
            with telemetry.span("inner"):
                c.inc(2)
            telemetry.event("tick", a=1)
    spans = {s["name"]: s for s in rec.spans()}
    assert spans["inner"]["path"] == "outer/inner"
    assert spans["outer"]["attrs"] == {"N": 3}
    assert rec.events_named("tick")[0]["path"] == "outer"
    assert rec.counter_delta("edm_test_torch_counter") == 2
    assert "edm_test_torch_counter" in telemetry.render_prom()


def test_profiler_bridge_records_span_ranges():
    telemetry.enable_profiler_trace()
    try:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            with telemetry.record():
                with telemetry.span("engine.drive"):
                    torch.ones(4).sum()
    finally:
        telemetry.enable_profiler_trace(False)
    names = {e.key for e in prof.key_averages()}
    assert "engine.drive" in names


class _FakeEvent:
    """A stand-in for ``torch.cuda.Event``: completes only when told to."""

    made: list = []

    def __init__(self, enable_timing=False):
        assert enable_timing
        self.done = False
        self.stream = None
        self.at = None
        _FakeEvent.made.append(self)

    def record(self, stream=None):
        self.stream = stream
        self.at = len(_FakeEvent.made)  # ms, by the order of recording

    def query(self):
        return self.done

    def synchronize(self):
        self.done = True

    def elapsed_time(self, end):
        assert end.done
        return float(end.at - self.at)


@pytest.fixture
def fake_cuda(monkeypatch):
    _FakeEvent.made = []
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev: "s0")
    return _FakeEvent


def test_device_span_off_makes_no_cuda_event(fake_cuda):
    assert not telemetry.active()
    with telemetry.device_span("plan.derive", "cuda", E_max=3) as sp:
        sp.annotate(x=1)
    assert fake_cuda.made == []


@pytest.mark.parametrize("device", ["cpu", torch.device("cpu"),
                                    torch.zeros(1)])
def test_device_span_on_the_cpu_is_a_plain_span(fake_cuda, device):
    with telemetry.record() as rec:
        with telemetry.device_span("plan.derive", device, E_max=3):
            pass
    (sp,) = rec.spans("plan.derive")
    assert sp["attrs"] == {"E_max": 3} and "dev_s" not in sp
    assert fake_cuda.made == []


def test_device_span_waits_for_its_end_event_without_blocking(fake_cuda):
    rec = telemetry.Recorder()
    telemetry.add_sink(rec)
    try:
        with telemetry.span("session.optimal_E"):
            with telemetry.device_span("session.master_build", "cuda",
                                       N=4):
                pass
            start, end = fake_cuda.made
            assert (start.stream, end.stream) == ("s0", "s0")
            assert rec.spans("session.master_build") == []  # not done
            with telemetry.span("probe"):
                pass
            assert rec.spans("session.master_build") == []  # polled, held
            end.done = True
            with telemetry.device_span("plan.derive", "cuda"):
                pass  # this exit polls: the build is out, derive held
            (build,) = rec.spans("session.master_build")
            assert build["path"] == "session.optimal_E/session.master_build"
            assert build["dev_s"] == pytest.approx(1e-3)
            assert build["attrs"] == {"N": 4} and build["dur_s"] >= 0
            assert rec.spans("plan.derive") == []
    finally:
        telemetry.remove_sink(rec)  # waits for the rest
    (derive,) = rec.spans("plan.derive")
    assert derive["dev_s"] == pytest.approx(1e-3)
    assert [e.done for e in fake_cuda.made] == [False, True] * 2  # ends
    assert [s["name"] for s in rec.spans()] == [
        "probe", "session.master_build", "session.optimal_E", "plan.derive"]


def test_flush_emits_held_device_spans_to_every_sink(fake_cuda):
    a, b = telemetry.Recorder(), telemetry.Recorder()
    telemetry.add_sink(a)
    telemetry.add_sink(b)
    try:
        with telemetry.device_span("session.master_build", "cuda:0"):
            pass
        assert a.spans() == [] and b.spans() == []
        telemetry.flush()
        assert len(a.spans()) == 1 and a.spans() == b.spans()
        telemetry.flush()  # nothing left: nothing twice
        assert len(b.spans()) == 1
    finally:
        telemetry.remove_sink(a)
        telemetry.remove_sink(b)


def test_profiler_bridge_opens_ranges_only_while_a_profiler_records(
        monkeypatch):
    opened = []

    class Range:
        def __init__(self, name):
            opened.append(name)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(torch.profiler, "record_function", Range)
    telemetry.enable_profiler_trace()
    try:
        with telemetry.record() as rec:
            with telemetry.span("engine.drive"):
                with telemetry.span("engine.launch"):
                    pass
            assert opened == []  # no profiler: one check a span
            with torch.profiler.profile(
                    activities=[torch.profiler.ProfilerActivity.CPU]):
                with telemetry.span("engine.drive"):
                    with telemetry.span("engine.launch"):
                        pass
    finally:
        telemetry.enable_profiler_trace(False)
    assert opened == ["engine.drive", "engine.drive/engine.launch"]
    assert len(rec.spans("engine.launch")) == 2
