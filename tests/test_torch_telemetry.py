"""The port's telemetry: the reference's metric/span API on torch, with the
profiler bridge on ``torch.profiler.record_function``."""

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
