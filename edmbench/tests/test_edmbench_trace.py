"""The trace reduction and the per-layer metrics' arithmetic on a
hand-made profile: busy time as the union of device intervals, idle gaps
put to the host span open during them, the kernel and whole-call
rooflines, and readers that find nothing returning nothing."""

import pytest

from edmbench import spec
from edmbench.context import Context
from edmbench.trace import CALL_RANGE, Profile

K_RHO = "void (anonymous namespace)::rho_all_kernel(float4 const*, int)"
K_KNN = "void (anonymous namespace)::knn_batch_thread_kernel(float const*)"

# one call, 100 µs: two kernels overlapping, one later, idle gaps between
DEVICE = [(K_KNN, 10.0, 30.0), (K_RHO, 25.0, 40.0), (K_RHO, 70.0, 80.0)]
HOST = [(CALL_RANGE, 0.0, 100.0), ("session.xmap", 2.0, 98.0),
        ("session.xmap/engine.drive", 5.0, 85.0),
        ("aten::copy_", 45.0, 60.0)]
SPANS = {"session.xmap", "session.xmap/engine.drive"}


def _ctx(profile, calls=None, spans=()):
    mix = spec.mix("xmap")
    shape = {"N": 8, "L": 50, "E": 3, "tau": 1, "Tp": 0}
    calls = calls or [{"wall_s": 100e-6, "profiled": True,
                       "counters": {"edm_launches": 2}}]
    return Context(cell="test", mix=mix, shape=shape, calls=calls,
                   spans=list(spans), profile=profile,
                   peaks=spec.load_json(spec.HERE / "peaks.json"))


def test_busy_window_and_idle_gaps():
    p = Profile(DEVICE, HOST, SPANS)
    assert p.window_s == pytest.approx(100e-6)
    assert p.busy_s == pytest.approx(40e-6)  # [10, 40] and [70, 80]
    gaps = dict(p.idle_by_host())
    assert gaps["session.xmap/engine.drive | aten::copy_"] == \
        pytest.approx(30e-6)
    assert gaps["session.xmap/engine.drive | python"] == \
        pytest.approx(10e-6)
    assert gaps["session.xmap | python"] == pytest.approx(20e-6)
    assert sum(gaps.values()) == pytest.approx(60e-6)
    assert p.top_ops() == [["rho_all_kernel", pytest.approx(25e-6)],
                           ["knn_batch_thread_kernel", pytest.approx(20e-6)]]


def test_kernel_roofline_and_idle_share():
    p = Profile(DEVICE, HOST, SPANS)
    ctx = _ctx(p)
    w = spec.work_stage("lookup_rho").work(**ctx.call_shape())
    want = 100 * ctx.least_time_s([w]) / 25e-6  # two rho launches: 25 µs
    got = spec.metric_reader("lookup_rho_roofline").read(ctx)
    assert got == pytest.approx(want)
    assert spec.metric_reader("device_idle.xmap").read(ctx) == \
        pytest.approx(0.6)
    works = [spec.work_stage(s).work(**ctx.call_shape())
             for s in ("knn_batch", "weights", "lookup_rho")]
    assert spec.metric_reader("work_roofline.xmap").read(ctx) == \
        pytest.approx(100 * ctx.least_time_s(works, io=True) / 100e-6)


def test_span_and_counter_readers():
    spans = [{"name": "session.xmap", "path": "session.xmap", "dur_s": 2.0},
             {"name": "engine.drive", "path": "session.xmap/engine.drive",
              "dur_s": 1.5}]
    calls = [{"wall_s": 2.0, "profiled": False,
              "counters": {"edm_launches": 4}}] * 3
    ctx = _ctx(None, calls=calls, spans=spans)
    assert spec.metric_reader("session_self_share.xmap").read(ctx) == \
        pytest.approx(0.25)
    assert spec.metric_reader("engine_launches.xmap").read(ctx) == 4


def test_readers_with_nothing_to_read_return_nothing():
    ctx = _ctx(None)
    for name in ("lookup_rho_roofline", "knn_batch_roofline",
                 "knn_multi_e_roofline",
                 "device_idle.xmap", "device_idle.edim"):
        assert spec.metric_reader(name).read(ctx) is None, name
    # no call profiled (a run on the CPU): no whole-call roofline
    unprofiled = _ctx(None, calls=[{"wall_s": 1.0, "profiled": False,
                                    "counters": {"edm_launches": 2}}])
    for name in ("work_roofline.xmap", "work_roofline.edim"):
        assert spec.metric_reader(name).read(unprofiled) is None, name
    # a kernel that did not run leaves its roofline silent
    p = Profile([(K_KNN, 10.0, 30.0)], HOST, SPANS)
    assert spec.metric_reader("lookup_rho_roofline").read(_ctx(p)) is None
    assert spec.metric_reader("session_self_share.xmap").read(ctx) is None
