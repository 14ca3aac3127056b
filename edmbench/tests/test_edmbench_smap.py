"""The ``fly80xy-smap`` cell's own parts: the float64 S-Map reference
against a hand-written per-row weighted least squares and on a period-3
forcing series, its independence from the port, the work counts of
``smap_gram`` and ``smap_solve`` at Fly80XY's shape, and the five
readers on a hand-made trace — each silent where the program has nothing
to read."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from edmbench import data, spec
from edmbench.context import Context
from edmbench.reference import smap_xmap
from edmbench.trace import CALL_RANGE, Profile

PEAKS = spec.load_json(spec.HERE / "peaks.json")
FLY = dict(N=82, L=10608, E=3, tau=1, Tp=0, launches=1)
READERS = ["smap_gram_roofline", "smap_solve_ms.smap",
           "smap_fallback_share.smap", "work_roofline.smap",
           "device_idle.smap"]


def _by_rows(x, Y, *, E, theta, ridge):
    """ρ of each target by S-Map, one weighted ridge fit a row in numpy."""
    x, Y = np.asarray(x, np.float64), np.asarray(Y, np.float64)
    rows = len(x) - (E - 1)
    Z = np.stack([x[k:k + rows] for k in range(E)], axis=1)
    A = np.hstack([np.ones((rows, 1)), Z])
    y = Y[:, E - 1:E - 1 + rows]
    pred = np.empty_like(y)
    for j in range(rows):
        d = np.sqrt(((Z - Z[j]) ** 2).sum(1))
        w = np.exp(-theta * d / d.mean())
        w[j] = 0.0
        G = A.T @ (w[:, None] * A)
        G += (ridge * np.trace(G) / (E + 1) + 1e-20) * np.eye(E + 1)
        for n in range(len(Y)):
            pred[n, j] = A[j] @ np.linalg.solve(G, A.T @ (w * y[n]))
    return np.array([np.corrcoef(pred[n], y[n])[0, 1] for n in range(len(Y))])


def test_reference_against_a_row_by_row_fit():
    X = data.logistic_network(3, 60, seed=11)
    params = {"E": 2, "tau": 1, "Tp_cross": 0, "theta": 2.0, "ridge": 1e-3}
    got = smap_xmap.expected(X, np.array([0, 2]), params, device="cpu",
                             precision="float64")
    for r, lib in enumerate([0, 2]):
        want = _by_rows(X[lib], X, E=2, theta=2.0, ridge=1e-3)
        np.testing.assert_allclose(got[r], want, rtol=0, atol=1e-12)


def test_reference_cross_maps_a_period3_series_to_one():
    X = data.logistic_network(4, 400, seed=7000000027)
    params = {"E": 3, "tau": 1, "Tp_cross": 0, "theta": 1.0, "ridge": 1e-6}
    got = smap_xmap.expected(X, np.array([0]), params, device="cpu",
                             precision="float64")
    assert np.isfinite(got).all()
    # the series maps itself (Tp 0: ŷ is z's last lag) up to the ridge
    assert got[0, 0] == pytest.approx(1.0, abs=1e-6)


def test_reference_loads_nothing_of_the_port():
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(spec.ROOT), str(spec.ROOT / "src")]))
    code = ("import json, sys\n"
            "from edmbench.reference import smap_xmap\n"
            "print(json.dumps(sorted({n.split('.')[0] "
            "for n in sys.modules})))\n")
    r = subprocess.run([sys.executable, "-c", code], env=env, cwd=spec.ROOT,
                       capture_output=True, text=True, timeout=120,
                       check=True)
    loaded = set(json.loads(r.stdout.strip().splitlines()[-1]))
    assert not loaded & {"jax", "jaxlib", "flax", "repro", "repro_torch"}


def test_config_states_the_settings_the_mix_runs():
    cell = spec.cell(spec.benchmark(), "fly80xy-smap")
    cfg, mix = spec.config(cell["config"]), spec.mix(cell["traffic"])
    args = {**spec.resolve(mix["session_args"], cfg),
            **spec.resolve(mix["call_args"], cfg)}
    for key in ("E", "tau", "Tp_cross", "method", "theta", "ridge"):
        assert args[key] == spec.param(cfg, key), key
    # Fly80XY's published shape, with nothing cut
    fly = spec.config("fly80xy")
    assert cfg["published"] == fly["published"] and cfg["reduced"] == []
    assert (cfg["num_series"], cfg["series_length"]) == (82, 10608)


def test_work_at_fly80xy_shape():
    g = spec.work_stage("smap_gram").work(**FLY)
    s = spec.work_stage("smap_solve").work(**FLY)
    rows = 10606
    # 338 unique columns (10 of G, 328 of M), a multiply-add a row, 3×TF32
    assert g["tf32"] == 3 * 2 * 82 * rows * rows * 338
    assert 1e3 * g["tf32"] / PEAKS["tf32_flops_per_s"] == pytest.approx(
        37.8, abs=0.1)
    # a 4×4 Cholesky: 16 operations on the diagonal, 14 below it
    assert s["fp32"] == 82 * rows * (7 + 4 + 30 + 82 * (32 + 8 - 1 + 5))
    assert s["io_bytes"] == 82 * 82 * 4 and g["io_bytes"] == 82 * 10608 * 4
    # M (rows × N × 4 floats a library) written by one, read by the other
    m = 82 * rows * 82 * 4 * 4
    assert m < g["bytes"] and m < s["bytes"]


K_GEMM = ("void (anonymous namespace)::smap_gemm_wide_kernel("
          "unsigned int const*)")
K_DIST = "void (anonymous namespace)::smap_dist_kernel(float const*, int)"
K_KNN = "void (anonymous namespace)::knn_batch_thread_kernel(float const*)"


def _ctx(profile=None, calls=None, spans=()):
    calls = calls or [{"wall_s": 0.2, "profiled": profile is not None,
                       "counters": {"edm_launches": 1}}]
    return Context(cell="fly80xy-smap", mix=spec.mix("smap"),
                   shape={"N": 82, "L": 10608, "E": 3, "tau": 1, "Tp": 0},
                   calls=calls, spans=list(spans), profile=profile,
                   peaks=PEAKS)


def test_readers_on_a_hand_made_trace():
    # one 0.2 s call: the Gram kernels 0.15 s, a stray kNN kernel, a gap
    dev = [(K_DIST, 0.0, 10_000.0), (K_GEMM, 10_000.0, 150_000.0),
           (K_KNN, 150_000.0, 160_000.0)]
    p = Profile(dev, [(CALL_RANGE, 0.0, 200_000.0)], set())
    ctx = _ctx(p)
    g = spec.work_stage("smap_gram").work(**FLY)
    s = spec.work_stage("smap_solve").work(**FLY)
    roof = spec.metric_reader("smap_gram_roofline").read(ctx)
    assert roof == pytest.approx(100 * ctx.least_time_s([g]) / 0.15)
    whole = spec.metric_reader("work_roofline.smap").read(ctx)
    assert whole == pytest.approx(
        100 * ctx.least_time_s([g, s], io=True) / 0.2)
    assert 0 < whole <= 100 and 0 < roof <= 100
    assert spec.metric_reader("device_idle.smap").read(ctx) == \
        pytest.approx(0.2)


def test_span_and_counter_readers():
    spans = [{"name": "smap.solve", "path": "session.xmap/smap.solve",
              "dur_s": 0.05, "dev_s": dev} for dev in (0.010, 0.014)]
    calls = [{"wall_s": 0.2, "profiled": False,
              "counters": {"edm_smap_systems": 869_692,
                           "edm_smap_ridge_fallbacks": f}}
             for f in (10_606, 0)]
    ctx = _ctx(calls=calls, spans=spans)
    assert spec.metric_reader("smap_solve_ms.smap").read(ctx) == \
        pytest.approx(12.0)
    assert spec.metric_reader("smap_fallback_share.smap").read(ctx) == \
        pytest.approx(10_606 / (2 * 869_692))


def test_readers_with_nothing_to_read_return_nothing():
    # a program without the spans and counters, and no profile (the CPU)
    ctx = _ctx(calls=[{"wall_s": 0.2, "profiled": False,
                       "counters": {"edm_launches": 1}}],
               spans=[{"name": "smap.solve", "path": "smap.solve",
                       "dur_s": 0.05}])
    for name in READERS:
        assert spec.metric_reader(name).read(ctx) is None, name
    # a trace where no smap kernel ran leaves the kernel's share silent
    p = Profile([(K_KNN, 0.0, 10.0)], [(CALL_RANGE, 0.0, 20.0)], set())
    assert spec.metric_reader("smap_gram_roofline").read(_ctx(p)) is None
