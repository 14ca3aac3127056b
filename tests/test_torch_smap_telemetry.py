"""The S-Map engine's spans and counters (``core/smap_engine.py::_fit``):
``smap.gram`` around ``ops.smap_gram`` with its shape, ``smap.solve``
around the ridge solve, ``edm_smap_systems`` for every system solved and
``edm_smap_ridge_fallbacks`` for those solved again in float64 — more
than 0 on a panel with a period-3 forcing series, 0 on the others, never
more than the systems."""

import pytest

from edmbench import data
from repro_torch import telemetry
from repro_torch.edm import EDM

PANELS = [(7000000027, True), (7000000012, True), (7000000001, False),
          (7000000002, False)]


def _xmap(seed, N=5, L=300):
    X = data.logistic_network(N, L, seed=seed)
    with telemetry.record() as rec:
        EDM(X, E=3, device="cpu").xmap(method="smap", theta=1.0)
    return rec


def test_spans_carry_their_shapes():
    rec = _xmap(7000000001)
    gram = rec.spans("smap.gram")
    solve = rec.spans("smap.solve")
    assert len(gram) == len(solve) == 1  # B = N: one launch a call
    assert gram[0]["attrs"] == {"B": 5, "rows": 298, "N": 5, "T": 1}
    assert gram[0]["path"].startswith("session.xmap/")
    assert solve[0]["path"].endswith("engine.launch/smap.solve")
    assert "dev_s" not in solve[0]  # no device time on the CPU


@pytest.mark.parametrize("seed,period3", PANELS)
def test_fallbacks_count_the_period3_library_alone(seed, period3):
    rec = _xmap(seed)
    systems = rec.counter_delta("edm_smap_systems")
    fallbacks = rec.counter_delta("edm_smap_ridge_fallbacks")
    assert systems == 5 * 298
    assert (fallbacks > 0) == period3
    assert fallbacks <= systems
