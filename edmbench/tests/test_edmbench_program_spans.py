"""The per-layer metrics that read the port's own spans, from traced CPU
runs of the cells at a small size: the session's assembly share and the
engine's enqueue and landing times in each xmap cell; no device-timed plan
metric where no device ran."""

import pytest

from edmbench import harness
from edmbench_small import small

XMAP = ["session_assemble_share.xmap", "engine_enqueue_us.xmap",
        "engine_land_us.xmap"]
EDIM = ["master_build_ms.edim", "plan_derive_ms.edim"]


def _traced(cell):
    cfg, chk = small(cell)
    return harness.run(cell, 2**40 + 29, 0.2, True, device="cpu", cfg=cfg,
                       check_spec=chk, log=lambda *a: None)


@pytest.mark.parametrize("cell", ["subject6-xmap", "fly80xy-xmap"])
def test_traced_xmap_run_reads_the_session_and_engine_spans(cell):
    out = _traced(cell)
    assert out["correct"] is True
    m = {k: v["value"] for k, v in out["metrics"].items()}
    assert set(XMAP) <= set(m)
    assert 0.0 <= m["session_assemble_share.xmap"] \
        <= m["session_self_share.xmap"]
    assert m["engine_enqueue_us.xmap"] > 0
    assert m["engine_land_us.xmap"] > 0
    assert out["metrics"]["engine_land_us.xmap"]["unit"] == "us"
    assert not set(EDIM) & set(m)


def test_traced_edim_run_on_the_cpu_reads_no_device_time():
    out = _traced("fly80xy-edim")
    assert out["correct"] is True
    assert not (set(EDIM) | set(XMAP)) & set(out["metrics"])
