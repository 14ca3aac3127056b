"""The control on the card: the reference in the precision below the
configuration's (float32 with TF32 products), put in the program's place,
has to come out not correct where the program comes out correct, through
the harness's own window, check and limits. At the cells' series lengths
with fewer series, so that a test run holds it; the cells' own sizes are
run by ``control.py``."""

import copy

import pytest

from edmbench import control, spec
from edmbench_small import CELLS

#: Series a cell keeps here (its series length is kept).
SERIES = {"subject6-xmap": 256, "fly80xy-edim": 4, "fly80xy-xmap": 16}


@pytest.mark.gpu
@pytest.mark.parametrize("cell", [c for c in CELLS if c in SERIES])
def test_control_fails_where_the_program_passes(cell, cuda):
    c = spec.cell(spec.benchmark(), cell)
    cfg = copy.deepcopy(spec.config(c["config"]))
    cfg["num_series"] = SERIES[cell]
    chk = copy.deepcopy(spec.check(cell))
    chk["sample"] = min(chk["sample"], SERIES[cell])
    r = control.readings(cell, 2**33 + 41, control=True, device=cuda,
                         cfg=cfg, check_spec=chk, log=lambda *a: None)
    assert r["program"]["correct"] is True, r
    assert r["control"]["correct"] is False, r
    assert r["control"]["failed"] == 0, r  # judged, not crashed
