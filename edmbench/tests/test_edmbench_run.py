"""Whole runs of every cell on the CPU at a small size: the result's
shape, the output check, and the check turning false when the timed path
is broken underneath (an answer altered where it is produced; half of
the rows left out of ρ, the mean taken over the rest). The cells have no
state a step carries and no exchange between chips, so those faults do
not apply."""

import json
import math

import pytest
import torch

from edmbench import harness, spec
from edmbench_small import CELLS, small

RESULT_KEYS = ["correct", "attempted", "failed", "metrics", "device",
               "checks"]


def _run(cell, trace=False, control=None):
    cfg, chk = small(cell)
    return harness.run(cell, 2**40 + 17, 0.2, trace, device="cpu", cfg=cfg,
                       check_spec=chk, control=control, log=lambda *a: None)


@pytest.mark.parametrize("cell", CELLS)
def test_run_is_correct_and_reports_its_metrics(cell):
    out = _run(cell)
    assert list(out) == RESULT_KEYS  # the checks come last
    assert out["correct"] is True and out["failed"] == 0
    assert out["attempted"] >= 1
    e2e = {m["name"] for m in spec.cell_metrics(spec.benchmark(), cell,
                                                 "end_to_end")}
    assert set(out["metrics"]) == e2e
    for m in out["metrics"].values():
        assert m["value"] > 0 and math.isfinite(m["value"])
    for c in out["checks"].values():
        assert c["value"] <= c["limit"]
    json.loads(json.dumps(out, allow_nan=False))


@pytest.mark.parametrize("cell", ["subject6-xmap", "fly80xy-xmap"])
def test_traced_run_reads_the_span_and_counter_metrics(cell):
    out = _run(cell, trace=True)
    assert out["correct"] is True
    m = out["metrics"]
    assert 0.0 <= m["session_self_share.xmap"]["value"] <= 1.0
    assert m["engine_launches.xmap"]["value"] >= 1
    # nothing on a CPU run is a device number
    assert not any("roofline" in k or "idle" in k for k in m)


def _alter_one(fn):
    def wrapped(*a, **k):
        out = fn(*a, **k).clone()
        out.view(-1)[0] += 0.5
        return out
    return wrapped


def _half_rows(fn):
    def wrapped(Y, idx, w, **k):
        h = idx.shape[-2] // 2
        return fn(Y, idx[..., :h, :], w[..., :h, :], **k)
    return wrapped


FAULTS = {
    ("xmap", "answer"): ("repro_torch.kernels.ops", "lookup_rho", _alter_one),
    ("xmap", "half"): ("repro_torch.kernels.ops", "lookup_rho", _half_rows),
    ("edim", "answer"): ("repro_torch.kernels.ops", "lookup_rho_own",
                         _alter_one),
    ("edim", "half"): ("repro_torch.kernels.ops", "lookup_rho_own",
                       _half_rows),
}


def _traffic(cell):
    return spec.cell(spec.benchmark(), cell)["traffic"]


@pytest.mark.parametrize("fault", ["answer", "half"])
@pytest.mark.parametrize("cell", [c for c in CELLS
                                  if (_traffic(c), "answer") in FAULTS])
def test_broken_timed_path_is_not_correct(cell, fault, monkeypatch):
    import importlib

    modname, attr, wrap = FAULTS[(_traffic(cell), fault)]
    mod = importlib.import_module(modname)
    monkeypatch.setattr(mod, attr, wrap(getattr(mod, attr)))
    out = _run(cell)
    assert out["correct"] is False
    assert any(c["value"] == "inf" or c["value"] > c["limit"]
               for c in out["checks"].values())


@pytest.mark.parametrize("cell", CELLS)
def test_the_reference_in_the_programs_place_goes_through_the_check(cell):
    """The control's path: every call returns the reference's part in the
    program's output, judged by the same window, check and limits; in
    the reference's own precision it meets them exactly."""
    out = _run(cell, control="float64")
    assert out["correct"] is True and out["attempted"] >= 1
    assert all(c["value"] == 0.0 for c in out["checks"].values())


def test_no_card_refuses_to_run(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = harness.main(["--workload", CELLS[0], "--seed", "1",
                       "--seconds", "1", "--trace", "0"])
    assert rc != 0
    assert capsys.readouterr().out == ""


def test_too_few_cards_refuse_to_run(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    rc = harness.main(["--workload", CELLS[0], "--seed", "1",
                       "--seconds", "1", "--trace", "0"])
    assert rc != 0
    assert capsys.readouterr().out == ""


def test_sample_is_drawn_from_a_large_seed():
    a = harness.sample_indices(2**33 + 5, 8192, 64)
    b = harness.sample_indices(2**33 + 5, 8192, 64)
    c = harness.sample_indices(2**33 + 6, 8192, 64)
    assert (a == b).all() and not (a == c).all() and len(set(a)) == 64
