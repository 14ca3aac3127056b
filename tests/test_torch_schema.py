"""The port's artifact schema (``repro_torch.telemetry.schema``): the
reference's cases, the same verdicts as ``repro.telemetry.schema`` on the
same records, and the CLI run as a module."""

import json
import os
import pathlib
import subprocess
import sys

import pytest

from repro.telemetry import schema as jschema
from repro_torch.telemetry import schema

ROOT = pathlib.Path(__file__).resolve().parent.parent

RECORDS = [
    {"type": "event", "name": "x", "ts": 1.0},
    {"type": "span", "name": "x", "ts": 1.0, "dur_s": 0.1, "path": "a/x"},
    [1, 2],
    {"type": "bogus", "name": "x", "ts": 0},
    {"type": "event", "name": "", "ts": 0},
    {"type": "span", "name": "x", "ts": 0, "dur_s": -1, "path": "x"},
    {"type": "span", "name": "x", "ts": 0, "dur_s": 0.5},
    {"type": "event", "name": "x", "ts": "now"},
    {"type": "event", "name": "x", "ts": 0, "attrs": [1]},
]

BENCHES = [
    {"bench": "ccm", "rows": [
        {"name": "r", "us_per_call": 12.5, "derived": "8pairs_per_s"}]},
    {"bench": "", "rows": []},
    {"bench": "b", "rows": [{"name": "r", "us_per_call": 0}]},
    {"bench": "b", "rows": [{"name": "", "us_per_call": 1, "derived": 3}]},
    {"bench": "b", "rows": ["row"]},
    "not a doc",
]


def test_schema_rejects_malformed_records():
    assert schema.validate_event({"type": "event", "name": "x",
                                  "ts": 1.0}) == []
    assert schema.validate_event({"type": "span", "name": "x", "ts": 1.0,
                                  "dur_s": 0.1, "path": "a/x"}) == []
    assert schema.validate_event([1, 2])  # not an object
    assert schema.validate_event({"type": "bogus", "name": "x", "ts": 0})
    assert schema.validate_event({"type": "event", "name": "", "ts": 0})
    assert schema.validate_event({"type": "span", "name": "x", "ts": 0,
                                  "dur_s": -1, "path": "x"})
    assert schema.validate_event({"type": "event", "name": "x", "ts": 0,
                                  "attrs": [1]})


def test_schema_bench_and_cli(tmp_path, capsys):
    good = BENCHES[0]
    assert schema.validate_bench(good) == []
    assert schema.validate_bench({"bench": "", "rows": []})
    assert schema.validate_bench({"bench": "b", "rows": [
        {"name": "r", "us_per_call": 0}]})
    bench = tmp_path / "BENCH_x.json"
    bench.write_text(json.dumps(good))
    events = tmp_path / "events.jsonl"
    events.write_text(json.dumps(
        {"type": "event", "name": "e", "ts": 1.0}) + "\n")
    assert schema.main([str(bench), str(events)]) == 0
    assert "schema OK: 2 artifact(s)" in capsys.readouterr().out
    bad = tmp_path / "bad.jsonl"
    bad.write_text('{"type": "nope"}\nnot json\n')
    assert schema.main([str(bad)]) == 1
    assert schema.main([]) == 2


@pytest.mark.parametrize("i", range(len(RECORDS)))
def test_event_verdicts_equal_reference(i):
    assert schema.validate_event(RECORDS[i]) == \
        jschema.validate_event(RECORDS[i])


@pytest.mark.parametrize("i", range(len(BENCHES)))
def test_bench_verdicts_equal_reference(i):
    assert schema.validate_bench(BENCHES[i]) == \
        jschema.validate_bench(BENCHES[i])


def test_files_verdicts_equal_reference(tmp_path):
    log = tmp_path / "events.jsonl"
    log.write_text("\n".join(json.dumps(r) for r in RECORDS)
                   + "\nnot json\n\n")
    unreadable = tmp_path / "BENCH_gone.json"
    for p in (log, unreadable):
        assert schema.validate_file(str(p)) == jschema.validate_file(str(p))
    assert schema.validate_file(str(log))  # the malformed lines are named


def test_cli_as_a_module(tmp_path):
    good = tmp_path / "BENCH_ok.json"
    good.write_text(json.dumps(BENCHES[0]))
    bad = tmp_path / "bad.jsonl"
    bad.write_text('{"type": "nope"}\n')
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))

    def run(*paths):
        return subprocess.run(
            [sys.executable, "-m", "repro_torch.telemetry.schema", *paths],
            env=env, capture_output=True, text=True, timeout=120)

    ok = run(str(good))
    assert ok.returncode == 0 and "schema OK: 1 artifact(s)" in ok.stdout
    res = run(str(good), str(bad))
    assert res.returncode == 1 and "bad.jsonl:1" in res.stderr
    assert run().returncode == 2


SPAN = {"type": "span", "name": "plan.derive", "ts": 1.0, "dur_s": 0.1,
        "path": "session.optimal_E/plan.derive"}


@pytest.mark.parametrize("dev_s,ok", [
    (0, True), (0.0625, True), (3, True),
    (-1e-9, False), ("0.1", False), (None, False), (True, False),
    (float("nan"), False), ([0.1], False)])
def test_span_dev_s_is_an_optional_number_at_least_zero(dev_s, ok):
    assert schema.validate_event(SPAN) == []
    errs = schema.validate_event(dict(SPAN, dev_s=dev_s))
    assert (errs == []) is ok
    if not ok:
        assert "dev_s" in errs[0]


def test_dev_s_only_on_spans():
    ev = {"type": "event", "name": "x", "ts": 1.0, "dev_s": 0.1}
    assert schema.validate_event(ev)
