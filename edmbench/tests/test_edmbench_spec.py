"""BENCHMARK.json against the benchmark's contract, and discovery by name:
every cell, configuration, mix, work stage, check and per-layer metric
is a file of its own found by the name the benchmark gives it."""

import json
import math
import re

import pytest

from edmbench import spec
from edmbench_small import CELLS

BENCH = spec.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level_keys_paths_and_command():
    assert set(BENCH) == TOP_KEYS
    assert len(json.dumps(BENCH)) <= 64 * 1024
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_.\-/]{1,200}", p)
        assert not p.endswith("_torch") and (spec.ROOT / p).is_dir()
    cmd = BENCH["command"]
    assert 1 <= len(cmd) <= 32 and all(_line(w) for w in cmd)
    for w in cmd:
        assert not w.startswith("/") and ".." not in w
        if "/" in w:
            assert any(w.startswith(p + "/") for p in BENCH["paths"])


def test_run_seconds_fits_the_full_check():
    rs = BENCH["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    cells = 24  # later PRs may add cells up to the limit at this length
    runs = 2 + 14 * cells
    assert runs * (rs + 60) + cells * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end",
                                     "per_layer"])
def test_names_are_unique_and_well_formed(section):
    names = [e["name"] for e in BENCH[section]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)


def test_configs_have_files_and_their_cuts():
    assert 1 <= len(BENCH["configs"]) <= 24
    used = {w["config"] for w in BENCH["workloads"]}
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used
        assert _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith("edmbench/configs/")
        cfg = spec.config(c["name"])
        assert (spec.ROOT / c["file"]).resolve() == (
            spec.HERE / "configs" / f"{c['name']}.json").resolve()
        assert cfg["reduced"] == c["reduced"] and len(c["reduced"]) <= 16
        for key in c["reduced"]:
            assert NAME.match(key)
            assert cfg[key] != cfg["published"][key]
        for key, value in cfg["published"].items():
            assert key in c["reduced"] or cfg[key] == value


def test_workloads_name_their_parts():
    pairs = set()
    four = 0
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and _line(w["why"])
        assert NAME.match(w["traffic"]) and NAME.match(w["config"])
        pairs.add((w["config"], w["traffic"]))
        four += w["chips"] == 4
        spec.config(w["config"])
        mix = spec.mix(w["traffic"])
        assert callable(spec.generator(mix["generator"]).make)
        chk = spec.check(w["name"])
        assert chk["sample"] >= 1 and chk["limits"]
        for stage in mix["stages"]:
            assert callable(spec.work_stage(stage).work)
    assert len(pairs) == len(BENCH["workloads"])
    assert four <= max(1, len(BENCH["workloads"]) // 4)


def test_metrics_follow_the_contract():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25 and math.isfinite(m["bound"])
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert _line(m["layer"]) and m["moves"] in e2e
        if m["name"].endswith("_roofline") or "roofline" in m["name"] \
                or "mfu" in m["name"]:
            assert m["unit"] == "%"
        for cell in m.get("workloads", CELLS):
            moved = e2e[m["moves"]]
            assert cell in moved.get("workloads", CELLS)
        assert callable(spec.metric_reader(m["name"]).read)


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_reports_what_it_must(cell):
    e2e = spec.cell_metrics(BENCH, cell, "end_to_end")
    names = {m["name"] for m in e2e}
    assert "setup_s" in names and len(names) >= 2
    per = [m for m in BENCH["per_layer"] if cell in m.get("workloads", ())]
    assert per


def test_a_name_that_is_not_there_is_refused():
    with pytest.raises(KeyError):
        spec.cell(BENCH, "no-such-cell")
    with pytest.raises(FileNotFoundError):
        spec.metric_reader("no_such_metric")
    with pytest.raises(FileNotFoundError):
        spec.mix("no_such_mix")
    with pytest.raises(FileNotFoundError):
        spec.generator("no_such_generator")
