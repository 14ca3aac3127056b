"""Find a cell's parts by name: ``BENCHMARK.json`` → config, mix, check.

Everything that belongs to one configuration, traffic mix, per-layer
metric, work stage or cell check is a file of its own, found by the name
``BENCHMARK.json`` gives it:

* ``configs/<config>.json`` — the dataset's shape, source, cuts and
  assumed settings;
* ``mixes/<traffic>.json`` — a traffic mix's parameters, data read by
  the generator it names;
* ``generators/<generator>.py`` — a generator of traffic: the calls and
  the window's loop (``generators/__init__.py`` gives its interface);
* ``metrics/<metric>.py`` — a per-layer metric's reader;
* ``work/<stage>.py`` — a stage's operations and bytes from the shapes;
* ``checks/<cell>.json`` — the output check's sample and limits.

So a later cell or metric adds files and entries and edits none.
"""

from __future__ import annotations

import importlib.util
import json
import pathlib

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent


def load_json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: pathlib.Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                   f"(have {[w['name'] for w in bench['workloads']]})")


def config(name: str) -> dict:
    return load_json(HERE / "configs" / f"{name}.json")


def mix(name: str) -> dict:
    return load_json(HERE / "mixes" / f"{name}.json")


def check(cell_name: str) -> dict:
    return load_json(HERE / "checks" / f"{cell_name}.json")


def _module(path: pathlib.Path, label: str):
    spec = importlib.util.spec_from_file_location(label, path)
    if spec is None or not path.exists():
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str):
    """The module of ``metrics/<name>.py`` (its ``read(ctx)``)."""
    return _module(HERE / "metrics" / f"{name}.py",
                   "edmbench_metric_" + name.replace(".", "_"))


def generator(name: str):
    """The module of ``generators/<name>.py`` (its ``make(...)``)."""
    return _module(HERE / "generators" / f"{name}.py",
                   "edmbench_generator_" + name)


def work_stage(name: str):
    """The module of ``work/<name>.py`` (its ``work(**shape)``)."""
    return _module(HERE / "work" / f"{name}.py", "edmbench_work_" + name)


def param(cfg: dict, key: str):
    """A configuration value: a top-level key, else one of ``assumed``."""
    if key in cfg:
        return cfg[key]
    if key in cfg.get("assumed", {}):
        return cfg["assumed"][key]
    raise KeyError(f"configuration {cfg['name']!r} has no {key!r}")


def resolve(args: dict, cfg: dict) -> dict:
    """A mix's arguments with each ``"$key"`` replaced by ``param``."""
    return {k: (param(cfg, v[1:]) if isinstance(v, str)
                and v.startswith("$") else v) for k, v in args.items()}


def cell_metrics(bench: dict, cell_name: str, section: str) -> list[dict]:
    """The metrics of ``section`` that this cell reports: those that list
    it under ``workloads``, and those without the key."""
    return [m for m in bench[section]
            if "workloads" not in m or cell_name in m["workloads"]]
