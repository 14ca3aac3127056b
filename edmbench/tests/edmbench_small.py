"""Small CPU-sized copies of the cells for the harness's tests."""

import copy

from edmbench import spec

#: Every cell of BENCHMARK.json.
CELLS = [w["name"] for w in spec.benchmark()["workloads"]]


def small(cell_name: str, *, N: int = 10, L: int = 240, E_max: int = 5):
    """(config, check spec) of a cell cut to a size the CPU runs in
    well under a second; the check samples every series."""
    cell = spec.cell(spec.benchmark(), cell_name)
    cfg = copy.deepcopy(spec.config(cell["config"]))
    cfg.update(num_series=N, series_length=L)
    if "E_max" in cfg["assumed"]:
        cfg["assumed"]["E_max"] = E_max
    chk = copy.deepcopy(spec.check(cell_name))
    chk["sample"] = N
    return cfg, chk
