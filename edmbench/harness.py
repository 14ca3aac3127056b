"""Run one cell once: set-up, a closed-loop window, the output check.

``run(...)`` does the work and returns the result line's object; ``main``
is the command line (``python3 edmbench/run.py --workload <cell> --seed
<n> --seconds <s> --trace <0|1>``), which also refuses to run without the
cards the cell asks for. The port (``repro_torch``) is the system under
test; the benchmark makes the panel, drives the port's public entry
through the mix's generator (``generators/``), reads its telemetry, and
checks what the timed calls returned against its own plain reference.
"""

from __future__ import annotations

import argparse
import gc
import json
import math
import os
import pathlib
import statistics
import subprocess
import sys
import time
import traceback

import numpy as np

from edmbench import data, spec
from edmbench.context import Context

#: Top-level module names that may not be loaded in a run's process.
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
#: A traced run profiles whole calls until this much wall has passed.
PROFILE_MIN_S = 1.0


def forbidden_modules() -> list[str]:
    """Loaded modules whose whole top-level name is forbidden."""
    return sorted({n.split(".", 1)[0] for n in list(sys.modules)}
                  & set(FORBIDDEN))


def cache_env(root: pathlib.Path) -> None:
    """Build and kernel caches at fixed paths inside the checkout (the
    port's own nvcc cache is ``build/repro_torch/<hash>/`` already)."""
    os.environ["TORCH_EXTENSIONS_DIR"] = str(root / "build" / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(root / "build" / "triton")


def sample_indices(seed: int, n: int, size: int) -> np.ndarray:
    """The checked rows (libraries or series), drawn from the seed."""
    rng = np.random.default_rng([int(seed), 0x5EED])
    return np.sort(rng.choice(n, size=min(size, n), replace=False))


def _counters(telemetry) -> dict:
    return {k: v for k, v in telemetry.metrics_snapshot().items()
            if isinstance(v, (int, float))}


def _delta(before: dict, after: dict) -> dict:
    return {k: v - before.get(k, 0) for k, v in after.items()
            if v != before.get(k, 0)}


def power_limit() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reads them."""
    try:
        r = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=False)
    except (OSError, subprocess.SubprocessError) as exc:
        return f"not read ({exc.__class__.__name__})"
    return r.stdout.strip().replace("\n", "; ") or "not read"


class Window:
    """The measured calls of one run and what was kept of them."""

    def __init__(self, call, units, keep, sample, *, telemetry=None):
        self._call = call
        self._units = units
        self.keep = keep
        self.sample = sample
        self.telemetry = telemetry
        self.calls: list[dict] = []
        self.kept: list = []
        self.units = 0
        self.failed = 0

    def call(self, profiled: bool = False) -> None:
        before = (_counters(self.telemetry) if self.telemetry is not None
                  else None)
        t0 = time.perf_counter()
        try:
            out = self._call()
        except Exception:  # a call that raises is a failed call
            traceback.print_exc()
            self.failed += 1
            out = None
        wall = time.perf_counter() - t0
        rec = {"wall_s": wall, "profiled": profiled}
        if before is not None:
            rec["counters"] = _delta(before, _counters(self.telemetry))
        self.calls.append(rec)
        if out is not None:
            self.units += self._units(out)
            self.kept.append(self.keep(out, self.sample))


def _profiled_calls(torch, win: Window):
    from torch.profiler import ProfilerActivity, profile, record_function

    from edmbench.trace import CALL_RANGE

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        while True:
            with record_function(CALL_RANGE):
                win.call(profiled=True)
            torch.cuda.synchronize()
            if time.perf_counter() - t0 >= PROFILE_MIN_S:
                break
    return prof


class Cell:
    """A cell's parts found by name, and the seed's panel and sample."""

    def __init__(self, cell_name: str, seed: int, *, bench=None, cfg=None,
                 check_spec=None):
        from edmbench import reference

        self.seed = seed
        self.bench = spec.benchmark() if bench is None else bench
        self.cell = spec.cell(self.bench, cell_name)
        self.cfg = spec.config(self.cell["config"]) if cfg is None else cfg
        self.mix = spec.mix(self.cell["traffic"])
        self.check_spec = (spec.check(cell_name) if check_spec is None
                           else check_spec)
        self.check = reference.module(self.mix["check"])
        self.N = int(self.cfg["num_series"])
        self.L = int(self.cfg["series_length"])
        self.panel = data.logistic_network(self.N, self.L, seed=seed)
        self.sample = sample_indices(seed, self.N,
                                     int(self.check_spec["sample"]))

    def generator(self, torch, device: str):
        """The mix's traffic on the device panel (``generators/``)."""
        return spec.generator(self.mix["generator"]).make(
            self.mix, self.cfg, torch.from_numpy(self.panel).to(device),
            device, self.seed)

    def expected(self, params: dict, device: str,
                 precision: str = "float64"):
        return self.check.expected(self.panel, self.sample, params,
                                   device=device, precision=precision)


def run(cell_name: str, seed: int, seconds: float, trace: bool, *,
        device: str = "cuda", bench: dict | None = None,
        cfg: dict | None = None, check_spec: dict | None = None,
        control: str | None = None, t_start: float | None = None,
        log=print) -> dict:
    """One run of one cell → the result line's object.

    ``bench``, ``cfg`` and ``check_spec`` default to the files the cell
    names; tests pass small configurations and run on the CPU.
    ``control`` (a precision of the reference, ``"tf32"`` for the
    control) puts the reference in the program's place: every call of
    the set-up and the window returns the reference's sampled part in the
    program's output, and the same check judges it. The benchmark's own
    runs never set it.
    """
    import torch

    from repro_torch import telemetry

    t_start = time.perf_counter() if t_start is None else t_start
    cuda = device.startswith("cuda")

    # ---- set-up: the panel, the traffic's state, one warm call
    c = Cell(cell_name, seed, bench=bench, cfg=cfg, check_spec=check_spec)
    bench, mix, check = c.bench, c.mix, c.check
    gen = c.generator(torch, device)
    params = dict(gen.params)
    call = gen.call
    if control is not None:
        def call():
            part = c.expected(params, device, precision=control)
            return check.as_output(part, c.sample, c.N)
    call()
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start

    # ---- the window, driven by the mix's generator
    rec = None
    if trace:
        telemetry.enable()
        telemetry.enable_profiler_trace(True)
        rec = telemetry.Recorder()
        telemetry.add_sink(rec)
    win = Window(call, gen.units, check.keep, c.sample,
                 telemetry=telemetry if trace else None)
    prof = None
    t0 = time.perf_counter()
    if trace and cuda:
        prof = _profiled_calls(torch, win)
    gen.window(win, t0, seconds)
    window_s = time.perf_counter() - t0
    if trace:
        telemetry.remove_sink(rec)
        telemetry.enable_profiler_trace(False)
        telemetry.disable()
    mem_peak = torch.cuda.max_memory_allocated() if cuda else 0
    walls = [w["wall_s"] for w in win.calls]
    log(f"window {window_s:.6f} s, {len(walls)} calls, call s min "
        f"{min(walls):.6f} median {statistics.median(walls):.6f} max "
        f"{max(walls):.6f}; set-up {setup_s:.6f} s")
    log(f"memory: max_memory_allocated {mem_peak} B")
    if cuda:
        log(f"card: {power_limit()}")

    # ---- per-layer metrics of a traced run
    metrics: dict = {}
    profile = None
    if trace:
        from edmbench.trace import Profile

        if prof is not None:
            names = {s["path"] for s in rec.spans()}
            profile = Profile.from_profiler(prof, names)
            del prof
        shape = {"N": c.N, "L": c.L, **spec.resolve(mix["shape"], c.cfg)}
        ctx = Context(cell=cell_name, mix=mix, shape=shape, calls=win.calls,
                      spans=rec.spans(), profile=profile,
                      peaks=spec.load_json(spec.HERE / "peaks.json"))
        for m in _per_layer(bench, cell_name):
            value = spec.metric_reader(m["name"]).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        e2e = {m["name"]: m for m in spec.cell_metrics(bench, cell_name,
                                                       "end_to_end")}
        values = dict(gen.end_to_end(win, window_s), setup_s=setup_s)
        metrics = {name: {"value": values[name], "unit": m["unit"]}
                   for name, m in e2e.items()}

    # ---- the output check, once the program's state is freed
    gen.close()
    del gen, call, win._call
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    readings = check.readings(win.kept, c.expected(params, device))
    log(f"reference {time.perf_counter() - t_ref:.6f} s")
    checks = {name: {"value": value,
                     "limit": c.check_spec["limits"][name]["limit"]}
              for name, value in readings.items()}
    correct = (bool(win.calls) and win.failed == 0
               and all(math.isfinite(k["value"]) and k["limit"] is not None
                       and k["value"] <= k["limit"]
                       for k in checks.values()))
    for k in checks.values():  # JSON has no inf or NaN: name them
        if not math.isfinite(k["value"]):
            k["value"] = str(k["value"])

    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": int(c.cell["chips"]), "memory_peak_bytes": int(mem_peak)}
    out = {"correct": correct, "attempted": len(win.calls),
           "failed": win.failed, "metrics": metrics, "device": dev}
    if trace and profile is not None:
        dev["busy_s"] = profile.busy_s
        dev["window_s"] = profile.window_s
        out["breakdown"] = {"device_ops": profile.top_ops(10),
                            "idle_gaps": profile.idle_by_host(10)}
    out["checks"] = checks
    return out


def _per_layer(bench: dict, cell_name: str) -> list[dict]:
    """Per-layer metrics of the cell: those listing it, and those without
    a list whose end-to-end metric the cell reports."""
    e2e = {m["name"] for m in spec.cell_metrics(bench, cell_name,
                                                "end_to_end")}
    return [m for m in bench["per_layer"]
            if cell_name in m.get("workloads", ())
            or ("workloads" not in m and m["moves"] in e2e)]


def main(argv=None, t_start: float | None = None) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    if not (spec.ROOT / "src" / "repro_torch").is_dir():
        print("edmbench: the port (src/repro_torch) is not in this "
              "checkout", file=sys.stderr)
        return 2
    bench = spec.benchmark()
    cell = spec.cell(bench, args.workload)
    cache_env(spec.ROOT)
    import torch

    if not torch.cuda.is_available():
        print("edmbench: no CUDA device", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < int(cell["chips"]):
        print(f"edmbench: the cell needs {cell['chips']} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    out = run(args.workload, args.seed, args.seconds, bool(args.trace),
              bench=bench, t_start=t_start)
    found = forbidden_modules()
    if found:
        print(f"edmbench: forbidden modules loaded: {found}",
              file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0
