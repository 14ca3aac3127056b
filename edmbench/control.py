"""The readings a cell's limits are set from, at the cell's own size.

    python3 edmbench/control.py --workload <cell> --seeds 11 12 ... [--control 3] [--seconds 0]

For each seed, a run of the cell as the benchmark makes it (``harness.run``,
its window ``--seconds`` long: at 0, one call): the program's readings,
the lower end of a limit. For the first ``--control`` seeds also a run
with the control in the program's place: the reference itself in the
precision below the configuration's (float32 with TF32 products), judged
by the same check and limits, so its ``correct`` has to come out false
(the upper end). One JSON line a seed. The benchmark's own runs never run
this.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
sys.path[:] = [str(ROOT), str(ROOT / "src")] + [
    p for p in sys.path if pathlib.Path(p or ".").resolve() != HERE]

from edmbench import harness  # noqa: E402


#: The precision below the configurations' float32.
CONTROL = "tf32"


def _brief(out: dict) -> dict:
    return {k: out[k] for k in ("correct", "attempted", "failed", "checks")}


def readings(cell_name: str, seed: int, *, control: bool, device: str,
             seconds: float = 0.0, cfg: dict | None = None,
             check_spec: dict | None = None, log=print) -> dict:
    """One seed's program (and control) runs of a cell."""
    kw = dict(device=device, cfg=cfg, check_spec=check_spec, log=log)
    out = {"seed": seed,
           "program": _brief(harness.run(cell_name, seed, seconds, False,
                                         **kw))}
    if control:
        out["control"] = _brief(harness.run(cell_name, seed, seconds, False,
                                            control=CONTROL, **kw))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", type=int, default=3,
                    help="run the control on this many of the seeds")
    ap.add_argument("--seconds", type=float, default=0.0,
                    help="each run's window (0: one call)")
    args = ap.parse_args(argv)
    harness.cache_env(ROOT)
    import torch

    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    for i, seed in enumerate(args.seeds):
        r = readings(args.workload, seed, control=i < args.control,
                     device="cuda", seconds=args.seconds,
                     log=lambda *a: print(*a, file=sys.stderr))
        print(json.dumps({"cell": args.workload, **r}), flush=True)
    print(f"control: {time.perf_counter() - T_START:.1f} s",
          file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
