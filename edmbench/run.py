"""Command line of the benchmark: one run of one cell.

    python3 edmbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout; the port is imported from ``src``. The
last line of standard output is the result's JSON object.
"""

import time

T_START = time.perf_counter()

import pathlib  # noqa: E402
import sys  # noqa: E402

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
# This file's folder would shadow standard modules; the checkout's root
# and its src take its place.
sys.path[:] = [str(ROOT), str(ROOT / "src")] + [
    p for p in sys.path if pathlib.Path(p or ".").resolve() != HERE]

from edmbench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t_start=T_START))
