"""Fault tolerance: preemption handling, heartbeats, straggler detection.

The port's copy of ``repro.distributed.fault``, over the port's
telemetry. The hooks are fully functional in-process:

  * ``PreemptionGuard`` — converts SIGTERM/SIGINT into a "checkpoint and
    exit cleanly" request the journaled runner polls at each tile.
  * ``StragglerMonitor`` — rolling median of step times; flags steps
    slower than ``threshold ×`` median and records them for the run
    report.
  * ``Heartbeat`` — appends (step, wall-time) to a file so an external
    watchdog can detect hangs and restart the job (restart-safety is
    provided by CheckpointManager's atomic auto-resume).
"""

from __future__ import annotations

import os
import signal
import statistics
import time

from repro_torch import telemetry


class PreemptionGuard:
    """Converts SIGTERM/SIGINT into a polled "checkpoint and exit" flag.

    Usable as a context manager: handlers are installed on ``__enter__``
    (or construction) and the previous handlers restored on ``__exit__``
    — the ``repro_torch.edm.runner`` drivers poll ``requested`` between
    tile launches and turn a preemption into "commit the journal, exit 17"
    instead of lost work.
    """

    def __init__(self, signals=(signal.SIGTERM,)):
        self.requested = False
        self._prev = {}
        for sig in signals:
            self._prev[sig] = signal.signal(sig, self._handler)

    def _handler(self, signum, frame):
        self.requested = True

    def restore(self):
        for sig, prev in self._prev.items():
            signal.signal(sig, prev)
        self._prev = {}

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.restore()
        return False


class StragglerMonitor:
    """Rolling-median launch timer; flags launches ``threshold ×`` slower.

    ``threshold`` is configurable per run (``EDMConfig(
    straggler_threshold=...)`` threads it through ``EDM.xmap(run_dir=
    ...)``); ``clock`` is injectable so regression tests can replay a
    synthetic timing sequence deterministically. Each flagged launch is
    also published as a ``straggler.flag`` telemetry event and counted
    in ``edm_stragglers_flagged``.
    """

    def __init__(self, threshold: float = 2.0, window: int = 50,
                 clock=time.monotonic):
        if not threshold > 0:
            raise ValueError(f"threshold must be > 0, got {threshold}")
        self.threshold = float(threshold)
        self.window = window
        self.clock = clock
        self.times: list[float] = []
        self.flagged: list[tuple[int, float, float]] = []
        self._t0 = None

    def start(self):
        self._t0 = self.clock()

    def stop(self, step: int) -> bool:
        dt = self.clock() - self._t0
        hist = self.times[-self.window:]
        self.times.append(dt)
        if len(hist) >= 5:
            med = statistics.median(hist)
            if dt > self.threshold * med:
                self.flagged.append((step, dt, med))
                telemetry.counter("edm_stragglers_flagged").inc()
                telemetry.event("straggler.flag", step=step, seconds=dt,
                                rolling_median_s=med,
                                threshold=self.threshold)
                return True
        return False

    def report(self) -> dict:
        """JSON-ready summary for a run report: per-step stats + flags."""
        return {
            "steps": len(self.times),
            "median_s": (statistics.median(self.times)
                         if self.times else None),
            "max_s": max(self.times) if self.times else None,
            "threshold": self.threshold,
            "flagged": [
                {"step": s, "seconds": dt, "rolling_median_s": med}
                for s, dt, med in self.flagged
            ],
        }


class Heartbeat:
    def __init__(self, path: str):
        self.path = path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)

    def beat(self, step: int):
        with open(self.path, "a") as f:
            f.write(f"{step},{time.time():.3f}\n")
