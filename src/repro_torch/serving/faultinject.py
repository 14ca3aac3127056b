"""Deterministic fault injection for the serving stack.

The port's own copy of ``repro.serving.faultinject``. The chaos suite
(``tests/test_torch_serving_chaos.py``) needs to kill workers,
fail launches, starve memory, slow batches down, and break WAL writes
*on purpose*, reproducibly, without monkeypatching scheduler internals.
``FaultInjector`` is the one knob: construct it with a seed and a rate
per injection point, hand it to ``EDMServer(faults=...)``, and the
scheduler / durability layers consult it at five fixed points:

=================  =====================================================
point              where it fires
=================  =====================================================
``worker_death``   start of a drain batch — raises a ``BaseException``
                   so the worker dies exactly like a real crash (its
                   in-flight futures fail with "serve worker died", the
                   panel is released, the supervisor may revive it).
``launch_error``   inside op execution — an ordinary ``Exception``; a
                   coalesced launch fails the whole batch, a loop-path
                   op fails only its own request.
``launch_oom``     same site, but the message carries the anchored
                   ``RESOURCE_EXHAUSTED`` marker that
                   ``repro_torch.edm.runner.is_oom_error`` keys on —
                   the allocator-failure shape.
``slow_launch``    sleeps ``slow_s`` before executing — the straggler /
                   deadline-pressure shape.
``wal_write``      inside ``durability.PanelLog.log_append`` before any
                   bytes hit the file — an ``OSError``: the append is
                   applied in memory but NOT durable, which must
                   quarantine the panel (memory is ahead of the log).
=================  =====================================================

Determinism: every point owns an independent ``numpy`` Generator seeded
``(seed, point_index)``, so the k-th *draw at a given point* is a pure
function of the seed — independent of what the other points are doing.
Under a thread pool the mapping of draws to requests still depends on
scheduling, so a chaos scenario is *statistically* reproducible (same
number of fires per point for the same draw count) while every assert
stays schedule-independent (linearization against ticket order).

``max_fires`` caps total fires per point — scenarios can guarantee
"exactly one worker death" shapes. ``fired`` / ``calls`` counters are
exposed for assertions.
"""

from __future__ import annotations

import threading
import time

import numpy as np

#: The fixed injection points, in (seed-stream) order.
POINTS = ("worker_death", "launch_error", "launch_oom", "slow_launch",
          "wal_write")


class InjectedWorkerDeath(BaseException):
    """Raised at the ``worker_death`` point; a ``BaseException`` so it
    rides the scheduler's real worker-death path (which deliberately
    does not catch ``Exception``-only)."""


class InjectedFault(RuntimeError):
    """An injected launch failure (``launch_error`` / ``launch_oom``)."""


class InjectedWalError(OSError):
    """An injected WAL write failure (``wal_write`` point)."""


class FaultInjector:
    """Seeded, rate-based fault source for the five serving points."""

    def __init__(self, seed: int = 0, *, rates: dict | None = None,
                 slow_s: float = 0.02, max_fires: int | None = None):
        rates = dict(rates or {})
        unknown = set(rates) - set(POINTS)
        if unknown:
            raise ValueError(f"unknown fault points {sorted(unknown)}; "
                             f"expected among {POINTS}")
        self.rates = {p: float(rates.get(p, 0.0)) for p in POINTS}
        self.slow_s = float(slow_s)
        self.max_fires = max_fires
        self._lock = threading.Lock()
        self._rngs = {p: np.random.default_rng((int(seed), i))
                      for i, p in enumerate(POINTS)}
        self.calls = {p: 0 for p in POINTS}
        self.fired = {p: 0 for p in POINTS}

    def fire(self, point: str) -> bool:
        """Draw the point's next Bernoulli sample; True means inject."""
        with self._lock:
            self.calls[point] += 1
            if self.rates[point] <= 0.0:
                return False
            if (self.max_fires is not None
                    and self.fired[point] >= self.max_fires):
                return False
            hit = bool(self._rngs[point].random() < self.rates[point])
            if hit:
                self.fired[point] += 1
            return hit

    def check(self, point: str, *, detail: str = "") -> None:
        """Consult one point; raises (or sleeps) when it fires."""
        if not self.fire(point):
            return
        where = f" [{detail}]" if detail else ""
        if point == "worker_death":
            raise InjectedWorkerDeath(f"injected worker death{where}")
        if point == "launch_error":
            raise InjectedFault(f"injected launch failure{where}")
        if point == "launch_oom":
            raise InjectedFault(
                f"RESOURCE_EXHAUSTED: injected allocation failure{where}")
        if point == "slow_launch":
            time.sleep(self.slow_s)
            return
        if point == "wal_write":
            raise InjectedWalError(f"injected WAL write failure{where}")
        raise AssertionError(f"unreachable fault point {point!r}")
