"""Reduction of a ``torch.profiler`` trace of whole calls.

The method is that of ``chip_smoke.device_profile``: the device's busy
time is the union of its kernel and copy intervals, the idle share one
minus busy over wall. Beside it, the time each named kernel took, and the
device's idle gaps put to what the host had open during them: the
innermost telemetry span (the port's ``session.*``/``engine.*`` ranges,
bridged by ``telemetry.enable_profiler_trace``) and the innermost other
host event (an ``aten`` op or a CUDA runtime call).
"""

from __future__ import annotations

import bisect
import heapq
import re

#: The harness's own range around each profiled call.
CALL_RANGE = "edmbench.call"

_KERNEL = re.compile(r"::(\w+_kernel)\b")


def short_name(name: str) -> str:
    """A kernel's name as the breakdown lists it: a hand-written kernel's
    own name, else the name up to its template arguments."""
    m = _KERNEL.search(name)
    if m:
        return m.group(1)
    return name.split("<", 1)[0].replace("void ", "")[:96]


def merge(intervals):
    """Sorted disjoint union of (start, end) intervals."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


class Profile:
    """Device and host events of the profiled calls, times in µs."""

    def __init__(self, device, host, span_names):
        # device: [(name, start, end)]; host: [(name, start, end)]
        self.device = device
        self.host = host
        self.span_names = set(span_names)
        calls = [(a, b) for n, a, b in host if n == CALL_RANGE]
        if calls:
            self.start = min(a for a, _ in calls)
            self.end = max(b for _, b in calls)
        else:
            self.start = min((a for _, a, _ in device), default=0.0)
            self.end = max((b for _, _, b in device), default=0.0)
        self.busy = merge((max(a, self.start), min(b, self.end))
                          for _, a, b in device
                          if b > self.start and a < self.end)

    @classmethod
    def from_profiler(cls, prof, span_names):
        import torch

        cuda = torch.autograd.DeviceType.CUDA
        ranges = set(span_names) | {CALL_RANGE}
        device, host = [], []
        for e in prof.events():
            rec = (e.name, float(e.time_range.start), float(e.time_range.end))
            if e.device_type != cuda:
                host.append(rec)
            elif e.name not in ranges:  # a host range's mirror on the GPU
                device.append(rec)
        return cls(device, host, span_names)

    @property
    def window_s(self) -> float:
        return (self.end - self.start) * 1e-6

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy) * 1e-6

    def device_time_s(self, pattern: str) -> float:
        """Summed device time of the events whose name matches."""
        rx = re.compile(pattern)
        return sum(b - a for n, a, b in self.device if rx.search(n)) * 1e-6

    def top_ops(self, n: int = 10):
        per = {}
        for name, a, b in self.device:
            key = short_name(name)
            per[key] = per.get(key, 0.0) + (b - a) * 1e-6
        return sorted(([k, v] for k, v in per.items()),
                      key=lambda kv: -kv[1])[:n]

    def gaps(self):
        """The device's idle intervals inside the window."""
        out, t = [], self.start
        for a, b in self.busy:
            if a > t:
                out.append((t, a))
            t = max(t, b)
        if self.end > t:
            out.append((t, self.end))
        return out

    def idle_by_host(self, n: int = 10):
        """Idle seconds summed by what the host had open at each gap's
        middle: "<span> | <op>", the longest first (``edmbench.call``: in
        the call but in no span of the port's; ``python``: in no op)."""
        gaps = sorted(self.gaps(), key=lambda g: (g[0] + g[1]) / 2)
        events = sorted(self.host, key=lambda e: e[1])
        starts = [e[1] for e in events]
        per, active, i = {}, [], 0
        for a, b in gaps:
            mid = (a + b) / 2
            j = bisect.bisect_right(starts, mid)
            for e in events[i:j]:
                heapq.heappush(active, (e[2], e[1], e[0]))
            i = max(i, j)
            while active and active[0][0] < mid:
                heapq.heappop(active)
            span = op = None
            for end, start, name in active:
                if name == CALL_RANGE:
                    continue
                kind = "span" if name in self.span_names else "op"
                cur = span if kind == "span" else op
                if cur is None or end - start < cur[0]:
                    if kind == "span":
                        span = (end - start, name)
                    else:
                        op = (end - start, name)
            label = (f"{span[1] if span else CALL_RANGE} | "
                     f"{op[1] if op else 'python'}")
            per[label] = per.get(label, 0.0) + (b - a) * 1e-6
        return sorted(([k, v] for k, v in per.items()),
                      key=lambda kv: -kv[1])[:n]
