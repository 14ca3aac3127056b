"""What a per-layer metric's reader is given: the traced run's calls,
spans, counters and profile, the cell's shape, the work counts and the
peaks."""

from __future__ import annotations

import dataclasses

from edmbench import spec


@dataclasses.dataclass
class Context:
    cell: str
    mix: dict
    shape: dict            # N, L and the mix's shape keys (E or E_max, tau, Tp)
    calls: list            # a dict a traced call: wall_s, profiled, counters
    spans: list            # telemetry span events of the traced window
    profile: object        # trace.Profile of the profiled calls, or None
    peaks: dict

    @property
    def profiled(self) -> list:
        return [c for c in self.calls if c["profiled"]]

    def per_call(self, counter: str) -> list:
        """The counter's rise in each traced call."""
        return [c["counters"].get(counter, 0) for c in self.calls]

    def call_shape(self) -> dict:
        """The shape with the launches a call makes (the engine's
        ``edm_launches`` rise, the same in every call)."""
        launches = self.per_call("edm_launches")
        return dict(self.shape, launches=max(launches) if launches else 0)

    def work(self, stage: str) -> dict:
        """One call's work of ``work/<stage>.py``."""
        return spec.work_stage(stage).work(**self.call_shape())

    def least_time_s(self, works, *, io: bool = False) -> float:
        """The least time of the works on the chip: the larger of their
        operations at the peaks and their bytes at the HBM bandwidth
        (``io``: only the bytes that cross the call's boundary)."""
        pk = self.peaks
        ops_s = (sum(w["fp32"] for w in works) / pk["fp32_flops_per_s"]
                 + sum(w["tf32"] for w in works) / pk["tf32_flops_per_s"])
        key = "io_bytes" if io else "bytes"
        return max(ops_s, sum(w[key] for w in works) / pk["hbm_bytes_per_s"])

    def kernel_roofline(self, stage: str, pattern: str):
        """% of the stage's least time in the device time of the kernels
        whose names match, over the profiled calls; None where none ran."""
        if self.profile is None or not self.profiled:
            return None
        t = self.profile.device_time_s(pattern)
        if t <= 0:
            return None
        least = self.least_time_s([self.work(stage)]) * len(self.profiled)
        return 100.0 * least / t

    def call_share(self):
        """% of the profiled calls' wall that the least time of the mix's
        whole work takes, the bytes those crossing the call's boundary
        (None where no call was profiled)."""
        if not self.profiled:
            return None
        works = [self.work(s) for s in self.mix["stages"]]
        least = self.least_time_s(works, io=True)
        wall = sum(c["wall_s"] for c in self.profiled)
        return 100.0 * least * len(self.profiled) / wall

    def idle_share(self):
        if self.profile is None or self.profile.window_s <= 0:
            return None
        return 1.0 - self.profile.busy_s / self.profile.window_s
