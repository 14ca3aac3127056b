"""A closed loop of calls of one ``EDM`` session method: one caller,
back-to-back calls, as one analyst's job runs.

The mix names the session's arguments, the method called, its arguments,
whether each call binds a fresh session (``"per_call"``) or all calls
share the one bound in set-up (``"shared"``), the units of a call's work
and the rate metric they make. ``"$key"`` arguments are the
configuration's values. Each call returns host arrays, so a returned call
is a finished one.
"""

from __future__ import annotations

import time

import numpy as np

from edmbench import spec


def make(mix: dict, cfg: dict, panel, device: str, seed: int):
    return SessionCalls(mix, cfg, panel, device)


class SessionCalls:
    def __init__(self, mix: dict, cfg: dict, panel, device: str):
        from repro_torch.edm import EDM

        self._EDM = EDM
        self.mix = mix
        self.panel = panel
        self.device = device
        self.session_args = spec.resolve(mix["session_args"], cfg)
        self.call_args = spec.resolve(mix["call_args"], cfg)
        self.params = {**self.session_args, **self.call_args}
        if mix["session"] not in ("shared", "per_call"):
            raise ValueError(f"unknown session kind {mix['session']!r}")
        self.session = (self._bind() if mix["session"] == "shared"
                        else None)

    def _bind(self):
        return self._EDM(self.panel, device=self.device, **self.session_args)

    def call(self):
        sess = self.session if self.session is not None else self._bind()
        return getattr(sess, self.mix["call"])(**self.call_args)

    def units(self, out) -> int:
        kind = self.mix["units"]
        if kind == "matrix_entries":  # an (N_lib, N_target) ρ matrix
            return int(np.asarray(out).shape[0] * np.asarray(out).shape[1])
        if kind == "series":          # (E_opt (N,), ρ(E) (N, E_max))
            return int(np.asarray(out[0]).shape[0])
        raise ValueError(f"unknown units {kind!r}")

    def window(self, win, t0: float, seconds: float) -> None:
        """Calls start until ``seconds`` have passed; the window ends when
        the call in flight then completes."""
        while not win.calls or time.perf_counter() - t0 < seconds:
            win.call()

    def end_to_end(self, win, window_s: float) -> dict:
        """The rate: all the work of the window's calls over its whole
        elapsed time."""
        return {self.mix["rate_metric"]: win.units / window_s}

    def close(self) -> None:
        self.session = None
        self.panel = None
