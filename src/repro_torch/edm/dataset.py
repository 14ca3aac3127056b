"""``Dataset`` — a screened (N, L) panel of time series on one device.

Every panel is screened for non-finite values and constant series at
construction, under an explicit ``on_invalid`` policy (as in
``repro.edm.dataset``):

* ``"raise"`` (default) — refuse the panel with the offending series named.
* ``"mask"``  — keep the panel shape; non-finite entries are zeroed for
  compute and every output touching an invalid series is NaN.
* ``"drop"``  — remove invalid series before binding.

Growing a panel (``append``) is not ported yet (ROADMAP queue 1, item 8).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.edm.config import INVALID_POLICIES


def screen_panel(panel: np.ndarray) -> list[dict]:
    """Invalid-series records of an (N, L) panel (empty = clean).

    A series is invalid when it holds non-finite values or is constant
    (zero spread: its delay vectors coincide and ρ divides by zero).
    """
    arr = np.asarray(panel)
    if arr.size == 0:
        return []
    finite = np.isfinite(arr)
    cnt = (~finite).sum(axis=1)
    lo = np.min(np.where(finite, arr, np.inf), axis=1, initial=np.inf)
    hi = np.max(np.where(finite, arr, -np.inf), axis=1, initial=-np.inf)
    recs = []
    for i in np.nonzero((cnt > 0) | (lo >= hi))[0]:
        reason = (f"{int(cnt[i])} non-finite values" if cnt[i] > 0
                  else "constant series")
        recs.append({"index": int(i), "name": None, "reason": reason})
    return recs


class Dataset:
    """An (N, L) panel of equal-length float32 series on ``device``."""

    def __init__(self, panel, *, names=None, on_invalid: str = "raise",
                 device: str | torch.device = "cpu"):
        if on_invalid not in INVALID_POLICIES:
            raise ValueError(
                f"unknown on_invalid policy {on_invalid!r}; expected one "
                f"of {INVALID_POLICIES}")
        if isinstance(panel, torch.Tensor):
            panel = panel.detach().cpu().numpy()
        arr = np.asarray(panel, np.float32)
        if arr.ndim == 1:
            arr = arr[None, :]
        if arr.ndim != 2:
            raise ValueError(f"panel must be (N, L) or (L,), got {arr.shape}")
        if names is not None:
            names = list(names)
            if len(names) != arr.shape[0]:
                raise ValueError(
                    f"{len(names)} names for {arr.shape[0]} series")
        self.on_invalid = on_invalid
        report = screen_panel(arr)
        for r in report:
            r["name"] = names[r["index"]] if names is not None else None
        self.invalid_report = report
        valid = np.ones(arr.shape[0], bool)
        for r in report:
            valid[r["index"]] = False
        if report and on_invalid == "raise":
            what = "; ".join(
                f"series {r['name'] if r['name'] is not None else r['index']}"
                f": {r['reason']}" for r in report)
            raise ValueError(
                f"panel contains invalid series ({what}); pass "
                f"on_invalid='mask' to NaN-flag them in outputs or "
                f"on_invalid='drop' to remove them")
        if report and on_invalid == "drop":
            arr = arr[valid]
            if names is not None:
                names = [n for n, ok in zip(names, valid) if ok]
            if arr.shape[0] == 0:
                raise ValueError(
                    "every series in the panel is invalid; nothing left "
                    "after on_invalid='drop'")
            valid = np.ones(arr.shape[0], bool)
        elif report:  # mask: zero non-finite entries so kernels never see NaN
            arr = np.nan_to_num(arr, nan=0.0, posinf=0.0, neginf=0.0)
        self.panel = torch.as_tensor(arr, device=device)
        self.names = names
        self.valid = valid

    def append(self, delta):
        raise NotImplementedError(
            "Dataset.append is not ported yet: ROADMAP queue 1, item 8 "
            "(Append and serving)")

    @property
    def N(self) -> int:
        return self.panel.shape[0]

    @property
    def L(self) -> int:
        return self.panel.shape[1]

    @property
    def num_invalid(self) -> int:
        """Invalid series still in the panel (0 under raise/drop)."""
        return int((~self.valid).sum())

    def is_valid(self, i: int) -> bool:
        return bool(self.valid[i])

    def index_of(self, key) -> int:
        """Series index for an int position or a name."""
        if isinstance(key, str):
            if self.names is None:
                raise KeyError(f"panel has no names (asked for {key!r})")
            return self.names.index(key)
        return int(key)

    def __len__(self) -> int:
        return self.N

    def __repr__(self) -> str:
        bad = f", invalid={self.num_invalid}" if self.num_invalid else ""
        return f"Dataset(N={self.N}, L={self.L}, device={self.panel.device}{bad})"
