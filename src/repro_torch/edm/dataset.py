"""``Dataset`` — a screened (N, L) panel of time series on one device.

Every panel is screened for non-finite values and constant series at
construction, under an explicit ``on_invalid`` policy (as in
``repro.edm.dataset``):

* ``"raise"`` (default) — refuse the panel with the offending series named.
* ``"mask"``  — keep the panel shape; non-finite entries are zeroed for
  compute and every output touching an invalid series is NaN.
* ``"drop"``  — remove invalid series before binding.

``append`` grows every series by Δt points under the same policy, judging
the grown panel from running per-series statistics and the new columns
only.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.edm.config import INVALID_POLICIES
from repro_torch.kernels import ops


def series_stats(arr: np.ndarray) -> dict:
    """Running screening statistics of an (N, dt) column block.

    ``{"cnt": non-finite count, "lo"/"hi": finite min/max}`` per series —
    enough for both invalidity tests (non-finite values; no spread). The
    statistics of two column blocks combine with ``merge_stats``, so a
    grown panel is screened from its new columns alone.
    """
    arr = np.asarray(arr)
    finite = np.isfinite(arr)
    return {
        "cnt": (~finite).sum(axis=1).astype(np.int64),
        "lo": np.min(np.where(finite, arr, np.inf), axis=1, initial=np.inf),
        "hi": np.max(np.where(finite, arr, -np.inf), axis=1,
                     initial=-np.inf),
    }


def merge_stats(a: dict, b: dict) -> dict:
    """Statistics of the column-concatenation of two blocks."""
    return {"cnt": a["cnt"] + b["cnt"],
            "lo": np.minimum(a["lo"], b["lo"]),
            "hi": np.maximum(a["hi"], b["hi"])}


def _records(cnt, lo, hi, delta_cnt=None) -> list[dict]:
    """Invalid-series records from screening statistics (empty = clean).

    ``delta_cnt`` (the appended block's non-finite counts) names the
    faults that arrived with an append as such.
    """
    bad = cnt > 0
    const = ~bad & (lo >= hi)  # no finite spread (lo > hi: no data)
    recs = []
    for i in np.nonzero(bad | const)[0]:
        if not bad[i]:
            reason = "constant series"
        elif delta_cnt is not None and delta_cnt[i] > 0:
            reason = (f"{int(delta_cnt[i])} non-finite values in "
                      f"appended delta")
        else:
            reason = f"{int(cnt[i])} non-finite values"
        recs.append({"index": int(i), "name": None, "reason": reason})
    return recs


def screen_panel(panel: np.ndarray, *, prior: dict | None = None
                 ) -> list[dict]:
    """Invalid-series records of an (N, L) panel (empty = clean).

    A series is invalid when it holds non-finite values or is constant
    (zero spread: its delay vectors coincide and ρ divides by zero).

    With ``prior=`` (the ``series_stats`` of the columns already
    screened), ``panel`` is only the appended (N, Δt) block: the grown
    panel is judged from the merged statistics in O(N·Δt).
    """
    arr = np.asarray(panel)
    if arr.size == 0 and prior is None:
        return []
    stats = series_stats(arr)
    if prior is None:
        return _records(stats["cnt"], stats["lo"], stats["hi"])
    if len(prior["cnt"]) != arr.shape[0]:
        raise ValueError(
            f"delta has {arr.shape[0]} series but prior stats cover "
            f"{len(prior['cnt'])}")
    m = merge_stats(prior, stats)
    return _records(m["cnt"], m["lo"], m["hi"], delta_cnt=stats["cnt"])


def resolve_device(device: str | torch.device, owner: str) -> torch.device:
    """``device`` as a torch device, a bare "cuda" pinned to the current
    card; raises when it asks for CUDA and none exists (no CPU fallback)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"{owner}(device={str(device)!r}) but CUDA is not available; "
                f"the port does not fall back to the CPU — pass "
                f"device='cpu' to run the plain versions there")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class Dataset:
    """An (N, L) panel of equal-length float32 series on ``device``: the
    card by default, as ``EDMConfig``; ``device="cpu"`` runs the plain
    versions."""

    def __init__(self, panel, *, names=None, on_invalid: str = "raise",
                 device: str | torch.device = "cuda"):
        device = resolve_device(device, "Dataset")
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
        stats = series_stats(arr)
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
            stats = {k: v[valid] for k, v in stats.items()}
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
        self._stats = stats  # running series_stats of the raw panel
        self._embeddings: dict[tuple[int, int], torch.Tensor] = {}

    def append(self, delta) -> list[dict]:
        """Grow every series by Δt points under the bound policy.

        The screen is O(N·Δt): the running per-series statistics absorb
        only the new columns. ``"raise"`` rejects the delta before any
        state changes, naming the offending series; ``"mask"`` zeroes
        non-finite delta entries and flags the series invalid; ``"drop"``
        removes the series the delta invalidated.

        Returns the records of series this delta invalidated, with
        pre-append indices (positions in the panel as it was when the call
        started), so a caller holding per-series state (the ``EDM``
        session's kNN master) can compact it to match. The statistics are
        of the raw delta, so a masked series never silently heals; a
        constant series becomes valid once its values spread.
        """
        if isinstance(delta, torch.Tensor):
            delta = delta.detach().cpu().numpy()
        arr = np.asarray(delta, np.float32)
        if arr.ndim == 1:
            arr = arr[None, :]
        if arr.ndim != 2 or arr.shape[0] != self.N:
            raise ValueError(
                f"delta must be ({self.N}, dt), got {tuple(arr.shape)}")
        if arr.shape[1] < 1:
            raise ValueError("delta must append at least one point")
        fresh = [dict(r) for r in screen_panel(arr, prior=self._stats)
                 if self.valid[r["index"]]]
        for r in fresh:
            r["name"] = (self.names[r["index"]]
                         if self.names is not None else None)
        if fresh and self.on_invalid == "raise":
            what = "; ".join(
                f"series {r['name'] if r['name'] is not None else r['index']}"
                f": {r['reason']}" for r in fresh)
            raise ValueError(
                f"append rejected: delta would invalidate series ({what}); "
                f"bind the panel with on_invalid='mask' or 'drop' to accept "
                f"faulty ticks")
        merged = merge_stats(self._stats, series_stats(arr))
        if self.num_invalid or fresh:  # keep NaN out of the kernels
            arr = np.nan_to_num(arr, nan=0.0, posinf=0.0, neginf=0.0)
        panel = torch.cat([self.panel, torch.as_tensor(
            arr, device=self.panel.device)], dim=1)
        if fresh and self.on_invalid == "drop":
            bad = {r["index"] for r in fresh}
            keep = np.array([i for i in range(self.N) if i not in bad], int)
            if keep.size == 0:
                raise ValueError(
                    "append would invalidate every remaining series; "
                    "refusing to drop the whole panel")
            panel = panel[torch.as_tensor(keep, device=panel.device)]
            merged = {k: v[keep] for k, v in merged.items()}
            if self.names is not None:
                self.names = [self.names[i] for i in keep]
            self.valid = np.ones(panel.shape[0], bool)
        else:
            self.valid = np.asarray(
                (merged["cnt"] == 0) & (merged["lo"] < merged["hi"]))
        self.panel = panel
        self._stats = merged
        self.invalid_report = self.invalid_report + fresh
        self._embeddings.clear()
        return fresh

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

    def series(self, key) -> torch.Tensor:
        """One series (an int position or a name) as an (L,) tensor."""
        return self.panel[self.index_of(key)]

    def embedding(self, E: int, tau: int = 1) -> torch.Tensor:
        """Cached (N, Lp, E) delay embeddings of every series, on the
        panel's device; the same tensor until ``append`` grows the panel."""
        key = (int(E), int(tau))
        if key not in self._embeddings:
            self._embeddings[key] = ops.delay_embed(self.panel, key[0],
                                                    key[1])
        return self._embeddings[key]

    def __len__(self) -> int:
        return self.N

    def __repr__(self) -> str:
        bad = f", invalid={self.num_invalid}" if self.num_invalid else ""
        return f"Dataset(N={self.N}, L={self.L}, device={self.panel.device}{bad})"
