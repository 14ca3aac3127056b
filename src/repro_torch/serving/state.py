"""Panel registry for the EDM server: warm sessions, versioning, LRU.

The port of ``repro.serving.state``: each panel's session lives on
``config.device`` (the card by default, ``device="cpu"`` for the plain
versions), and an eviction frees the master's device memory.

One ``PanelEntry`` per registered panel, owning the long-lived ``EDM``
session (so its kNN master and optimal-E curves stay warm across
requests) and the two version counters the scheduler's
coalescing rule is built on:

* ``version``          — committed library state, bumped when an append
                         EXECUTES. Results are tagged with it.
* ``queued_version``   — what a request submitted *now* will observe,
                         bumped when an append is ENQUEUED. Requests
                         capture it in their coalescing signature, so a
                         query behind a pending append can never be
                         pulled into a batch that runs ahead of it: the
                         append is a version barrier by construction.

**Session memory management.** Every warm session's multi-E kNN master
is ``2·N·E_max·Lp·k_master`` float32/int32 values — at whole-brain
panel counts cold panels cannot all keep theirs resident. The registry
enforces an LRU **byte budget** over cached masters
(``EDMServer(master_budget_mb=...)`` → ``set_budget``): after each
executed batch the scheduler touches the panel's LRU slot and calls
``enforce_budget``, which evicts the least-recently-used panels'
masters (``EDM.evict_master``) until the budget holds. The
most-recently-used panel is never evicted — a single working panel
larger than the budget must not thrash. Eviction is *only* a memory
event: the next request on an evicted panel lazily rebuilds the master
from the current panel (``EDM._master``), and because the incremental
append path is bit-identical to a cold rebuild, every answer (and every
later append) is bit-identical to a never-evicted session. Telemetry:
``serve_evictions`` counter, ``serve_master_bytes`` gauge.

Concurrency: registry mutation goes through the registry lock; session
state is touched only by the panel's single active drain worker (the
scheduler serializes per-panel execution) and by the evictor — the two
exclude each other through ``PanelEntry.exec_lock``, and the evictor
only ever tries that lock non-blocking (a busy panel is hot, skip it).
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from repro_torch import telemetry
from repro_torch.edm.config import EDMConfig
from repro_torch.edm.dataset import Dataset
from repro_torch.edm.session import EDM


def host_array(a) -> np.ndarray:
    """A panel or delta as a float32 host array (tensors from any device)."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a, np.float32)


class PanelEntry:
    """A registered panel: warm session + version counters + LRU slot."""

    def __init__(self, name: str, sess: EDM):
        self.name = name
        self.sess = sess
        self.version = 0
        self.queued_version = 0
        self.last_used = 0           # registry LRU tick, monotonic
        self.evictions = 0
        self.wal = None              # durability.PanelLog when durable
        # Held by the active drain worker for the whole batch and by the
        # evictor around evict_master(): execution and eviction exclude
        # each other; per-panel drains are already serial above this.
        self.exec_lock = threading.Lock()

    def master_nbytes(self) -> int:
        return self.sess.master_nbytes()

    def info(self) -> dict:
        """JSON-ready description (the ``/panels`` listing row)."""
        return {
            "name": self.name,
            "N": self.sess.data.N,
            "L": self.sess.data.L,
            "version": self.version,
            "num_invalid": self.sess.data.num_invalid,
            "E_max": self.sess.config.E_max,
            "tau": self.sess.config.tau,
            "master_bytes": self.master_nbytes(),
            "evictions": self.evictions,
        }


class Registry:
    """Name → ``PanelEntry`` map behind one lock, plus the LRU budget."""

    def __init__(self, *, master_budget_bytes: int | None = None):
        self._lock = threading.Lock()
        self._panels: dict[str, PanelEntry] = {}
        self._budget = master_budget_bytes
        self._tick = 0

    @property
    def lock(self) -> threading.Lock:
        return self._lock

    def register(self, name: str, panel, *, names=None,
                 config: EDMConfig | None = None, **overrides) -> dict:
        """Bind a panel under ``name``; rejects duplicates.

        Construction (including the Dataset screen) happens outside the
        registry lock — a big panel must not stall the scheduler — and
        the name is claimed atomically afterwards.
        """
        panel = host_array(panel)
        if config is None:
            config = EDMConfig(**overrides)
        elif overrides:
            config = config.replace(**overrides)
        sess = EDM(Dataset(panel, names=names, on_invalid=config.on_invalid,
                           device=config.device), config)
        entry = PanelEntry(name, sess)
        with self._lock:
            if name in self._panels:
                raise ValueError(f"panel {name!r} is already registered")
            self._tick += 1
            entry.last_used = self._tick
            self._panels[name] = entry
        return entry.info()

    def adopt(self, name: str, sess: EDM, *, version: int = 0
              ) -> PanelEntry:
        """Claim ``name`` for an already-built session (the recovery
        path: ``EDMServer.recover`` replays a WAL into a session and
        binds it here at its recovered library version)."""
        entry = PanelEntry(name, sess)
        entry.version = entry.queued_version = int(version)
        with self._lock:
            if name in self._panels:
                raise ValueError(f"panel {name!r} is already registered")
            self._tick += 1
            entry.last_used = self._tick
            self._panels[name] = entry
        return entry

    def remove(self, name: str) -> None:
        """Unbind a panel (the rollback when a durable registration's
        WAL publish fails after the name was claimed)."""
        with self._lock:
            self._panels.pop(name, None)

    def get(self, name: str) -> PanelEntry:
        with self._lock:
            try:
                return self._panels[name]
            except KeyError:
                raise KeyError(f"no panel registered as {name!r}") from None

    def names(self) -> list[str]:
        with self._lock:
            return sorted(self._panels)

    def infos(self) -> list[dict]:
        with self._lock:
            entries = list(self._panels.values())
        return [e.info() for e in entries]

    # -------------------------------------------------- LRU byte budget

    def set_budget(self, nbytes: int | None) -> None:
        with self._lock:
            self._budget = nbytes

    @property
    def budget_bytes(self) -> int | None:
        return self._budget

    def touch(self, entry: PanelEntry) -> None:
        """Mark ``entry`` most-recently-used (called after each batch)."""
        with self._lock:
            self._tick += 1
            entry.last_used = self._tick

    def master_bytes_total(self) -> int:
        with self._lock:
            entries = list(self._panels.values())
        return sum(e.master_nbytes() for e in entries)

    def evict(self, entry: PanelEntry, *, blocking: bool = True) -> int:
        """Evict one panel's cached kNN master; returns bytes freed.

        Takes the entry's ``exec_lock`` so eviction never races the
        panel's drain worker mid-batch. Non-blocking mode (the budget
        enforcer) skips a busy panel — it is hot by definition.
        """
        if not entry.exec_lock.acquire(blocking=blocking):
            return 0
        try:
            freed = entry.sess.evict_master()
        finally:
            entry.exec_lock.release()
        if freed:
            entry.evictions += 1
            telemetry.counter("serve_evictions").inc()
            telemetry.event("serve.evict", panel=entry.name, bytes=freed)
        return freed

    def enforce_budget(self, *, protect: str | None = None) -> list[str]:
        """Evict cold masters (LRU-first) until the byte budget holds.

        ``protect`` (the panel a batch just executed on) and, in any
        case, the most-recently-used cached master are exempt — the
        budget bounds *cold* state, it never deadlocks the working set.
        Returns the names evicted. Refreshes ``serve_master_bytes``.
        """
        with self._lock:
            budget = self._budget
            entries = sorted(self._panels.values(),
                             key=lambda e: e.last_used)
        sizes = {e.name: e.master_nbytes() for e in entries}
        total = sum(sizes.values())
        evicted: list[str] = []
        if budget is not None and total > budget:
            cached = [e for e in entries if sizes[e.name] > 0]
            for e in cached[:-1]:  # never the MRU cached master
                if e.name == protect:
                    continue
                freed = self.evict(e, blocking=False)
                if freed:
                    total -= freed
                    evicted.append(e.name)
                if total <= budget:
                    break
        telemetry.gauge("serve_master_bytes").set(total)
        return evicted
