"""Streaming append subscriptions: re-scored ρ pushed on every tick.

The port of ``repro.serving.subscriptions``; a tick's scores come back
from the session's device as host arrays.

A client registers a (lib, tgt) watch list on a panel and receives a
tick of re-scored CCM skills every time that panel's library grows —
the streaming shape of the whole-brain workload: recordings arrive
continuously, and the causal map is re-evaluated per append instead of
per request. The O(Lp·Δt) incremental master append makes the per-tick
re-score cheap: scoring rides ``EDM.ccm_batch`` on the already-merged
master, so a tick costs one group launch per distinct E in the watch
list, not a rebuild.

Execution model: ``open`` and ``on_append`` run ONLY inside the panel's
drain worker (the scheduler serializes them with every other op on that
panel), so ticks are linearized against the append stream — tick k
scores exactly library version k, and the pushed values are
bit-identical to ``ccm_batch`` on a quiesced, never-evicted session at
that version. Consumers poll from any thread: ``Subscription.poll`` is
a long-poll (block until a tick or timeout), mirrored over HTTP as
``GET /v1/subscriptions/<id>``.

Bounded queues: a consumer that stops polling loses OLDEST ticks first
(``serve_sub_dropped`` counter) — the subscription never grows without
bound and never blocks the drain worker.
"""

from __future__ import annotations

import collections
import itertools
import threading
import time

import numpy as np

from repro_torch import telemetry

#: Per-subscription tick buffer; beyond it, oldest ticks are dropped.
MAX_PENDING = 256


class Subscription:
    """One watch list on one panel + its pending-tick queue."""

    def __init__(self, sid: str, panel: str, pairs, groups):
        self.id = sid
        self.panel = panel
        self.pairs = pairs                  # [(lib_idx, tgt_idx), ...]
        self.groups = groups                # {E: [positions into pairs]}
        self.closed = False
        self._cv = threading.Condition()
        self._ticks: collections.deque[dict] = collections.deque()
        self._seq = 0
        self.last_rho: np.ndarray | None = None

    def push(self, version: int, L: int, rho: np.ndarray) -> None:
        """Queue one re-scored tick (drain-worker side)."""
        with self._cv:
            if self.closed:
                return
            d_rho = (None if self.last_rho is None
                     else rho - self.last_rho)
            self.last_rho = rho
            self._ticks.append({
                "seq": self._seq, "version": version, "L": L,
                "pairs": self.pairs, "rho": rho, "d_rho": d_rho})
            self._seq += 1
            if len(self._ticks) > MAX_PENDING:
                self._ticks.popleft()
                telemetry.counter("serve_sub_dropped").inc()
            self._cv.notify_all()
        telemetry.counter("serve_sub_ticks").inc()

    def poll(self, timeout: float = 0.0,
             max_ticks: int | None = None) -> list[dict]:
        """Long-poll: block up to ``timeout`` s for ticks, pop them all
        (or the oldest ``max_ticks``). Returns [] on timeout/close.

        Loops on a monotonic deadline: a spurious wakeup (or an
        unrelated ``notify_all`` — ``close`` broadcasts on the same
        condition) re-waits for the remaining time instead of returning
        early with nothing.
        """
        with self._cv:
            deadline = time.monotonic() + max(0.0, timeout)
            while not self._ticks and not self.closed:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                self._cv.wait(remaining)
            n = len(self._ticks) if max_ticks is None else min(
                max_ticks, len(self._ticks))
            return [self._ticks.popleft() for _ in range(n)]

    def close(self) -> None:
        with self._cv:
            self.closed = True
            self._ticks.clear()
            self._cv.notify_all()


class SubscriptionHub:
    """All live subscriptions, indexed by id and by panel."""

    def __init__(self):
        self._lock = threading.Lock()
        self._subs: dict[str, Subscription] = {}
        self._by_panel: dict[str, list[Subscription]] = {}
        self._ids = itertools.count()

    # ------------------------------------------------- drain-worker side

    def open(self, entry, *, pairs, E=None) -> dict:
        """Create a subscription and push its baseline tick.

        Runs inside the panel's drain worker (it touches the session):
        pairs are resolved to indices, E per pair (explicit ``E``, else
        the config's, else the target's cached optimal E), and the
        baseline scores — ``ccm_batch`` at the current library version —
        are both returned and queued as tick 0, so a consumer's first
        poll establishes the reference the deltas are against.
        """
        sess = entry.sess
        if not pairs:
            raise ValueError("subscription needs at least one (lib, tgt) "
                             "pair")
        idx = [(sess.data.index_of(l), sess.data.index_of(t))
               for l, t in pairs]
        groups: dict[int, list[int]] = collections.defaultdict(list)
        for j, (_, ti) in enumerate(idx):
            Ej = int(E) if E is not None else sess._resolve_pair_E(ti, None)
            groups[Ej].append(j)
        sub = Subscription(f"sub-{next(self._ids)}", entry.name, idx,
                           dict(groups))
        rho = self._score(sess, sub)
        with self._lock:
            self._subs[sub.id] = sub
            self._by_panel.setdefault(entry.name, []).append(sub)
            telemetry.gauge("serve_subscriptions").set(len(self._subs))
        sub.push(entry.version, int(sess.data.L), rho)
        telemetry.event("serve.subscribe", panel=entry.name, id=sub.id,
                        pairs=len(idx))
        return {"id": sub.id, "panel": entry.name, "pairs": idx,
                "E_groups": {str(k): v for k, v in sub.groups.items()},
                "version": entry.version, "rho": rho}

    def on_append(self, entry) -> None:
        """Re-score every watch list on this panel (drain-worker side,
        called right after the append executes — the scores are of the
        just-committed library version, linearized by construction)."""
        with self._lock:
            subs = list(self._by_panel.get(entry.name, ()))
        for sub in subs:
            if sub.closed:
                continue
            rho = self._score(entry.sess, sub)
            sub.push(entry.version, int(entry.sess.data.L), rho)

    @staticmethod
    def _score(sess, sub: Subscription) -> np.ndarray:
        """One ``ccm_batch`` group launch per distinct E in the list."""
        rho = np.full(len(sub.pairs), np.nan, np.float32)
        for Ej, members in sub.groups.items():
            got = sess.ccm_batch([sub.pairs[j] for j in members], E=Ej)
            for j, v in zip(members, got):
                rho[j] = v
        return rho

    # ---------------------------------------------------- consumer side

    def get(self, sid: str) -> Subscription:
        with self._lock:
            try:
                return self._subs[sid]
            except KeyError:
                raise KeyError(f"no subscription {sid!r}") from None

    def close_sub(self, sid: str) -> None:
        with self._lock:
            sub = self._subs.pop(sid, None)
            if sub is None:
                raise KeyError(f"no subscription {sid!r}")
            panel_subs = self._by_panel.get(sub.panel, [])
            if sub in panel_subs:
                panel_subs.remove(sub)
            telemetry.gauge("serve_subscriptions").set(len(self._subs))
        sub.close()

    def count(self) -> int:
        with self._lock:
            return len(self._subs)

    def close_all(self) -> None:
        with self._lock:
            subs = list(self._subs.values())
            self._subs.clear()
            self._by_panel.clear()
            telemetry.gauge("serve_subscriptions").set(0)
        for sub in subs:
            sub.close()
