"""Continuous batching scheduler for EDM serving: per-panel drains.

The port of ``repro.serving.scheduler``. Panels are drained by a pool of
workers, each panel by at most one at a time, so independent panels run
concurrently while each keeps its per-panel guarantees. On the card the
workers' launches share the device's current stream, in the order the
workers issue them; the kernel wrappers' ``launches`` counts are bare
increments, exact with one worker and approximate with several.

* **One FIFO queue per panel.** Every request carries a **signature**
  captured at submit time under the scheduler lock. For a default-cap
  CCM request that is ``("ccm", panel, E, queued_version)`` — the
  compatibility class: same panel, same embedding geometry, same
  library state.
* **A worker pool drains panels concurrently.** A panel with queued
  work sits on a ready list; a free worker claims it (round-robin
  across panels — a busy panel cannot starve the others), drains ONE
  batch, and returns the panel to the ready list if work remains. At
  most one worker drains a given panel at any moment, so per-panel
  execution stays serial: FIFO order, signature coalescing, and the
  append version barrier are per-panel properties and survive the pool
  unchanged. Distinct panels execute on distinct workers concurrently.
* **Batching is unchanged.** The drain takes the panel's HEAD request
  and pulls every queued signature-match into its batch, in arrival
  order. n compatible CCM requests become ONE ``EDM.ccm_batch`` launch;
  ``ccm_batch``'s bit contract is batch invariance, so
  ``ccm_batch([(l, t)])`` is the quiesced oracle for every served
  answer. Whole-panel ops coalesce only as exact duplicates. An
  **append is a version barrier**: submitting it bumps the panel's
  ``queued_version`` so requests behind it can never be batched ahead
  of it.
* **Failures are per-request, never structural.** An op raising in a
  loop-executed batch fails only that request's future; a coalesced
  single-launch batch fails all of its futures (they shared the
  launch); either way the panel queue keeps draining and the version
  barrier stays consistent (a failed append leaves the committed
  version untouched — later requests simply sign with the already-bumped
  queued version and execute normally). A worker killed by a
  ``BaseException`` fails its in-flight batch, releases the panel, and
  is reported dead by ``worker_stats()`` / ``health()`` until
  ``revive_workers()`` — or the supervisor — respawns it.
* **Memory budget hook.** After each batch the worker touches the
  panel's LRU slot and calls ``Registry.enforce_budget()`` — cold
  panels' cached kNN masters are evicted until the byte budget holds
  (see ``state.py``; rebuild-on-demand is bit-identical).

The overload/failure contract — **every submitted request resolves**,
with a typed error when it cannot resolve with a result:

* **Admission control** — ``max_queue_depth`` / ``max_queued_bytes``
  bound the total queued work; a burst that would exceed either is
  rejected *whole* at submit with ``Overloaded`` carrying a
  ``retry_after_s`` estimate derived from the ``serve_latency_ms``
  histograms (HTTP maps it to 429 + ``Retry-After``).
* **Deadlines** — a per-request ``deadline_s`` starts at submit; a
  request still queued past its deadline is failed with
  ``DeadlineExceeded`` at claim time, before it wastes a launch
  (HTTP 504). Deadlines never enter coalescing signatures.
* **Quarantine** — ``quarantine_after`` consecutive *batch-level*
  failures (shared-launch exceptions or worker deaths; per-request
  loop errors don't count) quarantine the panel: queued requests fail
  immediately and later submits raise ``PanelQuarantined`` with the
  last error, so one poisoned panel cannot grind the pool.
  ``clear_quarantine`` is the operator reset. A WAL write failure
  quarantines unconditionally — the in-memory library is ahead of the
  log and serving it would break the recovery bit-contract.
* **Supervision** — ``supervise=True`` runs a daemon thread that
  auto-revives dead drain workers with capped exponential backoff
  (``serve_worker_revives`` counter; backoff resets once the revived
  worker completes a batch).
* **Graceful drain** — ``drain()`` stops admission (``Draining``,
  HTTP 503) and waits for the per-panel queues to empty; the server
  layer then fsyncs WALs and exits 0 on SIGTERM.
* **Fault injection** — ``faults=FaultInjector(...)`` threads the five
  deterministic injection points of ``serving.faultinject`` through
  claim/execute (the chaos suite's entry).

Telemetry: ``serve_queue_depth`` / ``serve_queued_bytes`` /
``serve_batch_occupancy`` / ``serve_master_bytes`` gauges,
``serve_latency_ms_<op>`` histograms, ``serve_requests`` /
``serve_batches`` / ``serve_launches_saved`` / ``serve_evictions`` /
``serve_worker_deaths`` / ``serve_worker_revives`` / ``serve_rejected``
/ ``serve_deadline_exceeded`` / ``serve_quarantined`` counters, and a
span per batch with per-request events.
"""

from __future__ import annotations

import collections
import dataclasses
import threading
import time
from concurrent.futures import Future

import numpy as np
import torch

from repro_torch import telemetry
from repro_torch.serving.state import PanelEntry, Registry, host_array

#: Ops a request may carry; anything else is rejected at submit.
OPS = ("ccm", "xmap", "simplex", "surrogate_test", "optimal_E", "append",
       "subscribe")

#: Default worker-pool size (per-panel drains; panels > workers queue).
DEFAULT_WORKERS = 4

#: Consecutive batch-level failures before a panel is quarantined.
DEFAULT_QUARANTINE_AFTER = 3


class Overloaded(RuntimeError):
    """Admission refused: the queue bound would be exceeded.

    ``retry_after_s`` estimates when capacity should exist again
    (queue depth x mean request latency / workers) — the HTTP layer
    sends it as ``Retry-After`` on the 429.
    """

    def __init__(self, msg: str, retry_after_s: float = 1.0):
        super().__init__(msg)
        self.retry_after_s = float(retry_after_s)


class DeadlineExceeded(TimeoutError):
    """The request's ``deadline_s`` elapsed while it was still queued.

    A ``TimeoutError``, as the reference's: since Python 3.11 that is also
    ``concurrent.futures.TimeoutError``, so a client that waits with
    ``fut.result(timeout=...)`` must catch this before the wait's own
    timeout (or wait with ``concurrent.futures.wait`` and read
    ``fut.done()``) to tell an expired request from a hung one."""


class Draining(RuntimeError):
    """The scheduler is draining for shutdown; admission is closed."""


class PanelQuarantined(RuntimeError):
    """The panel's batches crashed repeatedly (or its WAL broke); it
    fails fast with the last error until ``clear_quarantine``."""

    def __init__(self, msg: str, last_error: BaseException | None = None):
        super().__init__(msg)
        self.last_error = last_error


@dataclasses.dataclass
class Request:
    ticket: int
    op: str
    panel: str
    params: dict
    signature: tuple
    future: Future
    t_submit: float
    deadline: float | None = None
    cost: int = 0


class _PanelQueue:
    """One panel's FIFO + the flag serializing its drains."""

    __slots__ = ("name", "q", "draining", "fail_streak", "quarantined")

    def __init__(self, name: str):
        self.name = name
        self.q: collections.deque[Request] = collections.deque()
        self.draining = False
        self.fail_streak = 0
        self.quarantined: BaseException | None = None


def _frozen(params: dict) -> tuple:
    """Hashable, order-insensitive view of request params."""
    out = []
    for k in sorted(params):
        v = params[k]
        if isinstance(v, (list, tuple)):
            v = tuple(tuple(x) if isinstance(x, (list, tuple)) else x
                      for x in v)
        elif isinstance(v, np.ndarray):
            v = ("array", v.shape, v.tobytes())
        out.append((k, v))
    return tuple(out)


def _cost(params: dict) -> int:
    """Queued-bytes estimate of a request: array payloads + overhead."""
    nbytes = 256
    for v in params.values():
        if isinstance(v, np.ndarray):
            nbytes += v.nbytes
        elif isinstance(v, torch.Tensor):
            nbytes += v.numel() * v.element_size()
        elif isinstance(v, (list, tuple)) and v \
                and isinstance(v[0], (list, tuple)):
            nbytes += 8 * sum(len(x) for x in v)
    return nbytes


class Scheduler:
    """Per-panel FIFO queues + a drain worker pool over a ``Registry``."""

    def __init__(self, registry: Registry, *, autostart: bool = True,
                 max_batch: int = 64, workers: int = DEFAULT_WORKERS,
                 subscriptions=None,
                 max_queue_depth: int | None = None,
                 max_queued_bytes: int | None = None,
                 quarantine_after: int = DEFAULT_QUARANTINE_AFTER,
                 supervise: bool = False,
                 supervise_interval: float = 0.25,
                 revive_backoff_s: tuple[float, float] = (0.2, 30.0),
                 faults=None):
        self.registry = registry
        self.max_batch = max_batch
        self.num_workers = max(1, int(workers))
        self.subscriptions = subscriptions
        self.max_queue_depth = max_queue_depth
        self.max_queued_bytes = max_queued_bytes
        self.quarantine_after = max(1, int(quarantine_after))
        self.supervise = bool(supervise)
        self.supervise_interval = float(supervise_interval)
        self.revive_backoff_s = (float(revive_backoff_s[0]),
                                 float(revive_backoff_s[1]))
        self.faults = faults
        self._queues: dict[str, _PanelQueue] = {}
        self._ready: collections.deque[_PanelQueue] = collections.deque()
        self._cv = threading.Condition()
        self._next_ticket = 0
        self._queued_bytes = 0
        self._closed = False
        self._draining = False
        self._threads: list[threading.Thread | None] = []
        self._wstats: list[dict] = []
        self._sup_thread: threading.Thread | None = None
        self._sup_stop = threading.Event()
        self._revive_state: dict[int, dict] = {}
        if autostart:
            self.start()

    # ------------------------------------------------------------- pool

    def start(self) -> None:
        """Spin up the worker pool (idempotent; ``autostart=False``
        constructions call this to go live after preloading queues)."""
        with self._cv:
            if self._closed:
                raise RuntimeError("scheduler is closed")
            while len(self._threads) < self.num_workers:
                self._spawn(len(self._threads))
        if self.supervise and self._sup_thread is None:
            self._sup_thread = threading.Thread(
                target=self._supervise_loop, name="edm-serve-supervisor",
                daemon=True)
            self._sup_thread.start()

    def _spawn(self, wid: int) -> None:
        """Start worker ``wid`` (caller holds the lock)."""
        st = {"name": f"edm-serve-worker-{wid}", "alive": True,
              "batches": 0, "last_beat": time.monotonic(), "error": None}
        t = threading.Thread(target=self._run, args=(wid,),
                             name=st["name"], daemon=True)
        if wid < len(self._threads):
            self._threads[wid] = t
            self._wstats[wid] = st
        else:
            self._threads.append(t)
            self._wstats.append(st)
        t.start()

    def worker_stats(self) -> list[dict]:
        """Per-worker liveness snapshot (the ``/healthz`` payload rows).

        ``alive`` is the thread's actual ``is_alive()`` — a worker that
        died without running its own epilogue (or was never started on
        an ``autostart=False`` scheduler) still reads dead here.
        """
        with self._cv:
            out = []
            for t, st in zip(self._threads, self._wstats):
                d = dict(st)
                d["alive"] = bool(st["alive"] and t is not None
                                  and t.is_alive())
                d["age_s"] = time.monotonic() - st["last_beat"]
                out.append(d)
            return out

    def queue_depths(self) -> dict[str, int]:
        with self._cv:
            return {name: len(pq.q) for name, pq in self._queues.items()}

    def quarantined_panels(self) -> dict[str, str]:
        with self._cv:
            return {name: f"{type(pq.quarantined).__name__}: "
                          f"{pq.quarantined}"
                    for name, pq in self._queues.items()
                    if pq.quarantined is not None}

    def health(self) -> dict:
        """Liveness + queue depths; ``ok`` is False when any spawned
        worker is dead (a dead drain thread must NOT answer healthy —
        its panels would wedge silently)."""
        ws = self.worker_stats()
        ok = (not self._closed
              and len(ws) == self.num_workers
              and all(w["alive"] for w in ws))
        return {"ok": bool(ok), "workers": ws,
                "queues": self.queue_depths(), "closed": self._closed,
                "draining": self._draining,
                "quarantined": self.quarantined_panels()}

    def revive_workers(self) -> int:
        """Respawn dead workers; returns how many were restarted."""
        revived = 0
        with self._cv:
            if self._closed:
                return 0
            for wid, (t, st) in enumerate(zip(self._threads, self._wstats)):
                if t is not None and not t.is_alive():
                    self._spawn(wid)
                    revived += 1
        if revived:
            telemetry.counter("serve_worker_revivals").inc(revived)
        return revived

    def _supervise_loop(self) -> None:
        """Auto-revive dead workers with capped exponential backoff.

        A worker that dies again before completing a batch doubles its
        backoff (up to the cap); finishing a batch resets it — the
        journal's retry discipline applied to thread liveness.
        """
        base, cap = self.revive_backoff_s
        while not self._sup_stop.wait(self.supervise_interval):
            revived = 0
            try:
                now = time.monotonic()
                with self._cv:
                    if self._closed:
                        return
                    for wid, (t, st) in enumerate(
                            zip(self._threads, self._wstats)):
                        rs = self._revive_state.get(wid)
                        if t is None or t.is_alive():
                            if rs and st["batches"] > 0:
                                del self._revive_state[wid]
                            continue
                        if rs is None:
                            rs = self._revive_state[wid] = {
                                "streak": 0, "not_before": now}
                        if now < rs["not_before"]:
                            continue
                        self._spawn(wid)
                        rs["streak"] += 1
                        rs["not_before"] = now + min(
                            cap, base * (2 ** (rs["streak"] - 1)))
                        revived += 1
            except Exception:  # noqa: BLE001 — the supervisor never dies
                pass
            if revived:
                telemetry.counter("serve_worker_revives").inc(revived)
                telemetry.event("serve.worker_revive", n=revived)

    # ------------------------------------------------------------ submit

    def submit(self, op: str, panel: str, **params) -> Future:
        """Enqueue a request; thread-safe; returns its ``Future``.

        The coalescing signature (and, for appends, the version bump
        that makes them barriers) is fixed here, under the scheduler
        lock — after ``submit`` returns, no later request can be batched
        ahead of this one's library state. The returned future carries
        its queue position as ``fut.ticket`` (global submit order — the
        per-panel linearization tests key on it).

        ``deadline_s=`` (optional, never part of the coalescing
        signature) bounds the time the request may sit queued; past it,
        the claim path fails the future with ``DeadlineExceeded``
        instead of launching. Raises ``Overloaded`` / ``Draining`` /
        ``PanelQuarantined`` when admission is refused.
        """
        return self.submit_many(op, panel, [params])[0]

    def submit_many(self, op: str, panel: str,
                    params_list: list[dict]) -> list[Future]:
        """Enqueue a burst of same-op requests under ONE lock acquisition.

        The bulk path for saturating clients: signatures are still
        per-request (so coalescing semantics are identical to n
        ``submit`` calls in the same order), but queue-lock traffic,
        telemetry, and worker wakeup are paid once per burst. The
        scheduler takes ownership of the param dicts — callers must not
        mutate them after submitting. Admission bounds apply to the
        burst as a whole: it is accepted or ``Overloaded`` entirely.
        """
        if op not in OPS:
            raise ValueError(f"unknown op {op!r}; expected one of {OPS}")
        entry = self.registry.get(panel)  # raises for unknown panels
        deadlines = [p.pop("deadline_s", None) for p in params_list]
        costs = [_cost(p) for p in params_list]
        futs = [Future() for _ in params_list]
        now = time.perf_counter()
        with self._cv:
            if self._closed:
                raise RuntimeError("scheduler is closed")
            if self._draining:
                raise Draining(
                    "server is draining for shutdown; not accepting work")
            pq = self._queues.get(panel)
            if pq is None:
                pq = self._queues[panel] = _PanelQueue(panel)
            if pq.quarantined is not None:
                raise PanelQuarantined(
                    f"panel {panel!r} is quarantined: "
                    f"{type(pq.quarantined).__name__}: {pq.quarantined}",
                    pq.quarantined)
            depth = sum(len(q.q) for q in self._queues.values())
            if (self.max_queue_depth is not None
                    and depth + len(params_list) > self.max_queue_depth):
                telemetry.counter("serve_rejected").inc(len(params_list))
                raise Overloaded(
                    f"queue depth {depth}+{len(params_list)} would exceed "
                    f"max_queue_depth={self.max_queue_depth}",
                    self._retry_after(op, depth))
            add = sum(costs)
            if (self.max_queued_bytes is not None
                    and self._queued_bytes + add > self.max_queued_bytes):
                telemetry.counter("serve_rejected").inc(len(params_list))
                raise Overloaded(
                    f"queued bytes {self._queued_bytes}+{add} would exceed "
                    f"max_queued_bytes={self.max_queued_bytes}",
                    self._retry_after(op, depth))
            was_empty = not pq.q
            for params, fut, dl, cost in zip(params_list, futs,
                                             deadlines, costs):
                ticket = self._next_ticket
                self._next_ticket += 1
                if op == "append":
                    entry.queued_version += 1
                    sig = ("append", panel, ticket)
                elif (op == "ccm" and params.get("E") is not None
                        and params.get("lib_sizes") is None):
                    sig = ("ccm", panel, int(params["E"]),
                           entry.queued_version)
                elif op in ("ccm", "subscribe"):
                    # sweeps / E-to-resolve CCM and subscribe: solo.
                    sig = (op, panel, ticket)
                else:  # whole-panel ops: dedup exact duplicates only.
                    sig = (op, panel, entry.queued_version,
                           _frozen(params))
                fut.ticket = ticket  # type: ignore[attr-defined]
                pq.q.append(Request(
                    ticket, op, panel, params, sig, fut, now,
                    deadline=None if dl is None else now + float(dl),
                    cost=cost))
            self._queued_bytes += add
            if was_empty and not pq.draining:
                self._ready.append(pq)
            telemetry.gauge("serve_queue_depth").set(
                sum(len(q.q) for q in self._queues.values()))
            telemetry.gauge("serve_queued_bytes").set(self._queued_bytes)
            telemetry.counter("serve_requests").inc(len(futs))
            self._cv.notify(len(futs))
        return futs

    def _retry_after(self, op: str, depth: int) -> float:
        """Retry-After estimate: queued work x mean latency / workers."""
        h = telemetry.histogram(f"serve_latency_ms_{op}")
        mean_ms = (h.sum / h.count) if h.count else 50.0
        est = (depth + 1) * mean_ms / 1e3 / max(self.num_workers, 1)
        return float(min(60.0, max(0.1, est)))

    # ------------------------------------------------------------- drain

    def drain_once(self, timeout: float | None = 0.0) -> int:
        """Process one batch in the calling thread; returns how many
        requests were retired (executed + expired).

        The deterministic test/bench entry (``autostart=False``): the
        exact claim → coalesce → execute → release cycle a pool worker
        performs, minus the thread. Panels are visited in ready-list
        (round-robin) order.
        """
        claim = self._claim(timeout)
        if claim is None:
            return 0
        pq, batch, expired = claim
        try:
            if batch:
                self._execute(batch, pq)
        finally:
            self._release(pq)
        return len(batch) + expired

    def _run(self, wid: int) -> None:
        st = self._wstats[wid]
        while True:
            with self._cv:
                while not self._ready and not self._closed:
                    self._cv.wait(0.1)
                    st["last_beat"] = time.monotonic()
                if self._closed and not self._ready:
                    return
            claim = self._claim(timeout=0.0)
            if claim is None:
                continue
            pq, batch, _ = claim
            try:
                if batch:
                    self._execute(batch, pq)
                    st["batches"] += 1
                    st["last_beat"] = time.monotonic()
            except BaseException as exc:  # worker is dying: fail the
                # in-flight futures rather than hanging their clients,
                # then report dead until revive_workers()/supervisor.
                err = RuntimeError(
                    f"serve worker died: {type(exc).__name__}: {exc}")
                for r in batch:
                    if not r.future.done():
                        r.future.set_exception(err)
                st["alive"] = False
                st["error"] = f"{type(exc).__name__}: {exc}"
                telemetry.counter("serve_worker_deaths").inc()
                self._note_batch_failure(pq, exc)
                return
            finally:
                self._release(pq)

    def _claim(self, timeout
               ) -> tuple[_PanelQueue, list[Request], int] | None:
        """Claim the next ready panel and coalesce one batch from it.

        Returns ``(panel_queue, batch, n_expired)`` with the panel
        marked as draining — the caller MUST ``_release`` it — or None
        if nothing became ready within ``timeout``. Requests whose
        deadline passed while queued are failed with
        ``DeadlineExceeded`` here, before they cost a launch.
        """
        with self._cv:
            if not self._ready:
                if self._closed:
                    return None
                self._cv.wait(timeout)
                if not self._ready:
                    return None
            pq = self._ready.popleft()
            pq.draining = True
            now = time.perf_counter()
            expired: list[Request] = []
            batch: list[Request] = []
            while pq.q:
                r = pq.q.popleft()
                if r.deadline is not None and now > r.deadline:
                    expired.append(r)
                    continue
                batch.append(r)
                break
            if batch and batch[0].op != "append":
                head = batch[0]
                rest = collections.deque()
                while pq.q and len(batch) < self.max_batch:
                    r = pq.q.popleft()
                    if r.deadline is not None and now > r.deadline:
                        expired.append(r)
                    elif r.signature == head.signature:
                        batch.append(r)
                    else:
                        rest.append(r)
                rest.extend(pq.q)
                pq.q = rest
            self._queued_bytes -= (sum(r.cost for r in batch)
                                   + sum(r.cost for r in expired))
            telemetry.gauge("serve_queue_depth").set(
                sum(len(q.q) for q in self._queues.values()))
            telemetry.gauge("serve_queued_bytes").set(self._queued_bytes)
        if expired:
            err_by = time.perf_counter()
            for r in expired:
                r.future.set_exception(DeadlineExceeded(
                    f"request {r.ticket} ({r.op} on {r.panel!r}) "
                    f"spent {err_by - r.t_submit:.3f}s queued, past its "
                    f"deadline"))
            telemetry.counter("serve_deadline_exceeded").inc(len(expired))
        if batch:
            telemetry.gauge("serve_batch_occupancy").set(len(batch))
            telemetry.histogram("serve_batch_occupancy_hist").observe(
                len(batch))
            if len(batch) > 1:
                telemetry.counter("serve_launches_saved").inc(
                    len(batch) - 1)
        return pq, batch, len(expired)

    def _release(self, pq: _PanelQueue) -> None:
        """Return a drained panel to the ready list if work remains."""
        with self._cv:
            pq.draining = False
            if pq.q and not self._closed:
                self._ready.append(pq)
                self._cv.notify()

    # ------------------------------------------------- quarantine logic

    def _note_batch_failure(self, pq: _PanelQueue | None,
                            exc: BaseException) -> None:
        """Count a batch-level failure; quarantine past the threshold.

        Called by the panel's single active drainer (or its dying
        worker), so the streak needs no extra lock.
        """
        if pq is None:
            return
        pq.fail_streak += 1
        if pq.fail_streak >= self.quarantine_after:
            self._quarantine(pq.name, exc)

    def _note_batch_success(self, pq: _PanelQueue | None) -> None:
        if pq is not None:
            pq.fail_streak = 0

    def _quarantine(self, panel: str, exc: BaseException) -> None:
        """Fail the panel fast: flush its queue, refuse new submits."""
        with self._cv:
            pq = self._queues.get(panel)
            if pq is None:
                pq = self._queues[panel] = _PanelQueue(panel)
            if pq.quarantined is not None:
                return
            pq.quarantined = exc
            pending = list(pq.q)
            pq.q.clear()
            self._queued_bytes -= sum(r.cost for r in pending)
        err = PanelQuarantined(
            f"panel {panel!r} quarantined: "
            f"{type(exc).__name__}: {exc}", exc)
        for r in pending:
            if not r.future.done():
                r.future.set_exception(err)
        telemetry.counter("serve_quarantined").inc()
        telemetry.event("serve.quarantine", panel=panel,
                        error=f"{type(exc).__name__}: {exc}")

    def clear_quarantine(self, panel: str) -> bool:
        """Operator reset; returns whether the panel was quarantined."""
        with self._cv:
            pq = self._queues.get(panel)
            if pq is None or pq.quarantined is None:
                return False
            pq.quarantined = None
            pq.fail_streak = 0
            return True

    # ----------------------------------------------------------- execute

    def _execute(self, batch: list[Request],
                 pq: _PanelQueue | None = None) -> None:
        head = batch[0]
        entry = self.registry.get(head.panel)
        t0 = time.perf_counter()
        with entry.exec_lock:  # excludes the eviction path, nothing else
            if self.faults is not None:
                # BaseException: rides the real worker-death path.
                self.faults.check("worker_death", detail=head.panel)
            try:
                with telemetry.span("serve.batch", op=head.op,
                                    panel=head.panel, size=len(batch)):
                    if head.op == "ccm" and len(batch) > 1:
                        results = self._exec_ccm_batch(entry, batch)
                    else:
                        # Loop path: failures stay per-request — one op
                        # raising must not poison its batch peers.
                        results = []
                        for r in batch:
                            try:
                                results.append(self._exec_one(entry, r))
                            except Exception as exc:  # noqa: BLE001
                                telemetry.counter("serve_errors").inc()
                                results.append(exc)
            except Exception as exc:  # noqa: BLE001 — shared-launch failure
                telemetry.counter("serve_errors").inc()
                for r in batch:
                    r.future.set_exception(exc)
                self._note_batch_failure(pq, exc)
                self._after_batch(entry)
                return
        done = time.perf_counter()
        ms = (done - t0) * 1e3
        hist = telemetry.histogram(f"serve_latency_ms_{head.op}")
        live = telemetry.active()  # per-request events only under a sink
        for r, res in zip(batch, results):
            if live:
                telemetry.event("serve.request", op=r.op, ticket=r.ticket,
                                batched_with=len(batch) - 1,
                                queued_ms=(t0 - r.t_submit) * 1e3,
                                exec_ms=ms)
            hist.observe((done - r.t_submit) * 1e3)
            if isinstance(res, Exception):
                r.future.set_exception(res)
            else:
                r.future.set_result(res)
        telemetry.counter("serve_batches").inc()
        self._note_batch_success(pq)
        self._after_batch(entry)

    def _after_batch(self, entry: PanelEntry) -> None:
        """LRU touch + byte-budget enforcement after every batch."""
        self.registry.touch(entry)
        self.registry.enforce_budget(protect=entry.name)

    def _exec_one(self, entry: PanelEntry, r: Request):
        sess = entry.sess
        p = r.params
        if self.faults is not None:
            self.faults.check("slow_launch")
            self.faults.check("launch_error", detail=f"{r.op}:{r.panel}")
            self.faults.check("launch_oom", detail=f"{r.op}:{r.panel}")
        if r.op == "append":
            delta = host_array(p["delta"])
            records = sess.append(delta)
            new_version = entry.version + 1
            if entry.wal is not None:
                # WAL before the future resolves. On write failure the
                # in-memory library is ahead of the log: quarantine —
                # serving it would break the recovery bit-contract.
                try:
                    entry.wal.log_append(delta, new_version)
                except Exception as exc:
                    self._quarantine(entry.name, exc)
                    raise
                if entry.wal.should_compact():
                    entry.wal.compact(sess, new_version)
            entry.version = new_version
            telemetry.counter("serve_appends").inc()
            out = {"records": records, "version": entry.version,
                   "N": sess.data.N, "L": sess.data.L}
            if self.subscriptions is not None:
                self.subscriptions.on_append(entry)
            return out
        if r.op == "subscribe":
            if self.subscriptions is None:
                raise RuntimeError("this scheduler has no subscription hub")
            return self.subscriptions.open(
                entry, pairs=p["pairs"], E=p.get("E"))
        if r.op == "ccm":
            if p.get("lib_sizes") is not None:  # sweep: classic engine
                return sess.ccm(p["lib"], p["target"],
                                lib_sizes=p["lib_sizes"], E=p.get("E"))
            # Default-cap requests ALWAYS go through the batch engine —
            # solo or coalesced, a pair's answer has the same bits.
            E = p.get("E")
            if E is None:
                E = sess._resolve_pair_E(sess.data.index_of(p["target"]),
                                         None)
            return sess.ccm_batch([(p["lib"], p["target"])], E=E)[0]
        if r.op == "xmap":
            return sess.xmap(p.get("method", "simplex"),
                             theta=p.get("theta"))
        if r.op == "simplex":
            return sess.simplex(p.get("E"))
        if r.op == "optimal_E":
            return sess.optimal_E()
        if r.op == "surrogate_test":
            return sess.surrogate_test(
                p["lib"], p["target"],
                num_surrogates=p.get("num_surrogates", 100),
                method=p.get("method", "shuffle"),
                period=p.get("period"), seed=p.get("seed", 0))
        raise AssertionError(f"unreachable op {r.op!r}")

    def _exec_ccm_batch(self, entry: PanelEntry, batch: list[Request]):
        """n compatible CCM pairs as ONE coalesced engine launch.

        ``EDM.ccm_batch`` owns the bit contract (batch-invariant
        answers; see its docstring) — the scheduler only supplies the
        coalesced pair list and the telemetry.
        """
        sess = entry.sess
        if self.faults is not None:
            self.faults.check("slow_launch")
            self.faults.check("launch_error",
                              detail=f"ccm_batch:{entry.name}")
            self.faults.check("launch_oom",
                              detail=f"ccm_batch:{entry.name}")
        E = int(batch[0].params["E"])
        pairs = [(r.params["lib"], r.params["target"]) for r in batch]
        rho = sess.ccm_batch(pairs, E=E)
        telemetry.counter("serve_ccm_group_launches").inc()
        self._bump_session(sess, "ccm_coalesced", len(batch))
        return list(rho)  # np.float32 scalars, no copies

    @staticmethod
    def _bump_session(sess, key, n) -> None:
        sess.stats[key] += n
        telemetry.counter(f"edm_{key}").inc(n)

    # -------------------------------------------------- drain and close

    def drain(self, timeout: float | None = None) -> bool:
        """Stop admission and wait for the queues to empty.

        New submits raise ``Draining`` immediately; already-queued
        requests keep executing (workers stay up). Returns True once
        every per-panel queue is empty and idle, False on timeout.
        """
        with self._cv:
            self._draining = True
        telemetry.event("serve.drain_begin")
        deadline = (None if timeout is None
                    else time.monotonic() + timeout)
        while True:
            with self._cv:
                busy = any(pq.q or pq.draining
                           for pq in self._queues.values())
            if not busy:
                telemetry.event("serve.drain_done")
                return True
            if deadline is not None and time.monotonic() > deadline:
                return False
            time.sleep(0.02)

    def close(self) -> None:
        """Stop accepting work; fail queued requests; join the pool."""
        with self._cv:
            if self._closed:
                return
            self._closed = True
            pending = [r for pq in self._queues.values() for r in pq.q]
            for pq in self._queues.values():
                pq.q.clear()
            self._queued_bytes = 0
            self._ready.clear()
            threads = [t for t in self._threads if t is not None]
            self._cv.notify_all()
        self._sup_stop.set()
        for r in pending:
            r.future.set_exception(RuntimeError("scheduler closed"))
        for t in threads:
            t.join(timeout=5.0)
        if self._sup_thread is not None:
            self._sup_thread.join(timeout=5.0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
