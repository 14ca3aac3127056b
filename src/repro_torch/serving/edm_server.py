"""EDM-as-a-service: warm sessions behind a batching worker pool.

The port of ``repro.serving.edm_server``: each panel's session lives on
its config's device (``device="cuda"`` by default; ``device="cpu"`` runs
the plain versions), so a served ``ccm`` rides the port's kernels —
``knn_multi_e`` for the master (and its rebuild after an eviction),
``lookup_rho`` for each coalesced batch, ``knn_append`` for each append.

``EDMServer`` is the embeddable server object — register panels, submit
``ccm``/``xmap``/``simplex``/``surrogate_test``/``optimal_E``/``append``
requests from any number of threads, get ``Future``s back. Requests
flow through ``scheduler.Scheduler``: per-panel FIFO queues with
signature coalescing drained by a worker pool, so distinct panels
execute concurrently while each panel's FIFO + append-barrier semantics
hold (see that module's docstring). ``master_budget_mb`` puts an LRU
byte budget on the cached kNN masters (``state.py``): cold panels are
evicted and lazily rebuilt bit-identically. ``subscribe`` registers a
(lib, tgt) watch list whose re-scored ρ is pushed on every append tick
(``subscriptions.py``).

Durability and overload control:

* ``state_dir=`` makes the server crash-durable: registrations and
  accepted appends hit a per-panel write-ahead log before their futures
  resolve, and ``EDMServer.recover(state_dir)`` rebuilds every panel
  bit-identically at its pre-crash library version (``durability.py``).
* ``max_queue_depth`` / ``max_queued_bytes`` bound admission
  (``Overloaded`` → HTTP 429 + Retry-After), per-request ``deadline_s``
  bounds queueing (``DeadlineExceeded`` → 504), ``request_timeout_s``
  bounds the HTTP thread's blocking wait (503 on a wedged panel).
* ``supervise=True`` auto-revives dead drain workers; repeatedly
  crashing panels are quarantined (fail fast, 503).
* ``drain()`` stops admission, waits the queues out and fsyncs WALs —
  ``run_until_terminated`` wires it to SIGTERM for a clean exit 0.

``serve_http`` wraps a server in a stdlib ``ThreadingHTTPServer`` JSON
front end — each connection thread blocks on its request's future while
the worker pool batches across connections:

* ``POST /v1/register``     {"panel": name, "data": [[...]], ...config}
* ``POST /v1/<op>``         {"panel": name, ...params} → {"result": ...}
* ``POST /v1/append``       {"panel": name, "delta": [[...]]}
* ``POST /v1/subscribe``    {"panel": name, "pairs": [[l,t],...], "E": 3}
* ``POST /v1/unsubscribe``  {"id": sub_id}
* ``GET  /v1/subscriptions/<id>?timeout=25``  long-poll pending ticks
* ``GET  /panels``          registry listing
* ``GET  /metrics``         Prometheus text (``telemetry.render_prom()``)
* ``GET  /healthz``         per-worker liveness + queue depths; HTTP 503
                            when any drain worker is dead or the server
                            is draining

No third-party dependencies: stdlib HTTP, JSON bodies, numpy arrays
serialized as nested lists (NaN encoded ``null`` per strict JSON).
"""

from __future__ import annotations

import dataclasses
import json
import math
import threading
import time
import urllib.parse
from concurrent.futures import TimeoutError as _FutureTimeout
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from repro_torch import telemetry
from repro_torch.serving.durability import Durability
from repro_torch.serving.scheduler import (DEFAULT_WORKERS, OPS,
                                           DeadlineExceeded, Draining,
                                           Overloaded, PanelQuarantined,
                                           Scheduler)
from repro_torch.serving.state import Registry, host_array
from repro_torch.serving.subscriptions import SubscriptionHub


class EDMServer:
    """Warm EDM sessions + the batching worker pool, one object."""

    def __init__(self, *, autostart: bool = True, max_batch: int = 64,
                 workers: int = DEFAULT_WORKERS,
                 master_budget_mb: float | None = None,
                 state_dir: str | None = None,
                 compact_every: int = 64, wal_fsync: bool = False,
                 max_queue_depth: int | None = None,
                 max_queued_bytes: int | None = None,
                 quarantine_after: int = 3, supervise: bool = False,
                 revive_backoff_s: tuple[float, float] = (0.2, 30.0),
                 faults=None):
        budget = (None if master_budget_mb is None
                  else int(master_budget_mb * 2**20))
        self.registry = Registry(master_budget_bytes=budget)
        self.subscriptions = SubscriptionHub()
        self.durability = (None if state_dir is None else Durability(
            state_dir, compact_every=compact_every, wal_fsync=wal_fsync,
            faults=faults))
        self.scheduler = Scheduler(self.registry, autostart=autostart,
                                   max_batch=max_batch, workers=workers,
                                   subscriptions=self.subscriptions,
                                   max_queue_depth=max_queue_depth,
                                   max_queued_bytes=max_queued_bytes,
                                   quarantine_after=quarantine_after,
                                   supervise=supervise,
                                   revive_backoff_s=revive_backoff_s,
                                   faults=faults)
        self.recovery_report: dict[str, dict] = {}

    # ---------------------------------------------------------- recovery

    @classmethod
    def recover(cls, state_dir: str, **kw) -> "EDMServer":
        """Rebuild a server from a ``state_dir`` after a crash.

        Every panel found on disk is replayed — snapshot, then WAL tail
        — through the normal ``Dataset.append`` path, so the recovered
        session is bit-identical to the pre-crash one at its last
        durably-logged version (the append≡rebuild contract makes the
        lazily rebuilt kNN master bit-identical too). A torn final WAL
        record (the crash landed mid-write) is dropped with a warning.
        ``srv.recovery_report`` maps panel → replay info. Each panel is
        rebuilt on the device it was registered on.
        """
        srv = cls(state_dir=state_dir, **kw)
        assert srv.durability is not None
        for log in srv.durability.scan():
            name = log.meta()["name"]
            with telemetry.span("serve.recover", panel=name):
                sess, version, info = log.recover()
                log.reset_after_recovery(sess, version)
                entry = srv.registry.adopt(name, sess, version=version)
                entry.wal = log
                srv.durability.adopt(name, log)
                telemetry.event(
                    "serve.recovered", panel=name,
                    version=info["version"], replayed=info["replayed"],
                    torn_tail_bytes=info["torn_tail_bytes"])
            srv.recovery_report[name] = info
        return srv

    def register_panel(self, name: str, panel, **kw) -> dict:
        with telemetry.span("serve.register", panel=name):
            arr = host_array(panel)
            info = self.registry.register(name, arr, **kw)
            if self.durability is not None:
                entry = self.registry.get(name)
                try:
                    entry.wal = self.durability.register(
                        name, arr, kw.get("names"), entry.sess.config)
                except Exception:
                    self.registry.remove(name)
                    raise
            return info

    def submit(self, op: str, panel: str, **params):
        """Thread-safe enqueue; returns a ``concurrent.futures.Future``."""
        return self.scheduler.submit(op, panel, **params)

    def submit_many(self, op: str, panel: str, params_list: list[dict]):
        """Bulk enqueue (one lock/wakeup); returns one Future per entry."""
        return self.scheduler.submit_many(op, panel, params_list)

    def call(self, op: str, panel: str, timeout: float | None = None,
             **params):
        """Submit and block for the result (the one-client convenience).

        ``timeout`` bounds the blocking wait only — the request itself
        stays queued (pass ``deadline_s=`` to bound that instead).
        """
        return self.submit(op, panel, **params).result(timeout=timeout)

    # ----------------------------------------------------- subscriptions

    def subscribe(self, panel: str, pairs, *, E: int | None = None) -> dict:
        """Register a (lib, tgt) watch list; blocks for the baseline tick.

        Routed through the scheduler like any op, so it linearizes with
        the panel's append stream: the returned dict's ``rho`` is the
        watch list scored at the current library version, and every
        later append pushes a re-scored tick to
        ``self.subscription(id)`` / ``GET /v1/subscriptions/<id>``.
        """
        return self.call("subscribe", panel, pairs=list(pairs), E=E)

    def subscription(self, sid: str):
        """The live ``Subscription`` (``.poll(timeout)`` for ticks)."""
        return self.subscriptions.get(sid)

    def unsubscribe(self, sid: str) -> None:
        self.subscriptions.close_sub(sid)

    # ------------------------------------------------------------ memory

    def evict_panel(self, name: str) -> int:
        """Force-evict one panel's cached kNN master; returns bytes freed.

        Thread-safe (waits for any in-flight batch on that panel). The
        operator's knob; the LRU budget does this automatically. Purely
        a memory event — the master rebuilds bit-identically on demand.
        """
        return self.registry.evict(self.registry.get(name), blocking=True)

    def clear_quarantine(self, name: str) -> bool:
        """Re-admit a quarantined panel (operator override). Note that
        after a WAL write failure the in-memory library is ahead of the
        log — prefer ``EDMServer.recover`` for the durable state."""
        return self.scheduler.clear_quarantine(name)

    # ----------------------------------------------------- observability

    def health(self) -> dict:
        """Scheduler liveness + queue depths + memory/subscription state."""
        h = self.scheduler.health()
        if h.get("draining"):
            h["ok"] = False
        h["master_bytes"] = self.registry.master_bytes_total()
        h["master_budget_bytes"] = self.registry.budget_bytes
        h["subscriptions"] = self.subscriptions.count()
        return h

    def metrics_text(self) -> str:
        return telemetry.render_prom()

    # ----------------------------------------------------------- shutdown

    def drain(self, timeout: float | None = 30.0) -> bool:
        """Graceful shutdown, phase 1: stop admission (new submits
        raise ``Draining`` → HTTP 503), wait the per-panel queues out,
        then fsync every WAL. Returns False if queues did not empty in
        ``timeout`` — callers should still ``close()`` after."""
        ok = self.scheduler.drain(timeout=timeout)
        if self.durability is not None:
            self.durability.fsync_all()
        return ok

    def close(self) -> None:
        self.scheduler.close()
        self.subscriptions.close_all()
        if self.durability is not None:
            self.durability.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def run_until_terminated(edm: EDMServer, httpd=None, *,
                         poll_s: float = 0.25,
                         drain_timeout: float = 30.0) -> int:
    """Serve until SIGTERM/SIGINT, then drain gracefully; returns the
    process exit code (0 on a clean drain).

    The ``PreemptionGuard`` pattern from ``distributed.fault``: the
    signal only sets a flag; this loop notices it, stops admission
    (in-flight and queued requests still finish), fsyncs the WALs and
    shuts the HTTP front end down.
    """
    import signal as _signal

    from repro_torch.distributed.fault import PreemptionGuard
    with PreemptionGuard(signals=(_signal.SIGTERM, _signal.SIGINT)) as g:
        while not g.requested:
            time.sleep(poll_s)
    telemetry.event("serve.terminate_requested")
    ok = edm.drain(timeout=drain_timeout)
    if httpd is not None:
        httpd.shutdown()
    edm.close()
    return 0 if ok else 1


# ------------------------------------------------------------------ JSON


def _jsonable(obj):
    """Results → strict-JSON values (arrays and tensors to lists, NaN to
    None)."""
    if isinstance(obj, torch.Tensor):
        return _jsonable(obj.detach().cpu().numpy())
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {f.name: _jsonable(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if isinstance(obj, dict):
        return {str(k): _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    if isinstance(obj, np.ndarray) or hasattr(obj, "__array__"):
        return _jsonable(np.asarray(obj).tolist())
    if isinstance(obj, (np.floating, float)):
        f = float(obj)
        return f if np.isfinite(f) else None
    if isinstance(obj, (np.integer,)):
        return int(obj)
    if isinstance(obj, (np.bool_,)):
        return bool(obj)
    return obj


class _Handler(BaseHTTPRequestHandler):
    server_version = "edm-serve/3"

    # The EDMServer rides on the HTTP server object (set by serve_http).
    @property
    def edm(self) -> EDMServer:
        return self.server.edm_server  # type: ignore[attr-defined]

    def log_message(self, fmt, *args):  # quiet; telemetry covers it
        pass

    def _reply(self, code: int, payload, *, raw: str | None = None,
               headers: dict | None = None) -> None:
        body = (raw if raw is not None
                else json.dumps(payload)).encode("utf-8")
        try:
            self.send_response(code)
            self.send_header("Content-Type",
                             "text/plain; charset=utf-8" if raw is not None
                             else "application/json")
            self.send_header("Content-Length", str(len(body)))
            for k, v in (headers or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)
        except (BrokenPipeError, ConnectionResetError,
                ConnectionAbortedError):
            # The client hung up mid-long-poll or mid-body: count it,
            # drop the connection quietly — never a stderr traceback.
            telemetry.counter("serve_client_disconnects").inc()
            self.close_connection = True

    def do_GET(self):  # noqa: N802 — stdlib API
        url = urllib.parse.urlparse(self.path)
        if url.path == "/metrics":
            self._reply(200, None, raw=self.edm.metrics_text())
        elif url.path == "/panels":
            self._reply(200, {"panels": self.edm.registry.infos()})
        elif url.path == "/healthz":
            h = self.edm.health()
            self._reply(200 if h["ok"] else 503, _jsonable(h))
        elif url.path.startswith("/v1/subscriptions/"):
            sid = url.path[len("/v1/subscriptions/"):]
            q = urllib.parse.parse_qs(url.query)
            timeout = min(float(q.get("timeout", ["25"])[0]), 60.0)
            maxn = (int(q["max"][0]) if "max" in q else None)
            try:
                sub = self.edm.subscription(sid)
            except KeyError as exc:
                self._reply(404, {"error": str(exc)})
                return
            ticks = sub.poll(timeout=timeout, max_ticks=maxn)
            self._reply(200, {"id": sid, "closed": sub.closed,
                              "ticks": _jsonable(ticks)})
        else:
            self._reply(404, {"error": f"unknown path {self.path}"})

    def do_POST(self):  # noqa: N802 — stdlib API
        try:
            n = int(self.headers.get("Content-Length", 0))
            body = json.loads(self.rfile.read(n) or b"{}")
            if not isinstance(body, dict):
                self._reply(400, {"error": "body must be a JSON object"})
                return
            if not self.path.startswith("/v1/"):
                self._reply(404, {"error": f"unknown path {self.path}"})
                return
            op = self.path[len("/v1/"):]
            if op == "unsubscribe":  # addressed by id, not panel
                if "id" not in body:
                    self._reply(400, {"error": "missing 'id'"})
                    return
                self.edm.unsubscribe(body["id"])
                self._reply(200, {"result": {"closed": body["id"]}})
                return
            panel = body.pop("panel", None)
            if panel is None:
                self._reply(400, {"error": "missing 'panel'"})
                return
            if op == "register":
                if "data" not in body:
                    self._reply(400, {"error": "missing 'data'"})
                    return
                data = body.pop("data")
                info = self.edm.register_panel(panel, np.asarray(
                    data, np.float32), **body)
                self._reply(200, {"result": info})
                return
            if op not in OPS:
                self._reply(404, {"error": f"unknown op {op!r}"})
                return
            if op == "append":
                if "delta" not in body:
                    self._reply(400, {"error": "missing 'delta'"})
                    return
                body["delta"] = np.asarray(body["delta"], np.float32)
            timeout = getattr(self.server, "request_timeout_s", None)
            result = self.edm.call(op, panel, timeout=timeout, **body)
            self._reply(200, {"result": _jsonable(result)})
        except Overloaded as exc:
            self._reply(429, {"error": str(exc),
                              "retry_after_s": exc.retry_after_s},
                        headers={"Retry-After":
                                 str(max(1, math.ceil(exc.retry_after_s)))})
        except DeadlineExceeded as exc:
            self._reply(504, {"error": str(exc)})
        except (Draining, PanelQuarantined) as exc:
            self._reply(503, {"error": str(exc)})
        except _FutureTimeout:
            telemetry.counter("serve_request_timeouts").inc()
            self._reply(503, {"error": "request timed out waiting for a "
                                       "drain worker (panel may be "
                                       "wedged)"})
        except (KeyError, ValueError) as exc:
            self._reply(400, {"error": str(exc)})
        except Exception as exc:  # noqa: BLE001 — surface, don't crash
            self._reply(500, {"error": f"{type(exc).__name__}: {exc}"})


def serve_http(edm: EDMServer, host: str = "127.0.0.1", port: int = 0, *,
               request_timeout_s: float | None = 120.0
               ) -> ThreadingHTTPServer:
    """Start the JSON front end on a daemon thread; returns the HTTP
    server (``.server_address`` has the bound port; ``.shutdown()``
    stops it). ``port=0`` binds an ephemeral port — the test/CI mode.
    ``request_timeout_s`` bounds each connection thread's blocking wait
    on its future: a wedged panel returns 503 instead of hanging the
    connection forever."""
    httpd = ThreadingHTTPServer((host, port), _Handler)
    httpd.edm_server = edm  # type: ignore[attr-defined]
    httpd.request_timeout_s = request_timeout_s  # type: ignore[attr-defined]
    threading.Thread(target=httpd.serve_forever, name="edm-serve-http",
                     daemon=True).start()
    return httpd
