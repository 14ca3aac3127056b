"""``repro_torch.telemetry`` — tracing + metrics for the EDM engine.

The paper's headline claim is throughput (pairs/s), and the matrix-scale
workloads this repo targets (whole-brain CCM, 10⁵ series / 10¹⁰ pairs)
cannot be tuned or debugged from scattered one-offs — so every layer,
from the ``EDM`` session facade down to each engine launch, reports
through this one subsystem:

* **Spans** — ``with telemetry.span("engine.drive", Nl=..., B=...):``
  records wall time plus static attributes on a context-var span stack
  (nested spans carry their parent path). Span *emission* is gated by
  ``active()``: with telemetry disabled and no sinks attached (the
  default), ``span()`` returns a shared no-op context manager — the
  disabled fast path costs one attribute read per call site.
* **Counters / gauges / histograms** — a process-local metrics registry
  (``counter("edm_pairs_total")``, ``gauge("edm_batch_libs_effective")``,
  ``histogram("edm_launch_latency_seconds")``). Metric updates are plain
  dict/int operations and are ALWAYS on — they are the supported
  observation API the tests assert against (via ``Recorder`` deltas),
  replacing monkeypatched kernel shims. ``render_prom()`` exports the
  registry in Prometheus text format; journaled matrix runs fold it
  into ``run_dir/report.json``.
* **Sinks** — pluggable event consumers: ``Recorder`` (in-memory, what
  tests use), ``JsonlSink`` (one JSON object per line; journaled runs
  attach one to any file), and an optional
  ``torch.profiler.record_function`` bridge (``enable_profiler_trace()``)
  so spans line up with kernel launches in a ``torch.profiler`` trace.

Timing honesty: kernel launches are asynchronous on the GPU, so a host
span around device work times its enqueue. Dispatch (``kernels.ops``) is
counters only (``edm_ops_<op>_calls``). Host spans time host work: the
engine's enqueue (``engine.launch``) and its landings (``engine.land``,
where ``.cpu()`` is a real device sync) and the session's assembly.
Device work is timed by ``device_span``: the same span, plus ``dev_s``,
the device time between two CUDA events recorded on the current stream at
enter and exit. No call waits for them: a closed device span is held back
until its end event has completed, each later span exit polls the held
ones with ``Event.query()``, and ``flush()`` / ``remove_sink`` — which run
outside the timed calls — wait for the rest, so every device span has
reached every sink once ``remove_sink`` returns. With emission off no CUDA
event is made; on a CPU tensor or device the span has no ``dev_s``.

Metric names, and the names of the spans both packages have, are those
of ``repro.telemetry``, so the two packages' observations compare one to
one.
"""

from __future__ import annotations

import contextlib
import contextvars
import json
import os
import threading
import time

__all__ = [
    "span", "device_span", "flush", "event", "active", "enable", "disable",
    "enable_profiler_trace",
    "counter", "gauge", "histogram", "render_prom", "metrics_snapshot",
    "reset_metrics", "add_sink", "remove_sink", "record",
    "Recorder", "JsonlSink",
]

# --------------------------------------------------------------- state

_enabled = False
#: (``record_function``, ``torch.autograd._profiler_enabled``) while the
#: profiler bridge is on, else None.
_bridge = None
_sinks: list = []
_lock = threading.Lock()          # guards sink list mutation + registry
_span_stack: contextvars.ContextVar[tuple] = contextvars.ContextVar(
    "repro_torch_telemetry_span_stack", default=())
#: Closed device spans whose end event has not completed: (event, start
#: CUDA event, end CUDA event), in the order they closed.
_pending: list = []
_pending_lock = threading.Lock()


def enable() -> None:
    """Turn span/event emission on globally (metrics are always on)."""
    global _enabled
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


def enable_profiler_trace(on: bool = True) -> None:
    """Bridge spans to ``torch.profiler.record_function`` so they appear
    as ranges beside the kernel launches of a ``torch.profiler`` trace.
    Off by default. On, a span opens its range only while a profiler
    records (a range costs a profiler call; outside a profile a span pays
    one check), and its ``dur_s`` includes the range's own cost, so nested
    spans still cover their parent."""
    global _bridge
    if on:
        from torch.autograd import _profiler_enabled
        from torch.profiler import record_function
        _bridge = (record_function, _profiler_enabled)
    else:
        _bridge = None


def active() -> bool:
    """Is span/event emission live (enabled, or any sink attached)?"""
    return _enabled or bool(_sinks)


def add_sink(sink) -> None:
    """Attach an event sink (an object with ``emit(event: dict)``)."""
    with _lock:
        _sinks.append(sink)


def remove_sink(sink) -> None:
    """Detach a sink, once every held device span has reached it."""
    flush()
    with _lock:
        if sink in _sinks:
            _sinks.remove(sink)


def _emit(ev: dict) -> None:
    for sink in list(_sinks):
        sink.emit(ev)


def _resolve(block: bool) -> None:
    """Emit the held device spans whose end event has completed (all of
    them, waiting for each, when ``block``)."""
    with _pending_lock:
        done, held = [], []
        for p in _pending:
            (done if block or p[2].query() else held).append(p)
        if not done:
            return
        _pending[:] = held
    for ev, start, end in done:
        if block:
            end.synchronize()
        ev["dev_s"] = start.elapsed_time(end) * 1e-3
        _emit(ev)


def flush() -> None:
    """Wait for every held device span and emit it (blocks on the device:
    call it outside timed work)."""
    if _pending:
        _resolve(block=True)


# --------------------------------------------------------------- spans


class _NoopSpan:
    """Shared do-nothing span: the disabled-by-default fast path."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def annotate(self, **attrs):
        pass


_NOOP = _NoopSpan()


class _Span:
    __slots__ = ("name", "path", "attrs", "_ts", "_t0", "_token", "_ta")

    def __init__(self, name: str, attrs: dict):
        self.name = name
        self.attrs = attrs

    def annotate(self, **attrs) -> None:
        """Attach attributes discovered mid-span (e.g. a resolved B)."""
        self.attrs.update(attrs)

    def __enter__(self) -> "_Span":
        stack = _span_stack.get()
        parent = stack[-1].path if stack else ""
        self.path = f"{parent}/{self.name}" if parent else self.name
        self._token = _span_stack.set(stack + (self,))
        self._ts = time.time()
        self._t0 = time.perf_counter()
        self._ta = None
        bridge = _bridge
        if bridge is not None and bridge[1]():
            self._ta = bridge[0](self.path)
            self._ta.__enter__()
        return self

    def __exit__(self, *exc) -> bool:
        if self._ta is not None:
            self._ta.__exit__(*exc)
        dur = time.perf_counter() - self._t0
        _span_stack.reset(self._token)
        ev = {"type": "span", "name": self.name, "path": self.path,
              "ts": self._ts, "dur_s": dur}
        if self.attrs:
            ev["attrs"] = self.attrs
        self._close(ev)
        if _pending:
            _resolve(block=False)
        return False

    def _close(self, ev: dict) -> None:
        _emit(ev)


class _DeviceSpan(_Span):
    """A span that also records CUDA events on ``stream`` at enter and
    exit; its event waits in ``_pending`` until the device has passed
    the end event."""

    __slots__ = ("_stream", "_start")

    def __init__(self, name: str, attrs: dict, stream):
        super().__init__(name, attrs)
        self._stream = stream

    def __enter__(self) -> "_DeviceSpan":
        import torch

        self._start = torch.cuda.Event(enable_timing=True)
        self._start.record(self._stream)
        return super().__enter__()

    def _close(self, ev: dict) -> None:
        import torch

        end = torch.cuda.Event(enable_timing=True)
        end.record(self._stream)
        with _pending_lock:
            _pending.append((ev, self._start, end))


def span(name: str, **attrs):
    """Context manager timing one named region of work.

    No-op (a shared singleton, no allocation beyond the kwargs dict)
    unless ``active()``. Attributes must be cheap static values — shapes,
    batch sizes, impl names; anything costly to compute should be added
    via ``Span.annotate`` under an ``active()`` guard at the call site.
    """
    if not active():
        return _NOOP
    return _Span(name, attrs)


def device_span(name: str, device, **attrs):
    """``span`` whose event also carries ``dev_s``, the device time of the
    work enqueued inside it on the current CUDA stream of ``device`` (a
    ``torch.device``, its name, or a tensor on it).

    No-op like ``span`` unless ``active()``, with no CUDA event made. On
    a CPU device it is a plain ``span``: no ``dev_s``. Adds no host sync:
    the event reaches the sinks once the device has finished the work
    (see the module's "Timing honesty").
    """
    if not active():
        return _NOOP
    import torch

    dev = (device.device if isinstance(device, torch.Tensor)
           else torch.device(device))
    if dev.type != "cuda":
        return _Span(name, attrs)
    return _DeviceSpan(name, attrs, torch.cuda.current_stream(dev))


def current_span_path() -> str:
    """Path of the innermost live span ("" outside any span)."""
    stack = _span_stack.get()
    return stack[-1].path if stack else ""


def event(name: str, **attrs) -> None:
    """Emit one point-in-time event (no duration) to the sinks."""
    if not active():
        return
    ev = {"type": "event", "name": name, "ts": time.time(),
          "path": current_span_path()}
    if attrs:
        ev["attrs"] = attrs
    _emit(ev)


# ------------------------------------------------------------- metrics


class Counter:
    """Monotonic counter (process-local; ``inc`` is a GIL-atomic add)."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0

    def inc(self, n: int | float = 1) -> None:
        self.value += n


class Gauge:
    """Last-write-wins value (e.g. the engine's effective batch size)."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)


#: Log-spaced latency buckets (seconds) covering sub-ms kernel launches
#: through multi-minute sharded chunks.
DEFAULT_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                   0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0)


class Histogram:
    """Fixed-bucket histogram (Prometheus-style cumulative export)."""

    __slots__ = ("name", "buckets", "counts", "sum", "count")

    def __init__(self, name: str, buckets=DEFAULT_BUCKETS):
        self.name = name
        self.buckets = tuple(float(b) for b in buckets)
        self.counts = [0] * (len(self.buckets) + 1)  # +1: the +Inf bucket
        self.sum = 0.0
        self.count = 0

    def observe(self, v: float) -> None:
        v = float(v)
        self.sum += v
        self.count += 1
        for i, b in enumerate(self.buckets):
            if v <= b:
                self.counts[i] += 1
                return
        self.counts[-1] += 1


_registry: dict[str, Counter | Gauge | Histogram] = {}


def _metric(name: str, cls, **kw):
    m = _registry.get(name)
    if m is None:
        with _lock:
            m = _registry.get(name)
            if m is None:
                m = _registry[name] = cls(name, **kw)
    if not isinstance(m, cls):
        raise TypeError(
            f"metric {name!r} is already registered as "
            f"{type(m).__name__}, not {cls.__name__}")
    return m


def counter(name: str) -> Counter:
    return _metric(name, Counter)


def gauge(name: str) -> Gauge:
    return _metric(name, Gauge)


def histogram(name: str, buckets=DEFAULT_BUCKETS) -> Histogram:
    return _metric(name, Histogram, buckets=buckets)


def reset_metrics() -> None:
    """Clear the registry (test/bench isolation; not for production)."""
    with _lock:
        _registry.clear()


def _fmt(v) -> str:
    if isinstance(v, int):
        return str(v)
    return format(float(v), ".10g")


def render_prom() -> str:
    """The whole registry in Prometheus text exposition format."""
    lines = []
    for name in sorted(_registry):
        m = _registry[name]
        if isinstance(m, Counter):
            lines += [f"# TYPE {name} counter", f"{name} {_fmt(m.value)}"]
        elif isinstance(m, Gauge):
            lines += [f"# TYPE {name} gauge", f"{name} {_fmt(m.value)}"]
        else:
            lines.append(f"# TYPE {name} histogram")
            cum = 0
            for b, c in zip(m.buckets, m.counts):
                cum += c
                lines.append(f'{name}_bucket{{le="{_fmt(b)}"}} {cum}')
            cum += m.counts[-1]
            lines.append(f'{name}_bucket{{le="+Inf"}} {cum}')
            lines.append(f"{name}_sum {_fmt(m.sum)}")
            lines.append(f"{name}_count {m.count}")
    return "\n".join(lines) + ("\n" if lines else "")


def metrics_snapshot() -> dict:
    """JSON-ready snapshot of every registered metric's current value."""
    out = {}
    for name, m in sorted(_registry.items()):
        if isinstance(m, (Counter, Gauge)):
            out[name] = m.value
        else:
            out[name] = {"sum": m.sum, "count": m.count,
                         "buckets": dict(zip(map(_fmt, m.buckets),
                                             m.counts))}
    return out


# --------------------------------------------------------------- sinks


def _jsonable(o):
    try:
        f = float(o)  # np scalars, 0-d arrays
    except (TypeError, ValueError):
        return str(o)
    i = int(f)
    return i if i == f else f


class JsonlSink:
    """Append each event as one JSON line (the run-journal event log)."""

    def __init__(self, path: str):
        self.path = path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._f = open(path, "a")
        self._wlock = threading.Lock()

    def emit(self, ev: dict) -> None:
        line = json.dumps(ev, default=_jsonable)
        with self._wlock:
            self._f.write(line + "\n")
            self._f.flush()

    def close(self) -> None:
        with self._wlock:
            if not self._f.closed:
                self._f.close()


class Recorder:
    """In-memory sink + counter-delta snapshots: the test observation API.

    Captures every span/event emitted while attached, and snapshots the
    counter registry at construction so invocation-count assertions read
    ``counter_delta`` instead of monkeypatching kernel entry points::

        with telemetry.record() as rec:
            sess.optimal_E(); sess.xmap()
        assert rec.counter_delta("edm_knn_master_builds") == 1
    """

    def __init__(self):
        self.events: list[dict] = []
        self._base = {n: m.value for n, m in _registry.items()
                      if isinstance(m, Counter)}

    def emit(self, ev: dict) -> None:
        self.events.append(ev)

    def spans(self, name: str | None = None) -> list[dict]:
        return [e for e in self.events if e["type"] == "span"
                and (name is None or e["name"] == name)]

    def events_named(self, name: str) -> list[dict]:
        return [e for e in self.events if e["type"] == "event"
                and e["name"] == name]

    def counter_delta(self, name: str) -> int | float:
        m = _registry.get(name)
        now = m.value if isinstance(m, Counter) else 0
        return now - self._base.get(name, 0)


@contextlib.contextmanager
def record():
    """Attach a fresh ``Recorder`` for the block (spans become active)."""
    rec = Recorder()
    add_sink(rec)
    try:
        yield rec
    finally:
        remove_sink(rec)
