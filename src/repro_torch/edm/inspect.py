"""Run inspector: live progress of a journaled matrix run.

The port's copy of ``repro.edm.inspect`` (the journal layout is the
same). ``python -m repro_torch.edm.inspect <run_dir>`` renders what a
running (or finished) ``EDM.xmap(run_dir=...)`` matrix run is doing, from
artifacts alone — no imports of the engine, no locks taken, safe to
point at a directory another process is actively writing:

* ``run.json``    — identity: run key, status, shape, attempt lineage.
* ``report.json`` — progress counters, this-attempt vs cumulative
  elapsed, pairs/s, straggler flags, the OOM backoff trail (refreshed
  at every snapshot, not just at exit).
* ``heartbeat``   — per-tile (rows_done, wall time) lines: recent
  throughput, heartbeat age (a stale age with a live process = hang),
  and the ETA extrapolated from the recent row rate.
* ``telemetry/events.jsonl`` — the span/event log; the summary shows
  the trailing straggler/OOM/lifecycle events.

Exposed as functions (``inspect_run`` → dict, ``format_summary`` →
str) so tests and dashboards consume the same logic as the CLI.
"""

from __future__ import annotations

import json
import os
import sys
import time

#: Heartbeat window (entries) for the recent-throughput estimate.
RATE_WINDOW = 20

#: Trailing telemetry events surfaced in the summary.
EVENT_TAIL = 8

#: Event names worth surfacing in a progress trail.
TRAIL_EVENTS = ("straggler.flag", "oom.backoff", "run.start", "run.resume",
                "run.preempt", "run.complete")


def _load_json(path: str):
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, json.JSONDecodeError):
        return None


def _load_heartbeat(path: str) -> list[tuple[int, float]]:
    beats = []
    try:
        with open(path) as f:
            for line in f:
                try:
                    step, ts = line.strip().split(",")
                    beats.append((int(step), float(ts)))
                except ValueError:
                    continue  # torn final line of a live writer
    except OSError:
        pass
    return beats


def _load_event_trail(path: str) -> list[dict]:
    trail = []
    try:
        with open(path) as f:
            for line in f:
                try:
                    ev = json.loads(line)
                except json.JSONDecodeError:
                    continue  # torn final line of a live writer
                if ev.get("name") in TRAIL_EVENTS:
                    trail.append(ev)
    except OSError:
        pass
    return trail[-EVENT_TAIL:]


def inspect_run(run_dir: str, *, now: float | None = None) -> dict:
    """Everything the inspector knows about ``run_dir``, as one dict.

    Never raises on missing/partial artifacts — a run that has only
    written its manifest still inspects (progress fields are None).
    ``now`` is injectable for deterministic tests.
    """
    now = time.time() if now is None else now
    manifest = _load_json(os.path.join(run_dir, "run.json"))
    report = _load_json(os.path.join(run_dir, "report.json"))
    beats = _load_heartbeat(os.path.join(run_dir, "heartbeat"))
    trail = _load_event_trail(
        os.path.join(run_dir, "telemetry", "events.jsonl"))

    info = {
        "run_dir": os.path.abspath(run_dir),
        "manifest": manifest,
        "report": report,
        "events": trail,
        "status": (manifest or {}).get("status"),
        "attempts": (manifest or {}).get("attempts", []),
        "rows_done": (report or {}).get("rows_done"),
        "rows_total": (report or {}).get("rows_total"),
        "pairs_per_s": (report or {}).get("pairs_per_s"),
        "heartbeat_age_s": None,
        "rows_per_s": None,
        "eta_s": None,
    }
    if beats:
        info["heartbeat_age_s"] = round(now - beats[-1][1], 3)
        recent = beats[-RATE_WINDOW:]
        d_rows = recent[-1][0] - recent[0][0]
        d_t = recent[-1][1] - recent[0][1]
        if d_rows > 0 and d_t > 0:
            rate = d_rows / d_t
            info["rows_per_s"] = round(rate, 3)
            if info["rows_total"] is not None:
                remaining = info["rows_total"] - recent[-1][0]
                info["eta_s"] = round(max(0, remaining) / rate, 1)
    return info


def _fmt_eta(s: float | None) -> str:
    if s is None:
        return "?"
    if s >= 3600:
        return f"{s / 3600:.1f}h"
    if s >= 60:
        return f"{s / 60:.1f}m"
    return f"{s:.0f}s"


def format_summary(info: dict) -> str:
    """Human-readable multi-line summary of ``inspect_run``'s dict."""
    lines = [f"run_dir: {info['run_dir']}"]
    m, r = info["manifest"], info["report"]
    if m is None:
        lines.append("no run.json — not a journaled run dir (yet?)")
        return "\n".join(lines)
    lines.append(f"status: {info['status']}   key: {m.get('key', '?')[:12]}…"
                 f"   shape: {m.get('shape')}")
    attempts = info["attempts"]
    if attempts:
        ids = [a.get("run_id", "?") for a in attempts]
        lines.append(f"attempts: {len(ids)} ({', '.join(ids)})")
    if r is not None:
        done, total = r.get("rows_done"), r.get("rows_total")
        pct = f" ({100.0 * done / total:.1f}%)" if total else ""
        lines.append(
            f"rows: {done}/{total}{pct}   this attempt: "
            f"{r.get('rows_this_attempt')}   resumed: "
            f"{r.get('rows_resumed')}")
        lines.append(
            f"throughput: {r.get('pairs_per_s')} pairs/s, "
            f"{r.get('tiles_per_s')} tiles/s   elapsed: "
            f"{r.get('elapsed_s')}s (cumulative "
            f"{r.get('cumulative_elapsed_s')}s)")
        flags = (r.get("stragglers") or {}).get("flagged", [])
        ooms = r.get("oom_backoff", [])
        if flags or ooms:
            lines.append(f"stragglers flagged: {len(flags)}   "
                         f"oom backoffs: {len(ooms)}")
    lines.append(
        f"heartbeat age: {_fmt_eta(info['heartbeat_age_s'])}   recent: "
        f"{info['rows_per_s']} rows/s   ETA: {_fmt_eta(info['eta_s'])}")
    for ev in info["events"]:
        attrs = ev.get("attrs", {})
        brief = ", ".join(f"{k}={v}" for k, v in list(attrs.items())[:4])
        lines.append(f"  event {ev.get('name')}: {brief}")
    return "\n".join(lines)


def main(argv=None) -> int:
    args = list(sys.argv[1:] if argv is None else argv)
    if len(args) != 1:
        print("usage: python -m repro_torch.edm.inspect <run_dir>",
              file=sys.stderr)
        return 2
    run_dir = args[0]
    if not os.path.isdir(run_dir):
        print(f"no such run_dir: {run_dir}", file=sys.stderr)
        return 2
    print(format_summary(inspect_run(run_dir)))
    return 0


if __name__ == "__main__":  # pragma: no cover
    sys.exit(main())
