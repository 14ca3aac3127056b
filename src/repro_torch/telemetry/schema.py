"""Shared schemas for the repo's machine-readable artifacts.

Two artifact families flow out of runs and benches:

* telemetry JSONL event logs (``run_dir/telemetry/events.jsonl``) —
  one JSON object per line, ``type`` either ``"span"`` or ``"event"``; a
  device span also carries ``dev_s``;
* bench snapshots (``BENCH_*.json``) — rows of
  ``name, us_per_call, derived``.

``python -m repro_torch.telemetry.schema <files...>`` validates both, so
a malformed artifact fails the run that wrote it instead of corrupting
the run inspector's view. The port's copy of ``repro.telemetry.schema``
(the two packages write the same artifacts, and give the same verdicts,
but for the port's device spans' ``dev_s``). Validators are hand-rolled —
the schema is small and the repo takes no dependency on jsonschema.
"""

from __future__ import annotations

import json
import sys

EVENT_TYPES = ("span", "event")


def _fail(msg: str, obj=None) -> str:
    if obj is not None:
        msg = f"{msg}: {json.dumps(obj)[:200]}"
    return msg


def validate_event(ev) -> list[str]:
    """Violations in one telemetry JSONL record ([] when valid)."""
    errs = []
    if not isinstance(ev, dict):
        return [_fail("record is not an object", ev)]
    t = ev.get("type")
    if t not in EVENT_TYPES:
        errs.append(_fail(f"type must be one of {EVENT_TYPES}", ev))
    if not isinstance(ev.get("name"), str) or not ev.get("name"):
        errs.append(_fail("name must be a non-empty string", ev))
    if not isinstance(ev.get("ts"), (int, float)):
        errs.append(_fail("ts must be a number", ev))
    if t == "span":
        dur = ev.get("dur_s")
        if not isinstance(dur, (int, float)) or dur < 0:
            errs.append(_fail("span dur_s must be a number >= 0", ev))
        if not isinstance(ev.get("path"), str):
            errs.append(_fail("span path must be a string", ev))
    if "dev_s" in ev:  # a device span's device time (spans only)
        dev = ev["dev_s"]
        if (t != "span" or isinstance(dev, bool)
                or not isinstance(dev, (int, float)) or not dev >= 0):
            errs.append(_fail("dev_s must be a number >= 0 on a span", ev))
    if "attrs" in ev and not isinstance(ev["attrs"], dict):
        errs.append(_fail("attrs must be an object", ev))
    return errs


def validate_events_file(path: str) -> list[str]:
    errs = []
    with open(path) as f:
        for i, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            try:
                ev = json.loads(line)
            except json.JSONDecodeError as e:
                errs.append(f"{path}:{i}: invalid JSON ({e})")
                continue
            errs += [f"{path}:{i}: {m}" for m in validate_event(ev)]
    return errs


def validate_bench(doc) -> list[str]:
    """Violations in one BENCH_*.json snapshot ([] when valid)."""
    errs = []
    if not isinstance(doc, dict):
        return [_fail("bench doc is not an object", doc)]
    if not isinstance(doc.get("bench"), str) or not doc.get("bench"):
        errs.append(_fail("bench must be a non-empty string", doc))
    rows = doc.get("rows")
    if not isinstance(rows, list) or not rows:
        return errs + [_fail("rows must be a non-empty array", doc)]
    for r in rows:
        if not isinstance(r, dict):
            errs.append(_fail("row is not an object", r))
            continue
        if not isinstance(r.get("name"), str) or not r.get("name"):
            errs.append(_fail("row name must be a non-empty string", r))
        us = r.get("us_per_call")
        if not isinstance(us, (int, float)) or us <= 0:
            errs.append(_fail("row us_per_call must be a number > 0", r))
        if "derived" in r and not isinstance(r["derived"], str):
            errs.append(_fail("row derived must be a string", r))
    return errs


def validate_bench_file(path: str) -> list[str]:
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        return [f"{path}: unreadable ({e})"]
    return [f"{path}: {m}" for m in validate_bench(doc)]


def validate_file(path: str) -> list[str]:
    """Dispatch on suffix: ``.jsonl`` → events, ``.json`` → bench."""
    if path.endswith(".jsonl"):
        return validate_events_file(path)
    return validate_bench_file(path)


def main(argv=None) -> int:
    paths = list(sys.argv[1:] if argv is None else argv)
    if not paths:
        print("usage: python -m repro_torch.telemetry.schema <artifact...>",
              file=sys.stderr)
        return 2
    errs = []
    for p in paths:
        errs += validate_file(p)
    for e in errs:
        print(e, file=sys.stderr)
    if not errs:
        print(f"schema OK: {len(paths)} artifact(s)")
    return 1 if errs else 0


if __name__ == "__main__":  # pragma: no cover
    sys.exit(main())
