"""Crash durability for the EDM server: per-panel write-ahead logs.

The port of ``repro.serving.durability``, with the same on-disk layout
and a byte-identical WAL frame. What differs: the fingerprint is the
port's (``edm.runner.config_fingerprint`` keys the device type and the
package), so a state dir written by ``repro``, or whose config names
another device type than the one it was registered on, is refused with
``WalError``; a snapshot copies the panel off the device; recovery
rebuilds the panel on the registration's device.

Under ``EDMServer(state_dir=...)`` every panel registration and every
*accepted* append delta is made durable before its future resolves, so
``EDMServer.recover(state_dir)`` after any crash (kill -9 included)
rebuilds every panel at its exact pre-crash library version — and by
the append≡rebuild contract (``plan.panel_master_append`` is
bit-identical to a cold rebuild), every served answer after recovery is
bit-identical to an uninterrupted session.

On-disk layout, one directory per panel under ``<state_dir>/panels/``::

    <slug>/                      # atomic: written as <slug>.tmp, renamed
      meta.json                  # name, names, config fields, fingerprint
      base.npy                   # the raw registered panel (float32)
      snap-0000000012/           # newest compaction snapshot (version 12)
        state.npz                # panel, valid mask, running screen stats
        snap.json                # version, names, invalid_report
      wal-0000000012.log         # append records with version > 12

The **fingerprint** reuses the journal's ``run_key`` hashing idiom: sha256
over the panel's dtype/shape/bytes plus ``config_fingerprint`` of the
resolved session config — recovery refuses a state dir whose base panel
or config no longer hashes to what was registered.

**WAL records** are length-prefixed, CRC-framed segments::

    b"EDMW" | u32 header_len | u32 payload_len | u32 crc32 | header | payload

where the header is a JSON dict ``{"v": version, "shape": [N, dt]}``
and the payload is the delta's float32 bytes. A torn tail (the crash
landed mid-write) fails its CRC: recovery replays to the last complete
record and warns — exactly the journal's posture. Corruption
*before* the tail is refused loudly (``WalError``).

**Compaction**: every ``compact_every`` logged records the owner
snapshots the live ``Dataset`` state (panel + validity mask + running
screen stats + invalid report — sufficient to continue ``append``
bit-identically) into an atomic tmp+rename directory, rotates to a
fresh WAL, and deletes older segments — recovery cost is
O(snapshot + log tail), not O(append history).

**Write/fsync discipline**: records are written and flushed before the
append future resolves — durable against process death (the OS page
cache survives kill -9). ``wal_fsync=True`` additionally fsyncs per
record (power-loss durability at a per-append fsync cost); the default
fsyncs at compaction, drain, and close. Registration and snapshots are
always fsynced before their atomic rename publishes them.

Failure honesty: if a WAL write fails *after* the in-memory append was
applied, memory is ahead of the log — the scheduler quarantines the
panel (fail fast with the WAL error) rather than serving answers a
recovery could never reproduce.
"""

from __future__ import annotations

import hashlib
import io
import json
import os
import re
import struct
import threading
import warnings
import zlib

import numpy as np
import torch

from repro_torch import telemetry
from repro_torch.edm.config import EDMConfig
from repro_torch.edm.dataset import Dataset, resolve_device
from repro_torch.edm.runner import config_fingerprint
from repro_torch.edm.session import EDM

_MAGIC = b"EDMW"
_FRAME = struct.Struct("<III")  # header_len, payload_len, crc32

#: Default records-per-WAL before compaction into a snapshot.
COMPACT_EVERY = 64


class WalError(RuntimeError):
    """A state dir that cannot be recovered (corruption before the
    tail, a version gap, or a fingerprint mismatch)."""


def panel_fingerprint(panel: np.ndarray, config: EDMConfig) -> str:
    """Identity of (panel bytes, resolved config) — the ``run_key``
    hashing idiom from ``edm.runner``, minus the task signature."""
    arr = np.ascontiguousarray(np.asarray(panel, np.float32))
    h = hashlib.sha256()
    h.update(f"{arr.dtype}|{arr.shape}|".encode())
    h.update(arr.tobytes())
    h.update(config_fingerprint(config).encode())
    return h.hexdigest()[:32]


def _config_dict(config: EDMConfig) -> dict:
    d = {f: getattr(config, f) for f in config.__dataclass_fields__}
    if d.pop("mesh", None) is not None:
        raise ValueError(
            "a config carrying a live device mesh cannot be made "
            "durable; register without mesh= when state_dir is set")
    return {k: (list(v) if isinstance(v, tuple) else v)
            for k, v in d.items()}


def _fsync(path: str) -> None:
    """fsync a file or a directory (its entries)."""
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _slug(name: str) -> str:
    safe = re.sub(r"[^A-Za-z0-9._-]", "_", name)[:48]
    return f"{safe}-{hashlib.sha256(name.encode()).hexdigest()[:8]}"


def _frame_record(version: int, delta: np.ndarray) -> bytes:
    header = json.dumps(
        {"v": int(version), "shape": list(delta.shape)}).encode()
    payload = delta.tobytes()
    crc = zlib.crc32(header + payload)
    return _MAGIC + _FRAME.pack(len(header), len(payload), crc) \
        + header + payload


def _read_frames(path: str) -> tuple[list[tuple[int, np.ndarray]], int]:
    """Parse one WAL file; returns (records, torn_tail_bytes).

    Stops at the first frame that is incomplete or fails its CRC; the
    caller decides whether a torn tail is tolerable (last segment) or
    corruption (an earlier one).
    """
    records: list[tuple[int, np.ndarray]] = []
    with open(path, "rb") as f:
        data = f.read()
    off, n = 0, len(data)
    while off < n:
        head_end = off + len(_MAGIC) + _FRAME.size
        if data[off:off + len(_MAGIC)] != _MAGIC or head_end > n:
            break
        hlen, plen, crc = _FRAME.unpack(data[off + len(_MAGIC):head_end])
        end = head_end + hlen + plen
        if end > n:
            break
        blob = data[head_end:end]
        if zlib.crc32(blob) != crc:
            break
        header = json.loads(blob[:hlen])
        delta = np.frombuffer(
            blob[hlen:], np.float32).reshape(header["shape"]).copy()
        records.append((int(header["v"]), delta))
        off = end
    return records, n - off


def _restore_dataset(npz, snap: dict, config: EDMConfig):
    """Rebuild a ``Dataset`` from snapshot state without re-screening.

    The snapshot holds the *live* dataset fields (post-mask/drop panel,
    validity mask, running screen stats, accumulated invalid report) —
    restoring them verbatim is what keeps later ``append`` calls
    bit-identical to the uninterrupted session. The panel goes to the
    config's device.
    """
    ds = Dataset.__new__(Dataset)
    ds.on_invalid = config.on_invalid
    ds.panel = torch.as_tensor(
        np.asarray(npz["panel"], np.float32),
        device=resolve_device(config.device, "Dataset"))
    ds.names = snap["names"]
    ds.valid = np.asarray(npz["valid"], bool)
    ds._stats = {"cnt": np.asarray(npz["cnt"]),
                 "lo": np.asarray(npz["lo"]),
                 "hi": np.asarray(npz["hi"])}
    ds.invalid_report = list(snap["invalid_report"])
    ds._embeddings = {}
    return ds


class PanelLog:
    """One panel's durable state: meta + base + snapshots + active WAL."""

    def __init__(self, pdir: str, *, compact_every: int = COMPACT_EVERY,
                 wal_fsync: bool = False, faults=None):
        self.pdir = pdir
        self.compact_every = max(1, int(compact_every))
        self.wal_fsync = bool(wal_fsync)
        self.faults = faults
        self._lock = threading.Lock()
        self._wal: io.BufferedWriter | None = None
        self._wal_path: str | None = None
        self._since_snap = 0
        self.broken: Exception | None = None

    # ------------------------------------------------------ registration

    @classmethod
    def create(cls, panels_dir: str, name: str, panel: np.ndarray,
               names, config: EDMConfig, **kw) -> "PanelLog":
        """Durably publish a registration (atomic tmp+rename)."""
        pdir = os.path.join(panels_dir, _slug(name))
        if os.path.isdir(pdir):
            raise ValueError(
                f"state dir already holds panel {name!r}; use "
                f"EDMServer.recover() to reload it")
        tmp = pdir + ".tmp"
        if os.path.isdir(tmp):
            import shutil
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        arr = np.ascontiguousarray(np.asarray(panel, np.float32))
        meta = {"format": 1, "name": name,
                "names": list(names) if names is not None else None,
                "config": _config_dict(config),
                "fingerprint": panel_fingerprint(arr, config)}
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump(meta, f)
            f.flush()
            os.fsync(f.fileno())
        np.save(os.path.join(tmp, "base.npy"), arr)
        _fsync(os.path.join(tmp, "base.npy"))
        _fsync(tmp)
        os.rename(tmp, pdir)
        _fsync(panels_dir)
        log = cls(pdir, **kw)
        log._open_wal(0)
        return log

    @classmethod
    def open_dir(cls, pdir: str, **kw) -> "PanelLog":
        if not os.path.isfile(os.path.join(pdir, "meta.json")):
            raise WalError(f"{pdir} has no meta.json — not a panel dir")
        return cls(pdir, **kw)

    def meta(self) -> dict:
        with open(os.path.join(self.pdir, "meta.json")) as f:
            return json.load(f)

    # -------------------------------------------------------- WAL writes

    def _wal_name(self, base_version: int) -> str:
        return os.path.join(self.pdir, f"wal-{base_version:010d}.log")

    def _open_wal(self, base_version: int) -> None:
        self._wal_path = self._wal_name(base_version)
        self._wal = open(self._wal_path, "ab")
        self._since_snap = 0

    def log_append(self, delta: np.ndarray, version: int) -> None:
        """Durably frame one accepted delta; called BEFORE the append
        future resolves. Raises on write failure (the caller must then
        quarantine the panel: memory is ahead of the log)."""
        with self._lock:
            if self.broken is not None:
                raise WalError(
                    f"panel WAL is broken: {self.broken}") from self.broken
            if self._wal is None:
                self._open_wal(0)
            frame = _frame_record(
                version, np.ascontiguousarray(delta, dtype=np.float32))
            try:
                if self.faults is not None:
                    self.faults.check("wal_write", detail=self.pdir)
                self._wal.write(frame)
                self._wal.flush()
                if self.wal_fsync:
                    os.fsync(self._wal.fileno())
            except Exception as exc:
                self.broken = exc
                raise
            self._since_snap += 1
            telemetry.counter("serve_wal_bytes").inc(len(frame))
            telemetry.counter("serve_wal_records").inc()

    def should_compact(self) -> bool:
        return self.broken is None and self._since_snap >= self.compact_every

    # ------------------------------------------------------- compaction

    def compact(self, sess: EDM, version: int) -> None:
        """Snapshot the live dataset state at ``version`` and rotate the
        WAL. Crash-safe at every step: recovery is version-driven, so a
        half-finished compaction is at worst ignored."""
        with self._lock:
            if self._wal is not None:
                self._wal.flush()
                os.fsync(self._wal.fileno())
            snap = os.path.join(self.pdir, f"snap-{version:010d}")
            if not os.path.isdir(snap):
                # A snapshot at this version may already exist (the
                # post-recovery compaction re-compacts the recovered
                # version). Same version == same durable state, so the
                # existing one stands — replacing it would open a crash
                # window with no snapshot at all.
                tmp = snap + ".tmp"
                if os.path.isdir(tmp):
                    import shutil
                    shutil.rmtree(tmp)
                os.makedirs(tmp)
                ds = sess.data
                np.savez(os.path.join(tmp, "state.npz"),
                         panel=ds.panel.detach().cpu().numpy(),
                         valid=np.asarray(ds.valid, bool),
                         cnt=ds._stats["cnt"], lo=ds._stats["lo"],
                         hi=ds._stats["hi"])
                with open(os.path.join(tmp, "snap.json"), "w") as f:
                    json.dump({"version": int(version), "names": ds.names,
                               "invalid_report": ds.invalid_report}, f)
                    f.flush()
                    os.fsync(f.fileno())
                _fsync(os.path.join(tmp, "state.npz"))
                _fsync(tmp)
                os.rename(tmp, snap)
                _fsync(self.pdir)
            if self._wal is not None:
                self._wal.close()
            self._open_wal(version)
            self._gc(keep_version=version)
            telemetry.event("serve.wal_compact", panel_dir=self.pdir,
                            version=int(version))

    def _gc(self, keep_version: int) -> None:
        """Drop snapshots and WAL segments older than ``keep_version``."""
        for fn in os.listdir(self.pdir):
            m = re.match(r"(snap|wal)-(\d{10})(?:\.log)?$", fn)
            if m and int(m.group(2)) < keep_version:
                path = os.path.join(self.pdir, fn)
                if m.group(1) == "snap":
                    import shutil
                    shutil.rmtree(path, ignore_errors=True)
                else:
                    os.unlink(path)

    # --------------------------------------------------------- recovery

    def _snapshots(self) -> list[tuple[int, str]]:
        out = []
        for fn in os.listdir(self.pdir):
            m = re.match(r"snap-(\d{10})$", fn)
            if m and os.path.isfile(
                    os.path.join(self.pdir, fn, "snap.json")):
                out.append((int(m.group(1)), os.path.join(self.pdir, fn)))
        return sorted(out)

    def _wal_files(self) -> list[tuple[int, str]]:
        out = []
        for fn in os.listdir(self.pdir):
            m = re.match(r"wal-(\d{10})\.log$", fn)
            if m:
                out.append((int(m.group(1)), os.path.join(self.pdir, fn)))
        return sorted(out)

    def recover(self) -> tuple[EDM, int, dict]:
        """Rebuild the session through the normal append path.

        Returns ``(session, version, info)`` where the session is
        bit-identical to the pre-crash one at ``version`` (the last
        durably logged append), on the device the panel was registered
        on. After this, call ``reset_after_recovery`` to rotate a clean
        WAL before serving.
        """
        meta = self.meta()
        base = np.load(os.path.join(self.pdir, "base.npy"))
        fields = {k: v for k, v in meta["config"].items() if k != "mesh"}
        unknown = sorted(set(fields) - set(EDMConfig.__dataclass_fields__))
        # This package writes ``device`` with every config; ``repro`` never.
        if unknown or "device" not in fields:
            what = (f"fields {unknown} are" if unknown
                    else "names no device, so it is")
            raise WalError(
                f"panel {meta['name']!r}: its config {what} not this "
                f"package's — the state dir was written by another "
                f"package")
        config = EDMConfig(**fields)
        fp = panel_fingerprint(base, config)
        if fp != meta["fingerprint"]:
            raise WalError(
                f"panel {meta['name']!r}: base panel/config fingerprint "
                f"mismatch ({fp} != {meta['fingerprint']}) — the state "
                f"dir does not belong to this registration (another "
                f"panel, config, device type or package wrote it)")
        snaps = self._snapshots()
        if snaps:
            v0, sdir = snaps[-1]
            with np.load(os.path.join(sdir, "state.npz")) as npz:
                with open(os.path.join(sdir, "snap.json")) as f:
                    sj = json.load(f)
                ds = _restore_dataset(npz, sj, config)
        else:
            v0 = 0
            ds = Dataset(base, names=meta["names"],
                         on_invalid=config.on_invalid, device=config.device)
        sess = EDM(ds, config)
        version, replayed, torn = v0, 0, 0
        wals = self._wal_files()
        for i, (_, path) in enumerate(wals):
            records, tail = _read_frames(path)
            if tail:
                if i != len(wals) - 1:
                    raise WalError(
                        f"{path}: {tail} undecodable bytes before the "
                        f"final WAL segment — state dir is corrupt")
                torn = tail
                warnings.warn(
                    f"{path}: torn tail ({tail} bytes) — recovering to "
                    f"the last complete record", stacklevel=2)
                telemetry.event("serve.wal_torn_tail",
                                panel_dir=self.pdir, bytes=int(tail))
            for v, delta in records:
                if v <= version:
                    continue  # already inside the snapshot
                if v != version + 1:
                    raise WalError(
                        f"{path}: version gap (have {version}, record "
                        f"claims {v})")
                sess.append(delta)
                version, replayed = v, replayed + 1
        return sess, version, {"name": meta["name"], "version": version,
                               "replayed": replayed, "snapshot": v0,
                               "torn_tail_bytes": torn}

    def reset_after_recovery(self, sess: EDM, version: int) -> None:
        """Post-recovery compaction: snapshot the recovered state and
        rotate a fresh WAL (also truncates any torn tail for good)."""
        self.compact(sess, version)

    # ------------------------------------------------------------ flush

    def fsync(self) -> None:
        with self._lock:
            if self._wal is not None and self.broken is None:
                self._wal.flush()
                os.fsync(self._wal.fileno())

    def close(self) -> None:
        with self._lock:
            if self._wal is not None:
                try:
                    self._wal.flush()
                    os.fsync(self._wal.fileno())
                except OSError:
                    pass
                self._wal.close()
                self._wal = None


class Durability:
    """All panels' logs under one ``state_dir`` (the server-level knob)."""

    def __init__(self, state_dir: str, *,
                 compact_every: int = COMPACT_EVERY,
                 wal_fsync: bool = False, faults=None):
        self.state_dir = state_dir
        self.panels_dir = os.path.join(state_dir, "panels")
        os.makedirs(self.panels_dir, exist_ok=True)
        self.compact_every = compact_every
        self.wal_fsync = wal_fsync
        self.faults = faults
        self._lock = threading.Lock()
        self._logs: dict[str, PanelLog] = {}

    def _kw(self) -> dict:
        return dict(compact_every=self.compact_every,
                    wal_fsync=self.wal_fsync, faults=self.faults)

    def register(self, name: str, panel, names,
                 config: EDMConfig) -> PanelLog:
        log = PanelLog.create(self.panels_dir, name, panel, names,
                              config, **self._kw())
        with self._lock:
            self._logs[name] = log
        return log

    def adopt(self, name: str, log: PanelLog) -> None:
        with self._lock:
            self._logs[name] = log

    def scan(self) -> list[PanelLog]:
        """Panel logs found on disk (the recovery entry point)."""
        out = []
        for fn in sorted(os.listdir(self.panels_dir)):
            pdir = os.path.join(self.panels_dir, fn)
            if fn.endswith(".tmp") or not os.path.isdir(pdir):
                continue
            if os.path.isfile(os.path.join(pdir, "meta.json")):
                out.append(PanelLog.open_dir(pdir, **self._kw()))
        return out

    def get(self, name: str) -> PanelLog | None:
        with self._lock:
            return self._logs.get(name)

    def drop(self, name: str) -> None:
        with self._lock:
            log = self._logs.pop(name, None)
        if log is not None:
            log.close()

    def fsync_all(self) -> None:
        with self._lock:
            logs = list(self._logs.values())
        for log in logs:
            log.fsync()

    def close(self) -> None:
        with self._lock:
            logs = list(self._logs.values())
            self._logs.clear()
        for log in logs:
            log.close()
