"""Fault-tolerant matrix runs: tile journal, preemption, OOM backoff.

The port of ``repro.edm.runner``. The workloads the batched matrix engine
targets are exactly the ones that get preempted — whole-brain CCM at 10⁵
series is 10¹⁰ pairs of tiled launches — so ``EDM.xmap(...,
run_dir=...)`` journals every (lib-batch × tgt-group) tile through a
``MatrixRunner`` and a preempted job restarts at the last committed
tile instead of from zero.

Journal format (everything lives under ``run_dir``):

* ``run.json`` — the run manifest: a **content hash** of the panel
  bytes + the numeric-semantics fields of the ``EDMConfig`` + the task
  signature (method, θ, the **full per-series E table** — not a
  group-size summary, so reassigning manifolds while keeping group
  sizes still changes the key), the matrix shape, and the group
  layout. The key also separates the device type (the CUDA kernels and
  the plain versions differ in ρ's last bits) and the package (a journal
  written by ``repro`` is never resumed here). A resume whose recomputed key differs is REFUSED with a
  clear error — a stale journal (edited panel, changed config, changed
  ``E_opt``) can never silently leak rows into a fresh run.
* ``state/step_*`` — run-state snapshots via
  ``checkpoint.CheckpointManager`` (atomic tmp+rename publish, last-K
  retention, manifest-validated restore): the partial ρ matrix plus a
  per-(group, lib-row) done mask. Committed every
  ``checkpoint_every``-th tile; a crash between snapshots redoes at
  most that many tiles.
* ``heartbeat`` — one appended line per committed tile
  (``distributed.fault.Heartbeat``) so an external watchdog can detect
  a hang (no heartbeat progress) as opposed to a crash (process gone).
* ``lock`` — an advisory ``flock`` held for the runner's lifetime: a
  restart loop relaunching before the dying process has fully exited
  would otherwise interleave two writers over ``run.json`` and the
  snapshot dirs. The second process fails fast with a clear error.
* ``report.json`` — the run report: progress counters, straggler
  flags (``StragglerMonitor`` over the engine launch timings), the OOM
  backoff decision trail, and the dataset's invalid-series records.

A mesh run (``EDMConfig(mesh=...)``) has one runner on every rank: rank 0
alone owns ``run_dir`` (the lock, the manifest, the snapshots and the
report) and broadcasts its resume point; every rank drives the same tiles,
holds the same rows in memory, and at each tile boundary the ranks agree
(one all-reduce of two flags) on going on or preempting, so a preemption
or a failed commit stops every rank at the same tile. An out-of-memory
error reaches every rank from the same tile (the sharded engines agree
before they deliver), so every rank takes the same rung of the ladder.

Correctness contract: tiles are committed only after their rows have
landed on the host (``.cpu()``, which waits for the device), done-ness is tracked per *library row* (so the
tile shape may change across resumes — the engines are bit-invariant
in batch size B), and a resumed run is **bit-identical** to an
uninterrupted one because every committed row is replayed from the
journal verbatim and every recomputed row runs the same engine on the
same inputs.

Graceful degradation:

* **Preemption** — a ``PreemptionGuard`` turns SIGTERM/SIGINT into a
  flag polled at each tile commit; the runner snapshots the state,
  writes the report, and exits with code ``PREEMPTED_EXIT`` (17) — the
  restart loop's "resume me" signal — instead of dying mid-launch.
* **OOM backoff** — a ``torch.cuda.OutOfMemoryError`` (the caching
  allocator's, or a kernel's own ``cudaErrorMemoryAllocation`` through
  ``kernels._build.check``), a ``MemoryError`` or an anchored allocator
  message around a launch halves the library batch B (re-equalized over
  the remaining rows, the ``auto_batch_libs`` discipline) and retries, at
  most ``oom_retries`` times, logging each decision; a budget
  misestimate degrades to smaller launches instead of killing the job.
  The retry holds no device tensor of the failed tiles: only the error's
  first 200 characters are kept.
"""

from __future__ import annotations

import fcntl
import hashlib
import json
import os
import signal
import time
import uuid

import numpy as np
import torch

from repro_torch import telemetry
from repro_torch.checkpoint import CheckpointManager
from repro_torch.core.ccm import drive_batched
from repro_torch.distributed.fault import (Heartbeat, PreemptionGuard,
                                           StragglerMonitor)

#: Exit code of a preempted run that checkpointed cleanly (restart loops
#: treat it as "resume from run_dir", distinct from crash codes).
PREEMPTED_EXIT = 17

#: EDMConfig fields hashed into the run key — everything that changes
#: numeric results or the task decomposition. ``device`` is keyed by its
#: type alone ("cuda" / "cpu", not the index): the CUDA kernels' ρ differs
#: from the plain versions' in the last bits, so a journal begun on one
#: and resumed on the other would mix rows. Deliberately excluded:
#: perf-only knobs (batch_libs, batch_budget_mb, checkpoint_*,
#: oom_retries, run_tile_rows, pad, straggler_threshold) — results are
#: invariant in them, so resuming with a different batch size or snapshot
#: cadence is legal — and the mesh object itself (its dim names and sizes
#: and the lib/tgt axes are keyed separately).
KEYED_CONFIG_FIELDS = ("E", "E_max", "tau", "Tp", "Tp_cross", "theta",
                       "thetas", "k", "extra_slack", "ridge", "impl",
                       "cache", "on_invalid", "device")

#: Written into every fingerprint: a run_dir journaled by another package
#: (``repro``) keys differently and is refused as stale, never resumed.
PACKAGE_TAG = "repro_torch"


def config_fingerprint(config) -> str:
    """Deterministic string of the result-relevant config fields."""
    parts = [f"package={PACKAGE_TAG!r}"]
    for f in KEYED_CONFIG_FIELDS:
        v = getattr(config, f)
        if f == "device":
            v = torch.device(v).type
        parts.append(f"{f}={v!r}")
    mesh = config.mesh
    if mesh is not None:
        parts.append(f"mesh={tuple(zip(mesh.mesh_dim_names, mesh.shape))!r}"
                     f"/lib={config.lib_axes!r}/tgt={config.tgt_axes!r}")
    return ";".join(parts)


def run_key(panel, config, task_sig) -> str:
    """Content hash identifying one (panel, config, task) matrix run.

    The staleness rule: a journal written under a different key — the
    panel's bytes changed, a numeric config knob changed, the task or
    its E-group structure changed — must be refused, never resumed.
    """
    if isinstance(panel, torch.Tensor):
        panel = panel.detach().cpu().numpy()
    arr = np.ascontiguousarray(np.asarray(panel))
    h = hashlib.sha256()
    h.update(f"{arr.dtype}{arr.shape}".encode())
    h.update(arr.tobytes())
    h.update(config_fingerprint(config).encode())
    h.update(repr(task_sig).encode())
    return h.hexdigest()[:32]


#: Allocator-failure markers, ANCHORED: a message must start with one
#: (the status prefix / allocator message itself) or carry it right
#: after a ``": "`` wrapper separator. An error that merely *mentions*
#: memory mid-sentence is not an OOM and must not burn backoff retries.
OOM_MARKERS = ("RESOURCE_EXHAUSTED", "Out of memory",
               "CUDA_ERROR_OUT_OF_MEMORY")


def is_oom_error(e: BaseException) -> bool:
    """Does this look like a device/host allocation failure?

    PyTorch raises ``torch.cuda.OutOfMemoryError`` when the caching
    allocator cannot serve a request (and ``kernels._build.check`` raises
    it for a kernel's own ``cudaErrorMemoryAllocation``). Its message
    begins "CUDA out of memory.", which the anchored markers do not
    match, so it is classified by type. Host-side failures come as
    ``MemoryError``; anything else only by an anchored allocator
    message, so that an unrelated error whose text happens to mention
    memory is not retried.
    """
    if isinstance(e, (MemoryError, torch.cuda.OutOfMemoryError)):
        return True
    msg = str(e)
    return any(msg.startswith(m) or f": {m}" in msg for m in OOM_MARKERS)


def halved_batch(B: int, remaining: int) -> int:
    """The OOM ladder's next rung: halve B, re-equalize the launches.

    Same discipline as ``auto_batch_libs``: under the new cap
    ``max(1, B // 2)``, pick B = ceil(remaining / nb) for the smallest
    launch count nb the cap allows, so the ragged final launch never
    wastes a near-full padded batch.
    """
    cap = max(1, B // 2)
    remaining = max(1, remaining)
    cap = min(cap, remaining)
    nb = -(-remaining // cap)
    return -(-remaining // nb)


class RunState:
    """The journaled state of one matrix run (a checkpointable tree).

    rho:  (N_lib, N_tgt) f32 — committed tiles' values, verbatim.
    done: (n_groups, N_lib) bool — which library rows of which tile
          group have been committed. Row-level (not tile-level) so a
          resume may re-tile with a different B (bit-invariance in B
          makes that legal).
    """

    def __init__(self, shape: tuple[int, int], n_groups: int):
        self.rho = np.zeros(shape, np.float32)
        self.done = np.zeros((n_groups, shape[0]), bool)

    def tree(self) -> dict:
        return {"rho": self.rho, "done": self.done}

    def load(self, tree: dict) -> None:
        # np.array, not asarray: committed tiles write into these.
        self.rho = np.array(tree["rho"], np.float32)
        self.done = np.array(tree["done"], bool)

    @property
    def rows_done(self) -> int:
        return int(self.done.sum())

    @property
    def complete(self) -> bool:
        return bool(self.done.all())


class MatrixRunner:
    """Journaled driver for one all-pairs matrix run under ``run_dir``.

    Built by ``EDM.xmap(run_dir=...)`` (not usually directly): the
    session resolves the task into tile groups — per-E-group for the
    local engines, one lib-chunked group for the sharded path — and
    calls ``drive_group`` per group between ``start()``/``finalize()``.
    ``mesh``: the ``DeviceMesh`` of a mesh run, on every rank of which the
    session builds a runner (only rank 0's ``writes`` the journal).
    See the module docstring for the journal format and the guarantees.
    """

    def __init__(self, run_dir: str, *, key: str,
                 shape: tuple[int, int], groups_sig,
                 keep: int = 3, checkpoint_every: int | None = None,
                 oom_retries: int = 4, invalid_series=(),
                 straggler_threshold: float = 2.0, mesh=None):
        self.mesh = mesh
        self.writes = mesh is None or torch.distributed.get_rank() == 0
        self.dir = os.path.abspath(run_dir)
        self.key = key
        self.shape = tuple(int(s) for s in shape)
        self.groups_sig = [[int(E), int(n)] for E, n in groups_sig]
        self.checkpoint_every = (None if checkpoint_every is None
                                 else int(checkpoint_every))
        self.oom_retries = int(oom_retries)
        self.ckpt = self.heartbeat = None
        if self.writes:
            self.ckpt = CheckpointManager(os.path.join(self.dir, "state"),
                                          keep=keep)
            self.heartbeat = Heartbeat(os.path.join(self.dir, "heartbeat"))
        self.monitor = StragglerMonitor(threshold=straggler_threshold)
        self.oom_trail: list[dict] = []
        self.invalid_series = list(invalid_series)
        self.state = RunState(self.shape, len(self.groups_sig))
        self._tiles = 0            # committed this process
        self._since_snapshot = 0
        self._t0 = time.monotonic()
        self._guard: PreemptionGuard | None = None
        self._saved_step = None    # step of the newest snapshot on disk
        self.resumed_rows = 0
        #: this attempt's identity + the journal's prior-attempt trail —
        #: the resume lineage the run report and inspector surface.
        self.run_id = uuid.uuid4().hex[:12]
        self.prior_attempts: list[dict] = []
        self._sink: telemetry.JsonlSink | None = None
        self._lock = None
        self._status = "running"
        failed = None
        try:
            if self.writes:
                self._acquire_lock()
                self._load_manifest()
        except BaseException as e:
            self._release_lock()
            if mesh is None:
                raise
            failed = e
        if mesh is not None:
            self._join_rank0(failed)
        self._pairs_resumed = self._pairs_done()
        if self.writes and not self.complete:
            # One JSONL event log per journaled run, shared across
            # attempts (append mode): every span/event emitted anywhere
            # in the process while this runner is live lands here.
            self._sink = telemetry.JsonlSink(
                os.path.join(self.dir, "telemetry", "events.jsonl"))
            telemetry.add_sink(self._sink)
            telemetry.counter("edm_runs_started").inc()
            telemetry.event(
                "run.resume" if self.resumed_rows else "run.start",
                run_id=self.run_id, key=self.key,
                rows_resumed=self.resumed_rows,
                prior_run_ids=[a["run_id"] for a in self.prior_attempts])

    # --------------------------------------------------------------- lock

    def _acquire_lock(self) -> None:
        """Advisory single-writer lock on ``run_dir`` (fail fast).

        The preemption/restart-loop design (exit 17, controller
        relaunches) makes it plausible for a resume process to race a
        still-dying predecessor; two writers would interleave
        ``run.json``/``report.json`` replaces and snapshot dirs. flock
        is per open file description, so this also catches two runners
        in one process.
        """
        f = open(os.path.join(self.dir, "lock"), "w")
        try:
            fcntl.flock(f, fcntl.LOCK_EX | fcntl.LOCK_NB)
        except OSError:
            f.close()
            raise RuntimeError(
                f"run_dir {self.dir} is locked by another live run — a "
                f"previous process is still writing this journal. Wait "
                f"for it to exit (or kill it) before resuming.") from None
        self._lock = f

    def _release_lock(self) -> None:
        if self._lock is not None:
            fcntl.flock(self._lock, fcntl.LOCK_UN)
            self._lock.close()
            self._lock = None

    # ---------------------------------------------------------- mesh runs

    def _join_rank0(self, failed) -> None:
        """Every rank of a mesh run: hear whether rank 0 opened the
        journal, then take its state (the rows a snapshot holds, and
        whether the run is complete) so that every rank resumes at the
        same row with the same matrix."""
        from repro_torch.distributed.sharded_ccm import _agree, _from_rank0

        if _agree([failed is not None])[0]:
            if failed is not None:
                raise failed
            raise RuntimeError(f"rank 0 could not open the journal under "
                               f"{self.dir}")
        rho, done, status = _from_rank0(
            self.state.rho, self.state.done.astype(np.uint8),
            np.asarray([self.complete], np.uint8))
        if not self.writes:
            self.state.rho = rho
            self.state.done = done.astype(bool)
            self._status = "complete" if status[0] else "running"
            self.resumed_rows = self.state.rows_done

    def _stop_requested(self, failed=None) -> bool:
        """Preempt at this tile boundary? Re-raises a failed commit. On a
        mesh run the ranks agree first (one all-reduce), so every rank
        stops, or fails, at the same tile."""
        requested = self._guard is not None and self._guard.requested
        if self.mesh is None:
            if failed is not None:
                raise failed
            return requested
        from repro_torch.distributed.sharded_ccm import _agree

        stop, any_failed = _agree([requested, failed is not None])
        if failed is not None:
            raise failed
        if any_failed:
            raise RuntimeError("rank 0 failed to commit a tile of the "
                               "journal")
        return bool(stop)

    # ---------------------------------------------------- manifest/journal

    @property
    def _manifest_path(self) -> str:
        return os.path.join(self.dir, "run.json")

    def _load_manifest(self) -> None:
        path = self._manifest_path
        if not os.path.exists(path):
            self._status = "running"
            self._write_manifest()
            return
        with open(path) as f:
            manifest = json.load(f)
        if manifest.get("key") != self.key:
            raise ValueError(
                f"run_dir {self.dir} holds a journal for a DIFFERENT run "
                f"(key {manifest.get('key')!r}, this run {self.key!r}): "
                f"the panel, config, or task changed since it was "
                f"written. Refusing to resume from a stale journal — "
                f"point run_dir at a fresh directory or delete this one.")
        if (manifest.get("shape") != list(self.shape)
                or manifest.get("groups") != self.groups_sig):
            raise ValueError(
                f"run_dir {self.dir} journal layout does not match this "
                f"run (shape {manifest.get('shape')} vs "
                f"{list(self.shape)}) despite an identical key — the "
                f"journal is corrupt; delete it and rerun")
        self._status = manifest.get("status", "running")
        self.prior_attempts = list(manifest.get("attempts", []))
        step = self.ckpt.latest_step()
        if step is not None:
            self.state.load(self.ckpt.restore(self.state.tree(), step=step))
            self._saved_step = step
            self._since_snapshot = 0
            self.resumed_rows = self.state.rows_done
        if not self.complete:
            # a live attempt: reopen the manifest under this run_id
            self._status = "running"
            self._write_manifest()

    def _pairs_done(self) -> int:
        """Matrix cells committed so far (each group's done rows cover
        only that group's member columns — not the full target axis)."""
        return int(sum(self.state.done[g].sum() * n
                       for g, (_, n) in enumerate(self.groups_sig)))

    def _attempt_record(self) -> dict:
        return {"run_id": self.run_id, "status": self._status,
                "rows_resumed": self.resumed_rows,
                "elapsed_s": round(time.monotonic() - self._t0, 3)}

    def _write_manifest(self) -> None:
        if not self.writes:
            return
        tmp = self._manifest_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"key": self.key, "shape": list(self.shape),
                       "groups": self.groups_sig,
                       "status": self._status,
                       "attempts": (self.prior_attempts
                                    + [self._attempt_record()])}, f)
        os.replace(tmp, self._manifest_path)

    def _snapshot(self, report: bool = True) -> None:
        """Snapshot the run state. A state the newest snapshot already
        holds is not written again: rows are committed once, so an equal
        row count is an equal state."""
        step = self.state.rows_done
        if self.writes and step != self._saved_step:
            self.ckpt.save(step, self.state.tree())
            self._saved_step = step
        self._since_snapshot = 0
        if report and self.writes:
            # refresh the report on every snapshot so the run inspector
            # (python -m repro_torch.edm.inspect) sees live progress, not
            # just the terminal states
            self.write_report()

    @property
    def complete(self) -> bool:
        return self._status == "complete" and self.state.complete

    def result(self) -> np.ndarray:
        return self.state.rho

    # ------------------------------------------------------------ running

    def start(self) -> "MatrixRunner":
        """Install the preemption guard (SIGTERM/SIGINT → checkpoint)."""
        if self._guard is None:
            self._guard = PreemptionGuard(
                signals=(signal.SIGTERM, signal.SIGINT))
        return self

    def close(self) -> None:
        if self._guard is not None:
            self._guard.restore()
            self._guard = None
        if self._sink is not None:
            telemetry.remove_sink(self._sink)
            self._sink.close()
            self._sink = None
        self._release_lock()

    def __enter__(self) -> "MatrixRunner":
        return self.start()

    def __exit__(self, *exc) -> bool:
        self.close()
        return False

    def drive_group(self, g: int, launch, B: int, members) -> None:
        """Drive tile group ``g`` to completion, journaled and guarded.

        ``launch(a, b, B)`` must return matrix rows [a, b) of the group's
        column block (the engines' launch closures); ``members`` are the
        target columns the block lands in. Already-done rows (a resumed
        journal) are skipped; each landed tile commits rows + done-mask,
        beats the heartbeat, snapshots on cadence, and polls the
        preemption guard. An out-of-memory error (``is_oom_error``)
        triggers the halve-B ladder (``oom_retries`` rungs, logged in the
        run report) before propagating.
        """
        cols = np.asarray(members)
        done = self.state.done[g]
        Nl = self.shape[0]
        B = max(1, min(int(B), Nl))
        attempts = 0
        cadence = self.checkpoint_every

        def commit(a, b, block):
            self.state.rho[a:b, cols] = block
            done[a:b] = True
            self._tiles += 1
            self._since_snapshot += 1
            telemetry.counter("edm_tiles_committed").inc()
            telemetry.event("tile.commit", group=g, a=a, b=b,
                            rows_done=self.state.rows_done)
            failed = None
            try:
                if self.writes:
                    self.heartbeat.beat(self.state.rows_done)
                # auto cadence: ~8 snapshots per group — bounds journal
                # I/O to a few % of engine time on many-tile runs while a
                # preemption still snapshots immediately (below); only a
                # hard crash redoes up to cadence − 1 tiles.
                every = cadence or max(1, -(-(-(-Nl // B)) // 8))
                if self._since_snapshot >= every:
                    self._snapshot()
            except Exception as e:  # noqa: BLE001 — re-raised after agreeing
                failed = e
            if self._stop_requested(failed):
                self._preempt()

        while True:
            todo = np.nonzero(~done)[0]
            if len(todo) == 0:
                return
            start = int(todo[0])  # commits are in order: ~done is a suffix
            try:
                drive_batched(Nl, B, launch, start=start, on_block=commit,
                              monitor=self.monitor)
                return
            except Exception as e:  # noqa: BLE001 — filtered to OOM below
                if not is_oom_error(e):
                    if "out of memory" in str(e).lower():
                        # Mentions memory but fails the anchored match:
                        # propagate unretried, with a trail entry so the
                        # report explains why no backoff was attempted.
                        self.oom_trail.append(
                            {"group": g, "B": B, "action": "unclassified",
                             "error": str(e)[:200]})
                        self.write_report()
                    raise
                if attempts >= self.oom_retries or B <= 1:
                    self.oom_trail.append(
                        {"group": g, "B": B, "action": "give_up",
                         "attempt": attempts, "error": str(e)[:200]})
                    self.write_report()
                    raise
                error = str(e)[:200]
            # Leaving the handler dropped ``e``, and with its traceback the
            # frames that held the in-flight tile's and the failed launch's
            # device tensors: the next rung starts with that memory free.
            remaining = Nl - int(np.nonzero(~done)[0][0])
            newB = halved_batch(B, remaining)
            self.oom_trail.append(
                {"group": g, "B": B, "to_B": newB, "action": "halve",
                 "attempt": attempts, "rows_remaining": remaining,
                 "error": error})
            telemetry.counter("edm_oom_backoffs").inc()
            telemetry.event("oom.backoff", group=g, B=B, to_B=newB,
                            rows_remaining=remaining)
            attempts += 1
            B = newB

    def _preempt(self):
        """Commit the journal and exit PREEMPTED_EXIT (restart-loop ABI)."""
        self._status = "preempted"
        self._snapshot(report=False)
        self._write_manifest()
        self.write_report()
        telemetry.counter("edm_runs_preempted").inc()
        telemetry.event("run.preempt", run_id=self.run_id,
                        rows_done=self.state.rows_done)
        self.close()
        raise SystemExit(PREEMPTED_EXIT)

    def finalize(self) -> np.ndarray:
        """Final snapshot + report; marks the manifest complete."""
        if not self.state.complete:
            raise RuntimeError(
                f"finalize() with {int((~self.state.done).sum())} rows "
                f"not driven — a tile group was skipped")
        self._status = "complete"
        self._snapshot(report=False)
        self._write_manifest()
        self.write_report()
        telemetry.event("run.complete", run_id=self.run_id,
                        rows_done=self.state.rows_done,
                        tiles=self._tiles)
        self.close()
        return self.state.rho

    # ------------------------------------------------------------- report

    def write_report(self) -> dict:
        if not self.writes:
            return {}
        rows_total = int(self.state.done.size)
        elapsed = time.monotonic() - self._t0
        pairs_done = self._pairs_done()
        pairs_this = pairs_done - self._pairs_resumed
        prior_elapsed = sum(a.get("elapsed_s") or 0.0
                            for a in self.prior_attempts)
        report = {
            "key": self.key,
            "status": self._status,
            "run_id": self.run_id,
            "prior_run_ids": [a.get("run_id")
                              for a in self.prior_attempts],
            "rows_done": self.state.rows_done,
            "rows_total": rows_total,
            "rows_resumed": self.resumed_rows,
            "rows_this_attempt": self.state.rows_done - self.resumed_rows,
            "tiles_committed": self._tiles,
            "pairs_done": pairs_done,
            # this-attempt throughput and monotonic durations: elapsed_s
            # is THIS attempt's monotonic clock; cumulative_elapsed_s
            # adds every prior attempt's recorded duration so the
            # inspector can show cumulative vs this-attempt progress.
            "pairs_per_s": (round(pairs_this / elapsed, 3)
                            if elapsed > 0 else None),
            "tiles_per_s": (round(self._tiles / elapsed, 3)
                            if elapsed > 0 else None),
            "elapsed_s": round(elapsed, 3),
            "cumulative_elapsed_s": round(prior_elapsed + elapsed, 3),
            "stragglers": self.monitor.report(),
            "oom_backoff": self.oom_trail,
            "invalid_series": self.invalid_series,
            # the whole process-local metrics registry, Prometheus text
            # exposition format (edm_pairs_total, the per-launch latency
            # histogram, cache/run counters, ...)
            "metrics_prom": telemetry.render_prom(),
        }
        tmp = os.path.join(self.dir, "report.json.tmp")
        with open(tmp, "w") as f:
            json.dump(report, f, indent=1)
        os.replace(tmp, os.path.join(self.dir, "report.json"))
        return report
