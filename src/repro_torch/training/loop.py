"""Fault-tolerant training loop (the port of ``repro.training.loop``).

Restart-safe by construction: state lives in CheckpointManager (atomic,
retained; the parameter module saved by name and restored into itself in
place), data is a pure function of (seed, step), and the loop always
resumes from ``latest_step()``. SIGTERM triggers checkpoint-and-exit
(preemption); per-step wall times feed the straggler monitor; heartbeats
let an external watchdog detect hangs.
"""

from __future__ import annotations

import os

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.distributed.fault import (Heartbeat, PreemptionGuard,
                                           StragglerMonitor)
from repro_torch.edm.dataset import resolve_device
from repro_torch.training.step import make_train_step


def train(
    cfg,
    tcfg,
    pipeline,
    *,
    workdir: str,
    num_steps: int,
    ckpt_every: int = 50,
    log_every: int = 10,
    resume: bool = True,
    handle_preemption: bool = True,
    donate: bool = True,
    verbose: bool = True,
    device="cuda",
):
    """Run (or resume) a training job on ``device`` (the card by default;
    raises without CUDA). Returns (state, history list). ``donate`` is
    accepted for the reference's signature: the step updates the state in
    place anyway."""
    del donate
    dev = resolve_device(device, "train")
    init_state, train_step, _ = make_train_step(cfg, tcfg)
    manager = CheckpointManager(os.path.join(workdir, "ckpt"), keep=3)
    monitor = StragglerMonitor()
    heartbeat = Heartbeat(os.path.join(workdir, "heartbeat.csv"))
    guard = PreemptionGuard() if handle_preemption else None

    start = 0
    state = init_state(torch.Generator(device=dev).manual_seed(tcfg.seed))
    if resume and manager.latest_step() is not None:
        start = manager.latest_step()
        state = manager.restore(state)
        if verbose:
            print(f"[loop] resumed from step {start}")

    history = []
    preempted = False
    for step in range(start, num_steps):
        batch = {k: torch.as_tensor(v, device=dev)
                 for k, v in pipeline.global_batch(step).items()}
        monitor.start()
        state, metrics = train_step(state, batch)
        metrics = {k: float(v) for k, v in metrics.items()}
        straggler = monitor.stop(step)
        heartbeat.beat(step)
        metrics.update(step=step, straggler=straggler)
        history.append(metrics)
        if verbose and (step % log_every == 0 or step == num_steps - 1):
            print(f"[loop] step {step} loss {metrics['loss']:.4f} "
                  f"gnorm {metrics['grad_norm']:.3f} lr {metrics['lr']:.2e}"
                  + (" STRAGGLER" if straggler else ""))
        if (step + 1) % ckpt_every == 0:
            manager.save(step + 1, state)
        if guard is not None and guard.requested:
            manager.save(step + 1, state)
            preempted = True
            if verbose:
                print(f"[loop] preemption: checkpointed at {step + 1}, "
                      "exiting cleanly")
            break

    if not preempted:
        manager.save(num_steps, state)
    if guard is not None:
        guard.restore()
    if monitor.flagged and verbose:
        print(f"[loop] {len(monitor.flagged)} straggler steps flagged: "
              f"{[(s, round(t, 3)) for s, t, _ in monitor.flagged[:5]]}")
    return state, history
