"""The port's training loop (``repro_torch.training.train``) and launcher
(``python -m repro_torch.launch.train``) on the CPU: the six loop tests of
``tests/test_train_loop.py`` (convergence, restart continuity — here bit
for bit —, preemption, microbatching, int8-compressed and 8-bit-Adam
training) on the reference tests' tiny config, the checkpoint of a
parameter module by name, a SIGTERM'd child process, and the launcher."""

import dataclasses
import os
import signal
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import TrainConfig, get_config
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.launch import train as launcher
from repro_torch.training import make_train_step, train
from torch_world import ROOT
from torch_threads import one_torch_thread  # noqa: F401


def _tiny():
    cfg = dataclasses.replace(
        get_config("llama3-8b", smoke=True), vocab_size=64)
    tcfg = TrainConfig(learning_rate=3e-3, warmup_steps=5, total_steps=60,
                       weight_decay=0.01, seed=0)
    pipe = TokenPipeline(vocab_size=cfg.vocab_size, batch=4, seq_len=32,
                         seed=1)
    return cfg, tcfg, pipe


def _run(cfg, tcfg, pipe, workdir, num_steps, **kw):
    kw = dict(dict(ckpt_every=100, verbose=False, handle_preemption=False,
                   device="cpu"), **kw)
    return train(cfg, tcfg, pipe, workdir=str(workdir), num_steps=num_steps,
                 **kw)


def _learns(hist, what):
    first = np.mean([h["loss"] for h in hist[:5]])
    last = np.mean([h["loss"] for h in hist[-5:]])
    assert last < first - 0.2, f"{what}: {first:.3f} → {last:.3f}"


def test_loss_decreases(tmp_path):
    cfg, tcfg, pipe = _tiny()
    _, hist = _run(cfg, tcfg, pipe, tmp_path, 40)
    assert [h["step"] for h in hist] == list(range(40))
    assert hist[0]["lr"] == 0.0  # warmup: step 0 reads a rate of 0
    _learns(hist, "no learning")


def test_checkpoint_restart_continuity(tmp_path):
    """Stop at step 20, restart, and land bit-equal to an unbroken run
    (the data a pure function of (seed, step); the state, step count,
    moments included, restored losslessly). The reference's test holds
    rtol 1e-5, atol 1e-6; on one CPU the port is exact."""
    cfg, tcfg, pipe = _tiny()
    state_a, hist_a = _run(cfg, tcfg, pipe, tmp_path / "a", 30)
    _run(cfg, tcfg, pipe, tmp_path / "b", 20, ckpt_every=10)
    state_b, hist_b = _run(cfg, tcfg, pipe, tmp_path / "b", 30,
                           ckpt_every=10)
    assert [h["step"] for h in hist_b] == list(range(20, 30))
    assert [h["loss"] for h in hist_b] == [h["loss"] for h in hist_a[20:]]
    for (n, pa), (_, pb) in zip(state_a["params"].named_parameters(),
                                state_b["params"].named_parameters()):
        np.testing.assert_allclose(pa.detach().numpy(), pb.detach().numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=n)
        assert torch.equal(pa, pb), n
    assert int(state_b["opt"]["step"]) == 30
    for k in ("m", "v"):
        for n, t in state_a["opt"][k].items():
            assert torch.equal(t, state_b["opt"][k][n]), (k, n)


def test_preemption_checkpoint_and_clean_exit(tmp_path):
    cfg, tcfg, pipe = _tiny()

    class Boom:
        def __init__(self):
            self.n = 0

        def global_batch(self, step):
            self.n += 1
            if self.n == 5:
                os.kill(os.getpid(), signal.SIGTERM)  # simulate preemption
            return pipe.global_batch(step)

    _, hist = _run(cfg, tcfg, Boom(), tmp_path, 50, handle_preemption=True)
    assert len(hist) <= 6, "loop must stop quickly after SIGTERM"
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    assert mgr.latest_step() is not None, "preemption must checkpoint"
    assert signal.getsignal(signal.SIGTERM) is not None


def test_microbatch_equivalence():
    """grad-accumulated step == single-batch step (same loss, ~same
    params)."""
    cfg, _, pipe = _tiny()
    batch = {k: torch.as_tensor(v) for k, v in pipe.global_batch(0).items()}
    outs = {}
    for micro in (0, 2):
        tcfg = TrainConfig(learning_rate=1e-3, warmup_steps=0,
                           total_steps=10, microbatch=micro, seed=0)
        init_state, step, _ = make_train_step(cfg, tcfg)
        state = init_state(torch.Generator().manual_seed(0))
        state, metrics = step(state, batch)
        outs[micro] = (float(metrics["loss"]), state["params"])
    np.testing.assert_allclose(outs[0][0], outs[2][0], rtol=1e-4)
    for (n, a), (_, b) in zip(outs[0][1].named_parameters(),
                              outs[2][1].named_parameters()):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   rtol=1e-3, atol=1e-5, err_msg=n)


def test_compressed_training_converges(tmp_path):
    cfg, tcfg, pipe = _tiny()
    tcfg = dataclasses.replace(tcfg, grad_compression="int8")
    state, hist = _run(cfg, tcfg, pipe, tmp_path, 40)
    assert set(state["ebuf"]) == {n for n, _ in
                                  state["params"].named_parameters()}
    _learns(hist, "int8-EF training broken")


def test_adamw8bit_training_converges(tmp_path):
    cfg, tcfg, pipe = _tiny()
    tcfg = dataclasses.replace(tcfg, optimizer="adamw8bit")
    _, hist = _run(cfg, tcfg, pipe, tmp_path, 40)
    _learns(hist, "8-bit Adam training broken")


def test_checkpoint_saves_a_module_by_name_and_restores_in_place(tmp_path):
    cfg, tcfg, _ = _tiny()
    init, _, _ = make_train_step(cfg, dataclasses.replace(
        tcfg, optimizer="adamw8bit"))
    a = init(torch.Generator().manual_seed(1))
    b = init(torch.Generator().manual_seed(2))
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(3, a)
    module = b["params"]
    out = mgr.restore(b)
    assert out["params"] is module  # written back in place
    for (n, x), (_, y) in zip(a["params"].named_parameters(),
                              module.named_parameters()):
        assert torch.equal(x, y), n
    # the manifest names the parameters, not one opaque leaf
    with open(os.path.join(mgr._step_dir(3), "manifest.json")) as f:
        assert "'embed.table'" in f.read()
    # a module of another model is refused
    other = make_train_step(dataclasses.replace(cfg, n_layers=4), tcfg)[0](
        torch.Generator().manual_seed(0))
    with pytest.raises(ValueError):
        mgr.restore(other)


CHILD = r"""
import dataclasses, sys
from repro_torch.configs import TrainConfig, get_config
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.training import train
cfg = dataclasses.replace(get_config("llama3-8b", smoke=True), vocab_size=64)
tcfg = TrainConfig(learning_rate=3e-3, warmup_steps=5, total_steps=60,
                   weight_decay=0.01, seed=0)
pipe = TokenPipeline(vocab_size=64, batch=4, seq_len=32, seed=1)

class Slow:
    def global_batch(self, step):
        print(f"BATCH {step}", flush=True)
        if step == 3:
            sys.stdin.readline()  # wait for the parent's SIGTERM
        return pipe.global_batch(step)

_, hist = train(cfg, tcfg, Slow(), workdir=sys.argv[1], num_steps=50,
                ckpt_every=100, verbose=True, device="cpu")
print(f"DONE {len(hist)}", flush=True)
"""


def test_sigterm_child_exits_cleanly_with_a_checkpoint(tmp_path):
    """A child process sent SIGTERM after its fourth batch finishes that
    step, checkpoints and exits 0; a restart resumes after it."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    p = subprocess.Popen([sys.executable, "-c", CHILD, str(tmp_path)],
                         stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                         stderr=subprocess.PIPE, text=True, env=env)
    lines = []
    for line in p.stdout:
        lines.append(line)
        if line.startswith("BATCH 3"):
            break
    p.send_signal(signal.SIGTERM)
    out, err = p.communicate(input="\n", timeout=120)
    assert p.returncode == 0, err
    assert "DONE 4" in out and "checkpointed at 4" in out, out
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    assert mgr.latest_step() == 4


def test_launcher_runs_on_the_cpu(tmp_path, capsys):
    hist = launcher.main(["--arch", "llama3-8b", "--steps", "6", "--device",
                          "cpu", "--workdir", str(tmp_path),
                          "--optimizer", "adamw8bit"])
    assert len(hist) == 6
    assert CheckpointManager(str(tmp_path / "ckpt")).latest_step() == 6
    assert "device=cpu" in capsys.readouterr().out
    # again: resumes at step 6 and has nothing left to run
    assert launcher.main(["--arch", "llama3-8b", "--steps", "6", "--device",
                          "cpu", "--workdir", str(tmp_path)]) == []


def test_launcher_runs_an_embeds_arch(tmp_path):
    hist = launcher.main(["--arch", "hubert-xlarge", "--steps", "2",
                          "--batch", "2", "--seq", "16", "--device", "cpu",
                          "--workdir", str(tmp_path)])
    assert len(hist) == 2 and np.isfinite(hist[-1]["loss"])


def test_launcher_and_loop_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        launcher.main(["--arch", "llama3-8b", "--steps", "1"])
    cfg, tcfg, pipe = _tiny()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train(cfg, tcfg, pipe, workdir="unused", num_steps=1)
