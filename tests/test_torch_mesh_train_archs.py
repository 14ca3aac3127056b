"""The port's train step on a (2, 2) ("data", "model") mesh for each of the
ten smoke archs, held against its own no-mesh step from the same state.

Four gloo ranks draw one state (``init_state`` without a mesh, seed 0),
place it (``training.carry.place_state``) and take one ``adamw`` step
(lr 1e-3 from step 0) on the mesh; the no-mesh step runs from the same
state on the same batch (B 4 × S 16). Held: the metrics, and the gathered
state at ``tests/torch_train.py``'s one-step tolerances.

The MoE archs (deepseek-v2-lite, llama4-maverick, jamba) route per dp group
on the mesh, whole-batch without one, and their ``aux`` is the dp mean of
the groups' aux (the reference's semantics). Their configs take a capacity
factor of 8 (every expert's capacity ≥ its dp group's tokens × top-k: no
token drops in either run), and they run twice: on a batch whose two dp
groups hold the same rows, where the groups' routing and aux are the whole
batch's and everything is held; and on distinct rows, where the
cross-entropy is held (no drop: every token reaches the same experts) and
``aux`` is shown to differ.
"""

import numpy as np
import pytest

from torch_mesh import load_tree, run_world
from torch_threads import one_torch_thread  # noqa: F401

WORLD = 4
ARCHS = ("llama3-8b", "qwen1.5-4b", "deepseek-v2-lite-16b", "jamba-v0.1-52b",
         "xlstm-125m", "hubert-xlarge", "llama4-maverick-400b-a17b",
         "nemotron-4-15b", "yi-6b", "llava-next-mistral-7b")
MOE = ("deepseek-v2-lite-16b", "jamba-v0.1-52b", "llama4-maverick-400b-a17b")
CAPACITY = 8.0
LR = 1e-3

PORT = """
import dataclasses
import numpy as np
from repro_torch.configs import TrainConfig, get_config
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models import meshctx
from repro_torch.training import make_train_step
from repro_torch.training.carry import place_state, state_to_numpy
from torch_mesh import save_tree

ARCHS, MOE, CAPACITY, LR = %r, %r, %r, %r
mesh = make_test_mesh((2, 2), ("data", "model"), device_type="cpu")
tcfg = TrainConfig(learning_rate=LR, warmup_steps=0, total_steps=10)


def batch(cfg, repeat):
    rng = np.random.default_rng(7)
    b = {"labels": rng.integers(0, cfg.vocab_size, (4, 16))}
    if cfg.embed_inputs:
        b["embeds"] = rng.normal(size=(4, 16, cfg.d_model)).astype(np.float32)
    else:
        b["tokens"] = rng.integers(0, cfg.vocab_size, (4, 16))
    if repeat:
        b = {k: np.concatenate([v[:2], v[:2]]) for k, v in b.items()}
    return {k: torch.from_numpy(v) for k, v in b.items()}


out = {}
for arch in ARCHS:
    cfg = get_config(arch, smoke=True)
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=CAPACITY))
    init, step, _ = make_train_step(cfg, tcfg)
    for repeat in ((True, False) if arch in MOE else (False,)):
        b = batch(cfg, repeat)
        state = init(torch.Generator().manual_seed(0))
        with meshctx.use_mesh(mesh):
            placed = place_state(cfg, mesh, state)
            placed, met = step(placed, b)
            got = state_to_numpy(cfg, placed)
        state, plain = step(state, b)
        tag = f"{arch}/{'repeat' if repeat else 'distinct'}"
        out[tag] = {"mesh": got, "plain": state_to_numpy(cfg, state),
                    "metrics": {k: np.asarray(float(v))
                                for k, v in met.items()},
                    "plain_metrics": {k: np.asarray(float(v))
                                      for k, v in plain.items()}}
save_tree(OUT / f"port{RANK}.npz", out)
""" % (ARCHS, MOE, CAPACITY, LR)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("mesh_train_archs")
    run_world(PORT, WORLD, d)
    return [load_tree(d / f"port{r}.npz") for r in range(WORLD)]


def _pcfg(arch):
    import dataclasses

    from repro_torch.configs import get_config
    cfg = get_config(arch, smoke=True)
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=CAPACITY))
    return cfg


def _close(a, b, keys):
    from torch_lm import ATOL, RTOL
    for k in keys:
        assert abs(float(a[k]) - float(b[k])) <= ATOL + RTOL * abs(
            float(b[k])), (k, float(a[k]), float(b[k]))


@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_step_matches_the_no_mesh_step(runs, arch):
    from torch_train import compare
    tag = "repeat" if arch in MOE else "distinct"
    for r in range(WORLD):
        got = runs[r][arch][tag]
        _close(got["metrics"], got["plain_metrics"],
               ("ce", "aux", "loss", "grad_norm", "lr"))
    got = runs[0][arch][tag]
    compare(_pcfg(arch), got["mesh"], got["plain"], steps=1, one_step=True)


@pytest.mark.parametrize("arch", MOE)
def test_moe_on_distinct_rows_keeps_the_cross_entropy(runs, arch):
    """No token drops, so each token meets the same experts: the
    cross-entropy is the no-mesh one; ``aux`` is the mean of the dp
    groups' aux, not the whole batch's."""
    for r in range(WORLD):
        got = runs[r][arch]["distinct"]
        _close(got["metrics"], got["plain_metrics"], ("ce", "lr"))
        assert abs(float(got["metrics"]["aux"])
                   - float(got["plain_metrics"]["aux"])) > 1e-3
