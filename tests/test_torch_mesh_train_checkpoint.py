"""A placed train state through ``CheckpointManager``: the port of
``tests/test_substrates.py``'s elastic reshard for a train state.

Four gloo ranks take one ``adamw8bit`` step on a (2, 2) ("data", "model")
mesh (llama3-8b's smoke config widened to d_model 256, d_ff 768, vocab
256, float32 masters: its moments are int8 codes with float32 scales, the
straddling ``w_gate``/``w_up`` scales replicated over "model"), save the
state (every rank gathers, rank 0 writes) and restore it with
``shardings=to_shardings(mesh, state_specs(...))`` onto four ranks over
"model" (a (1, 4) ("data", "model") mesh: the sharding rules, the
reference's too, name the "data" axis); this process restores it onto a (1, 1) mesh (a world of one).
Every rank's block of every leaf (weights, codes, scales, float32 moments,
the step) is bit-equal to its slice of the saved leaf. Float32 and int8
leaves only: bf16 checkpoints fail in both packages (ROADMAP §3).
"""

import numpy as np
import pytest
import torch.distributed as dist

from torch_mesh import load_tree, run_world
from torch_threads import one_torch_thread  # noqa: F401

WORLD = 4
WIDE = dict(d_model=256, d_ff=768, vocab_size=256)

CKPT = """
import dataclasses
import numpy as np
import torch
from repro_torch.checkpoint import CheckpointManager
from repro_torch.checkpoint.manager import _flatten
from repro_torch.configs import TrainConfig, get_config
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.sharding import state_specs, to_shardings
from repro_torch.models import meshctx
from repro_torch.training import make_train_step

WIDE = %r
cfg = dataclasses.replace(get_config("llama3-8b", smoke=True), **WIDE)
tcfg = TrainConfig(optimizer="adamw8bit", learning_rate=1e-3,
                   warmup_steps=0, total_steps=10)
init, step, abstract = make_train_step(cfg, tcfg)


def held(got, ckpt):
    # (every leaf's block bit-equal to its slice of the saved leaf, the
    # placements seen)
    leaves, _ = _flatten(got)
    d = ckpt + "/step_0000000001"
    equal, seen = [], set()
    for i, t in enumerate(leaves):
        saved = torch.from_numpy(np.load(f"{d}/leaf_{i:05d}.npy"))
        equal.append(torch.equal(t.to_local(), meshctx.local_slice(
            saved, t.device_mesh, t.placements)))
        seen.add(str(list(t.placements)))
    return all(equal), len(equal), sorted(seen)


def restore(ckpt, mesh):
    like = abstract()
    return CheckpointManager(ckpt).restore(
        like, shardings=to_shardings(mesh, state_specs(cfg, mesh, like)))
""" % (WIDE,)

PORT = CKPT + """
from torch_mesh import save_tree

mesh = make_mesh((2, 2), ("data", "model"), device_type="cpu")
rng = np.random.default_rng(3)
b = {"tokens": torch.from_numpy(rng.integers(0, 256, (4, 16)))}
ckpt = str(OUT / "ckpt")
with meshctx.use_mesh(mesh):
    state = init(torch.Generator().manual_seed(0))
    state, _ = step(state, b)
    before = [meshctx.full(t.detach()).numpy().copy()
              for t in _flatten(state)[0]]
    CheckpointManager(ckpt).save(1, state)
d = ckpt + "/step_0000000001"
saved_equal = all(np.array_equal(np.load(f"{d}/leaf_{i:05d}.npy"), a)
                  for i, a in enumerate(before))
codes = [a for a in before if a.dtype == np.int8]
equal, n, seen = held(restore(ckpt, make_mesh(
    (1, 4), ("data", "model"), device_type="cpu")), ckpt)
save_tree(OUT / f"port{RANK}.npz", {
    "saved_equal": np.array(saved_equal), "equal": np.array(equal),
    "leaves": np.array(n), "placements": np.array(seen),
    "codes": np.array(len(codes)),
    "codes_nonzero": np.array(all(np.abs(c).max() > 0 for c in codes))})
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("mesh_train_ckpt")
    run_world(PORT, WORLD, d)
    return d, [load_tree(d / f"port{r}.npz") for r in range(WORLD)]


def test_saved_leaves_are_the_placed_state_whole(runs):
    _, port = runs
    for r in range(WORLD):
        assert bool(port[r]["saved_equal"])
        # the widened config's 8-bit moments: m and v of 8 leaves
        assert int(port[r]["codes"]) == 16 and bool(port[r]["codes_nonzero"])


def test_restore_onto_four_ranks_over_model(runs):
    _, port = runs
    for r in range(WORLD):
        assert bool(port[r]["equal"])
        seen = set(port[r]["placements"])
        # sharded leaves (tables, matrices, codes) and replicated ones
        # (norms, the straddling scales, the step) both restored
        # (the placement over "model", the last of each)
        model = {p.rsplit(", ", 1)[-1] for p in seen}
        assert {"Shard(dim=0)]", "Shard(dim=1)]", "Replicate()]"} <= model


def test_restore_onto_a_mesh_of_one(runs):
    d, port = runs
    ns = {}
    exec(CKPT, ns)
    from repro_torch.launch.mesh import make_mesh
    mesh = make_mesh((1, 1), ("data", "model"), device_type="cpu")
    try:
        equal, n, seen = ns["held"](ns["restore"](str(d / "ckpt"), mesh),
                                    str(d / "ckpt"))
        assert equal and n == int(port[0]["leaves"])
    finally:
        dist.destroy_process_group()
