"""The LM substrate served on a mesh, constraints, and elastic restore.

* ``ServeEngine.generate`` on a (1, 2) gloo mesh (the model drawn leaf by
  leaf by ``carry.place_params``, sequence-parallel decode on) returns the
  same tokens as the same engine without a mesh, greedy and sampled, for
  llama3-8b's and deepseek-v2-lite's smoke configs (the latter through
  the expert-parallel MoE); every placed block is bit-equal to its slice
  of the world of one's weights.
* ``forward_train`` and ``prefill`` on (1, 2) and (2, 1) meshes give the
  no-mesh logits (float32, the partial sums' order).
* ``constrain`` is the identity without a mesh; on a mesh it places an
  activation by the reference's spec, held against the output sharding
  of the reference's ``constrain`` compiled on 2 host devices.
* The port's version of ``tests/test_substrates.py``'s elastic reshard:
  ``CheckpointManager.restore(shardings=)`` onto a (1,) and a (2,) mesh,
  and a checkpoint of the world of one's model restored into a placed
  model; every rank's blocks are bit-equal to slices of the saved leaves.
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.checkpoint import CheckpointManager
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.sharding import NamedSharding, P
from repro_torch.models import meshctx
from torch_mesh import load_tree, run_reference, run_world
from torch_threads import one_torch_thread  # noqa: F401

WORLD = 2
ARCHS = ("llama3-8b", "deepseek-v2-lite-16b")
# (mesh shape, activation shape, logical dims)
CONSTRAIN = (((1, 2), (4, 3, 8), ("dp", None, "model")),
             ((1, 2), (4, 3, 7), ("dp", None, "model")),
             ((2, 1), (4, 6), ("dp", "model")),
             ((2, 1), (3, 6), ("dp", None)))

REFERENCE = """
import jax, jax.numpy as jnp, numpy as np
from repro.launch.mesh import make_test_mesh
from repro.models import meshctx
from torch_mesh import save_tree

out = {}
for i, (mshape, shape, logical) in enumerate(%r):
    mesh = make_test_mesh(mshape, ("data", "model"))
    with meshctx.use_mesh(mesh):
        y = jax.jit(lambda x: meshctx.constrain(x, *logical))(
            jnp.zeros(shape, jnp.float32))
    spec = list(y.sharding.spec) + [None] * (len(shape) - len(
        y.sharding.spec))
    out[str(i)] = np.array([str(s) for s in spec])
save_tree(OUT / "ref.npz", out)
""" % (CONSTRAIN,)

PORT = """
import numpy as np
from torch.distributed.tensor import Replicate
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.launch.sharding import NamedSharding, P
from repro_torch.models import carry, meshctx
from repro_torch.models import transformer as tf
from repro_torch.serving.engine import ServeEngine
from torch_mesh import save_tree

meshes = {(1, 2): make_test_mesh((1, 2), ("data", "model"),
                                 device_type="cpu"),
          (2, 1): make_test_mesh((2, 1), ("data", "model"),
                                 device_type="cpu")}
prompts = [[3, 5, 7], [11, 2, 9, 4, 1, 8, 6, 10, 12], [1, 2, 3, 4, 5],
           [7, 7]]
out = {}
for arch in %r:
    cfg = get_config(arch, smoke=True)
    model = tf.init_params(cfg, device="cpu")
    mesh = meshes[(1, 2)]
    placed = carry.place_params(cfg, mesh, device="cpu")
    whole = dict(model.named_parameters())
    same = all(torch.equal(t.to_local(), meshctx.local_slice(
        whole[n].detach(), mesh, t.placements))
        for n, t in placed.named_parameters())
    for kw, name in ((dict(), "greedy"),
                     (dict(temperature=0.8, seed=3), "sampled")):
        plain = ServeEngine(cfg, model, s_max=32).generate(
            prompts, max_new=8, **kw)
        with meshctx.use_mesh(mesh):
            meshctx.set_seqpar_decode(True)
            on = ServeEngine(cfg, placed, s_max=32).generate(
                prompts, max_new=8, **kw)
            meshctx.set_seqpar_decode(False)
        out[f"{arch}/{name}/plain"] = np.array(
            [t + [-1] * (20 - len(t)) for t in plain.tokens])
        out[f"{arch}/{name}/mesh"] = np.array(
            [t + [-1] * (20 - len(t)) for t in on.tokens])
    out[f"{arch}/blocks_equal"] = np.array(same)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (4, 8),
                                     generator=torch.Generator().manual_seed(5))}
    with torch.no_grad():
        out[f"{arch}/forward/plain"] = tf.forward_train(model, cfg,
                                                        batch)[0].numpy()
        out[f"{arch}/prefill/plain"] = tf.prefill(model, cfg, batch)[0].numpy()
        for mshape, m in meshes.items():
            tag = "x".join(map(str, mshape))
            pm = carry.place_params(cfg, m, model)
            with meshctx.use_mesh(m):
                out[f"{arch}/forward/{tag}"] = tf.forward_train(
                    pm, cfg, batch)[0].numpy()
                out[f"{arch}/prefill/{tag}"] = tf.prefill(
                    pm, cfg, batch)[0].numpy()

for i, (mshape, shape, logical) in enumerate(%r):
    mesh = meshes[tuple(mshape)]
    x = torch.arange(float(np.prod(shape))).reshape(shape)
    with meshctx.use_mesh(mesh):
        y = meshctx.constrain(meshctx.place(x, mesh, [Replicate()] * 2),
                              *logical)
    out[f"constrain/{i}"] = np.array([str(p) for p in y.placements])
    out[f"constrain_equal/{i}"] = np.array(torch.equal(
        y.to_local(), meshctx.local_slice(x, mesh, y.placements)))

# elastic restore: a checkpoint of the world of one's model, saved once
cfg = get_config("llama3-8b", smoke=True)
model = tf.init_params(cfg, device="cpu")
mgr = CheckpointManager(str(OUT / "ckpt"))
if RANK == 0:
    mgr.save(1, {"model": model, "a": torch.arange(24.0).reshape(6, 4)})
dist.barrier()
mesh2 = meshes[(2, 1)]
placed = carry.place_params(cfg, meshes[(1, 2)], device="cpu",
                            generator=torch.Generator().manual_seed(7))
like = {"model": placed, "a": torch.zeros(6, 4)}
sh = {"model": {n: None for n, _ in placed.named_parameters()},
      "a": NamedSharding(mesh2, P("data"))}
got = mgr.restore(like, shardings=sh)
whole = dict(model.named_parameters())
out["restore/model"] = np.array(all(
    torch.equal(t.to_local(), meshctx.local_slice(
        whole[n].detach(), t.device_mesh, t.placements))
    for n, t in got["model"].named_parameters()))
out["restore/a"] = got["a"].to_local().numpy()
out["restore/a_placements"] = np.array([str(p) for p in got["a"].placements])
save_tree(OUT / f"port{RANK}.npz", out)
""" % (ARCHS, CONSTRAIN)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("mesh_serve")
    run_reference(REFERENCE, WORLD, d)
    run_world(PORT, WORLD, d)
    return (load_tree(d / "ref.npz"),
            [load_tree(d / f"port{r}.npz") for r in range(WORLD)])


@pytest.mark.parametrize("sampling", ("greedy", "sampled"))
@pytest.mark.parametrize("arch", ARCHS)
def test_generate_on_a_mesh_equals_no_mesh(runs, arch, sampling):
    _, port = runs
    for r in range(WORLD):
        got = port[r][arch][sampling]
        np.testing.assert_array_equal(got["mesh"], got["plain"])


@pytest.mark.parametrize("entry", ("forward", "prefill"))
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_prefill_on_a_mesh_equal_no_mesh(runs, arch, entry):
    """Batch over "data" on (2, 1), tensor and expert parallel on (1, 2);
    float32, |Δ| ≤ 2e-5 + 2e-5·|ref| (the partial sums' order)."""
    _, port = runs
    for r in range(WORLD):
        got = port[r][arch][entry]
        for tag in ("1x2", "2x1"):
            np.testing.assert_allclose(got[tag], got["plain"], rtol=2e-5,
                                       atol=2e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_drawn_blocks_equal_the_world_of_one(runs, arch):
    _, port = runs
    assert all(bool(port[r][arch]["blocks_equal"]) for r in range(WORLD))


def test_constrain_is_the_identity_without_a_mesh():
    x = torch.ones(4, 3)
    assert meshctx.get_mesh() is None
    assert meshctx.constrain(x, "dp", "model") is x


def _placements_of(spec: list, mshape) -> list:
    """The reference's spec entries as the port's placements' strings on
    a ("data", "model") mesh; a mesh dim of size 1 as "R" (XLA drops a
    size-1 axis from a compiled spec: the layout is the same)."""
    out = []
    for axis, size in zip(("data", "model"), mshape):
        dim = next((d for d, s in enumerate(spec) if axis in s), None)
        out.append("R" if dim is None or size == 1 else f"S({dim})")
    return out


@pytest.mark.parametrize("case", range(len(CONSTRAIN)))
def test_constrain_places_by_the_reference_spec(runs, case):
    ref, port = runs
    mshape = CONSTRAIN[case][0]
    want = _placements_of([str(s) for s in ref[str(case)]], mshape)
    for r in range(WORLD):
        got = [p if n > 1 else "R" for p, n in
               zip(port[r]["constrain"][str(case)], mshape)]
        assert got == want
        assert bool(port[r]["constrain_equal"][str(case)])


def test_restore_onto_a_mesh_of_two(runs):
    _, port = runs
    a = np.arange(24.0).reshape(6, 4)
    for r in range(WORLD):
        assert bool(port[r]["restore"]["model"])
        assert list(port[r]["restore"]["a_placements"]) == ["S(0)", "R"]
        np.testing.assert_array_equal(port[r]["restore"]["a"],
                                      a[3 * r:3 * r + 3])


def test_restore_onto_a_mesh_of_one(tmp_path):
    """``tests/test_substrates.py::test_checkpoint_elastic_reshard`` in a
    world of one (gloo, in this process)."""
    mgr = CheckpointManager(str(tmp_path))
    state = {"a": torch.arange(12.0).reshape(4, 3), "b": torch.ones(2)}
    mgr.save(1, state)
    mesh = make_mesh((1,), ("data",), device_type="cpu")
    try:
        sh = {k: NamedSharding(mesh, P("data")) for k in state}
        got = mgr.restore(state, shardings=sh)
        assert [str(p) for p in got["a"].placements] == ["S(0)"]
        for k in state:
            assert got[k].device_mesh is mesh
            assert torch.equal(got[k].to_local(), state[k])
        with pytest.raises(ValueError, match="structure"):
            mgr.restore(state, shardings={"a": sh["a"]})
    finally:
        dist.destroy_process_group()
