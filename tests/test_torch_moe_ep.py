"""Port vs reference: the expert-parallel MoE branch on a (2, 2) mesh.

The reference runs ``moe_apply`` under ``use_mesh`` in one JAX subprocess
with 4 host devices on a (2, 2) ("data", "model") mesh; the port runs 4
gloo ranks on a (2, 2) ``DeviceMesh`` with the reference's weights carried
and placed by ``param_spec``. Configs: deepseek-v2-lite's and
llama4-maverick's smoke configs, B = 4 (divisible by dp = 2, so routing
and capacity are per dp group: the mesh result may differ from the
no-mesh one by design). A config with 3 experts (which "model" = 2 does
not divide) takes the no-mesh branch in both packages.

The reference's expert-parallel branch has a fault (ROADMAP §3, reference
caveats): it shifts the sorted expert ids into local range and relies on
out-of-bounds scatter/gather to drop the rows of other shards' experts,
but JAX wraps negative indices, so on every model shard above 0 the rows
of lower shards' experts are computed by the wrong local experts and
added in. The port drops them, as the reference's docstring says. So the
port's expert-parallel result is held against the reference's own
``_moe_local`` run per dp group without a mesh (its expert-parallel
semantics: routing and capacity per dp group, ``aux`` averaged over the
groups), and the reference's mesh result is only shown to differ from
that. A whole smoke model's decode runs four steps on the mesh in the
port and is held against the reference's decode without a mesh: one token
a row per step stays under every capacity, so per-group and whole-batch
routing agree there.

Tolerance: float32, the sum over "model" reordering the expert outputs'
additions: |Δ| ≤ 2e-5 + 2e-5·|ref| (``torch_lm.RTOL``/``ATOL``).
"""

import numpy as np
import pytest

from torch_mesh import load_tree, run_reference, run_world
from torch_threads import one_torch_thread  # noqa: F401

TOL = dict(rtol=2e-5, atol=2e-5)
WORLD = 4
ARCHS = ("deepseek-v2-lite-16b", "llama4-maverick-400b-a17b")
CASES = ("ep", "nomesh", "odd")

REFERENCE = """
import dataclasses
import numpy as np, jax, jax.numpy as jnp
from repro.configs import get_config
from repro.launch.mesh import make_test_mesh
from repro.models import meshctx
from repro.models import transformer as tf
from repro.models.moe import _moe_local, moe_apply
from torch_mesh import save_tree

mesh = make_test_mesh((2, 2), ("data", "model"))
out = {}
for arch in %r:
    cfg = get_config(arch, smoke=True)
    odd = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                          num_experts=3))
    i = next(j for j, k in enumerate(cfg.pattern) if k.endswith("_moe"))
    x = np.random.default_rng(1).normal(
        size=(4, 8, cfg.d_model)).astype(np.float32)
    toks = np.random.default_rng(2).integers(
        0, cfg.vocab_size, (4, 4)).astype(np.int32)
    for case, c in (("ep", cfg), ("nomesh", cfg), ("odd", odd)):
        params = tf.init_params(c, jax.random.key(0))
        p = jax.tree.map(lambda a: a[0], params["units"])[f"l{i}"]["mlp"]
        with meshctx.use_mesh(None if case == "nomesh" else mesh):
            y, aux = jax.jit(lambda p, x: moe_apply(p, c, x))(p, x)
        out[f"{arch}/{case}"] = {"params": jax.tree.map(np.asarray, params),
                                 "y": np.asarray(y), "aux": np.asarray(aux)}
        if case == "ep":  # its semantics: the local block per dp group
            m = c.moe
            dt = x.dtype
            parts = [_moe_local(
                jnp.asarray(x[g * 2:(g + 1) * 2]), p["router"],
                p["w_gate"].astype(dt), p["w_up"].astype(dt),
                p["w_down"].astype(dt), 0, k=m.top_k, E=m.num_experts,
                cf=m.capacity_factor, dp_names=()) for g in range(2)]
            y = jnp.concatenate([a for a, _ in parts])
            if m.num_shared:
                from repro.models.layers import mlp
                y = y + mlp(p["shared"], jnp.asarray(x), "swiglu")
            out[f"{arch}/oracle"] = {
                "y": np.asarray(y),
                "aux": np.asarray(sum(b for _, b in parts) / 2)}
    with meshctx.use_mesh(None):
        step = jax.jit(lambda p, t, ca, pos: tf.decode_step(p, cfg, t, ca,
                                                            pos))
        cache = tf.init_cache(cfg, 4, 8)
        logits = []
        for t in range(4):
            lg, cache = step(out[f"{arch}/ep"]["params"],
                             jnp.asarray(toks[:, t:t + 1]), cache,
                             jnp.int32(t))
            logits.append(np.asarray(lg))
    out[f"{arch}/decode"] = {"logits": np.stack(logits), "x": x,
                             "toks": toks}
save_tree(OUT / "ref.npz", out)
""" % (ARCHS,)

PORT = """
import dataclasses
import numpy as np
from repro_torch.configs import get_config
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models import carry, meshctx
from repro_torch.models import transformer as tf
from repro_torch.models.moe import moe_apply
from torch_mesh import load_tree, save_tree

mesh = make_test_mesh((2, 2), ("data", "model"), device_type="cpu")
out = {}
for arch in %r:
    cfg = get_config(arch, smoke=True)
    odd = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                          num_experts=3))
    i = next(j for j, k in enumerate(cfg.pattern) if k.endswith("_moe"))
    ref = load_tree(OUT / "ref.npz", arch)
    x = torch.from_numpy(ref["decode"]["x"])
    toks = torch.from_numpy(ref["decode"]["toks"])
    for case, c in (("ep", cfg), ("nomesh", cfg), ("odd", odd)):
        model = carry.params_from_numpy(c, ref[case]["params"], device="cpu")
        on = None if case == "nomesh" else mesh
        m = model if on is None else carry.place_params(c, mesh, model)
        p = m.units[0][f"l{i}"]["mlp"]
        with torch.no_grad(), meshctx.use_mesh(on):
            rows = x if on is None else meshctx.activation(x).to_local()
            y, aux = moe_apply(p, c, rows)
            y = meshctx.batch_all(y)
        out[f"{arch}/{case}"] = {"y": y.numpy(), "aux": aux.numpy(),
                                 "rows": np.array(rows.shape[0])}
    placed = carry.place_params(cfg, mesh, carry.params_from_numpy(
        cfg, ref["ep"]["params"], device="cpu"))
    with torch.no_grad(), meshctx.use_mesh(mesh):
        cache = tf.init_cache(cfg, 4, 8, device="cpu", mesh=mesh)
        logits = [tf.decode_step(placed, cfg, toks[:, t:t + 1], cache, t)[0]
                  for t in range(4)]
    out[f"{arch}/decode"] = {"logits": torch.stack(logits).numpy()}
save_tree(OUT / f"port{RANK}.npz", out)
""" % (ARCHS,)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("moe_ep")
    run_reference(REFERENCE, WORLD, d)
    run_world(PORT, WORLD, d)
    return (load_tree(d / "ref.npz"),
            [load_tree(d / f"port{r}.npz") for r in range(WORLD)])


ORACLE = {"ep": "oracle", "nomesh": "nomesh", "odd": "odd"}


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_equals_reference(runs, arch, case):
    ref, port = runs
    want = ref[arch][ORACLE[case]]
    for r in range(WORLD):
        got = port[r][arch][case]
        np.testing.assert_allclose(got["y"], want["y"], **TOL)
        np.testing.assert_allclose(got["aux"], want["aux"], **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_reference_mesh_branch_differs_from_its_own_semantics(runs, arch):
    """The reference caveat: its shard_map branch adds wrapped rows (aux,
    computed from the routing alone, is right)."""
    ref, _ = runs
    assert np.abs(ref[arch]["ep"]["y"] - ref[arch]["oracle"]["y"]).max() > 0.1
    np.testing.assert_allclose(ref[arch]["ep"]["aux"],
                               ref[arch]["oracle"]["aux"], **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_routing_is_per_dp_group(runs, arch):
    """Each rank's activation holds its dp group's 2 of the 4 rows, which
    the expert-parallel branch routes alone."""
    _, port = runs
    for r in range(WORLD):
        assert int(port[r][arch]["ep"]["rows"]) == 2


@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_decode_equals_reference(runs, arch):
    ref, port = runs
    for r in range(WORLD):
        np.testing.assert_allclose(port[r][arch]["decode"]["logits"],
                                   ref[arch]["decode"]["logits"], **TOL)
