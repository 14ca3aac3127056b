"""The backward rules of the mesh path's collectives (``models.meshctx``),
one test a rule, on four gloo ranks of a (2, 2) ("data", "model") mesh.

Each rank computes its share of a loss Σ f(x)·R over its own rows (the
data-parallel block; the "model" ranks of a dp group compute the same
value), backpropagates, sums the replicated leaves' gradients over "data"
(``optim.grad_utils.sum_over_dp``, as ``take_grads`` does) and gathers
every gradient whole. It is held against ``torch.autograd`` of the same f
computed whole on one rank (float32, |Δ| ≤ 1e-5 + 1e-5·|ref|):

* column-parallel ``dense`` (w over "model" on d_out): the output's
  all-gather backs up as this rank's slice, the input's partial gradient
  is summed over "model" (``meshctx.sum_grad``);
* row-parallel ``dense`` (w over "model" on d_in): the input's slice
  backs up as an all-gather, the output's sum all-reduce as the identity;
* the vocab-parallel ``embed`` (a sum over "model", identity backward) and
  ``unembed_ce`` (the vocab-parallel cross-entropy);
* an FSDP-gathered weight (w over "data"): the all-gather backs up as a
  reduce-scatter over "data";
* a norm replicated over "data": its gradient all-reduced over "data";
* the 8-bit codec's block absmax across ranks (``optim.adamw.codec_cut``).

Each rule is also run with its backward taken the wrong way round
(``meshctx._replicated`` flipped, so that "model" takes the data-parallel
rules and "data" the model ones; ``sum_grad`` or ``sum_over_dp`` made the
identity) on inputs whose rows repeat across the two dp groups: the
gradient is then off by exactly the axis' size (× 2 or × ½), or, for
``sum_grad``, one rank's partial sum, which the test's tolerance refuses.
This checks the test; the wrong rules are not kept anywhere.

The expert-parallel MoE: the port's ``moe_apply`` on the mesh (routing per
dp group, this rank's experts, the sum over "model", ``aux`` the dp mean)
gives input, router, expert-bank and shared-expert gradients held against
``jax.grad`` of the reference's ``_moe_local`` run per dp group without a
mesh (its own semantics; its mesh branch wraps negative expert ids:
ROADMAP §3), within 2e-5 + 2e-5·|ref|, in one JAX subprocess.
"""

import numpy as np
import pytest

from torch_mesh import load_tree, run_reference, run_world
from torch_threads import one_torch_thread  # noqa: F401

WORLD = 4
TOL = dict(rtol=1e-5, atol=1e-5)
MOE_TOL = dict(rtol=2e-5, atol=2e-5)
RULES = ("column", "row", "embed", "unembed_ce", "fsdp", "norm")
# the wrong backward of each rule, and the factor it is off by on rows
# that repeat across the dp groups (None: not a multiple)
WRONG = {"column": ("flip", 2.0), "column_nosum": ("nosum", None),
         "row": ("flip", 2.0), "embed": ("flip", 2.0),
         "unembed_ce": ("flip", 2.0), "fsdp": ("flip", 0.5),
         "norm": ("nodp", 0.5)}
# the 8-bit codec's routes: name → (leaf shape, codes' spec, scale's spec)
CODEC = {"local": ((8, 1024), ("data", "model"), ("data", "model")),
         "straddle": ((8, 768), ("data", "model"), ("data", None)),
         "whole": ((768, 768), ("data", "model"), ("model", None))}
MOE_ARCHS = ("deepseek-v2-lite-16b", "llama4-maverick-400b-a17b")
MOE_AUX_W = 0.01

PORT = """
import contextlib
import numpy as np
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.launch.sharding import P, to_placements
from repro_torch.models import layers, meshctx
from repro_torch.optim import grad_utils
from torch_mesh import save_tree

RULES, WRONG, CODEC = %r, %r, %r
mesh = make_test_mesh((2, 2), ("data", "model"), device_type="cpu")
meshctx.set_mesh(mesh)
B, S, D, F, V = 4, 3, 8, 12, 16


def data(repeat, seed=0):
    rng = np.random.default_rng(seed)
    d = {"x": rng.normal(size=(B, S, D)), "h": rng.normal(size=(B, S, F)),
         "R": rng.normal(size=(B, S, D)), "RF": rng.normal(size=(B, S, F)),
         "R2": rng.normal(size=(B, S)),
         "tok": rng.integers(0, V, (B, S)), "lab": rng.integers(0, V, (B, S)),
         "w": rng.normal(size=(D, F)) / 3, "wr": rng.normal(size=(F, D)) / 3,
         "table": rng.normal(size=(V, D)), "g": rng.normal(size=(D,))}
    if repeat:  # the second dp group's rows are the first's
        for k in ("x", "h", "R", "RF", "R2", "tok", "lab"):
            d[k][B // 2:] = d[k][:B // 2]
    return {k: torch.tensor(v, dtype=torch.float32 if v.dtype.kind == "f"
                            else torch.int64) for k, v in d.items()}


def f(rule, d, x, h, w, table, g):
    # returns the loss of rows (x, h, tokens, labels and R are this rank's
    # rows on the mesh, all rows whole)
    if rule == "column":
        return (layers.dense({"w": w}, x) * d["RF"]).sum()
    if rule == "row":
        return (layers.dense({"w": w}, h) * d["R"]).sum()
    if rule == "embed":
        return (layers.embed({"table": table}, d["tok"]) * d["R"]).sum()
    if rule == "unembed_ce":
        ce, lse = layers.unembed_ce({"table": table}, x, d["lab"])
        return (ce * d["R2"]).sum() + (lse * d["R2"] ** 2).sum()
    if rule == "fsdp":
        return (layers.dense({"w": w}, x) * d["RF"]).sum()
    if rule == "norm":
        return (layers.rmsnorm({"g": g}, x) * d["R"]).sum()


SPEC = {"column": P(None, "model"), "row": P("model", None),
        "embed": P("model", None), "unembed_ce": P("model", None),
        "fsdp": P("data", None), "norm": P(None)}
LEAF = {"column": "w", "row": "wr", "embed": "table", "unembed_ce": "table",
        "fsdp": "w", "norm": "g"}


def whole(rule, d):
    leaves = {k: d[k].clone().requires_grad_() for k in
              ("x", "h", "w", "wr", "table", "g")}
    w = leaves["wr"] if rule == "row" else leaves["w"]
    f(rule, d, leaves["x"], leaves["h"], w, leaves["table"],
      leaves["g"]).backward()
    xin = leaves["h"] if rule == "row" else leaves["x"]
    return {"param": leaves[LEAF[rule]].grad.numpy(),
            "x": torch.zeros_like(xin) if xin.grad is None else xin.grad}


@contextlib.contextmanager
def wrong(kind):
    saved = (meshctx._replicated, meshctx.sum_grad, grad_utils.sum_over_dp)
    if kind == "flip":
        meshctx._replicated = lambda axis: axis in meshctx.DP_AXES
    elif kind == "nosum":
        meshctx.sum_grad = lambda t, axis="model", mesh=None: t
    elif kind == "nodp":
        grad_utils.sum_over_dp = lambda grads: None
    try:
        yield
    finally:
        (meshctx._replicated, meshctx.sum_grad,
         grad_utils.sum_over_dp) = saved


def on_mesh(rule, d):
    rows = {k: meshctx.batch_local(v)[0] if k in (
        "x", "h", "R", "RF", "R2", "tok", "lab") else v for k, v in d.items()}
    x = rows["x"].clone().requires_grad_()
    h = rows["h"].clone().requires_grad_()
    p = torch.nn.Parameter(meshctx.place(d[LEAF[rule]], mesh, to_placements(
        mesh, SPEC[rule])))
    args = dict(w=p, table=p, g=p)
    f(rule, rows, x, h, args["w"], args["table"], args["g"]).backward()
    grads = {"p": p.grad}
    grad_utils.sum_over_dp(grads)
    xin = h if rule == "row" else x
    xg = torch.zeros_like(xin) if xin.grad is None else xin.grad
    # the input's gradient: each dp rank's rows, gathered whole
    xg = meshctx.all_gather(xg, "data", 0)
    return {"param": meshctx.full(grads["p"]).numpy(), "x": xg.numpy()}


out = {}
for rule in RULES:
    d = data(repeat=False)
    out[f"{rule}/right"] = on_mesh(rule, d)
    out[f"{rule}/whole"] = {k: np.asarray(v) for k, v in whole(rule, d).items()}
    d = data(repeat=True)
    out[f"{rule}/right_rep"] = on_mesh(rule, d)
for name, (kind, _) in WRONG.items():
    rule = name.split("_nosum")[0]
    with wrong(kind):
        out[f"{name}/wrong_rep"] = on_mesh(rule, data(repeat=True))

# the 8-bit codec on placed leaves: codes and scales of every route
from repro_torch.optim import adamw
for name, (shape, qspec, sspec) in CODEC.items():
    x = torch.tensor(np.random.default_rng(5).normal(size=shape),
                     dtype=torch.float32)
    want = adamw._quantize(x, "sq")
    q = meshctx.place(want["q"], mesh, to_placements(mesh, qspec))
    sc = meshctx.place(want["scale"], mesh, to_placements(mesh, sspec))
    cut = adamw.codec_cut(q, sc)
    xl = meshctx.local_slice(x, mesh, q.placements)
    got = adamw._quantize(xl, "sq", cut)
    back = adamw._dequantize(got, xl.shape, kind="sq", cut=cut)
    out[f"codec/{name}"] = {
        "route": np.array("local" if cut is None else "straddle"
                          if cut.scale_placements is None else "whole"),
        "q": np.array(torch.equal(got["q"], q.to_local())),
        "scale": np.array(torch.equal(got["scale"], sc.to_local())),
        "back": np.array(torch.equal(back, meshctx.local_slice(
            adamw._dequantize(want, shape, kind="sq"), mesh,
            q.placements)))}
meshctx.set_mesh(None)
save_tree(OUT / f"rules{RANK}.npz", out)
""" % (RULES, WRONG, CODEC)

MOE_REFERENCE = """
import numpy as np, jax, jax.numpy as jnp
from repro.configs import get_config
from repro.models import transformer as tf
from repro.models.layers import mlp
from repro.models.moe import _moe_local
from torch_mesh import save_tree

out = {}
for arch in %r:
    cfg = get_config(arch, smoke=True)
    m = cfg.moe
    i = next(j for j, k in enumerate(cfg.pattern) if k.endswith("_moe"))
    params = tf.init_params(cfg, jax.random.key(0))
    p = jax.tree.map(lambda a: a[0], params["units"])[f"l{i}"]["mlp"]
    x = np.random.default_rng(1).normal(
        size=(4, 8, cfg.d_model)).astype(np.float32)
    R = np.random.default_rng(2).normal(
        size=(4, 8, cfg.d_model)).astype(np.float32)

    def loss(p, x):
        dt = x.dtype
        parts = [_moe_local(x[g * 2:(g + 1) * 2], p["router"],
                            p["w_gate"].astype(dt), p["w_up"].astype(dt),
                            p["w_down"].astype(dt), 0, k=m.top_k,
                            E=m.num_experts, cf=m.capacity_factor,
                            dp_names=()) for g in range(2)]
        y = jnp.concatenate([a for a, _ in parts])
        if m.num_shared:
            y = y + mlp(p["shared"], x, "swiglu")
        aux = sum(b for _, b in parts) / 2
        return jnp.sum(y * R) + %r * aux

    gp, gx = jax.grad(loss, argnums=(0, 1))(p, jnp.asarray(x))
    out[arch] = {"params": jax.tree.map(np.asarray, params),
                 "x": x, "R": R, "grad_x": np.asarray(gx),
                 "grad_p": jax.tree.map(np.asarray, gp)}
save_tree(OUT / "moe_ref.npz", out)
""" % (MOE_ARCHS, MOE_AUX_W)

MOE_PORT = """
import numpy as np
from repro_torch.configs import get_config
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models import carry, meshctx
from repro_torch.models.moe import moe_apply
from repro_torch.optim import grad_utils
from torch_mesh import load_tree, save_tree

mesh = make_test_mesh((2, 2), ("data", "model"), device_type="cpu")
out = {}
for arch in %r:
    cfg = get_config(arch, smoke=True)
    i = next(j for j, k in enumerate(cfg.pattern) if k.endswith("_moe"))
    ref = load_tree(OUT / "moe_ref.npz", arch)
    placed = carry.place_params(cfg, mesh, carry.params_from_numpy(
        cfg, ref["params"], device="cpu"))
    p = placed.units[0][f"l{i}"]["mlp"]
    with meshctx.use_mesh(mesh):
        rows = meshctx.activation(torch.from_numpy(ref["x"])).to_local()
        rows = rows.detach().requires_grad_()
        R = meshctx.batch_local(torch.from_numpy(ref["R"]))[0]
        y, aux = moe_apply(p, cfg, rows)
        loss = (y * R).sum() + %r * aux / meshctx.dp_size()
        loss.backward()
        grads = {n: t.grad for n, t in p.named_parameters()}
        grad_utils.sum_over_dp(grads)
        gx = meshctx.all_gather(rows.grad, "data", 0)
        out[arch] = {"grad_x": gx.numpy(), "grad_p": {
            n.replace(".", "/"): meshctx.full(g).numpy()
            for n, g in grads.items()}}
save_tree(OUT / f"moe_port{RANK}.npz", out)
""" % (MOE_ARCHS, MOE_AUX_W)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("mesh_grads")
    run_world(PORT, WORLD, d)
    run_reference(MOE_REFERENCE, 1, d)
    run_world(MOE_PORT, WORLD, d)
    return ([load_tree(d / f"rules{r}.npz") for r in range(WORLD)],
            load_tree(d / "moe_ref.npz"),
            [load_tree(d / f"moe_port{r}.npz") for r in range(WORLD)])


@pytest.mark.parametrize("rule", RULES)
def test_rule_gives_the_whole_gradient(runs, rule):
    port = runs[0]
    for r in range(WORLD):
        got, want = port[r][rule]["right"], port[r][rule]["whole"]
        np.testing.assert_allclose(got["param"], want["param"], **TOL)
        np.testing.assert_allclose(got["x"], want["x"], **TOL)


@pytest.mark.parametrize("name", list(WRONG))
def test_rule_taken_the_wrong_way_fails_by_the_axis_size(runs, name):
    port = runs[0]
    rule = name.split("_nosum")[0]
    factor = WRONG[name][1]
    for r in range(WORLD):
        right = port[r][rule]["right_rep"]
        wrong = port[r][name]["wrong_rep"]
        leaf = "x" if name == "column_nosum" else "param"
        with pytest.raises(AssertionError):
            np.testing.assert_allclose(wrong[leaf], right[leaf], **TOL)
        if factor is not None:
            np.testing.assert_allclose(wrong["param"], factor * right["param"],
                                       **TOL)


@pytest.mark.parametrize("route", list(CODEC))
def test_8bit_codec_on_placed_blocks_is_the_whole_leafs(runs, route):
    """Each rank's codes, scales and decoded values of its block are
    bit-equal to its slice of the plain codec's on the whole leaf, on the
    three layouts the sharding rules give a codec-eligible leaf: blocks
    within the rank's columns, blocks straddling two ranks with the scale
    replicated over "model", and a scale placed on another dim (xLSTM's
    gate projections under the generic rule)."""
    port = runs[0]
    for r in range(WORLD):
        got = port[r]["codec"][route]
        assert str(got["route"]) == route
        assert bool(got["q"]) and bool(got["scale"]) and bool(got["back"])


def _flat(tree, key=""):
    if not isinstance(tree, dict):
        return {key: tree}
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, f"{key}/{k}" if key else k))
    return out


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_expert_parallel_moe_gradients_match_the_reference(runs, arch):
    _, ref, port = runs
    want = _flat(ref[arch]["grad_p"])
    for r in range(WORLD):
        got = port[r][arch]
        np.testing.assert_allclose(got["grad_x"], ref[arch]["grad_x"],
                                   **MOE_TOL)
        gp = _flat(got["grad_p"])
        assert set(gp) == set(want), (sorted(gp), sorted(want))
        for k in want:
            np.testing.assert_allclose(gp[k], want[k], err_msg=k, **MOE_TOL)
