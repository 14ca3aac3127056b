"""The port's train step on a mesh against the reference's, as GSPMD runs it.

The reference: ``repro.training.make_train_step`` with the dry run's
``batch_constraint`` (each microbatch's batch over the data-parallel axes)
and ``grad_constraint`` (the MoE expert banks' gradients pinned to their
parameter's spec), built as ``src/repro/launch/dryrun.py:140-168`` builds
them, jitted with ``state_specs``/``batch_specs`` in-shardings on a (2, 2)
("data", "model") mesh of four host devices under ``meshctx.use_mesh``,
in one JAX subprocess. The port: ``repro_torch.training.make_train_step``
with ``launch.sharding.dp_batch_constraint``/``expert_grad_constraint`` on
four gloo ranks of a (2, 2) ``DeviceMesh``, the reference's initial state
carried in and placed by the same specs (``state_from_numpy(mesh=)``),
every result gathered out (``state_to_numpy``).

Config: llama3-8b's smoke config widened for both packages to d_model 256,
d_ff 768, vocab 256: the tables (256, 256) and every unit matrix reach the
8-bit codec, and at "model" 2 the (256, 768) ``w_gate``/``w_up`` hold 1.5
blocks of 256 a rank, so their blocks straddle the ranks (the codec's
cross-rank absmax, the scale replicated over "model").

Cases: float32 ``adamw`` and ``adamw8bit`` at one and two microbatches, and
``adamw8bit`` with the int8 wire at two, two steps each (the schedule's
warmup step, lr 0, then lr 1e-3). Held, at ``tests/torch_train.py``'s
tolerances: the metrics at both steps; the whole state (weights, moments,
8-bit codes and scales, error buffers) after step 1 and, one step from the
reference's own state after step 1, after step 2 (codes within ±1, but
where the int8 wire rounded an element the other way: ``torch_train.
compare``); after two free-running steps the same, the codes held by their
share (``FREE_CODE_LIMIT``). The port's mesh step is also held
against its own no-mesh step from the same state (metrics at both steps,
the state after one step), every rank reports the same metrics, and the
mesh step issues the collectives it is built of.
"""

import numpy as np
import pytest

from torch_mesh import load_tree, run_reference, run_world
from torch_threads import one_torch_thread  # noqa: F401

WORLD = 4
LR = 1e-3
WIDE = dict(d_model=256, d_ff=768, vocab_size=256)
# name → (optimizer, microbatch, grad_compression)
CASES = {
    "adamw-mb1": ("adamw", 1, "none"),
    "adamw-mb2": ("adamw", 2, "none"),
    "8bit-mb1": ("adamw8bit", 1, "none"),
    "8bit-mb2": ("adamw8bit", 2, "none"),
    "8bit-int8-mb2": ("adamw8bit", 2, "int8"),
}
B, S, STEPS = 4, 16, 2
# Free-running 8-bit codes are held by their share only (at most
# ``torch_train.FLIP_SHARE`` of them differ): a code one off at step 1
# moves the next step's moment by up to (2c + 1)/127² of its block's scale,
# and the signed-sqrt map's slope 127/(2√|y|) near zero turns that into
# several codes (4 on ``lm_head`` here). One step from the reference's own
# state they are held within ±1 (test_state_after_one_step_…).
FREE_CODE_LIMIT = 254

COMMON = """
import dataclasses
import numpy as np
WIDE, CASES, LR, B, S, STEPS = %r, %r, %r, %r, %r, %r


def batches(vocab):
    out = []
    for i in range(STEPS):
        rng = np.random.default_rng(10 + i)
        out.append({"tokens": rng.integers(0, vocab, (B, S)).astype(np.int32),
                    "labels": rng.integers(0, vocab, (B, S)).astype(np.int32)})
    return out


def tcfg_kw(opt, micro, wire):
    return dict(learning_rate=LR, warmup_steps=1, total_steps=10,
                optimizer=opt, microbatch=micro, grad_compression=wire)
""" % (WIDE, CASES, LR, B, S, STEPS)

REFERENCE = COMMON + """
import jax, jax.numpy as jnp
from repro.configs import TrainConfig, get_config
from repro.launch import sharding as shd
from repro.launch.mesh import dp_axes, make_test_mesh
from repro.models import meshctx
from repro.models import transformer as tf
from repro.training import make_train_step
from torch_mesh import save_tree

P = jax.sharding.PartitionSpec
mesh = make_test_mesh((2, 2), ("data", "model"))
cfg = dataclasses.replace(get_config("llama3-8b", smoke=True), **WIDE)
dp = dp_axes(mesh)


def _axsize(mesh, axes):
    n = 1
    for a in (axes if isinstance(axes, tuple) else (axes,)):
        n *= mesh.shape[a]
    return n


# --- as src/repro/launch/dryrun.py:140-168 builds them
def constrain(mb):
    def leaf(x):
        dims = [dp if x.shape[0] % _axsize(mesh, dp) == 0 else None]
        dims += [None] * (x.ndim - 1)
        return jax.lax.with_sharding_constraint(
            x, jax.sharding.NamedSharding(mesh, P(*dims)))
    return jax.tree.map(leaf, mb)


def _expert_spec(path, leaf):
    names = [q.key for q in path if hasattr(q, "key")]
    core = leaf.ndim - (1 if "units" in names else 0)
    if "mlp" in names and core == 3 and names[-1].startswith("w_"):
        return jax.sharding.NamedSharding(
            mesh, shd.param_spec(path, leaf, cfg, mesh))
    return None


gshard = jax.tree_util.tree_map_with_path(_expert_spec,
                                          tf.abstract_params(cfg))


def grad_constrain(grads):
    return jax.tree.map(
        lambda g, s: g if s is None
        else jax.lax.with_sharding_constraint(g, s),
        grads, gshard,
        is_leaf=lambda v: v is None or hasattr(v, "shape"))
# ---


def host(tree):
    return jax.tree.map(np.asarray, tree)


out = {}
bs = batches(cfg.vocab_size)
meshctx.set_mesh(mesh)
for name, (opt, micro, wire) in CASES.items():
    init, step, abstract = make_train_step(
        cfg, TrainConfig(**tcfg_kw(opt, micro, wire)),
        batch_constraint=constrain, grad_constraint=grad_constrain)
    state = init(jax.random.key(0))
    state_sh = shd.to_shardings(mesh, shd.state_specs(cfg, mesh, abstract()))
    batch_sh = shd.to_shardings(mesh, shd.batch_specs(cfg, mesh, bs[0]))
    fn = jax.jit(step, in_shardings=(state_sh, batch_sh),
                 out_shardings=(state_sh, None))
    rec = {"init": host(state)}
    s = jax.device_put(state, state_sh)
    for i, b in enumerate(bs):
        s, met = fn(s, jax.device_put(b, batch_sh))
        rec[f"state{i + 1}"] = host(s)
        rec[f"metrics{i + 1}"] = {k: np.asarray(v) for k, v in met.items()}
    out[name] = rec
meshctx.set_mesh(None)
save_tree(OUT / "ref.npz", out)
"""

PORT = COMMON + """
from repro_torch.configs import TrainConfig, get_config
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.launch.sharding import (dp_batch_constraint,
                                         expert_grad_constraint)
from repro_torch.models import meshctx
from repro_torch.training import make_train_step
from repro_torch.training.carry import state_from_numpy, state_to_numpy
from torch_mesh import load_tree, save_tree

mesh = make_test_mesh((2, 2), ("data", "model"), device_type="cpu")
cfg = dataclasses.replace(get_config("llama3-8b", smoke=True), **WIDE)
bs = [{k: torch.from_numpy(v) for k, v in b.items()}
      for b in batches(cfg.vocab_size)]


def floats(met):
    return {k: np.asarray(float(v)) for k, v in met.items()}


out = {}
for name, (opt, micro, wire) in CASES.items():
    ref = load_tree(OUT / "ref.npz", name)
    tcfg = TrainConfig(**tcfg_kw(opt, micro, wire))
    _, step, _ = make_train_step(
        cfg, tcfg, batch_constraint=dp_batch_constraint(mesh),
        grad_constraint=expert_grad_constraint(cfg, mesh))
    rec = {}
    with meshctx.use_mesh(mesh):
        st = state_from_numpy(cfg, tcfg, ref["init"], device="cpu",
                              mesh=mesh)
        for i, b in enumerate(bs):
            meshctx.reset_collective_counts()
            st, met = step(st, b)
            rec[f"counts{i + 1}"] = {k: np.asarray(v) for k, v in
                                    meshctx.collective_counts().items()}
            rec[f"metrics{i + 1}"] = floats(met)
            rec[f"state{i + 1}"] = state_to_numpy(cfg, st)
        one = state_from_numpy(cfg, tcfg, ref["state1"], device="cpu",
                               mesh=mesh)
        one, _ = step(one, bs[1])
        rec["one2"] = state_to_numpy(cfg, one)
    # the port's own no-mesh step from the same state
    _, plain, _ = make_train_step(cfg, tcfg)
    st = state_from_numpy(cfg, tcfg, ref["init"], device="cpu")
    for i, b in enumerate(bs):
        st, met = plain(st, b)
        rec[f"plain_metrics{i + 1}"] = floats(met)
        if i == 0:
            rec["plain_state1"] = state_to_numpy(cfg, st)
    out[name] = rec
save_tree(OUT / f"port{RANK}.npz", out)
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("mesh_train_step")
    run_reference(REFERENCE, WORLD, d)
    run_world(PORT, WORLD, d)
    return (load_tree(d / "ref.npz"),
            [load_tree(d / f"port{r}.npz") for r in range(WORLD)])


def _setup(case):
    from torch_lm import configs

    from repro.configs import TrainConfig as RefTrainConfig
    opt, micro, wire = CASES[case]
    rcfg, pcfg = configs("llama3-8b", **WIDE)
    rt = RefTrainConfig(learning_rate=LR, warmup_steps=1, total_steps=10,
                        optimizer=opt, microbatch=micro,
                        grad_compression=wire)
    return rcfg, pcfg, rt


def _quanta(case, rcfg, rt, state, step):
    """The int8 wire's quanta of ``step`` from the reference ``state``
    (``torch_train.ebuf_quanta``), or None without the wire."""
    if CASES[case][2] != "int8":
        return None
    from torch_train import ebuf_quanta
    rng = np.random.default_rng(10 + step)
    b = {"tokens": rng.integers(0, rcfg.vocab_size, (B, S)).astype(np.int32),
         "labels": rng.integers(0, rcfg.vocab_size, (B, S)).astype(np.int32)}
    return ebuf_quanta(rcfg, rt, state, b)


def _metrics_close(got, want):
    from torch_lm import ATOL, RTOL
    for k, v in want.items():
        v = float(v)
        assert abs(float(got[k]) - v) <= ATOL + RTOL * abs(v), (k, got[k], v)


@pytest.mark.parametrize("case", list(CASES))
def test_metrics_match_the_reference(runs, case):
    ref, port = runs
    for r in range(WORLD):
        for i in range(1, STEPS + 1):
            _metrics_close(port[r][case][f"metrics{i}"],
                           ref[case][f"metrics{i}"])
            assert {k: float(v) for k, v in
                    port[r][case][f"metrics{i}"].items()} == {
                k: float(v) for k, v in port[0][case][f"metrics{i}"].items()}


@pytest.mark.parametrize("case", list(CASES))
def test_state_after_one_step_matches_the_reference(runs, case):
    """From the reference's state, each of the two steps: every leaf of the
    gathered state at ``torch_train.compare``'s one-step tolerances (8-bit
    codes within ±1, scales 2e-4, error buffers within a quantum)."""
    from torch_train import compare
    ref, port = runs
    rcfg, pcfg, rt = _setup(case)
    bits8 = CASES[case][0] == "adamw8bit"
    rec1 = compare(pcfg, port[0][case]["state1"], ref[case]["state1"],
                   steps=1, one_step=True, bits8=bits8,
                   quanta=_quanta(case, rcfg, rt, ref[case]["init"], 0))
    # step 2 from the reference's own state after step 1 (lr 1e-3)
    rec2 = compare(pcfg, port[0][case]["one2"], ref[case]["state2"],
                   steps=1, one_step=True, bits8=bits8,
                   quanta=_quanta(case, rcfg, rt, ref[case]["state1"], 1))
    print(case, rec1, rec2)


@pytest.mark.parametrize("case", list(CASES))
def test_free_running_state_matches_the_reference(runs, case):
    """Two steps from the initial state, at ``torch_train``'s two-step
    tolerances but for the codes' bound (``FREE_CODE_LIMIT``)."""
    from torch_train import compare
    ref, port = runs
    rcfg, pcfg, rt = _setup(case)
    rec = compare(pcfg, port[0][case]["state2"], ref[case]["state2"],
                  steps=2, bits8=CASES[case][0] == "adamw8bit",
                  quanta=_quanta(case, rcfg, rt, ref[case]["state1"], 1),
                  code_limit=FREE_CODE_LIMIT)
    print(case, rec)


def test_straddling_leaf_is_held(runs):
    """The case the cross-rank absmax exists for: w_up's 768 columns at
    "model" 2 are 1.5 blocks a rank, and its 8-bit codes and scales after
    one step agree with the reference's (within ±1, 2e-4)."""
    ref, port = runs
    want = ref["8bit-mb1"]["state1"]["opt"]["m"]["units"]["l0"]["mlp"]
    got = port[0]["8bit-mb1"]["state1"]["opt"]["m"]["units"]["l0"]["mlp"]
    for leaf in ("w_gate", "w_up"):
        w, g = want[leaf]["w"], got[leaf]["w"]
        assert w["q"].shape[-1] == 768 and w["scale"].shape[-1] == 3
        assert np.abs(w["q"].astype(int) - g["q"].astype(int)).max() <= 1
        assert np.abs(w["scale"] - g["scale"]).max() <= 2e-4 * np.abs(
            w["scale"]).max()
        assert np.abs(w["q"]).max() > 0


@pytest.mark.parametrize("case", list(CASES))
def test_mesh_step_matches_the_no_mesh_step(runs, case):
    """The port's mesh step against its own no-mesh step from the same
    state: the metrics of both steps, the state after one."""
    from torch_train import compare
    ref, port = runs
    rcfg, pcfg, rt = _setup(case)
    p = port[0][case]
    for i in range(1, STEPS + 1):
        _metrics_close(p[f"metrics{i}"], p[f"plain_metrics{i}"])
    compare(pcfg, p["state1"], p["plain_state1"], steps=1, one_step=True,
            bits8=CASES[case][0] == "adamw8bit",
            quanta=_quanta(case, rcfg, rt, ref[case]["init"], 0))


@pytest.mark.parametrize("case", ["adamw-mb1", "adamw-mb2"])
def test_step_issues_its_collectives(runs, case):
    """A step at (2, 2): forward and recomputed-forward all-gathers (FSDP
    weights over "data", q/k/v over "model"), sums over "model" (row-
    parallel products, the vocab-parallel lookup and cross-entropy) and
    max all-reduces (the cross-entropy's), and in the backward the FSDP
    gathers' reduce-scatters; with two microbatches about twice the
    model's and the same optimizer's."""
    _, port = runs
    c = {k: int(v) for k, v in port[0][case]["counts2"].items()}
    assert c["reduce_scatter"] > 0 and c["all_gather"] > c["reduce_scatter"]
    assert c["all_reduce_sum"] > 0 and c["all_reduce_max"] > 0
    for r in range(WORLD):
        assert {k: int(v) for k, v in port[r][case]["counts2"].items()} == c
