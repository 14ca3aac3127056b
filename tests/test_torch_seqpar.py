"""Port vs reference: sequence-parallel KV decode on a mesh, after
``tests/test_seqpar_decode.py``.

The reference program runs in one JAX subprocess with 8 host devices on a
(2, 4) ("data", "model") mesh: llama3-8b's smoke config, B = 4, six
decode steps, sequence-parallel decode and plain decode, at S_max 16 (a
multiple of the 4 model shards) and 18 (not: the reference falls back to
plain decode attention). The port runs 8 gloo ranks on a (2, 4)
``DeviceMesh`` with the reference's weights carried and placed by
``param_spec``, the cache placed by ``cache_specs``.

Tolerances: the reference's own, rtol = atol = 2e-4 (float32; the sums
over "model" change the order of additions).
"""

import numpy as np
import pytest

from torch_mesh import load_tree, run_reference, run_world
from torch_threads import one_torch_thread  # noqa: F401

TOL = dict(rtol=2e-4, atol=2e-4)
WORLD = 8
SIZES = (16, 18)

REFERENCE = """
import numpy as np, jax, jax.numpy as jnp
from repro.configs import get_config
from repro.launch.mesh import make_test_mesh
from repro.models import meshctx
from repro.models import transformer as tf
from torch_mesh import save_tree

cfg = get_config("llama3-8b", smoke=True)
params = tf.init_params(cfg, jax.random.key(0))
rng = np.random.default_rng(0)
B = 4
toks = rng.integers(0, cfg.vocab_size, (B, 6)).astype(np.int32)
mesh = make_test_mesh((2, 4), ("data", "model"))


def run(seqpar, S):
    with meshctx.use_mesh(mesh if seqpar else None):
        meshctx.set_seqpar_decode(seqpar)
        cache = tf.init_cache(cfg, B, S)
        step = jax.jit(lambda p, t, c, pos: tf.decode_step(p, cfg, t, c, pos))
        outs = []
        for t in range(6):
            logits, cache = step(params, jnp.asarray(toks[:, t:t + 1]),
                                 cache, jnp.int32(t))
            outs.append(np.asarray(logits))
        meshctx.set_seqpar_decode(False)
        return np.stack(outs)


out = {"params": jax.tree.map(np.asarray, params), "toks": toks}
for S in (16, 18):
    out[f"seqpar{S}"] = run(True, S)
    out[f"plain{S}"] = run(False, S)
save_tree(OUT / "ref.npz", out)
"""

PORT = """
import numpy as np
from repro_torch.configs import get_config
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models import carry, meshctx
from repro_torch.models import transformer as tf
from torch_mesh import load_tree, save_tree

cfg = get_config("llama3-8b", smoke=True)
ref = load_tree(OUT / "ref.npz")
model = carry.params_from_numpy(cfg, ref["params"], device="cpu")
toks = torch.from_numpy(ref["toks"])
B = toks.shape[0]
mesh = make_test_mesh((2, 4), ("data", "model"), device_type="cpu")
placed = carry.place_params(cfg, mesh, model)


def run(m, mesh, seqpar, S):
    with torch.no_grad(), meshctx.use_mesh(mesh):
        meshctx.set_seqpar_decode(seqpar)
        cache = tf.init_cache(cfg, B, S, device="cpu", mesh=mesh)
        outs = [tf.decode_step(m, cfg, toks[:, t:t + 1], cache, t)[0]
                for t in range(6)]
        meshctx.set_seqpar_decode(False)
    return torch.stack(outs).numpy(), cache


out = {}
for S in (16, 18):
    meshctx.reset_collective_counts()
    out[f"seqpar{S}"], cache = run(placed, mesh, True, S)
    out[f"counts{S}"] = np.array([meshctx.collective_counts().get(k, 0)
                                  for k in ("all_reduce_max",
                                            "all_reduce_sum",
                                            "all_gather")])
    out[f"secs{S}"] = np.array([meshctx.collective_seconds().get(k, -1.0)
                                for k in ("all_reduce_max",
                                          "all_reduce_sum", "all_gather")])
    out[f"local_k{S}"] = np.array(cache["l0"]["k"].to_local().shape)
    out[f"meshplain{S}"], _ = run(placed, mesh, False, S)
    out[f"plain{S}"], _ = run(model, None, False, S)
save_tree(OUT / f"port{RANK}.npz", out)
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("seqpar")
    run_reference(REFERENCE, WORLD, d)
    run_world(PORT, WORLD, d)
    return (load_tree(d / "ref.npz"),
            [load_tree(d / f"port{r}.npz") for r in range(WORLD)])


@pytest.mark.parametrize("S", SIZES)
def test_port_seqpar_equals_reference_seqpar(runs, S):
    ref, port = runs
    np.testing.assert_allclose(port[0][f"seqpar{S}"], ref[f"seqpar{S}"],
                               **TOL)


@pytest.mark.parametrize("S", SIZES)
def test_port_seqpar_equals_port_plain(runs, S):
    _, port = runs
    np.testing.assert_allclose(port[0][f"seqpar{S}"], port[0][f"plain{S}"],
                               **TOL)


@pytest.mark.parametrize("S", SIZES)
def test_mesh_without_seqpar_equals_reference_plain(runs, S):
    ref, port = runs
    np.testing.assert_allclose(port[0][f"meshplain{S}"], ref[f"plain{S}"],
                               **TOL)
    np.testing.assert_allclose(port[0][f"plain{S}"], ref[f"plain{S}"], **TOL)


@pytest.mark.parametrize("S", SIZES)
def test_every_rank_returns_the_same_logits(runs, S):
    _, port = runs
    for r in range(1, WORLD):
        for key in (f"seqpar{S}", f"meshplain{S}"):
            np.testing.assert_array_equal(port[r][key], port[0][key])


def test_cache_sharded_over_the_sequence_and_batch(runs):
    """(2, 4): each rank holds B/2 rows and S_max/4 positions at S 16; at
    18 the sequence is not divisible and stays whole."""
    _, port = runs
    for r in range(WORLD):
        assert tuple(port[r]["local_k16"][:3]) == (2, 2, 4)
        assert tuple(port[r]["local_k18"][:3]) == (2, 2, 18)


def test_seqpar_combines_with_one_max_and_two_sums_a_layer(runs):
    """Six steps × two layers: 12 max-reductions for the softmax combine,
    its two sums joined in one all-reduce beside wo's and the MLP's; q, k
    and v gathered in one all-gather. The fallback at S 18 issues no
    max."""
    _, port = runs
    assert port[0]["counts16"][0] == 6 * 2
    assert port[0]["counts16"][1] == 3 * 6 * 2 + 6  # + the embedding's
    assert port[0]["counts18"][0] == 0
    # every kind that ran has its host seconds, and only those
    for S in SIZES:
        ran = port[0][f"counts{S}"] > 0
        assert (port[0][f"secs{S}"][ran] >= 0).all()
        assert (port[0][f"secs{S}"][~ran] == -1.0).all()
