"""The port's substrates of the training half against the reference's:
the token pipeline (``repro_torch.data.pipeline``: synthetic, file and
embeds batches bit-equal), gradient compression
(``repro_torch.distributed.compression``: codec, error feedback over a
stacked leaf, ``allreduce_compressed`` on gloo worlds of one and two
ranks against the reference's single-device ``shard_map``), and the
behavioural tests of ``tests/test_substrates.py`` (optimizer, pipeline,
compression) on the port alone."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro import compat
from repro.data import pipeline as rpipe
from repro.distributed import compression as rcomp
from repro_torch.data import pipeline as ppipe
from repro_torch.distributed import compression as pcomp
from repro_torch.optim import (adamw_init, adamw_update, clip_by_global_norm,
                               global_norm, warmup_cosine)
from torch_world import spawn_world
from torch_threads import one_torch_thread  # noqa: F401


# ------------------------------------------------------------- pipeline


@pytest.mark.parametrize("world", [1, 2, 4])
def test_synthetic_batches_are_the_references(world):
    r = rpipe.TokenPipeline(vocab_size=97, batch=8, seq_len=33, seed=3)
    p = ppipe.TokenPipeline(vocab_size=97, batch=8, seq_len=33, seed=3)
    for step in (0, 5, 1234):
        for rank in range(world):
            a = p.batch_slice(step, rank=rank, world=world)["tokens"]
            b = r.batch_slice(step, rank=rank, world=world)["tokens"]
            assert a.dtype == np.int32
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(p.global_batch(7)["tokens"],
                                  r.global_batch(7)["tokens"])


def test_file_batches_are_the_references(tmp_path):
    path = str(tmp_path / "tokens.npy")
    np.save(path, np.random.default_rng(0).integers(
        0, 1000, 5000).astype(np.int32))
    r = rpipe.TokenPipeline(vocab_size=1000, batch=4, seq_len=64, seed=2,
                            source="file", path=path)
    p = ppipe.TokenPipeline(vocab_size=1000, batch=4, seq_len=64, seed=2,
                            source="file", path=path)
    for step in (0, 3):
        np.testing.assert_array_equal(p.global_batch(step)["tokens"],
                                      r.global_batch(step)["tokens"])
        np.testing.assert_array_equal(
            p.batch_slice(step, rank=1, world=2)["tokens"],
            r.batch_slice(step, rank=1, world=2)["tokens"])
    with pytest.raises(ValueError, match="path"):
        ppipe.TokenPipeline(vocab_size=10, batch=1, seq_len=4, source="file")
    with pytest.raises(ValueError, match="divisible"):
        p.batch_slice(0, rank=0, world=3)


def test_embeds_batches_are_the_references():
    r = rpipe.embeds_pipeline(16, 2, 8, seed=4)
    p = ppipe.embeds_pipeline(16, 2, 8, seed=4)
    for step in (0, 9):
        a, b = p(step, 50), r(step, 50)
        assert set(a) == set(b) == {"embeds", "labels"}
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


# ---------------------------------------------------------- compression


@pytest.mark.parametrize("kind", ["bf16", "int8"])
def test_compress_roundtrip_matches_the_reference(kind):
    g = np.random.default_rng(1).normal(size=(3, 300)).astype(np.float32)
    want = rcomp.decompress(rcomp.compress(jnp.asarray(g), kind), kind,
                            g.shape, g.size)
    got = pcomp.decompress(pcomp.compress(torch.from_numpy(g), kind), kind,
                           g.shape, g.size)
    assert got.dtype == torch.float32 and tuple(got.shape) == g.shape
    # the wire's linear code has no root to round: the same codes, values
    # within float32 rounding of the reference's
    err = np.abs(got.numpy() - np.asarray(want)).max()
    print(f"compress roundtrip, {kind}: max |Δ| {err:.3g}")
    assert err <= 1e-7
    with pytest.raises(ValueError):
        pcomp.compress(torch.from_numpy(g), "fp8")


@pytest.mark.parametrize("kind", ["none", "bf16", "int8"])
def test_ef_compress_tree_over_a_stacked_leaf(kind):
    """The reference blocks a stacked (2, 5, 40) leaf's 400 elements as
    one flat array (a block straddles the units); the port regroups its
    two unit leaves the same way, so wire and residual match."""
    rng = np.random.default_rng(2)
    ref_g = {"units": {"w": rng.normal(size=(2, 5, 40)).astype(np.float32)},
             "b": rng.normal(size=(7,)).astype(np.float32)}
    ref_e = jax.tree.map(lambda a: (a * 1e-3).astype(np.float32), ref_g)
    r_wire, r_err = rcomp.ef_compress_tree(
        jax.tree.map(jnp.asarray, ref_g), jax.tree.map(jnp.asarray, ref_e),
        kind)

    def port(tree):
        out = {"b": torch.from_numpy(tree["b"].copy())}
        for u in range(2):
            out[f"units.{u}.w"] = torch.from_numpy(tree["units"]["w"][u]
                                                   .copy())
        return out

    wire, err = pcomp.ef_compress_tree(port(ref_g), port(ref_e), kind,
                                       stack=2)
    tol = 0.0 if kind != "int8" else 1e-7
    for u in range(2):
        for got, want in ((wire, r_wire), (err, r_err)):
            np.testing.assert_allclose(
                got[f"units.{u}.w"].numpy(),
                np.asarray(want["units"]["w"][u]), rtol=0, atol=tol)
    np.testing.assert_allclose(wire["b"].numpy(), np.asarray(r_wire["b"]),
                               rtol=0, atol=tol)
    assert set(pcomp.init_error_buf(port(ref_g))) == set(port(ref_g))


ALLREDUCE_CHILD = r"""
import sys
import numpy as np
import torch
import torch.distributed as dist
from repro_torch.distributed.compression import allreduce_compressed
rank, world, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
dist.init_process_group("gloo", store=dist.FileStore(out + "/store", world),
                        rank=rank, world_size=world)
g = torch.from_numpy(np.load(out + f"/g{rank}.npy"))
res = {kind: allreduce_compressed(g, kind).float().numpy()
       for kind in ("none", "bf16", "int8")}
np.savez(out + f"/out{rank}.npz", **res)
dist.destroy_process_group()
"""


def _ref_single(g, kind):
    """The reference's ``allreduce_compressed`` over a one-device mesh."""
    mesh = compat.make_mesh((1,), ("data",))
    spec = jax.sharding.PartitionSpec(None)
    return np.asarray(compat.shard_map(
        lambda x: rcomp.allreduce_compressed(x, "data", kind), mesh=mesh,
        in_specs=spec, out_specs=spec, check_vma=False)(jnp.asarray(g)),
        np.float32)


def test_allreduce_compressed_world_of_one_is_the_references(tmp_path):
    g = np.random.default_rng(1).normal(size=(300,)).astype(np.float32)
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        for kind in ("none", "bf16", "int8"):
            got = pcomp.allreduce_compressed(torch.from_numpy(g), kind)
            assert got.dtype == torch.float32
            want = _ref_single(g, kind)
            tol = 0.0 if kind != "int8" else 1e-7
            err = np.abs(got.numpy() - want).max()
            print(f"allreduce world of one, {kind}: max |Δ| {err:.3g}")
            assert err <= tol, kind
    finally:
        dist.destroy_process_group()


def test_allreduce_compressed_two_ranks(tmp_path):
    """Two gloo ranks: each gets the mean of both ranks' wires. Against
    the reference's formula on one device: (out₀ + out₁)/2 of each rank's
    single-device result (its sum over the gathered axis is the same two
    terms); float32 and bf16 against the plain means."""
    gs = [np.random.default_rng(10 + r).normal(size=(300,)).astype(
        np.float32) for r in range(2)]
    for r, g in enumerate(gs):
        np.save(tmp_path / f"g{r}.npy", g)
    res = spawn_world(ALLREDUCE_CHILD, 2, tmp_path, timeout=120)
    assert all(rc == 0 for rc, _ in res), res
    outs = [np.load(tmp_path / f"out{r}.npz") for r in range(2)]
    for kind in ("none", "bf16", "int8"):
        np.testing.assert_array_equal(outs[0][kind], outs[1][kind])
    np.testing.assert_allclose(outs[0]["none"], (gs[0] + gs[1]) / 2,
                               rtol=1e-6, atol=1e-7)
    bf = [np.asarray(jnp.asarray(g).astype(jnp.bfloat16), np.float32)
          for g in gs]
    np.testing.assert_allclose(outs[0]["bf16"], (bf[0] + bf[1]) / 2,
                               rtol=2.0 ** -8, atol=0)
    want = (_ref_single(gs[0], "int8") + _ref_single(gs[1], "int8")) / 2
    err = np.abs(outs[0]["int8"] - want).max()
    print(f"allreduce two ranks, int8: max |Δ| {err:.3g}")
    assert err <= 1e-7


# ----------------------------------- behaviour (``tests/test_substrates``)


def _rosenbrock_ish(params):
    x, y = params["x"], params["y"]
    return torch.sum((1 - x) ** 2) + 5 * torch.sum((y - x ** 2) ** 2)


@pytest.mark.parametrize("bits8", [False, True])
def test_adamw_optimizes(bits8):
    params = {"x": torch.full((8,), -1.0, requires_grad=True),
              "y": torch.full((8,), 2.0, requires_grad=True)}
    state = adamw_init(params, bits8=bits8)
    loss0 = float(_rosenbrock_ish(params).detach())
    for _ in range(300):
        loss = _rosenbrock_ish(params)
        grads = dict(zip(params, torch.autograd.grad(
            loss, list(params.values()))))
        params, state = adamw_update(grads, state, params, lr=3e-2,
                                     weight_decay=0.0, bits8=bits8)
    assert float(loss.detach()) < 0.05 * loss0, (
        f"bits8={bits8}: loss {float(loss.detach())}")


def test_adamw8bit_tracks_fp32():
    rng = np.random.default_rng(0)
    w0 = torch.from_numpy(rng.normal(size=(128, 512)).astype(np.float32))
    tgt = torch.from_numpy(rng.normal(size=(128, 512)).astype(np.float32))

    def run(bits8):
        params = {"w": w0.clone()}
        state = adamw_init(params, bits8=bits8)
        for _ in range(50):
            grads = {"w": 2 * (params["w"] - tgt)}
            params, state = adamw_update(grads, state, params, lr=1e-2,
                                         weight_decay=0.0, bits8=bits8)
        return params["w"].numpy()

    a, b = run(False), run(True)
    assert np.abs(a - b).max() < 0.1, np.abs(a - b).max()


def test_adamw8bit_state_is_int8():
    params = {"w": torch.zeros(64, 1024), "b": torch.zeros(100)}
    state = adamw_init(params, bits8=True)
    assert state["m"]["w"]["q"].dtype == torch.int8
    assert tuple(state["m"]["w"]["q"].shape) == (64, 1024)
    bytes_8 = state["m"]["w"]["q"].numel() + 4 * state["m"]["w"][
        "scale"].numel()
    assert bytes_8 < 0.3 * 64 * 1024 * 4, "8-bit state must be ≲ 1/4 of fp32"
    assert state["m"]["b"].dtype == torch.float32


def test_warmup_cosine_shape():
    lr = [float(warmup_cosine(s, peak_lr=1.0, warmup_steps=10,
                              total_steps=100)) for s in range(101)]
    assert lr[0] == 0.0 and abs(lr[10] - 1.0) < 1e-6
    assert lr[50] < lr[10] and lr[100] <= lr[50]
    assert abs(lr[100] - 0.1) < 1e-6  # final_frac


def test_clip_by_global_norm():
    tree = {"a": torch.full((4,), 10.0)}
    clipped, norm = clip_by_global_norm(tree, 1.0)
    assert abs(float(norm) - 20.0) < 1e-4
    assert abs(float(global_norm(clipped)) - 1.0) < 1e-4


def test_pipeline_deterministic_and_sharded():
    pipe = ppipe.TokenPipeline(vocab_size=97, batch=8, seq_len=16, seed=3)
    a = pipe.global_batch(5)["tokens"]
    b = pipe.global_batch(5)["tokens"]
    np.testing.assert_array_equal(a, b)
    c = pipe.global_batch(6)["tokens"]
    assert (a != c).any()
    parts = [pipe.batch_slice(5, rank=r, world=4)["tokens"] for r in range(4)]
    np.testing.assert_array_equal(np.concatenate(parts, 0), a)
    assert a.min() >= 0 and a.max() < 97


@pytest.mark.parametrize("kind", ["bf16", "int8"])
def test_ef_compression_error_feedback(kind):
    rng = np.random.default_rng(0)
    g_true = torch.from_numpy(rng.normal(size=(512,)).astype(
        np.float32)) * 1e-3
    grads = {"w": g_true}
    ebuf = pcomp.init_error_buf(grads)
    delivered = torch.zeros_like(g_true)
    for _ in range(30):
        wire, ebuf = pcomp.ef_compress_tree(grads, ebuf, kind)
        delivered = delivered + wire["w"]
    total_err = float((delivered - 30 * g_true).abs().max())
    assert total_err < 2e-4, total_err


def test_allreduce_compressed_single_device(tmp_path):
    g = torch.from_numpy(np.random.default_rng(1).normal(size=(256,))
                         .astype(np.float32))
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        out = pcomp.allreduce_compressed(g, "int8")
    finally:
        dist.destroy_process_group()
    np.testing.assert_allclose(out.numpy(), g.numpy(), rtol=2e-2,
                               atol=1.5e-2)



def test_modules_export_the_references_names():
    import inspect

    from repro import training as rtrain
    from repro.launch import train as rlaunch
    from repro_torch import training as ptrain
    from repro_torch.launch import train as plaunch

    assert ptrain.__all__ == rtrain.__all__

    def public(mod):
        return {n for n, v in vars(mod).items() if not n.startswith("_")
                and (inspect.isfunction(v) or inspect.isclass(v))
                and v.__module__ == mod.__name__}

    for ref, port in ((rpipe, ppipe), (rcomp, pcomp), (rlaunch, plaunch)):
        assert public(ref) <= public(port), (port.__name__,
                                             public(ref) - public(port))
