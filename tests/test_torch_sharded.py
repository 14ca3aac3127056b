"""Port vs reference: the sharded engines on the CPU.

``repro_torch.distributed.sharded_ccm`` on ``torch.distributed`` (gloo,
CPU tensors, the kernels' plain versions) against
``repro.distributed.sharded_ccm`` on a JAX (1, 1) mesh with ``impl="ref"``.
The same numpy panel goes to both. kNN tables are bit-equal between the
packages, so E_opt must be equal; ρ goes through float32 reductions ordered
differently by XLA and PyTorch and is held to ``ATOL`` (S-Map to
``smap_rho_tol(θ)``, as in tests/test_torch_session.py).

Inside the port the bits are held exactly: a world of one equals the port's
local engines, and every rank of a four-rank world (spawned as child
processes on a ``FileStore`` under ``tmp_path``, so no TCP port is shared
between test workers) equals the world of one, on meshes (2, 2), (4,) and
(2, 2, 1) with two lib axes, on a 7-series panel that both axes pad.
"""

import json
import pathlib
import types

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.data import timeseries as ts
from repro.distributed import sharded_ccm as jsh
from repro.edm import EDM as JEDM
from repro_torch import core, telemetry
from repro_torch.distributed import sharded_ccm as tsh
from repro_torch.edm import EDM, runner
from torch_world import spawn_world

ATOL = 1e-5
E_MAX = 6
LIB_SIZES = (40, 120, 197)
THETAS = (0.0, 1.0, 4.0)


def smap_rho_tol(theta: float) -> float:
    """S-Map ρ bound against JAX (tests/test_torch_session.py)."""
    return 1e-4 if theta <= 4.0 else 3e-3


#: The fixed-E S-Map matrix at E = 3 against JAX: the Lorenz library's
#: Gram matrix is ill-conditioned there (strongly correlated lags at
#: L = 200), and both packages' float32 solves sit about 1e-4 from a
#: float64 solve (measured: the port ≤ 2.0e-4, JAX ≤ 8.5e-5, 2.8e-4 apart;
#: ≤ 2.5e-5 apart at E = 2). The port's own engines are held bit-equal.
SMAP_FIXED_E_TOL = 5e-4


def _panel() -> np.ndarray:
    """Seven series whose optimal E differs: 7 pads on a lib axis of 2 or
    4 and on a target axis of 2."""
    net, _ = ts.forced_network_panel(6, 200, seed=4)
    return np.concatenate([net[:5], ts.tent_map_panel(1, 200, seed=4),
                           ts.lorenz63(200)[:1]]).astype(np.float32)


PANEL = _panel()


@pytest.fixture(scope="module")
def mesh1():
    """A world of one (gloo) and its (1, 1) mesh; torn down after the
    module, since a process group is global to the process."""
    mesh = tsh.make_ccm_mesh((1, 1), ("data", "model"), device_type="cpu")
    yield mesh
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def jmesh():
    return jsh.make_ccm_mesh((1, 1), ("data", "model"))


@pytest.fixture(scope="module")
def E_opt(mesh1):
    return EDM(PANEL, E_max=E_MAX, mesh=mesh1, device="cpu").optimal_E()[0]


# ----------------------------------------------------------- helpers


@pytest.mark.parametrize("S", [1, 2, 3, 4])
@pytest.mark.parametrize("table", [
    [2, 3, 2, 4, 3, 1, 2], [5] * 6, [1, 2, 3, 4, 5, 6, 7, 8], [3, 1]])
def test_egroup_layout_equals_reference(table, S):
    perm, keep, segs = tsh._egroup_layout(torch.tensor(table), S)
    jperm, jkeep, jsegs = jsh._egroup_layout(np.asarray(table, np.int32), S)
    np.testing.assert_array_equal(perm.numpy(), np.asarray(jperm))
    np.testing.assert_array_equal(keep, jkeep)
    assert segs == jsegs


@pytest.mark.parametrize("n,multiple,axis", [
    (5, 4, 0), (5, 5, 0), (7, 2, 0), (3, 4, 1), (1, 3, 0)])
def test_pad_to_multiple_equals_reference(n, multiple, axis):
    x = np.arange(n * 3, dtype=np.float32).reshape((n, 3) if axis == 0
                                                   else (3, n)) + 1
    got = tsh.pad_to_multiple(torch.as_tensor(x), multiple, axis=axis)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jsh.pad_to_multiple(x, multiple, axis=axis)))


@pytest.mark.parametrize("n,multiple", [(5, 4), (4, 4), (1, 3), (7, 2)])
def test_pad_members_equals_reference(n, multiple):
    members = np.arange(10, 10 + n)
    np.testing.assert_array_equal(tsh.pad_members(members, multiple),
                                  jsh.pad_members(members, multiple))


@pytest.mark.parametrize("shape,axes", [
    ({"data": 2, "model": 2}, ("data",)),
    ({"pod": 2, "data": 2, "model": 1}, ("pod", "data")),
    ({"data": 4}, ("data",)), ({"data": 4}, ())])
def test_mesh_axes_size_equals_reference(shape, axes):
    tmesh = types.SimpleNamespace(mesh_dim_names=tuple(shape),
                                  shape=tuple(shape.values()))
    jmesh_ = types.SimpleNamespace(shape=shape)
    assert tsh.mesh_axes_size(tmesh, axes) == jsh.mesh_axes_size(jmesh_,
                                                                  axes)


# ----------------------------------------------------- world of one


def test_world_of_one_ccm_matrix_fixed_E(mesh1, jmesh):
    X = torch.as_tensor(PANEL)
    dt = tsh.sharded_ccm_matrix(X, X, E=3, mesh=mesh1)
    from torch.distributed.tensor import DTensor, Shard
    assert isinstance(dt, DTensor)
    assert tuple(dt.placements) == (Shard(0), Shard(1))
    got = tsh.gather_host(dt)
    np.testing.assert_array_equal(got, dt.full_tensor().numpy())
    np.testing.assert_array_equal(got, core.ccm_group_batched(X, X, E=3))
    want = np.asarray(jsh.sharded_ccm_matrix(PANEL, PANEL, E=3, mesh=jmesh,
                                             impl="ref"))
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_world_of_one_ccm_matrix_E_opt(mesh1, jmesh, E_opt):
    got = tsh.sharded_ccm_matrix(PANEL, PANEL, E_opt=E_opt, mesh=mesh1)
    local = EDM(PANEL, E_max=E_MAX, cache=False, device="cpu")
    np.testing.assert_array_equal(got, local.xmap(E_opt=E_opt))
    want = jsh.sharded_ccm_matrix(PANEL, PANEL, E_opt=E_opt, mesh=jmesh,
                                  impl="ref")
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("mode", ["fixed", "E_opt"])
def test_world_of_one_ccm_convergence(mesh1, jmesh, E_opt, mode):
    X = torch.as_tensor(PANEL)
    kw = dict(E=3) if mode == "fixed" else dict(E_opt=E_opt)
    got = tsh.sharded_ccm_convergence(X[:3], X, lib_sizes=LIB_SIZES,
                                      mesh=mesh1, **kw)
    if mode == "fixed":
        got = tsh.gather_host(got)
    E_t = np.full(7, 3) if mode == "fixed" else E_opt
    local = np.stack([np.stack([core.ccm_convergence(
        x, X[t:t + 1], E=int(E_t[t]), lib_sizes=LIB_SIZES)[:, 0].numpy()
        for t in range(7)], axis=-1) for x in X[:3]], axis=1)
    np.testing.assert_array_equal(got, local)
    want = np.asarray(jsh.sharded_ccm_convergence(
        PANEL[:3], PANEL, lib_sizes=LIB_SIZES, mesh=jmesh, impl="ref", **kw))
    assert got.shape == want.shape == (len(LIB_SIZES), 3, 7)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_world_of_one_optimal_E(mesh1, jmesh):
    E_dt, rho_dt = tsh.sharded_optimal_E(PANEL, E_max=E_MAX, mesh=mesh1)
    E_t, rho_t = tsh.gather_host(E_dt), tsh.gather_host(rho_dt)
    E_l, rho_l = core.optimal_E_batch(torch.as_tensor(PANEL), E_max=E_MAX)
    np.testing.assert_array_equal(E_t, E_l.numpy())
    np.testing.assert_array_equal(rho_t, rho_l.numpy())
    E_j, rho_j = jsh.sharded_optimal_E(PANEL, E_max=E_MAX, mesh=jmesh,
                                       impl="ref")
    np.testing.assert_array_equal(E_t, np.asarray(E_j))
    np.testing.assert_allclose(rho_t, np.asarray(rho_j), rtol=0, atol=ATOL)


def test_world_of_one_smap_theta(mesh1, jmesh):
    got = tsh.gather_host(tsh.sharded_smap_theta(PANEL, E=2, thetas=THETAS,
                                                 mesh=mesh1))
    local = core.smap_theta_sweep(torch.as_tensor(PANEL), E=2, thetas=THETAS)
    np.testing.assert_array_equal(got, local.numpy())
    want = np.asarray(jsh.sharded_smap_theta(PANEL, E=2, thetas=THETAS,
                                             mesh=jmesh, impl="ref"))
    for i, th in enumerate(THETAS):
        np.testing.assert_allclose(got[:, i], want[:, i], rtol=0,
                                   atol=smap_rho_tol(th))


@pytest.mark.parametrize("mode", ["fixed", "E_opt"])
def test_world_of_one_smap_matrix(mesh1, jmesh, E_opt, mode):
    kw = dict(E=3) if mode == "fixed" else dict(E_opt=E_opt)
    got = tsh.sharded_smap_matrix(PANEL, PANEL, mesh=mesh1, **kw)
    X = torch.as_tensor(PANEL)
    if mode == "fixed":
        got = tsh.gather_host(got)
        local = core.smap_group(X, X, E=3).numpy()
    else:
        local = EDM(PANEL, E_max=E_MAX, cache=False, device="cpu").xmap(
            method="smap", E_opt=E_opt)
    np.testing.assert_array_equal(got, local)
    want = np.asarray(jsh.sharded_smap_matrix(PANEL, PANEL, mesh=jmesh,
                                              impl="ref", **kw))
    np.testing.assert_allclose(got, want, rtol=0, atol=(
        SMAP_FIXED_E_TOL if mode == "fixed" else smap_rho_tol(1.0)))


def test_ccm_step_is_the_fixed_E_matrix(mesh1):
    X = torch.as_tensor(PANEL)
    np.testing.assert_array_equal(
        tsh.gather_host(tsh.ccm_step(X, E=2, tau=1, mesh=mesh1)),
        core.ccm_group_batched(X, X, E=2))


@pytest.mark.parametrize("fn", ["ccm_matrix", "ccm_convergence",
                                "smap_matrix"])
def test_bad_arguments_raise_as_the_reference(mesh1, jmesh, fn):
    t_fn = getattr(tsh, f"sharded_{fn}")
    j_fn = getattr(jsh, f"sharded_{fn}")
    extra = dict(lib_sizes=LIB_SIZES) if fn == "ccm_convergence" else {}
    for kw, msg in ((dict(E=2, E_opt=np.full(7, 2)), "exactly one"),
                    ({}, "exactly one")):
        for f, mesh in ((t_fn, mesh1), (j_fn, jmesh)):
            with pytest.raises(ValueError, match=msg):
                f(PANEL, PANEL, mesh=mesh, **extra, **kw)
    for f, mesh in ((t_fn, mesh1), (j_fn, jmesh)):
        with pytest.raises(ValueError, match="length mismatch"):
            f(PANEL, PANEL[:, :150], E=2, mesh=mesh, **extra)


def test_mesh_refusals(mesh1, monkeypatch):
    # a mesh of another size than the world, and a CUDA mesh without CUDA
    with pytest.raises(RuntimeError, match="world of 2 ranks"):
        tsh.make_ccm_mesh((2,), ("data",), device_type="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tsh.make_ccm_mesh((1,), ("data",))
    with pytest.raises(ValueError, match="do not divide"):
        tsh._block(torch.zeros(3, 5), types.SimpleNamespace(
            mesh_dim_names=("data",), shape=(2,), size=lambda i: 2,
            get_local_rank=lambda ax: 0), ("data",), "X")


def test_sharded_telemetry(mesh1, E_opt):
    with telemetry.record() as rec:
        tsh.sharded_ccm_matrix(PANEL, PANEL, E_opt=E_opt, mesh=mesh1)
        tsh.sharded_optimal_E(PANEL, E_max=3, mesh=mesh1)
        tsh.sharded_smap_theta(PANEL, E=2, thetas=THETAS, mesh=mesh1)
    assert rec.counter_delta("edm_sharded_launches") == 3
    (m,) = rec.spans("sharded.ccm_matrix")
    assert m["attrs"]["N_lib"] == 7 and m["attrs"]["fixed_E"] is False
    assert len(rec.spans("sharded.optimal_E")) == 1
    assert rec.spans("sharded.smap_theta")[0]["attrs"]["thetas"] == 3


# ------------------------------------------------ four ranks (gloo)

WORLD_CHILD = r"""
import json, os, sys
import numpy as np
import torch
import torch.distributed as dist
from repro_torch.distributed import sharded_ccm as tsh
from repro_torch.edm import EDM, EDMConfig, runner

rank, world, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
dist.init_process_group("gloo", store=dist.FileStore(
    os.path.join(out, "store"), world), rank=rank, world_size=world)
panel = np.load(os.path.join(out, "panel.npy"))
cfg = json.load(open(os.path.join(out, "cfg.json")))
X = torch.as_tensor(panel)
flags = {}
for name, shape, names, lib_axes, tgt_axes in cfg["meshes"]:
    mesh = tsh.make_ccm_mesh(shape, names, device_type="cpu")
    kw = dict(mesh=mesh, lib_axes=tuple(lib_axes), tgt_axes=tuple(tgt_axes))
    sess = EDM(panel, E_max=cfg["E_max"], device="cpu", **kw)
    res = {}
    res["E_opt"], res["rho_E"] = sess.optimal_E()
    res["xmap"] = sess.xmap()
    res["xmap_smap"] = sess.xmap(method="smap")
    res["smap"] = sess.smap()
    E_opt = res["E_opt"]
    res["ccm_matrix"] = tsh.sharded_ccm_matrix(X, X, E_opt=E_opt, **kw)
    res["smap_matrix"] = tsh.sharded_smap_matrix(X, X, E_opt=E_opt, **kw)
    res["convergence"] = tsh.sharded_ccm_convergence(
        X[:3], X, E_opt=E_opt, lib_sizes=cfg["lib_sizes"], **kw)
    S_l = tsh.mesh_axes_size(mesh, lib_axes)
    S_t = tsh.mesh_axes_size(mesh, tgt_axes)
    res["fixed_ccm"] = tsh.gather_host(tsh.sharded_ccm_matrix(
        tsh.pad_to_multiple(X, S_l), tsh.pad_to_multiple(X, S_t), E=3,
        **kw))[:7, :7]
    E_dt, rho_dt = tsh.sharded_optimal_E(tsh.pad_to_multiple(X, S_l),
                                         E_max=cfg["E_max"], mesh=mesh,
                                         axes=tuple(lib_axes))
    res["opt_E_direct"] = tsh.gather_host(E_dt)[:7]
    res["smap_theta"] = tsh.gather_host(tsh.sharded_smap_theta(
        tsh.pad_to_multiple(X, S_l), E=2, thetas=cfg["thetas"], mesh=mesh,
        axes=tuple(lib_axes)))[:7]
    np.savez(os.path.join(out, f"{name}_rank{rank}.npz"), **res)
    flags[name] = runner.run_key(panel, sess.config, ("xmap", "simplex"))
    try:
        EDMConfig(mesh=mesh, lib_axes=tuple(lib_axes),
                  tgt_axes=tuple(tgt_axes), pad=False, device="cpu",
                  E_max=cfg["E_max"]).validate_panel(*panel.shape)
        flags[name + "_pad_false"] = "accepted"
    except ValueError as e:
        flags[name + "_pad_false"] = str(e)
json.dump(flags, open(os.path.join(out, f"flags_rank{rank}.json"), "w"))
dist.destroy_process_group()
"""

MESHES = [("m22", (2, 2), ("data", "model"), ("data",), ("model",)),
          ("m4", (4,), ("data",), ("data",), ()),
          ("m221", (2, 2, 1), ("pod", "data", "model"), ("pod", "data"),
           ("model",))]


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    out = tmp_path_factory.mktemp("world4")
    np.save(out / "panel.npy", PANEL)
    (out / "cfg.json").write_text(json.dumps(dict(
        meshes=MESHES, E_max=E_MAX, lib_sizes=LIB_SIZES, thetas=THETAS)))
    rcs = spawn_world(WORLD_CHILD, 4, out)
    for r, (rc, err) in enumerate(rcs):
        assert rc == 0, f"rank {r} exited {rc}:\n{err}"
    return out


@pytest.fixture(scope="module")
def one(mesh1):
    """The world of one's results of every call the four ranks make."""
    X = torch.as_tensor(PANEL)
    sess = EDM(PANEL, E_max=E_MAX, mesh=mesh1, device="cpu")
    res = {}
    res["E_opt"], res["rho_E"] = sess.optimal_E()
    res["xmap"] = sess.xmap()
    res["xmap_smap"] = sess.xmap(method="smap")
    res["smap"] = sess.smap()
    E_opt = res["E_opt"]
    res["ccm_matrix"] = tsh.sharded_ccm_matrix(X, X, E_opt=E_opt, mesh=mesh1)
    res["smap_matrix"] = tsh.sharded_smap_matrix(X, X, E_opt=E_opt,
                                                 mesh=mesh1)
    res["convergence"] = tsh.sharded_ccm_convergence(
        X[:3], X, E_opt=E_opt, lib_sizes=LIB_SIZES, mesh=mesh1)
    res["fixed_ccm"] = tsh.gather_host(tsh.sharded_ccm_matrix(X, X, E=3,
                                                              mesh=mesh1))
    res["opt_E_direct"] = tsh.gather_host(tsh.sharded_optimal_E(
        X, E_max=E_MAX, mesh=mesh1)[0])
    res["smap_theta"] = tsh.gather_host(tsh.sharded_smap_theta(
        X, E=2, thetas=THETAS, mesh=mesh1))
    return res


#: S-Map matrices on a mesh that splits the targets: a shard whose share
#: of an E-group is one target solves one right-hand side, and
#: ``torch.linalg.solve_triangular`` rounds a single column on another
#: path than several (measured on the CPU: ≤ 1.5e-6 on these meshes, and
#: no difference between any two counts of two or more columns). Every
#: other result, and these on meshes that keep the targets whole, is held
#: bit-equal.
SOLVE_ONE_RHS_ATOL = 1e-5
SMAP_MATRICES = ("xmap_smap", "smap_matrix")


@pytest.mark.parametrize("rank", range(4))
@pytest.mark.parametrize("mesh", [m[0] for m in MESHES])
def test_four_ranks_bit_equal_to_the_world_of_one(world4, one, mesh, rank):
    got = np.load(world4 / f"{mesh}_rank{rank}.npz")
    assert sorted(got.files) == sorted(one)
    split_targets = mesh == "m22"
    for name, want in one.items():
        if split_targets and name in SMAP_MATRICES:
            np.testing.assert_allclose(got[name], want, rtol=0,
                                       atol=SOLVE_ONE_RHS_ATOL, err_msg=name)
        else:
            np.testing.assert_array_equal(got[name], want, err_msg=name)


@pytest.mark.parametrize("mesh", [m[0] for m in MESHES])
def test_four_ranks_within_atol_of_the_reference_session(world4, mesh):
    got = np.load(world4 / f"{mesh}_rank0.npz")
    js = JEDM(PANEL, impl="ref", E_max=E_MAX)
    E_j, rho_j = js.optimal_E()
    np.testing.assert_array_equal(got["E_opt"], E_j)
    np.testing.assert_allclose(got["rho_E"], rho_j, rtol=0, atol=ATOL)
    np.testing.assert_allclose(got["xmap"], js.xmap(), rtol=0, atol=ATOL)
    np.testing.assert_allclose(got["xmap_smap"], js.xmap(method="smap"),
                               rtol=0, atol=smap_rho_tol(1.0))
    want = js.smap()
    for i, th in enumerate(js.config.thetas):
        np.testing.assert_allclose(got["smap"][:, i], want[:, i], rtol=0,
                                   atol=smap_rho_tol(th))


def test_four_ranks_run_keys_and_pad_false(world4, mesh1):
    flags = [json.loads((world4 / f"flags_rank{r}.json").read_text())
             for r in range(4)]
    assert all(f == flags[0] for f in flags)
    f = flags[0]
    sig = ("xmap", "simplex")
    local = runner.run_key(PANEL, EDM(PANEL, E_max=E_MAX,
                                      device="cpu").config, sig)
    k11 = runner.run_key(PANEL, EDM(PANEL, E_max=E_MAX, mesh=mesh1,
                                    device="cpu").config, sig)
    assert len({local, k11, f["m22"], f["m4"], f["m221"]}) == 5
    # 7 series: no mesh of four ranks divides them, so pad=False refuses
    for name in ("m22", "m4", "m221"):
        assert "do not divide" in f[name + "_pad_false"]
