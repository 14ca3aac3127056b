"""Port vs reference: ``EDM`` sessions on a mesh, on the CPU.

``repro_torch.edm.EDM(panel, EDMConfig(mesh=...), device="cpu")`` on a
gloo world: a world of one in this process (made by ``make_ccm_mesh`` and
torn down after the module), and two ranks spawned as child processes on a
``FileStore`` under ``tmp_path`` for the journaled mesh run. The session
methods on a world of one are bit-equal to a ``cache=False`` local
session's (the engines beneath are the same), and E_opt and ρ are held to
the JAX reference's session as in tests/test_torch_session.py.
"""

import json
import os
import signal

import numpy as np
import pytest
import torch.distributed as dist

from repro.data import timeseries as ts
from repro.distributed import sharded_ccm as jsh
from repro.edm import EDM as JEDM
from repro.edm import EDMConfig as JEDMConfig
from repro_torch.distributed import sharded_ccm as tsh
from repro_torch.edm import EDM, EDMConfig, runner
from torch_world import spawn_world

ATOL = 1e-5
E_MAX = 6


def _panel() -> np.ndarray:
    net, _ = ts.forced_network_panel(6, 200, seed=9)
    return np.concatenate([net[:5], ts.tent_map_panel(1, 200, seed=9),
                           ts.lorenz63(200)[:1]]).astype(np.float32)


PANEL = _panel()


@pytest.fixture(scope="module")
def mesh1():
    mesh = tsh.make_ccm_mesh((1, 1), ("data", "model"), device_type="cpu")
    yield mesh
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def pair(mesh1):
    """(mesh session, cache=False local session, reference session)."""
    return (EDM(PANEL, E_max=E_MAX, mesh=mesh1, device="cpu"),
            EDM(PANEL, E_max=E_MAX, cache=False, device="cpu"),
            JEDM(PANEL, impl="ref", E_max=E_MAX))


# ------------------------------------------------------------ config


def test_config_refuses_what_is_not_a_mesh_of_its_axes(mesh1):
    with pytest.raises(ValueError, match="DeviceMesh"):
        EDMConfig(mesh=object(), device="cpu")
    with pytest.raises(ValueError, match="missing 'pod'"):
        EDMConfig(mesh=mesh1, lib_axes=("pod", "data"), device="cpu")
    with pytest.raises(ValueError, match="missing 'model2'"):
        EDMConfig(mesh=mesh1, tgt_axes=("model2",), device="cpu")
    # the mesh's device type must be the session's: no CPU fallback
    with pytest.raises(ValueError, match="cpu mesh for device='cuda'"):
        EDMConfig(mesh=mesh1)
    cfg = EDMConfig(mesh=mesh1, device="cpu", pad=False)
    assert cfg.mesh_axis_size(cfg.lib_axes) == 1
    cfg.validate_panel(7, 200)  # a mesh of one divides every panel


def test_plan_of_a_mesh_session_equals_the_reference(mesh1):
    sess = EDM(PANEL, E_max=E_MAX, mesh=mesh1, device="cpu")
    js = JEDM(PANEL, JEDMConfig(E_max=E_MAX, impl="ref",
                                mesh=jsh.make_ccm_mesh((1, 1),
                                                       ("data", "model"))))
    tasks = ("optimal_E", "smap", "xmap", "simplex")
    for s in (sess, js):
        assert s.plan("xmap").placement == "sharded"
    before = [(sess.plan(t).describe(), js.plan(t).describe())
              for t in tasks]
    sess.optimal_E()
    js.optimal_E()
    after = [(sess.plan(t).describe(), js.plan(t).describe())
             for t in tasks]
    for got, want in before + after:
        assert got == want
    assert sess.plan("optimal_E").detail == "sharded_optimal_E"


def test_run_key_differs_by_placement(mesh1):
    sig = ("xmap", "simplex", None, b"")
    local = runner.run_key(PANEL, EDMConfig(device="cpu"), sig)
    mesh = runner.run_key(PANEL, EDMConfig(mesh=mesh1, device="cpu"), sig)
    assert local != mesh
    assert "mesh=(('data', 1), ('model', 1))/lib=('data',)/tgt=('model',)" \
        in runner.config_fingerprint(EDMConfig(mesh=mesh1, device="cpu"))


# ------------------------------------------------ the session's methods


def test_optimal_E_and_simplex_on_a_mesh(pair):
    sess, local, js = pair
    E_s, rho_s = sess.optimal_E()
    E_l, rho_l = local.optimal_E()
    np.testing.assert_array_equal(E_s, E_l)
    np.testing.assert_array_equal(rho_s, rho_l)
    E_j, rho_j = js.optimal_E()
    np.testing.assert_array_equal(E_s, E_j)
    np.testing.assert_allclose(rho_s, rho_j, rtol=0, atol=ATOL)
    for E in (None, 3):
        np.testing.assert_array_equal(sess.simplex(E), local.simplex(E))
    np.testing.assert_allclose(sess.simplex(3), js.simplex(3), rtol=0,
                               atol=ATOL)
    assert "master" not in sess._cache  # a mesh session holds no master


@pytest.mark.parametrize("method", ["simplex", "smap"])
def test_xmap_on_a_mesh(pair, method):
    sess, local, js = pair
    got = sess.xmap(method=method)
    np.testing.assert_array_equal(got, local.xmap(method=method))
    np.testing.assert_allclose(got, js.xmap(method=method), rtol=0,
                               atol=ATOL if method == "simplex" else 1e-4)


def test_smap_on_a_mesh(pair):
    sess, local, js = pair
    got = sess.smap()
    np.testing.assert_array_equal(got, local.smap())
    want = js.smap()
    for i, th in enumerate(sess.config.thetas):
        np.testing.assert_allclose(got[:, i], want[:, i], rtol=0,
                                   atol=1e-4 if th <= 4.0 else 3e-3)


def test_pairwise_methods_on_a_mesh(pair):
    sess, local, js = pair
    np.testing.assert_array_equal(sess.ccm(0, 1, lib_sizes=(40, 120)),
                                  local.ccm(0, 1, lib_sizes=(40, 120)))
    assert sess.ccm(2, 3) == local.ccm(2, 3)
    np.testing.assert_allclose(sess.ccm(2, 3), js.ccm(2, 3), atol=ATOL)
    pairs = [(0, 1), (3, 2), (6, 0)]
    np.testing.assert_array_equal(sess.ccm_batch(pairs, E=2),
                                  local.ccm_batch(pairs, E=2))
    a = sess.surrogate_test(0, 1, num_surrogates=9, seed=2)
    b = local.surrogate_test(0, 1, num_surrogates=9, seed=2)
    assert (a.rho, a.pvalue) == (b.rho, b.pvalue)
    np.testing.assert_array_equal(a.surrogate_rho, b.surrogate_rho)


def test_journaled_mesh_run_in_one_process(pair, tmp_path):
    sess, _, _ = pair
    plain = sess.xmap()
    np.testing.assert_array_equal(sess.xmap(run_dir=str(tmp_path / "a")),
                                  plain)
    before = sess.stats["runs_short_circuited"]
    np.testing.assert_array_equal(sess.xmap(run_dir=str(tmp_path / "a")),
                                  plain)
    assert sess.stats["runs_short_circuited"] == before + 1
    report = json.loads((tmp_path / "a" / "report.json").read_text())
    assert report["status"] == "complete" and report["tiles_committed"] == 7
    # a journal written by a local run is stale for a mesh run
    local = EDM(PANEL, E_max=E_MAX, device="cpu")
    local.xmap(run_dir=str(tmp_path / "b"))
    with pytest.raises(ValueError, match="DIFFERENT run"):
        sess.xmap(run_dir=str(tmp_path / "b"))


def test_journaled_mesh_run_preempted_and_resumed_in_one_process(
        mesh1, tmp_path, monkeypatch):
    sess = EDM(PANEL, E_max=E_MAX, mesh=mesh1, device="cpu",
               run_tile_rows=2)
    plain = sess.xmap(method="smap")
    orig, calls = tsh._egrouped_matrix, [0]

    def wrapped(*a, **k):
        calls[0] += 1
        if calls[0] == 2:
            os.kill(os.getpid(), signal.SIGTERM)
        return orig(*a, **k)

    monkeypatch.setattr(tsh, "_egrouped_matrix", wrapped)
    with pytest.raises(SystemExit) as exc:
        sess.xmap(method="smap", run_dir=str(tmp_path))
    assert exc.value.code == runner.PREEMPTED_EXIT
    monkeypatch.setattr(tsh, "_egrouped_matrix", orig)
    again = EDM(PANEL, E_max=E_MAX, mesh=mesh1, device="cpu",
                run_tile_rows=3)  # 3 rows a tile now: same bits
    np.testing.assert_array_equal(again.xmap(method="smap",
                                             run_dir=str(tmp_path)), plain)
    assert again.stats["rows_resumed"] == 2


# ------------------------------------------- two ranks, journaled (gloo)

JOURNAL_CHILD = r"""
import os, signal, sys
import numpy as np
import torch.distributed as dist
from repro_torch.distributed import sharded_ccm as tsh
from repro_torch.edm import EDM

rank, world, out, mode, tile = (int(sys.argv[1]), int(sys.argv[2]),
                                sys.argv[3], sys.argv[4], int(sys.argv[5]))
dist.init_process_group("gloo", store=dist.FileStore(
    os.path.join(out, "store_" + mode), world), rank=rank, world_size=world)
panel = np.load(os.path.join(out, "panel.npy"))
mesh = tsh.make_ccm_mesh((2, 1), ("data", "model"), device_type="cpu")
sess = EDM(panel, E_max=6, mesh=mesh, device="cpu", run_tile_rows=tile)
run_dir = os.path.join(out, "run")
if mode == "first":
    np.save(os.path.join(out, f"plain_rank{rank}.npy"), sess.xmap())
    np.save(os.path.join(out, f"full_rank{rank}.npy"),
            sess.xmap(run_dir=os.path.join(out, "full")))
    block, hits = tsh._local_block, [0]
    def oom_once(*a, **k):  # rank 1 runs out of memory in its first block
        hits[0] += 1
        if rank == 1 and hits[0] == 1:
            raise MemoryError("out of memory (injected)")
        return block(*a, **k)
    tsh._local_block = oom_once
    np.save(os.path.join(out, f"oom_rank{rank}.npy"),
            sess.xmap(run_dir=os.path.join(out, "oom")))
    tsh._local_block = block
    orig, calls = tsh._egrouped_matrix, [0]
    def wrapped(*a, **k):  # SIGTERM to rank 0 as its second tile launches
        calls[0] += 1
        if rank == 0 and calls[0] == 2:
            os.kill(os.getpid(), signal.SIGTERM)
        return orig(*a, **k)
    tsh._egrouped_matrix = wrapped
    sess.xmap(run_dir=run_dir)  # exits 17 on every rank
    sys.exit(3)
np.save(os.path.join(out, f"resumed_rank{rank}.npy"),
        sess.xmap(run_dir=run_dir))
np.save(os.path.join(out, f"rows_resumed_rank{rank}.npy"),
        np.asarray([sess.stats["rows_resumed"]]))
dist.destroy_process_group()
"""


def test_two_rank_journaled_mesh_run_preempted_and_resumed(tmp_path):
    """Rank 0 alone writes ``run_dir``; an out-of-memory error on rank 1
    halves the tile on both ranks; a SIGTERM to rank 0 stops both ranks
    at the same tile with exit 17; two new ranks resume at another
    ``run_tile_rows`` bit-identically to the plain mesh run."""
    np.save(tmp_path / "panel.npy", PANEL)
    rcs = spawn_world(JOURNAL_CHILD, 2, tmp_path, "first", 2)
    assert [rc for rc, _ in rcs] == [17, 17], rcs
    plain = np.load(tmp_path / "plain_rank0.npy")
    for r in range(2):
        np.testing.assert_array_equal(np.load(tmp_path / f"plain_rank{r}.npy"),
                                      plain)
        np.testing.assert_array_equal(np.load(tmp_path / f"full_rank{r}.npy"),
                                      plain)
        np.testing.assert_array_equal(np.load(tmp_path / f"oom_rank{r}.npy"),
                                      plain)
    oom = json.loads((tmp_path / "oom" / "report.json").read_text())
    assert [(o["action"], o["B"], o["to_B"]) for o in oom["oom_backoff"]] \
        == [("halve", 2, 1)]
    assert "another rank" in oom["oom_backoff"][0]["error"]
    manifest = json.loads((tmp_path / "run" / "run.json").read_text())
    assert manifest["status"] == "preempted"
    rcs = spawn_world(JOURNAL_CHILD, 2, tmp_path, "resume", 4)
    assert [rc for rc, _ in rcs] == [0, 0], rcs
    for r in range(2):
        np.testing.assert_array_equal(
            np.load(tmp_path / f"resumed_rank{r}.npy"), plain)
        assert np.load(tmp_path / f"rows_resumed_rank{r}.npy")[0] == 2
    report = json.loads((tmp_path / "run" / "report.json").read_text())
    assert report["status"] == "complete" and report["rows_resumed"] == 2
    assert len(report["prior_run_ids"]) == 1
    js = JEDM(PANEL, impl="ref", E_max=E_MAX)
    np.testing.assert_allclose(plain, js.xmap(), rtol=0, atol=ATOL)
