"""The port's dry run (``repro_torch.launch.dryrun``) against the
reference's (``repro.launch.dryrun``) and against a real world.

* ``input_specs``: every cell's stand-ins of the reference's shapes and
  dtypes (31 model cells and 2 EDM cells at full width);
* the serving specs at ``opt`` 1 and 3: the reference's ``_strip_dp`` and
  K/V replication of its ``param_spec``, for the ten archs on both
  production meshes given as stand-ins (as ``test_torch_sharding.py``);
* the counts of a fake process group equal to those of a real four-rank
  gloo world (llama3-8b's smoke train step and decode at (2, 2));
* the probes' extrapolation equal to direct counts at 3 units, 4
  microbatches and a sequence of 8 to 32 chunks, the peak of live bytes
  within a stated bound;
* the repairs the dry run needed: abstract caches placed on a mesh,
  the MoE on meta tensors, the fake backend admitted for counting only,
  the collectives' result bytes.

``repro.launch.dryrun`` sets ``XLA_FLAGS`` when imported; it is imported
with ``DRYRUN_XLA_FLAGS`` set to the worker's own flags and both variables
restored after, so the worker's flags stay as they were. The fake world
lives in this process for the module and is ended by its fixture.
"""

import dataclasses
import importlib
import json
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.configs import (ARCHS, SHAPES, ShapeConfig, SKIP_CELLS,
                                 TrainConfig, cells, get_config)
from repro_torch.launch import dryrun as dr
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import carry, meshctx
from repro_torch.models import transformer as tf
from torch_mesh import run_world
from torch_threads import one_torch_thread  # noqa: F401


def import_reference(name):
    """Import a reference launcher module, leaving ``XLA_FLAGS`` as it
    was."""
    keep = {k: os.environ.get(k) for k in ("XLA_FLAGS", "DRYRUN_XLA_FLAGS")}
    os.environ["DRYRUN_XLA_FLAGS"] = keep["XLA_FLAGS"] or ""
    try:
        return importlib.import_module(name)
    finally:
        for k, v in keep.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


@pytest.fixture(scope="module", autouse=True)
def end_fake_world():
    yield
    if dist.is_initialized() and str(dist.get_backend()) == "fake":
        dist.destroy_process_group()


def fake_mesh(shape, names):
    """A mesh of ``shape`` over a fake world of its ranks (CPU type)."""
    dr.fake_world(int(np.prod(shape)))
    return make_mesh(shape, names, device_type="cpu")


MESHES = {"pod": ((16, 16), ("data", "model")),
          "multi_pod": ((2, 16, 16), ("pod", "data", "model"))}
SMALL = {"2x2": ((2, 2), ("data", "model")),
         "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}


def leaves(tree, prefix=()):
    """[(path, leaf)] of a tree of dicts, lists and leaves."""
    if isinstance(tree, dict):
        return [x for k in tree for x in leaves(tree[k], prefix + (k,))]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree)
                for x in leaves(v, prefix + (i,))]
    return [(prefix, tree)]


def ref_leaves(tree):
    import jax

    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return [(tuple(k.key if hasattr(k, "key") else k.idx for k in path),
             leaf) for path, leaf in flat]


# ------------------------------------------------------------ input specs


@pytest.mark.parametrize("arch,shape", dr.all_cells())
def test_input_specs_equal(arch, shape):
    rdr = import_reference("repro.launch.dryrun")
    want = {p: (tuple(x.shape), str(x.dtype))
            for p, x in ref_leaves(rdr.input_specs(arch, shape))}
    got = {p: (tuple(x.shape), str(x.dtype).replace("torch.", ""))
           for p, x in leaves(dr.input_specs(arch, shape))}
    assert got == want
    assert all(x.is_meta for _, x in leaves(dr.input_specs(arch, shape)))


def test_decode_specs_on_a_mesh_are_placed():
    """A decode cell's cache on a mesh: DTensors of the reference's whole
    shapes, each holding rank 0's block of meta storage."""
    rdr = import_reference("repro.launch.dryrun")
    mesh = fake_mesh(*SMALL["2x2"])
    want = {p: tuple(x.shape) for p, x in ref_leaves(
        rdr.input_specs("llama3-8b", "decode_32k")["cache"])}
    got = dr.input_specs("llama3-8b", "decode_32k", mesh=mesh)["cache"]
    assert {p: tuple(x.shape) for p, x in leaves(got)} == want
    for _, x in leaves(got):
        assert meshctx.is_dtensor(x) and x.to_local().is_meta
        # batch 128 over "data" (2), the sequence over "model" (2)
        assert x.to_local().shape[1:3] == (64, 16384)


# ------------------------------------------------------- serving specs


def stand_in(kind):
    import types

    shape, names = MESHES[kind]
    return types.SimpleNamespace(shape=dict(zip(names, shape)),
                                 axis_names=names)


@pytest.mark.parametrize("mesh_kind", tuple(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_serving_specs_equal(arch, mesh_kind):
    import jax
    from jax.sharding import PartitionSpec as JP

    from repro.configs import get_config as ref_config
    from repro.launch import sharding as rsh
    from repro.models import transformer as rtf

    rdr = import_reference("repro.launch.dryrun")
    rcfg, pcfg = ref_config(arch), get_config(arch)
    mesh = stand_in(mesh_kind)
    base = jax.tree_util.tree_map_with_path(
        lambda path, leaf: rsh.param_spec(path, leaf, rcfg, mesh),
        rtf.abstract_params(rcfg))
    is_spec = dict(is_leaf=lambda v: isinstance(v, JP))
    stripped = jax.tree.map(rdr._strip_dp, base, **is_spec)

    def repl_kv(path, spec):  # the reference's build_cell, opt >= 3
        names = [q.key for q in path if hasattr(q, "key")]
        if len(names) >= 2 and names[-2] in ("wk", "wv"):
            return JP(*([None] * len(spec)))
        return spec

    ref = {1: stripped,
           3: jax.tree_util.tree_map_with_path(repl_kv, stripped, **is_spec)}
    params = dict(tf.abstract_params(pcfg).named_parameters())
    for opt, tree in ref.items():
        rule = dr.serving_spec(pcfg, mesh, opt)
        flat, _ = jax.tree_util.tree_flatten_with_path(tree, **is_spec)
        seen = set()
        for path, s in flat:
            path = tuple(k.key if hasattr(k, "key") else k.idx
                         for k in path)
            for name, idx in carry.port_names(pcfg, path):
                want = tuple(s)[1:] if idx else tuple(s)
                assert tuple(rule(name, params[name].shape)) == want, (
                    opt, name)
                seen.add(name)
        assert seen == set(params)


# ----------------------------------------------------------- smoke cells

KINDS = {"train": (16, 16), "prefill": (4, 32), "decode": (4, 32)}
RECORD_KEYS = {"arch", "shape", "mesh", "devices", "status", "opt",
               "total_s", "count_s", "cost", "memory", "collectives",
               "counted", "probe", "device_type"}


def smoke_cells():
    out = []
    for arch in ARCHS:
        skip = SKIP_CELLS.get(arch, set())
        for kind in KINDS:
            if kind == "decode" and "decode_32k" in skip:
                continue
            out.append((arch, kind))
    return out


@pytest.mark.parametrize("mesh_kind", tuple(SMALL))
@pytest.mark.parametrize("arch,kind", smoke_cells())
def test_smoke_cells_count(arch, kind, mesh_kind, monkeypatch):
    """Every arch's smoke config, in each of its kinds, builds and counts
    through the probes on a fake mesh; every collective goes through
    ``meshctx`` (the dispatcher's c10d ops equal its counts)."""
    monkeypatch.setenv("DRYRUN_MICROBATCH", "2")
    mesh = fake_mesh(*SMALL[mesh_kind])
    B, S = KINDS[kind]
    rec = dr.run_cell(arch, kind, mesh_kind, mesh=mesh,
                      config=get_config(arch, smoke=True),
                      shape=ShapeConfig(kind, kind, S, B))
    assert rec["status"] == "ok", rec.get("traceback")
    assert set(rec) == RECORD_KEYS
    assert rec["devices"] == int(np.prod(SMALL[mesh_kind][0]))
    assert rec["cost"]["flops"] > 0 and rec["cost"]["bytes accessed"] > 0
    assert set(rec["memory"]) == {
        "argument_size_in_bytes", "output_size_in_bytes",
        "temp_size_in_bytes", "alias_size_in_bytes"}
    col = rec["collectives"]
    assert set(col["counts"]) == set(col["bytes_by_kind"]) == {
        "all-reduce", "all-gather", "reduce-scatter", "all-to-all",
        "collective-permute"}
    assert col["total"] == sum(col["bytes_by_kind"].values())
    port = col["by_port_kind"]["counts"]
    assert sum(col["dispatched"].values()) == sum(port.values()) > 0
    assert col["counts"]["all-reduce"] == port.get(
        "all_reduce_sum", 0) + port.get("all_reduce_max", 0)
    if kind != "prefill":  # the state or the cache updated in place
        assert rec["memory"]["alias_size_in_bytes"] > 0


# ----------------------------------------------- fake world vs real world

B_TRAIN, S_TRAIN, B_DEC, S_DEC = 8, 16, 4, 32

WORLD = """
import json
import numpy as np
from repro_torch.configs import TrainConfig, get_config
from repro_torch.launch import dryrun as dr
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models import carry, meshctx
from repro_torch.models import transformer as tf
from repro_torch.training.carry import init_placed_state

mesh = make_test_mesh((2, 2), ("data", "model"), device_type="cpu")
cfg = get_config("llama3-8b", smoke=True)
tcfg = TrainConfig(microbatch=2)
rng = np.random.default_rng(0)
rec = {}
fn, _ = dr.train_cell(cfg, tcfg, mesh, %(bt)d, %(st)d)
state = init_placed_state(cfg, tcfg, mesh, device="cpu")
toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (%(bt)d, %(st)d)),
                       dtype=torch.int32)
batch = dr._placed_batch(cfg, mesh, {"tokens": toks, "labels": toks})
meshctx.reset_collective_counts()
fn(state, batch)
rec["train"] = [meshctx.collective_counts(), meshctx.collective_bytes()]
fn, _ = dr.serve_cell(cfg, "decode", mesh, %(bd)d, %(sd)d, opt=2)
params = carry.place_params(cfg, mesh, device="cpu",
                            spec=dr.serving_spec(cfg, mesh, 2))
cache = tf.init_cache(cfg, %(bd)d, %(sd)d, device="cpu", mesh=mesh)
tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size, (%(bd)d, 1)),
                         dtype=torch.int32)
meshctx.reset_collective_counts()
fn(params, tokens, cache, 0)
rec["decode"] = [meshctx.collective_counts(), meshctx.collective_bytes()]
(OUT / f"counts{RANK}.json").write_text(json.dumps(rec))
""" % dict(bt=B_TRAIN, st=S_TRAIN, bd=B_DEC, sd=S_DEC)


@pytest.fixture(scope="module")
def gloo_counts(tmp_path_factory):
    d = tmp_path_factory.mktemp("dryrun_world")
    run_world(WORLD, 4, d)
    return [json.loads((d / f"counts{r}.json").read_text())
            for r in range(4)]


def test_fake_counts_equal_a_real_world(gloo_counts):
    """The collectives a fake (2, 2) world counts on meta tensors, by kind
    and result bytes, are those every rank of a real four-rank gloo world
    issues: llama3-8b's smoke train step (two microbatches, the dry run's
    constraints) and a sequence-parallel decode step."""
    mesh = fake_mesh(*SMALL["2x2"])
    cfg = get_config("llama3-8b", smoke=True)
    got = {}
    rec = dr.analyze(*dr.train_cell(cfg, TrainConfig(microbatch=2), mesh,
                                    B_TRAIN, S_TRAIN))
    got["train"] = rec["collectives"]["by_port_kind"]
    rec = dr.analyze(*dr.serve_cell(cfg, "decode", mesh, B_DEC, S_DEC,
                                    opt=2))
    got["decode"] = rec["collectives"]["by_port_kind"]
    for r in range(4):
        for step in ("train", "decode"):
            counts, nbytes = gloo_counts[r][step]
            assert got[step]["counts"] == counts, (r, step)
            assert got[step]["bytes"] == nbytes, (r, step)
    assert got["decode"]["counts"].get("all_reduce_max", 0) > 0  # seqpar


# ----------------------------------------------------------------- probes


# The bound on a probed peak of live bytes against a direct count where
# the probes' lines do not hold it exactly (the phase-16 bound on the card).
PEAK_REL = 0.2


def assert_probes_match(direct, probed, peak_exact):
    """Every count of ``probed`` equal to ``direct``'s (FLOPs by op,
    collectives by kind and bytes, bytes accessed, ops, arguments,
    outputs, aliases); the peak of live bytes equal (``peak_exact``) or
    within ``PEAK_REL``."""
    a, b = dr._flat(direct), dr._flat(probed)
    peak = "temp_size_in_bytes"
    keys = (set(a) | set(b)) - {peak}
    assert {k: a.get(k, 0) for k in keys} == {k: b.get(k, 0) for k in keys}
    assert a["flops"] > 0
    rel = (b[peak] - a[peak]) / a[peak]
    print(f"peak: direct {a[peak]}, probed {b[peak]}, {rel:+.4f}")
    if peak_exact:
        assert b[peak] == a[peak]
    else:
        assert abs(rel) <= PEAK_REL


@pytest.mark.parametrize("arch,kind", [("llama3-8b", "train"),
                                       ("deepseek-v2-lite-16b", "train"),
                                       ("llama3-8b", "decode"),
                                       ("jamba-v0.1-52b", "prefill")])
def test_probes_extrapolate_exactly(arch, kind, monkeypatch):
    """Counts through the probes (1 and 2 units; a train step at 2 and 3
    microbatches) equal a direct count at 3 units and 4 microbatches:
    every count exactly; the peak of live bytes exactly for a train step
    (both lines hold it), within ``PEAK_REL`` otherwise."""
    monkeypatch.setenv("DRYRUN_MICROBATCH", "4")
    mesh = fake_mesh(*SMALL["2x2"])
    smoke = get_config(arch, smoke=True)
    cfg = dataclasses.replace(smoke, n_layers=3 * len(smoke.pattern))
    B, S = {"train": (16, 16), "prefill": (4, 32), "decode": (4, 32)}[kind]
    kw = dict(mesh=mesh, config=cfg, shape=ShapeConfig(kind, kind, S, B))
    direct = dr.count_cell(arch, kind, direct=True, **kw)
    probed = dr.count_cell(arch, kind, **kw)
    assert probed["probe"]["units"] == 3
    assert probed["probe"]["unit_counts"] == [1, 2]
    if kind == "train":
        assert probed["probe"]["microbatches"] == 4
        assert probed["probe"]["microbatch_counts"] == [2, 3]
    assert_probes_match(direct, probed, peak_exact=kind == "train")


def _chunked(cfg, chunk):
    """``cfg`` with its sequence chunk ``chunk``: the attention's (always
    chunked beyond two chunks) or, without attention, its recurrent
    layers'."""
    if cfg.xlstm is not None:
        return dataclasses.replace(cfg, xlstm=dataclasses.replace(
            cfg.xlstm, chunk=chunk))
    return dataclasses.replace(cfg, attn_chunk_q=chunk,
                               attn_full_max=2 * chunk)


@pytest.mark.parametrize("arch,kind,chunk,chunks,units", [
    ("xlstm-125m", "train", 1, 13, None),
    ("xlstm-125m", "prefill", 4, 32, None),
    ("llama3-8b", "prefill", 16, 8, 3),
    ("deepseek-v2-lite-16b", "prefill", 16, 8, None)])
def test_sequence_probes_extrapolate_exactly(arch, kind, chunk, chunks,
                                             units, monkeypatch):
    """Counts through the sequence probes (3, 4 and 5 chunks, each through
    the unit and microbatch probes) equal a direct count of the whole
    sequence: an xLSTM train step of 4 microbatches (xlstm-125m's train_4k
    is counted so), xLSTM and attention prefills, and an MoE prefill
    whose capacity grows with the chunks. Every count exactly; the peak
    of live bytes exactly for the train step, within ``PEAK_REL`` for the
    prefills (the xLSTM prefill's holder changes past the probes)."""
    monkeypatch.setenv("DRYRUN_MICROBATCH", "4")
    mesh = fake_mesh(*SMALL["2x2"])
    cfg = _chunked(get_config(arch, smoke=True), chunk)
    if units is not None:
        cfg = dataclasses.replace(cfg, n_layers=units * len(cfg.pattern))
    B = {"train": 8, "prefill": 4}[kind]
    kw = dict(mesh=mesh, config=cfg,
              shape=ShapeConfig(kind, kind, chunk * chunks, B))
    assert dr.seq_chunks(cfg, kw["shape"]) == (chunk, chunks)
    direct = dr.count_cell(arch, kind, direct=True, **kw)
    probed = dr.count_cell(arch, kind, **kw)
    assert probed["probe"]["seq_chunks"] == chunks
    assert_probes_match(direct, probed, peak_exact=kind == "train")


def test_sequence_probes_of_the_production_cells():
    """The production cells counted through sequence probes: a prefill or
    an attention-free train step, and in an MoE model every probe's and
    the cell's capacity linear in the chunks (a chunk's tokens, times
    top-k and the capacity factor, divide by the experts, and the
    capacity is above its floor of 4)."""
    import fractions

    from repro_torch.models.transformer import ATTN_KINDS

    probed = []
    for arch in ARCHS:
        cfg = get_config(arch)
        for shape in cells(arch):
            got = dr.seq_chunks(cfg, SHAPES[shape])
            if got is None:
                continue
            probed.append((arch, shape))
            assert SHAPES[shape].kind == "prefill" or not any(
                k in ATTN_KINDS for k in cfg.pattern)
            if cfg.moe is None:
                continue
            cq, n_cell = got
            m = cfg.moe
            for n in (*dr.SEQ_PROBES, n_cell):
                c = (fractions.Fraction(cq * n * m.top_k)
                     * fractions.Fraction(str(m.capacity_factor))
                     / m.num_experts)
                assert c.denominator == 1 and c >= 4, (arch, shape, n)
    assert ("xlstm-125m", "train_4k") in probed
    assert len(probed) == 11


def test_edm_probes_extrapolate_exactly():
    """The EDM cell's probes (one and two library batches) equal a direct
    count of a cut panel whose ranks hold eight batches."""
    mesh = fake_mesh(*SMALL["2x2x2"])
    shapes = dict(dr.EDM_SHAPES, tiny=dict(n_series=64, length=300, E=5,
                                           tau=1))
    import repro_torch.core.ccm as cc

    old = (dr.EDM_SHAPES, cc.DEFAULT_BATCH_BUDGET_MB)
    try:
        dr.EDM_SHAPES, cc.DEFAULT_BATCH_BUDGET_MB = shapes, 1
        assert dr.edm_batches("tiny", mesh) == (2, 8)
        direct = dr.count_cell("edm_ccm", "tiny", mesh, direct=True)
        probed = dr.count_cell("edm_ccm", "tiny", mesh)
    finally:
        dr.EDM_SHAPES, cc.DEFAULT_BATCH_BUDGET_MB = old
    a, b = dr._flat(direct), dr._flat(probed)
    a.pop("temp_size_in_bytes"), b.pop("temp_size_in_bytes")
    assert a == b


@pytest.mark.parametrize("arch,kind", [("llama3-8b", "train"),
                                       ("jamba-v0.1-52b", "prefill"),
                                       ("deepseek-v2-lite-16b", "decode")])
def test_flops_are_flop_counter_modes(arch, kind):
    """The dry run counts FLOPs with ``FlopCounterMode``'s formulas in its
    own dispatch mode: the same totals, op by op, as ``FlopCounterMode``
    on the same step."""
    from torch.utils.flop_counter import FlopCounterMode

    mesh = fake_mesh(*SMALL["2x2"])
    cfg = get_config(arch, smoke=True)
    B, S = KINDS[kind]

    def cell():
        if kind == "train":
            return dr.train_cell(cfg, TrainConfig(microbatch=2), mesh, B, S)
        return dr.serve_cell(cfg, kind, mesh, B, S)

    got = dr.analyze(*cell())["cost"]
    fn, args = cell()
    with FlopCounterMode(display=False) as fc:
        fn(*args)
    assert got["flops"] == fc.get_total_flops() > 0
    assert got["flops_by_op"] == {
        str(k): v for k, v in fc.get_flop_counts()["Global"].items()}


# ----------------------------------------------------------------- repairs


def test_abstract_placed_cache_has_the_real_blocks():
    """``init_cache(..., abstract=True, mesh=)``: meta DTensors placed by
    ``cache_specs`` whose blocks are the real placed cache's, for a
    stacked (llama3) and a per-unit recurrent (xlstm) layout."""
    mesh = fake_mesh(*SMALL["2x2"])
    for arch in ("llama3-8b", "xlstm-125m", "deepseek-v2-lite-16b"):
        cfg = get_config(arch, smoke=True)
        real = tf.init_cache(cfg, 4, 16, device="cpu", mesh=mesh)
        meta = tf.init_cache(cfg, 4, 16, abstract=True, mesh=mesh)
        real, meta = leaves(real), leaves(meta)
        assert [p for p, _ in real] == [p for p, _ in meta]
        for (p, r), (_, m) in zip(real, meta):
            assert meshctx.is_dtensor(m) and m.to_local().is_meta, p
            assert list(m.placements) == list(r.placements), p
            assert m.shape == r.shape and m.dtype == r.dtype, p
            assert m.to_local().shape == r.to_local().shape, p


def test_moe_counts_are_static_and_run_on_meta():
    """The experts' counts (a static-shape scatter) equal ``bincount``'s,
    and an MoE train step runs on meta tensors with no mesh."""
    from repro_torch.models import moe

    g = torch.Generator().manual_seed(0)
    xf = torch.randn(40, 16, generator=g)
    router = torch.randn(16, 8, generator=g)
    se, st, pos, wts, counts, probs = moe._route(xf, router, 2, 8, 1.25)
    want = torch.bincount(torch.sort(probs, dim=-1, descending=True,
                                     stable=True).indices[:, :2].reshape(-1),
                          minlength=8)
    assert torch.equal(counts, want) and counts.dtype == torch.int64
    cfg = get_config("deepseek-v2-lite-16b", smoke=True)
    rec = dr.analyze(*dr.train_cell(cfg, TrainConfig(), None, 4, 16))
    assert rec["cost"]["flops"] > 0
    assert rec["collectives"]["total"] == 0


def test_fake_backend_counts_only():
    """Over a fake world the production meshes build, ``ccm_step`` takes
    a meta panel, and any input holding values raises (the fake group
    never delivers results)."""
    from repro_torch.distributed import sharded_ccm
    from repro_torch.launch.mesh import make_production_mesh

    for kind, shape in (("single", (16, 16)), ("multi", (2, 16, 16))):
        dr.fake_world(dr.MESH_RANKS[kind])
        mesh = make_production_mesh(multi_pod=kind == "multi",
                                    device_type="cpu")
        assert tuple(mesh.shape) == shape
    mesh = fake_mesh(*SMALL["2x2"])
    X = torch.empty((8, 40), device="meta")
    rho = sharded_ccm.ccm_step(X, E=2, tau=1, mesh=mesh, impl="ref")
    assert meshctx.is_dtensor(rho) and rho.shape == (8, 8)
    assert rho.to_local().is_meta
    for bad in (torch.zeros(8, 40), np.zeros((8, 40), np.float32)):
        with pytest.raises(ValueError, match="only counts"):
            sharded_ccm.ccm_step(bad, E=2, tau=1, mesh=mesh, impl="ref")


def test_collective_bytes_are_the_results_bytes():
    mesh = fake_mesh(*SMALL["2x2"])
    t = torch.empty((3, 4), device="meta")
    meshctx.reset_collective_counts()
    meshctx.all_gather(t, "model", 0, mesh)
    meshctx.all_reduce(t, ("data", "model"), mesh=mesh)
    meshctx.all_reduce(t, "model", op="max", mesh=mesh)
    meshctx._c10d_reduce_scatter(torch.empty((4, 4), device="meta"),
                                 "data", 0, mesh)
    assert meshctx.collective_bytes() == {
        "all_gather": 2 * 48, "all_reduce_sum": 2 * 48,
        "all_reduce_max": 48, "reduce_scatter": 32}
    assert meshctx.collective_counts() == {
        "all_gather": 1, "all_reduce_sum": 2, "all_reduce_max": 1,
        "reduce_scatter": 1}


def test_cli_writes_the_reference_file_names(tmp_path):
    """``main`` on one decode cell and one EDM cell of the production
    mesh: the reference's file names and a ``status: ok`` record each."""
    dr.main(["--arch", "xlstm-125m", "--shape", "decode_32k", "--mesh",
             "single", "--device", "cpu", "--out", str(tmp_path)])
    dr.main(["--arch", "edm_ccm", "--shape", "ccm_subject6", "--mesh",
             "multi", "--device", "cpu", "--out", str(tmp_path)])
    names = sorted(p.name for p in tmp_path.iterdir())
    assert names == ["edm_ccm__ccm_subject6__multi.json",
                     "xlstm-125m__decode_32k__single.json"]
    for p in tmp_path.iterdir():
        rec = json.loads(p.read_text())
        assert rec["status"] == "ok" and rec["devices"] in (256, 512)
    assert len(dr.all_cells()) == 33
    assert sum(len(cells(a)) for a in ARCHS) == 31
    assert set(SHAPES) >= {s for a in ARCHS for s in cells(a)}
