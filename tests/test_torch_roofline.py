"""The port's roofline report (``repro_torch.launch.roofline``) against the
reference's (``repro.launch.roofline``).

* ``edm_analytic`` and ``model_flops`` equal the reference's for every
  cell;
* ``build_report`` on the same record files gives the reference's rows
  when the port's H100 rates are replaced by the reference's v5e ones;
  with the H100 rates each term is its count over its rate;
* the FLOPs the dry run counts for a no-mesh smoke train step equal a
  reckoning written out term by term (the matrices' forward, backward
  and recompute, the float32 head, and every chunk pair the chunked
  attention computes);
* ``--probe``'s units' line read off dry-run records, a sequence-probed
  one included.

``repro.launch.roofline`` (and the dry run it imports) sets ``XLA_FLAGS``
when imported; both are imported with ``DRYRUN_XLA_FLAGS`` set to the
worker's own flags, and the variables restored after.
"""

import dataclasses
import importlib
import json
import os

import pytest

from repro_torch.configs import ARCHS, SHAPES, TrainConfig, cells, get_config
from repro_torch.launch import dryrun as dr
from repro_torch.launch import roofline as rl
from torch_threads import one_torch_thread  # noqa: F401


def import_reference(name):
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


LM_CELLS = [(a, s) for a in ARCHS for s in cells(a)]


def test_the_reference_flags_are_left_as_they_were():
    before = os.environ.get("XLA_FLAGS")
    import_reference("repro.launch.roofline")
    assert os.environ.get("XLA_FLAGS") == before


@pytest.mark.parametrize("chips", (256, 512))
@pytest.mark.parametrize("shape", tuple(dr.EDM_SHAPES))
def test_edm_analytic_equal(shape, chips):
    rrl = import_reference("repro.launch.roofline")
    assert rl.edm_analytic(shape, chips) == rrl.edm_analytic(shape, chips)
    assert rl.EDM_E == rrl.EDM_E
    assert dr.EDM_SHAPES == import_reference("repro.launch.dryrun").EDM_SHAPES


@pytest.mark.parametrize("arch,shape", LM_CELLS)
def test_model_flops_equal(arch, shape):
    rrl = import_reference("repro.launch.roofline")
    assert rl.model_flops(arch, shape) == rrl.model_flops(arch, shape)


def write_records(root, rng):
    """Single-pod dry-run records for every cell (random counts), and
    probe files for every other model cell and the EDM cells."""
    dry, probes = root / "dryrun", root / "probes"
    dry.mkdir()
    probes.mkdir()
    cells_ = LM_CELLS + [(dr.EDM_ARCH, s) for s in dr.EDM_SHAPES]
    for i, (arch, shape) in enumerate(cells_):
        rec = {"arch": arch, "shape": shape, "mesh": "single",
               "status": "ok",
               "cost": {"flops": float(rng.integers(1, 10**15)),
                        "bytes accessed": float(rng.integers(1, 10**13))},
               "collectives": {"total": float(rng.integers(0, 10**11))},
               "memory": {"temp_size_in_bytes": int(rng.integers(
                   0, 10**11))}}
        (dry / f"{arch}__{shape}__single.json").write_text(json.dumps(rec))
        if arch == dr.EDM_ARCH:
            probe = rl.edm_analytic(shape, 256)
        elif i % 2:
            continue
        else:
            probe = {k: {"total": float(rng.integers(1, 10**14))}
                     for k in ("flops", "bytes", "coll")}
        (probes / f"{arch}__{shape}.json").write_text(json.dumps(probe))
    return dry, probes


def test_build_report_rows_equal_at_v5e_rates(tmp_path, rng, monkeypatch):
    rrl = import_reference("repro.launch.roofline")
    dry, probes = write_records(tmp_path, rng)
    want = rrl.build_report(str(dry), str(probes), str(tmp_path / "r.json"))
    monkeypatch.setattr(rl, "H100_BF16_FLOPS", rrl.V5E_FLOPS)
    monkeypatch.setattr(rl, "H100_HBM_BW", rrl.V5E_BW)
    monkeypatch.setattr(rl, "H100_COLL_BW", rrl.ICI_BW)
    got = rl.build_report(str(dry), str(probes), str(tmp_path / "p.json"))
    assert len(got) == len(want) == 33
    assert {r["corrected"] for r in got} == {True, False}
    for g, w in zip(got, want):
        assert {k: g[k] for k in w} == w
    assert json.loads((tmp_path / "p.json").read_text()) == got


def test_build_report_terms_are_counts_over_h100_rates(tmp_path, rng):
    assert (rl.H100_BF16_FLOPS, rl.H100_HBM_BW, rl.H100_COLL_BW) == (
        989e12, 3.35e12, 50e9)
    dry, probes = write_records(tmp_path, rng)
    rows = rl.build_report(str(dry), str(probes), str(tmp_path / "p.json"))
    for r in rows:
        rec = json.loads((dry / f"{r['arch']}__{r['shape']}__single.json")
                         .read_text())
        pf = probes / f"{r['arch']}__{r['shape']}.json"
        if pf.exists():
            p = json.loads(pf.read_text())
            f, b, c = (p[k]["total"] for k in ("flops", "bytes", "coll"))
        else:
            f, b = rec["cost"]["flops"], rec["cost"]["bytes accessed"]
            c = rec["collectives"]["total"]
        assert r["t_compute_s"] == f / 989e12
        assert r["t_memory_s"] == b / 3.35e12
        assert r["t_collective_s"] == c / 50e9
        terms = {"compute": r["t_compute_s"], "memory": r["t_memory_s"],
                 "collective": r["t_collective_s"]}
        assert r["dominant"] == max(terms, key=terms.get)
        assert r["rates"].startswith("reckoned at H100 SXM rates")


def test_probe_of_a_dryrun_record():
    """``--probe`` reads a cell's units' line from its dry-run record: the
    total, and c0 + U·cu through the one-unit point."""
    rec = {"count_s": 1.0, "cost": {"flops": 130, "bytes accessed": 70},
           "collectives": {"total": 40},
           "probe": {"units": 4, "microbatches": 8, "points": {
               "1": {"flops": 40, "bytes accessed": 25, "bytes:all-gather": 7,
                     "bytes:all-reduce": 3}}}}
    p = rl._probe_of(rec, "llama3-8b", "train_4k", 0)
    assert p["flops"] == {"c0": 10, "cu": 30, "total": 130}
    assert p["bytes"] == {"c0": 10, "cu": 15, "total": 70}
    assert p["coll"] == {"c0": 0, "cu": 10, "total": 40}
    assert (p["U"], p["M"]) == (4, 8)


def test_train_step_flops_reckoned_term_by_term():
    """A no-mesh train step of llama3-8b's smoke config (B 2 × S 64, the
    chunked attention: 16-token chunks past 16 tokens), counted by the dry
    run, term by term:

    * the units' matrices, 6·N·T (forward, backward) and 2·(N − N_down)·T
      for the unit's recompute, which stops once it has remade what the
      backward needs (``torch.utils.checkpoint``'s early stop: the MLP's
      output projection, the unit's last product, is not remade);
    * the float32 head, 6·V·D·T (outside the recompute);
    * the chunked attention's every (query, key) chunk pair, the masked
      ones included: QKᵀ and PV, five times a layer (forward, the unit's
      recompute, the chunks' own recompute, backward twice)."""
    cfg = dataclasses.replace(get_config("llama3-8b", smoke=True),
                              attn_chunk_q=16, attn_full_max=16)
    B, S = 2, 64
    rec = dr.analyze(*dr.train_cell(cfg, TrainConfig(), None, B, S))
    T = B * S
    from repro_torch.models import transformer as tf

    params = dict(tf.abstract_params(cfg).named_parameters())
    n_units = sum(p.numel() for n, p in params.items()
                  if n.startswith("units.") and p.ndim == 2)
    n_down = sum(p.numel() for n, p in params.items()
                 if n.endswith("mlp.w_down.w"))
    head = cfg.vocab_size * cfg.d_model
    nq, cq, d = S // 16, 16, cfg.d_head
    pair = 2 * B * cfg.n_heads * cq * cq * (d + d)  # QKᵀ and PV
    attn = 5 * cfg.n_layers * nq * nq * pair
    matrices = 6 * n_units * T + 2 * (n_units - n_down) * T + 6 * head * T
    assert rec["cost"]["flops_by_op"] == {"aten.mm": matrices,
                                          "aten.bmm": attn}
    assert rec["cost"]["flops"] == matrices + attn
    assert SHAPES["train_4k"].kind == "train"


def test_probe_of_a_sequence_probed_record():
    """A prefill counted through sequence probes: ``--probe``'s units' line
    is taken at the cell's own length (each unit point fitted along the
    sequence), equal to direct counts at one and two units."""
    from repro_torch.configs import ShapeConfig

    smoke = get_config("llama3-8b", smoke=True)
    cfg = dataclasses.replace(smoke, n_layers=3, attn_chunk_q=16,
                              attn_full_max=32)
    sc = ShapeConfig("prefill", "prefill", 16 * 8, 4)
    rec = dr.count_cell("llama3-8b", "prefill", None, config=cfg, shape=sc)
    assert rec["probe"]["seq_chunks"] == 8
    p = rl._probe_of(rec, "llama3-8b", "prefill", 0)
    direct = {u: dr.count_cell("llama3-8b", "prefill", None, direct=True,
                               config=dataclasses.replace(cfg, n_layers=u),
                               shape=sc)["cost"]["flops"] for u in (1, 2)}
    assert p["flops"]["cu"] == direct[2] - direct[1]
    assert p["flops"]["c0"] + 3 * p["flops"]["cu"] == p["flops"]["total"] \
        == rec["cost"]["flops"]
