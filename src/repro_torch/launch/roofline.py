"""Roofline report (the port of ``repro.launch.roofline``).

Derives the three roofline terms of each (arch × shape) cell from the
dry run's counts of one rank (``launch.dryrun``), reckoned at H100 SXM
rates:

    compute    = FLOPs / H100_BF16_FLOPS            [989e12 FLOP/s bf16 dense]
    memory     = bytes accessed / H100_HBM_BW       [3.35e12 B/s HBM3]
    collective = collective bytes / H100_COLL_BW    [50e9 B/s a card]

The collective rate is one 400 Gb/s NDR InfiniBand port a GPU, as in a DGX
H100: every collective of the production meshes spans 16 or more ranks,
so it crosses hosts of 8 cards. NVLink's 450 GB/s each way inside a host
is the figure not used. These are reckonings from the card's
published rates, not measurements; every row says so (``rates``).

The reference probes each cell at 1 and 2 units because XLA's cost
analysis counts a scan body once. The port counts eagerly and sees every
unit; it keeps the probes because an eager count costs time per op, and
the counts at 1 and 2 units (and, for a train cell, at 2 and 3
microbatches) give the cell's exactly (``dryrun.probe``).
``--probe`` takes the probe of a cell from its single-pod dry-run record
when ``--dryrun`` holds one (the dry run counts through the same probes),
and counts it otherwise. EDM cells use analytic kernel formulas, as in
the reference (the port's dry run counts their plain versions, whose
element-wise distance chains the FLOP counter does not see).

Usage:
  python -m repro_torch.launch.roofline --probe --out experiments/roofline \\
      [--dryrun experiments/dryrun] [--device cpu]
  python -m repro_torch.launch.roofline --report --dryrun experiments/dryrun \\
      --out experiments/roofline
"""

from __future__ import annotations

import argparse
import json
import os

from repro_torch.configs import ARCHS, SHAPES, cells, get_config
from repro_torch.launch import dryrun as dr
from repro_torch.models.meshctx import set_mesh

H100_BF16_FLOPS = 989e12   # dense bf16 tensor-core peak, H100 SXM
H100_HBM_BW = 3.35e12      # HBM3, H100 SXM
H100_COLL_BW = 50e9        # one 400 Gb/s NDR port a GPU (DGX H100)
RATES = ("reckoned at H100 SXM rates: 989e12 FLOP/s bf16, 3.35e12 B/s "
         "HBM3, 50e9 B/s a card for collectives")


def _probe_of(rec: dict, arch: str, shape_name: str, opt: int) -> dict:
    """The reference's probe record from a counted one: each term's
    ``total`` with its units' line ``c0 + U·cu`` at the cell's
    microbatches."""
    probe = rec["probe"]
    U = probe.get("units", 1)
    out = {"arch": arch, "shape": shape_name, "U": U, "opt": opt,
           "M": probe.get("microbatches"), "count_s": rec["count_s"]}
    pts = probe["points"]
    if "seq_points" in probe:  # the unit points at the cell's sequence
        pts = {u: dr.fit_seq([probe["seq_points"][str(n)]["points"][u]
                              for n in dr.SEQ_PROBES], probe["seq_chunks"])
               for u in pts}
    keys = {"flops": "flops", "bytes": "bytes accessed"}
    for key, flat_key in keys.items():
        total = rec["cost"][flat_key]
        cu = (total - pts["1"][flat_key]) // (U - 1) if U > 1 else 0
        out[key] = dict(c0=total - U * cu, cu=cu, total=total)
    coll = rec["collectives"]["total"]
    c1 = sum(v for k, v in pts["1"].items() if k.startswith("bytes:"))
    cu = (coll - c1) // (U - 1) if U > 1 else 0
    out["coll"] = dict(c0=coll - U * cu, cu=cu, total=coll)
    return out


def probe_cell(arch: str, shape_name: str, mesh, opt: int = 0) -> dict:
    """Linear-model coefficients for one cell (single-pod mesh): counts at
    1 and 2 units (and 2 and 3 microbatches of a train cell), through
    ``dryrun.count_cell``."""
    rec = dr.count_cell(arch, shape_name, mesh, opt=opt)
    return _probe_of(rec, arch, shape_name, opt)


EDM_E = {"ccm_pairwise": 20, "ccm_subject6": 10}


def edm_analytic(shape_name: str, chips: int) -> dict:
    """Analytic per-device kernel costs for the CCM cells (ref path)."""
    p = dr.EDM_SHAPES[shape_name]
    N, L, E = p["n_series"], p["length"], p["E"]
    Lp = L - (E - 1)
    k = E + 1
    libs_per_dev = N / (chips / 16)  # lib axes = data(+pod); model=16
    tgts_per_dev = N / 16
    per_lib_flops = 3.0 * E * Lp * Lp + k * Lp * Lp \
        + 2.0 * k * Lp * tgts_per_dev + 10.0 * Lp * tgts_per_dev
    per_lib_bytes = 4.0 * (2 * Lp * Lp + Lp * k * 2
                           + tgts_per_dev * Lp)  # D r/w + tables + gathers
    flops = libs_per_dev * per_lib_flops
    bytes_ = libs_per_dev * per_lib_bytes
    return {"flops": {"total": flops}, "bytes": {"total": bytes_},
            "coll": {"total": 4.0 * N * L / chips},  # one input scatter
            "U": int(libs_per_dev), "M": 1, "analytic": True}


def model_flops(arch: str, shape_name: str) -> float:
    """6·N_active·D (train) / 2·N_active·D (serving fwd), global."""
    cfg = get_config(arch)
    sc = SHAPES[shape_name]
    n_active = cfg.active_param_count()
    tokens = sc.global_batch * (sc.seq_len if sc.kind != "decode" else 1)
    mult = 6.0 if sc.kind == "train" else 2.0
    return mult * n_active * tokens


def build_report(dryrun_dir: str, probes_dir: str, out_path: str):
    rows = []
    for arch in list(ARCHS) + [dr.EDM_ARCH]:
        shapes = cells(arch) if arch != dr.EDM_ARCH else list(dr.EDM_SHAPES)
        for shape in shapes:
            rec_path = os.path.join(dryrun_dir,
                                    f"{arch}__{shape}__single.json")
            if not os.path.exists(rec_path):
                continue
            with open(rec_path) as f:
                rec = json.load(f)
            probe_path = os.path.join(probes_dir,
                                      f"{arch}__{shape}.json")
            if os.path.exists(probe_path):
                with open(probe_path) as f:
                    probe = json.load(f)
                flops = probe["flops"]["total"]
                bytes_ = probe["bytes"]["total"]
                coll = probe["coll"]["total"]
                corrected = True
            else:
                cost = rec.get("cost", {})
                flops = cost.get("flops", 0.0)
                bytes_ = cost.get("bytes accessed", 0.0)
                coll = rec.get("collectives", {}).get("total", 0.0)
                corrected = False
            t_c = flops / H100_BF16_FLOPS
            t_m = bytes_ / H100_HBM_BW
            t_x = coll / H100_COLL_BW
            dom = max(("compute", t_c), ("memory", t_m),
                      ("collective", t_x), key=lambda kv: kv[1])
            mf = (model_flops(arch, shape) / 256
                  if arch != dr.EDM_ARCH else flops)
            rows.append({
                "arch": arch, "shape": shape,
                "t_compute_s": t_c, "t_memory_s": t_m, "t_collective_s": t_x,
                "dominant": dom[0],
                "roofline_fraction": t_c / max(dom[1], 1e-30),
                "model_flops_per_dev": mf,
                "hlo_flops_per_dev": flops,
                "useful_ratio": mf / max(flops, 1e-30),
                "temp_gb": rec.get("memory", {}).get(
                    "temp_size_in_bytes", 0) / 1e9,
                "corrected": corrected,
                "rates": RATES,
            })
    with open(out_path, "w") as f:
        json.dump(rows, f, indent=1)
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--probe", action="store_true")
    ap.add_argument("--report", action="store_true")
    ap.add_argument("--arch", default=None,
                    help="the archs to probe, comma-separated (all: none)")
    ap.add_argument("--dryrun", default="experiments/dryrun")
    ap.add_argument("--out", default="experiments/roofline")
    ap.add_argument("--device", default="cuda",
                    help="the production mesh's device type (cuda or cpu)")
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)

    if args.probe:
        mesh = None
        archs = args.arch.split(",") if args.arch else list(ARCHS)
        for arch in archs:
            for shape in cells(arch):
                name = f"{arch}__{shape}"
                path = os.path.join(args.out, name + ".json")
                if os.path.exists(path):
                    continue
                rec_path = os.path.join(args.dryrun, name + "__single.json")
                try:
                    rec = None
                    if os.path.exists(rec_path):
                        with open(rec_path) as f:
                            rec = json.load(f)
                    if rec is not None and rec.get("status") == "ok" \
                            and "probe" in rec:
                        probe = _probe_of(rec, arch, shape, rec["opt"])
                        probe["from"] = rec_path
                    else:
                        if mesh is None:
                            mesh = dr.production_mesh(
                                "single", device_type=args.device)
                            set_mesh(mesh)
                        probe = probe_cell(arch, shape, mesh)
                except Exception as e:  # keep sweeping
                    probe = {"arch": arch, "shape": shape,
                             "error": repr(e)[:500]}
                with open(path, "w") as f:
                    json.dump(probe, f, indent=1)
                tot = probe.get("flops", {}).get("total", 0)
                print(f"[probe] {name}: flops_total={tot:.3e}", flush=True)
        if mesh is not None:
            set_mesh(None)
        for shape in dr.EDM_SHAPES:
            with open(os.path.join(args.out,
                                   f"{dr.EDM_ARCH}__{shape}.json"),
                      "w") as f:
                json.dump(edm_analytic(shape, 256), f, indent=1)

    if args.report:
        rows = build_report(args.dryrun, args.out,
                            os.path.join(args.out, "report.json"))
        print(f"[roofline] {RATES}")
        for r in rows:
            print(f"{r['arch']:>26} {r['shape']:<12} dom={r['dominant']:<10}"
                  f" frac={r['roofline_fraction']:.3f}"
                  f" useful={r['useful_ratio']:.2f}")
        return rows


if __name__ == "__main__":
    main()
