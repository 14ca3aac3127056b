#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one GPU and check it.

Usage: ``python3 chip_smoke.py`` from the repository root, on a machine
with an NVIDIA Hopper GPU and the CUDA toolkit. Exits 0 only if every
phase passed; any failure exits nonzero. Phases:

1. header — the card's name and power limit (``nvidia-smi``), torch and
   CUDA versions;
2. build — compiles the three kernels of ``src/repro_torch/kernels/csrc``
   with nvcc (seconds, and what ``-Xptxas -v`` reports for each);
3. kernels — each kernel against its plain PyTorch version on the card at
   the main path's shapes (kNN tables equal, ρ within ``RHO_ATOL``), with
   CUDA-event times of both and the least time the card could take;
4. main path — ``EDM(panel).optimal_E()`` then ``.xmap()``, and
   ``EDM(panel, E=3).xmap()``, on Fish1_Normo's published shape (154
   series × 1600 steps, E_max = 20), with every kernel's launch count
   read from that run; then the same calls with ``impl="ref"`` (the plain
   versions on the card): E_opt equal, ρ within ``RHO_ATOL``.

The second line from the end is a JSON ``{"kernels": [...]}`` record, the
last line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

N_SERIES, LENGTH, E_MAX, SEED = 154, 1600, 20, 0  # Fish1_Normo, Table 1
E_FIXED = 3           # the paper's fixed-E CCM benchmark setting
K_MASTER = E_MAX + 2  # session master: E_max + 1 + slack (Tp = 1)
# ρ tolerance: the kernel merges Welford moments over row slices, the plain
# version takes a two-pass Pearson in another summation order; both are
# float32 over 1600 terms, so they agree to a few float32 ULPs of ρ ≤ 1.
RHO_ATOL = 1e-5
# Published H100 SXM peaks: HBM bytes/s and float32 (non-tensor-core) FLOP/s.
HBM_BPS, F32_FLOPS = 3.35e12, 67e12


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def bound_ms(nbytes: float, ops: float) -> tuple[float, str]:
    t_b, t_o = nbytes / HBM_BPS * 1e3, ops / F32_FLOPS * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def time_ms(torch, fn, reps: int, warmup: int = 1) -> float:
    """Mean ms per call over ``reps`` calls, by CUDA events."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> None:
    root = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(root, "src", "repro_torch")):
        fail("src/repro_torch is missing beside chip_smoke.py")
    sys.path.insert(0, os.path.join(root, "src"))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")

    from repro_torch.data.timeseries import forced_network_panel
    from repro_torch.edm import EDM
    from repro_torch.kernels import _build, knn_batch, knn_multi_e, lookup
    from repro_torch.kernels import ref

    # ---------------------------------------------------------- 1. header
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    dev = torch.device("cuda")

    # ----------------------------------------------------------- 2. build
    t0 = time.perf_counter()
    logs = _build.build_all()
    print(f"build: {time.perf_counter() - t0:.2f} s into {_build.build_dir()}")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas {name}: {line.strip()}")

    # --------------------------------------------------------- 3. kernels
    panel = forced_network_panel(N_SERIES, LENGTH, seed=SEED)[0]
    X = torch.as_tensor(panel, device=dev)
    rows_out = []

    # Small shapes first: per-level k, capped and non-monotone masks, tau 2.
    Xs = X[:3, :257]
    for kw in (dict(E_max=6, tau=2, k=None, max_idx=None),
               dict(E_max=5, tau=1, k=9, max_idx=[200, 40, 180, 5, 100])):
        got = knn_multi_e.all_knn_multi_e(Xs, **kw)
        want = knn_multi_e.plain(Xs, **kw)
        if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
            fail(f"knn_multi_e differs from its plain version at {kw}")
    got = knn_batch.all_knn_batch(Xs, E=4, tau=2, k=300 // 2, max_idx=60)
    want = knn_batch.plain(Xs, E=4, tau=2, k=300 // 2, max_idx=60)
    if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
        fail("knn_batch differs from its plain version (small, capped)")

    # multi-E at the session master's shape.
    mkw = dict(E_max=E_MAX, tau=1, k=K_MASTER, exclude_self=True)
    dk, ik = knn_multi_e.all_knn_multi_e(X, **mkw)
    dp, ip = knn_multi_e.plain(X, **mkw)
    torch.cuda.synchronize()
    if not (torch.equal(dk, dp) and torch.equal(ik, ip)):
        bad = int((dk != dp).sum() + (ik != ip).sum())
        fail(f"knn_multi_e differs from its plain version in {bad} entries")
    fin = torch.isfinite(dk)
    err = float((dk[fin] - dp[fin]).abs().max())
    del dp, ip
    ms = time_ms(torch, lambda: knn_multi_e.all_knn_multi_e(X, **mkw), 10)
    plain_ms = time_ms(torch, lambda: knn_multi_e.plain(X, **mkw), 1, 0)
    b, by = bound_ms(X.numel() * 4 + dk.numel() * 8,
                     3.0 * N_SERIES * E_MAX * LENGTH * LENGTH)
    rows_out.append(dict(
        name="knn_multi_e", route="cuda",
        source="src/repro_torch/kernels/csrc/knn_multi_e.cu",
        replaces="src/repro/kernels/knn_multi_e.py:64",
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b, bound_by=by,
        library_ms=None))
    del dk, ik

    # knn_batch at the fixed-E direct route's kernel (B = N here).
    Lp = LENGTH - (E_FIXED - 1)
    bkw = dict(E=E_FIXED, tau=1, k=E_FIXED + 1, exclude_self=True,
               max_idx=Lp - 1)
    dk, ik = knn_batch.all_knn_batch(X, **bkw)
    dp, ip = knn_batch.plain(X, **bkw)
    if not (torch.equal(dk, dp) and torch.equal(ik, ip)):
        fail("knn_batch differs from its plain version at B=154, E=3, k=4")
    ms = time_ms(torch, lambda: knn_batch.all_knn_batch(X, **bkw), 20)
    plain_ms = time_ms(torch, lambda: knn_batch.plain(X, **bkw), 2)
    b, by = bound_ms(X.numel() * 4 + dk.numel() * 8,
                     3.0 * N_SERIES * E_FIXED * Lp * Lp)
    rows_out.append(dict(
        name="knn_batch", route="cuda",
        source="src/repro_torch/kernels/csrc/knn_batch.cu",
        replaces="src/repro/kernels/knn_batch.py:42",
        max_abs_err=float((dk - dp).abs().max()), ms=ms, plain_ms=plain_ms,
        bound_ms=b, bound_by=by, library_ms=None))

    # lookup_rho: E = 3, k = 4, 154 library tables × 154 targets (xmap),
    # and the own-target form of the ρ(E) sweep on the same tables.
    w = ref.make_weights(dk)
    off = E_FIXED - 1
    rk = lookup.lookup_rho(X, ik, w, offset=off)
    rp = lookup.plain(X, ik, w, offset=off)
    err = float((rk - rp).abs().max())
    if not err <= RHO_ATOL:
        fail(f"lookup_rho differs from its plain version by {err}")
    ok_own = lookup.lookup_rho(X, ik, w, offset=off, own=True)
    op = lookup.plain_own(X, ik, w, offset=off)
    err = max(err, float((ok_own - op).abs().max()))
    if not err <= RHO_ATOL:
        fail(f"lookup_rho (own target) differs by {err}")
    ms = time_ms(torch, lambda: lookup.lookup_rho(X, ik, w, offset=off), 20)
    plain_ms = time_ms(torch, lambda: lookup.plain(X, ik, w, offset=off), 2)
    b, by = bound_ms(ik.numel() * 8 + X.numel() * 4 + rk.numel() * 4,
                     N_SERIES * N_SERIES * Lp * (2.0 * (E_FIXED + 1) + 8))
    rows_out.append(dict(
        name="lookup_rho", route="cuda",
        source="src/repro_torch/kernels/csrc/lookup_rho.cu",
        replaces="src/repro/kernels/lookup.py:95",
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b, bound_by=by,
        library_ms=None))
    del dk, ik, dp, ip, w
    for r in rows_out:
        print(json.dumps({"kernel_check": r}))

    # ------------------------------------------------------- 4. main path
    wrappers = {"knn_multi_e": knn_multi_e.all_knn_multi_e,
                "knn_batch": knn_batch.all_knn_batch,
                "lookup_rho": lookup.lookup_rho}
    torch.cuda.synchronize()
    for fn in wrappers.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sess = EDM(panel)
    E_opt, rho = sess.optimal_E()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    xm = sess.xmap()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    xm3 = EDM(panel, E=E_FIXED).xmap()
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    launches = {name: fn.launches for name, fn in wrappers.items()}
    peak = torch.cuda.max_memory_allocated()
    pairs = N_SERIES * N_SERIES
    print(json.dumps({"main_path": {
        "optimal_E_s": t1 - t0, "xmap_master_s": t2 - t1,
        "xmap_fixed_E_s": t3 - t2, "pairs_per_s_master": pairs / (t2 - t1),
        "pairs_per_s_fixed_E": pairs / (t3 - t2), "peak_bytes": peak,
        "E_opt_hist": {int(e): int((E_opt == e).sum())
                       for e in np.unique(E_opt)},
        "launches": launches}}))
    for name, n in launches.items():
        if n <= 0:
            fail(f"the main path launched {name} no time")
    for name, m in (("xmap", xm), ("xmap E=3", xm3)):
        if m.shape != (N_SERIES, N_SERIES) or not np.isfinite(m).all():
            fail(f"{name}: shape {m.shape} or non-finite values")
    if rho.shape != (N_SERIES, E_MAX) or not np.isfinite(rho).all():
        fail(f"optimal_E: rho shape {rho.shape} or non-finite values")

    sess_r = EDM(panel, impl="ref")
    E_opt_r, rho_r = sess_r.optimal_E()
    xm_r = sess_r.xmap()
    xm3_r = EDM(panel, E=E_FIXED, impl="ref").xmap()
    srt = np.sort(rho_r, axis=1)
    gap = float((srt[:, -1] - srt[:, -2]).min())
    errs = {"rho_E": float(np.abs(rho - rho_r).max()),
            "xmap": float(np.abs(xm - xm_r).max()),
            "xmap_fixed_E": float(np.abs(xm3 - xm3_r).max())}
    print(json.dumps({"main_path_vs_plain": dict(
        errs, E_opt_equal=bool((E_opt == E_opt_r).all()),
        min_top2_rho_gap=gap)}))
    if not (E_opt == E_opt_r).all():
        fail(f"E_opt differs from the plain run in "
             f"{int((E_opt != E_opt_r).sum())} series")
    for name, e in errs.items():
        if not e <= RHO_ATOL:
            fail(f"{name} differs from the plain run by {e}")

    for r in rows_out:
        r["launches"] = launches[r["name"]]
    print(json.dumps({"kernels": rows_out}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
