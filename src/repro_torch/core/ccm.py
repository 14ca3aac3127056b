"""Convergent Cross Mapping — the library-batched all-pairs engine.

Directionality convention (as in ``repro.core.ccm``): to ask whether
``target`` causally forces ``lib``, embed the *library* series, find its
neighbours, and cross-map the *target*.

Two engines:

* the convergence engine — ``ccm_convergence`` / ``cross_map``: one
  ``pairwise_distances`` launch and one multi-cap ``topk_select_sizes``
  launch give every library-size table of a curve grid, then one fused
  lookup-ρ per size (``cross_map_sizes_seed`` is the per-size re-scan it
  replaces, kept as the baseline);
* the all-pairs engine — ``ccm_group_batched`` cuts the library axis into
  ceil(Nl/B) batches, each one launch of ``ops.all_knn_batch`` followed by
  the weights + fused-ρ stage (``post_lookup_rho``), double-buffered
  against host assembly by ``drive_batched``. Results are bit-invariant
  in B.
"""

from __future__ import annotations

import time
import warnings

import numpy as np
import torch

from repro_torch import telemetry
from repro_torch.core.embedding import embed_offset, num_embedded, pred_rows
from repro_torch.kernels import ops
from repro_torch.kernels.lookup import CHUNK_ROWS

def normalize_lib_sizes(lib_sizes, *, Lp: int, Tp: int = 0):
    """Validate a convergence-sweep size list → (caps, inverse map).

    ``caps`` is the ascending tuple of unique inclusive neighbour-index
    caps (``min(size − 1, Lp − 1 − Tp)``); ``inv`` maps each requested size
    to its cap's position. Sizes must be >= 1 (ValueError otherwise);
    unsorted, duplicate or oversized (> the Lp − Tp usable library points)
    sizes are accepted with one ``UserWarning`` naming what was cleaned.
    """
    sizes = [int(s) for s in lib_sizes]
    if not sizes:
        raise ValueError("lib_sizes must not be empty")
    bad = [s for s in sizes if s < 1]
    if bad:
        raise ValueError(f"lib_sizes must all be >= 1, got {bad}")
    hard_max = Lp - 1 - max(Tp, 0)
    issues = []
    if any(b < a for a, b in zip(sizes, sizes[1:])):
        issues.append("unsorted (computed on the sorted unique caps)")
    if len(set(sizes)) != len(sizes):
        issues.append("duplicates (each cap computed once)")
    over = [s for s in sizes if s - 1 > hard_max]
    if over:
        issues.append(
            f"sizes {over} exceed the {hard_max + 1} usable library "
            f"points (clamped)")
    if issues:
        warnings.warn(
            f"lib_sizes {tuple(sizes)}: " + "; ".join(issues),
            UserWarning, stacklevel=3)
    caps_all = [min(s - 1, hard_max) for s in sizes]
    caps = tuple(sorted(set(caps_all)))
    inv = np.asarray([caps.index(c) for c in caps_all], np.int32)
    return caps, inv


def ccm_convergence_caps(lib, targets, *, E, tau, Tp, caps, exclude_self,
                         impl) -> torch.Tensor:
    """(|caps|, Nt) curve grid: one distance launch, one multi-cap top-k,
    then one fused lookup-ρ per cap. ``caps`` are normalized ascending
    caps (``normalize_lib_sizes``)."""
    L = lib.shape[-1]
    rows = pred_rows(L, E, tau, Tp)
    off = embed_offset(E, tau, Tp)
    D = ops.pairwise_distances(lib, E=E, tau=tau, impl=impl)
    dS, iS = ops.topk_select_sizes(D, k=E + 1, max_idxs=caps,
                                   exclude_self=exclude_self, impl=impl)
    Yt = ops.lookup_targets(targets, impl=impl)
    curves = []
    for s in range(len(caps)):
        w = ops.make_weights(dS[s])
        curves.append(ops.lookup_rho(targets, iS[s, :rows], w[:rows],
                                     offset=off, impl=impl, Yt=Yt))
    return torch.stack(curves)


def ccm_convergence(lib: torch.Tensor, targets: torch.Tensor, *, E: int,
                    tau: int = 1, Tp: int = 0, lib_sizes,
                    exclude_self: bool = True,
                    impl: str = "auto") -> torch.Tensor:
    """Full CCM convergence curve grid → (num_sizes, Nt) ρ.

    One ``pairwise_distances`` launch and ONE multi-cap
    ``topk_select_sizes`` launch give every library-prefix table, whatever
    the number of sizes; ρ rising with library size is CCM's causality
    criterion. ``lib_sizes`` follows the caller's order (duplicates and
    oversized sizes computed once / clamped, with a warning). Equals the
    per-size loop ``cross_map_sizes_seed``.
    """
    if targets.ndim == 1:
        targets = targets[None, :]
    Lp = num_embedded(lib.shape[-1], E, tau)
    caps, inv = normalize_lib_sizes(lib_sizes, Lp=Lp, Tp=Tp)
    curves = ccm_convergence_caps(lib, targets, E=E, tau=tau, Tp=Tp,
                                  caps=caps, exclude_self=exclude_self,
                                  impl=impl)
    return curves[torch.as_tensor(inv, device=curves.device).long()]


def cross_map_sizes_seed(lib: torch.Tensor, targets: torch.Tensor, *, E: int,
                         tau: int = 1, Tp: int = 0, lib_sizes,
                         exclude_self: bool = True,
                         impl: str = "auto") -> torch.Tensor:
    """The per-size convergence loop → (num_sizes, Nt) ρ: one full
    ``topk_select`` re-scan of the distance matrix per library size. The
    baseline that ``ccm_convergence`` replaces."""
    if targets.ndim == 1:
        targets = targets[None, :]
    L = lib.shape[-1]
    Lp = num_embedded(L, E, tau)
    rows = pred_rows(L, E, tau, Tp)
    off = embed_offset(E, tau, Tp)
    hard_max = Lp - 1 - max(Tp, 0)
    D = ops.pairwise_distances(lib, E=E, tau=tau, impl=impl)
    Yt = ops.lookup_targets(targets, impl=impl)

    def rho_for(max_idx):
        d, i = ops.topk_select(D, k=E + 1, exclude_self=exclude_self,
                               max_idx=max_idx, impl=impl)
        w = ops.make_weights(d)
        return ops.lookup_rho(targets, i[:rows], w[:rows], offset=off,
                              impl=impl, Yt=Yt)

    return torch.stack([rho_for(min(int(s) - 1, hard_max))
                        for s in lib_sizes])


def cross_map(lib: torch.Tensor, targets: torch.Tensor, *, E: int,
              tau: int = 1, Tp: int = 0, lib_sizes=None,
              exclude_self: bool = True,
              impl: str = "auto") -> torch.Tensor:
    """Cross-map skill of predicting each target from ``lib``'s manifold.

    targets: (Nt, L) (a 1-D series is promoted). Returns (Nt,) ρ, or
    (num_sizes, Nt) when ``lib_sizes`` is given (the convergence sweep,
    through ``ccm_convergence``); a 1-D target drops its axis.
    """
    squeeze = targets.ndim == 1
    if squeeze:
        targets = targets[None, :]
    if lib_sizes is not None:
        curves = ccm_convergence(
            lib, targets, E=E, tau=tau, Tp=Tp, lib_sizes=lib_sizes,
            exclude_self=exclude_self, impl=impl)
        return curves[:, 0] if squeeze else curves
    L = lib.shape[-1]
    Lp = num_embedded(L, E, tau)
    rows = pred_rows(L, E, tau, Tp)
    off = embed_offset(E, tau, Tp)
    D = ops.pairwise_distances(lib, E=E, tau=tau, impl=impl)
    d, i = ops.topk_select(D, k=E + 1, exclude_self=exclude_self,
                           max_idx=Lp - 1 - max(Tp, 0), impl=impl)
    w = ops.make_weights(d)
    rho = ops.lookup_rho(targets, i[:rows], w[:rows], offset=off, impl=impl)
    return rho[0] if squeeze else rho


#: Default memory budgets (MB) of the library-batched engines: what one
#: launch holds in flight for its B libraries (``direct_batch_bytes`` on
#: the direct engine's two paths). A device with its own memory wants
#: launches big enough to amortize dispatch; on the CPU the plain path's
#: (B, Lp, Lp) distance stack competes with the cache.
DEFAULT_BATCH_BUDGET_MB = 256
DEFAULT_BATCH_BUDGET_MB_CPU = 32


def _default_budget_mb(device: torch.device | str) -> int:
    return (DEFAULT_BATCH_BUDGET_MB_CPU if torch.device(device).type == "cpu"
            else DEFAULT_BATCH_BUDGET_MB)


def auto_batch_libs(Lp: int, Nl: int, budget_mb: float | None = None, *,
                    device: torch.device | str = "cpu",
                    per_series_bytes: int | None = None) -> int:
    """Library batch size B with B·per-series bytes under the budget.

    Per-series bytes default to one (Lp, Lp) float32 distance matrix, what
    the direct engine's plain path holds a library; its kernel path
    (``direct_batch_bytes``), the master route and the S-Map sweep pass
    their own. Under the cap the launches are equalized — B = ceil(Nl /
    nb) for the smallest launch count nb the cap allows — because a
    ragged final launch is padded to a full B.
    """
    budget = _default_budget_mb(device) if budget_mb is None else budget_mb
    per = 4 * Lp * Lp if per_series_bytes is None else max(
        1, int(per_series_bytes))
    Nl = max(Nl, 1)
    cap = max(1, min(Nl, int(budget * 2**20) // per))
    nb = -(-Nl // cap)
    return -(-Nl // nb)


def direct_batch_bytes(L: int, Nt: int, *, E: int, tau: int, Tp: int,
                       k: int, kernel: bool) -> int:
    """Bytes one direct launch holds in flight for each of its libraries.

    The plain path (``kernel`` False: CPU tensors or ``impl="ref"``) holds
    the library's (Lp, Lp) float32 distance matrix (``ref.all_knn_batch``).
    The kernel path never forms it; there a library holds at most:

    * the ``knn_batch`` tables, float32 distances and int32 indices
      (8·Lp·k);
    * ``make_weights``' (Lp, k) float32 temporaries, five live at its peak
      with the weights (20·Lp·k), and its (Lp,) minima, sums and masks
      (16·Lp);
    * ``pad_batch``'s copy of the series on a ragged last launch (4·L);
    * ``lookup_rho``'s float64 moment partials, six a chunk of
      ``CHUNK_ROWS`` rows and target where a row has more than one chunk
      (48·nch·Nt), and its ρ row (4·Nt).

    The sum is above what the card shows (``tests/test_torch_gpu.py``
    holds one launch's peak under it). The targets' transposed copy is
    one a call, not a library, and is not counted.
    """
    Lp = num_embedded(L, E, tau)
    if not kernel:
        return 4 * Lp * Lp
    nch = -(-pred_rows(L, E, tau, Tp) // CHUNK_ROWS)
    partials = 48 * nch * Nt if nch > 1 else 0
    return 28 * Lp * k + 16 * Lp + 4 * L + partials + 4 * Nt


def direct_batch_libs(Nl: int, L: int, Nt: int, *, E: int, tau: int,
                      Tp: int, k: int, impl: str,
                      device: torch.device | str,
                      batch_libs: int | None = None,
                      budget_mb: float | None = None) -> int:
    """B of the direct engine for Nl libraries of length L against Nt
    targets: ``batch_libs`` where given, else ``auto_batch_libs`` over
    ``direct_batch_bytes`` of the path a launch on ``device`` takes
    (``ops.kernel_path``); clamped to [1, Nl]. Every caller of the direct
    engine sizes its launches here."""
    if batch_libs is None:
        per = direct_batch_bytes(L, Nt, E=E, tau=tau, Tp=Tp, k=k,
                                 kernel=ops.kernel_path(device, impl))
        batch_libs = auto_batch_libs(num_embedded(L, E, tau), Nl, budget_mb,
                                     device=device, per_series_bytes=per)
    B = max(1, min(int(batch_libs), Nl))
    telemetry.gauge("edm_batch_libs_effective").set(B)
    return B


def post_lookup_rho(targets, d, i, *, rows, off, impl, Yt=None):
    """Weights + fused-ρ stage of every batched matrix engine → (B, Nt).

    (d, i) are (B, Lp, k) neighbour tables. Weights are elementwise with
    a fixed-order k-sum and each lookup-ρ row depends on its table alone,
    so every row equals the B = 1 result (batch invariance). ``Yt``:
    ``ops.lookup_targets(targets)``, made once per engine call.
    """
    w = ops.make_weights(d)
    return ops.lookup_rho(targets, i[:, :rows], w[:, :rows], offset=off,
                          impl=impl, Yt=Yt)


def _group_step(libs, targets, *, E, tau, Tp, k, impl, Yt=None):
    """One engine launch: distance→top-k→weights→ρ for B libraries."""
    L = libs.shape[-1]
    rows = pred_rows(L, E, tau, Tp)
    off = embed_offset(E, tau, Tp)
    hard_max = num_embedded(L, E, tau) - 1 - max(Tp, 0)
    d, i = ops.all_knn_batch(libs, E=E, tau=tau, k=k, exclude_self=True,
                             max_idx=hard_max, impl=impl)
    return post_lookup_rho(targets, d, i, rows=rows, off=off, impl=impl,
                           Yt=Yt)


def pad_batch(chunk: torch.Tensor, B: int) -> torch.Tensor:
    """Pad a ragged final batch to B rows by repeating the last series.

    Real data, so the engine needs no masking; ``drive_batched`` drops the
    padded rows at assembly.
    """
    n = chunk.shape[0]
    if n == B:
        return chunk
    return torch.cat([chunk, chunk[-1:].expand(B - n, *chunk.shape[1:])])


def drive_batched(Nl: int, B: int, launch, *, start: int = 0,
                  on_block=None, monitor=None) -> np.ndarray | None:
    """Double-buffered host loop over ceil((Nl − start)/B) engine launches.

    ``launch(a, b, B)`` enqueues rows [a, b) (padded to B) and returns the
    device result before it is computed (CUDA launches are asynchronous),
    so while the host copies batch i's block (``.cpu()``, the sync point)
    the device already runs batch i+1. At most two launches are in
    flight.

    Hooks of the journaled runner (``repro_torch.edm.runner``), all
    optional:

    * ``start`` — resume offset: rows [0, start) are held elsewhere (a
      journal's committed tiles) and are neither launched nor written;
      the returned rows below ``start`` are uninitialized, and the result
      is None when ``start >= Nl``.
    * ``on_block(a, b, block)`` — called once block [a, b) has landed on
      the host (``block`` the unpadded rows): the journal's commit point.
      A raise here (preemption's checkpoint-and-exit) leaves no tile half
      written.
    * ``monitor`` — a ``distributed.fault.StragglerMonitor`` timed over
      each loop iteration (launch of tile i + landing of tile i−1) and
      stamped with the landed tile's first row.

    Traced, the loop is an ``engine.drive`` span holding one
    ``engine.launch`` span a launch (the enqueue) and one ``engine.land``
    span a landing (the copy to the host and into the result; attributes
    ``a``, ``b`` and ``latency_s``, dispatch to landed); ``on_block`` runs
    after its ``engine.land`` closes.
    """
    if start >= Nl:
        return None
    out = pending = None
    lat_hist = telemetry.histogram("edm_launch_latency_seconds")
    pairs = telemetry.counter("edm_pairs_total")
    launches = telemetry.counter("edm_launches")

    def land(pending):
        nonlocal out
        (pa, pb), arr, t_disp = pending
        with telemetry.span("engine.land", a=pa, b=pb) as sp:
            block = arr.cpu().numpy()       # the device sync point
            t_done = time.perf_counter()
            if out is None:
                out = np.empty((Nl,) + block.shape[1:], block.dtype)
            out[pa:pb] = block[: pb - pa]
            lat_hist.observe(t_done - t_disp)
            pairs.inc(int(block[: pb - pa].size))
            sp.annotate(latency_s=t_done - t_disp)
        if on_block is not None:
            on_block(pa, pb, block[: pb - pa])

    with telemetry.span("engine.drive", Nl=Nl, B=B, start=start):
        for a in range(start, Nl, B):
            if monitor is not None:
                monitor.start()
            launches.inc()
            b = min(a + B, Nl)
            with telemetry.span("engine.launch", a=a, b=b):
                cur = launch(a, b, B)
            if pending is not None:
                land(pending)
                if monitor is not None:
                    monitor.stop(pending[0][0])
            pending = ((a, b), cur, time.perf_counter())
        if monitor is not None:
            monitor.start()
        land(pending)
        if monitor is not None:
            monitor.stop(pending[0][0])
    return out


def make_group_launch(libs, targets, *, E, tau, Tp, k, impl):
    """Launch closure of the direct batched engine: ``launch(a, b, B)``."""
    ops.check_impl(impl)
    group_launches = telemetry.counter("edm_group_launches")
    Yt = ops.lookup_targets(targets, impl=impl)

    def launch(a, b, B):
        group_launches.inc()
        return _group_step(pad_batch(libs[a:b], B), targets, E=E, tau=tau,
                           Tp=Tp, k=k, impl=impl, Yt=Yt)

    return launch


def ccm_group_batched(libs: torch.Tensor, targets: torch.Tensor, *, E: int,
                      tau: int = 1, Tp: int = 0, k: int | None = None,
                      impl: str = "auto", batch_libs: int | None = None,
                      budget_mb: float | None = None) -> np.ndarray:
    """Library-batched CCM block → (Nl, Nt) ρ (host ndarray).

    The library axis is cut into ceil(Nl/B) batches of B series
    (``batch_libs``, or ``direct_batch_libs``' memory rule), each one
    launch of the kNN kernel plus the fused-ρ stage, double-buffered
    against host assembly. Results are bit-invariant in B.
    """
    if targets.ndim == 1:
        targets = targets[None, :]
    Nl = libs.shape[0]
    if Nl == 0:
        return np.zeros((0, targets.shape[0]), np.float32)
    kk = E + 1 if k is None else int(k)
    B = direct_batch_libs(Nl, libs.shape[-1], targets.shape[0], E=E,
                          tau=tau, Tp=Tp, k=kk, impl=impl,
                          device=libs.device, batch_libs=batch_libs,
                          budget_mb=budget_mb)
    launch = make_group_launch(libs, targets, E=E, tau=tau, Tp=Tp, k=kk,
                               impl=impl)
    return drive_batched(Nl, B, launch)


def ccm_group(libs: torch.Tensor, targets: torch.Tensor, *, E: int,
              tau: int = 1, Tp: int = 0, impl: str = "auto") -> torch.Tensor:
    """Per-series CCM block: every library × every target at one E → (Nl, Nt).

    The legacy per-series form, one library at a time: its (Lp, Lp)
    distance matrix, a top-k of E + 1 neighbours, weights and the fused
    lookup-ρ. Production callers (``EDM.xmap``) use ``ccm_group_batched``;
    each of whose rows is the same bits as this form's (the batched
    engines' B-invariance makes their B = 1 launch the per-series
    oracle).
    """
    if targets.ndim == 1:
        targets = targets[None, :]
    L = libs.shape[-1]
    Lp = num_embedded(L, E, tau)
    rows = pred_rows(L, E, tau, Tp)
    off = embed_offset(E, tau, Tp)
    hard_max = Lp - 1 - max(Tp, 0)
    Yt = ops.lookup_targets(targets, impl=impl)
    out = []
    for x in libs:
        D = ops.pairwise_distances(x, E=E, tau=tau, impl=impl)
        d, i = ops.topk_select(D, k=E + 1, exclude_self=True,
                               max_idx=hard_max, impl=impl)
        w = ops.make_weights(d)
        out.append(ops.lookup_rho(targets, i[:rows], w[:rows], offset=off,
                                  impl=impl, Yt=Yt))
    if not out:
        return torch.zeros((0, targets.shape[0]), dtype=torch.float32,
                           device=targets.device)
    return torch.stack(out)


def ccm_matrix(X, E_opt=None, *, tau: int = 1, Tp: int = 0,
               impl: str = "auto", device: str = "cuda") -> np.ndarray:
    """All-pairs CCM skill matrix (N_lib, N_target), a thin wrapper over
    ``repro_torch.edm.EDM.xmap``: entry (l, t) cross-maps series t from
    series l's manifold at t's optimal E (computed when ``E_opt`` is
    None). Prefer a session, which keeps its kNN master across calls."""
    from repro_torch.edm import EDM, EDMConfig

    X = np.asarray(X, np.float32)
    if E_opt is not None:
        E_opt = np.asarray(E_opt, dtype=np.int32)
        if E_opt.shape != (X.shape[0],):
            raise ValueError(
                f"E_opt must be ({X.shape[0]},), got {E_opt.shape}")
    sess = EDM(X, EDMConfig(tau=tau, Tp_cross=Tp, impl=impl, device=device,
                            E_max=int(np.max(E_opt)) if E_opt is not None
                            else 20))
    return sess.xmap(method="simplex", E_opt=E_opt)
