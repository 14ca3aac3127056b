"""Plan layer: what each session method will run, and the cached-table
functions it dispatches to.

As in ``repro.edm.plan``: the expensive shared state is the **multi-E kNN
master table** — one uncapped ``ops.all_knn_multi_e`` pass over the panel
(k_master = max needed k + slack columns) — from which every per-(E, Tp)
neighbour table the session needs is derived post hoc, bit-identically:

* neighbour **indices**: master rows are sorted by (distance, index), so
  dropping the entries past a ``max_idx`` cap and keeping the first k is
  the capped top-k, as long as the master carries enough slack columns.
* neighbour **distances**: the optimal-E sweep reads the master's own
  distances; simplex/CCM lookups recompute just the k selected distances
  in the per-E accumulation order (strict chain, root taken last).

Every function here works on the whole batch at once where the reference
maps one series at a time; each op is row-independent, so the batched
result equals the per-series one.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import telemetry
from repro_torch.core.ccm import (auto_batch_libs, drive_batched, pad_batch,
                                  post_lookup_rho)
from repro_torch.core.embedding import embed_offset, num_embedded, pred_rows
from repro_torch.kernels import ops
from repro_torch.kernels.ref import sqrt_rn, strict_sq


@dataclasses.dataclass(frozen=True)
class Plan:
    """What a session method resolved to run (introspectable, hashable)."""

    task: str              # "optimal_E" | "simplex" | "ccm" | "xmap"
    impl: str              # "cuda" (kernels) | "ref" (plain versions)
    placement: str         # "local" | "sharded"
    E: str                 # "fixed:<n>" | "per-series" | "sweep:1..<E_max>"
    Tp: int
    reuse: tuple[str, ...]  # session cache keys this plan reads
    builds: tuple[str, ...]  # session cache keys this plan populates
    detail: str = ""

    def describe(self) -> str:
        reuse = ", ".join(self.reuse) if self.reuse else "nothing"
        builds = ", ".join(self.builds) if self.builds else "nothing"
        return (f"{self.task}[{self.placement}/{self.impl}] E={self.E} "
                f"Tp={self.Tp} reuses {reuse}; builds {builds}"
                + (f" ({self.detail})" if self.detail else ""))


# ---------------------------------------------------------------- master


def panel_master(X, *, E_max, tau, k, impl):
    """Uncapped multi-E kNN master tables for a whole (N, L) panel →
    (dists, idx), both (N, E_max, L, k); one kernel launch on the GPU."""
    return ops.all_knn_multi_e(X, E_max=E_max, tau=tau, k=k,
                               exclude_self=True, max_idx=None, impl=impl)


def panel_master_append(X, dM, iM, *, tau, impl):
    """Grow a whole panel's master tables to cover appended points.

    ``X`` is the grown (N, L_new) panel, ``dM``/``iM`` the stored
    ``panel_master`` tables of its (N, L_old) prefix → (N, E_max, L_new, k)
    tables bit-identical to ``panel_master`` on the grown panel, at
    O(Lp·(k + Δt)) per row and level instead of O(Lp²). One
    ``ops.master_append`` call for the whole panel (one kernel launch on
    the GPU) where the reference maps the series one at a time. k_master
    is kept, so ``master_slack_covers`` carries over unchanged.
    """
    return ops.master_append(X, dM, iM, tau=tau, impl=impl)


def _derive_idx(iE, *, k, max_idx):
    """First k master indices surviving a ``max_idx`` cap (stable order).

    iE: (…, rows, k_master). Returns ((…, rows, k) idx with -1 in slots
    lacking a valid candidate, validity mask) — index-identical to a
    capped top-k.
    """
    valid = (iE >= 0) & (iE <= max_idx)
    order = torch.sort((~valid).to(torch.int32), dim=-1,
                       stable=True).indices[..., :k]
    ok = torch.gather(valid, -1, order)
    idx = torch.where(ok, torch.gather(iE, -1, order), -1)
    return idx, ok


def _derive(dE, iE, *, k, max_idx):
    """Like ``_derive_idx`` but also carrying the master distances."""
    valid = (iE >= 0) & (iE <= max_idx)
    order = torch.sort((~valid).to(torch.int32), dim=-1,
                       stable=True).indices[..., :k]
    ok = torch.gather(valid, -1, order)
    d = torch.where(ok, torch.gather(dE, -1, order), float("inf"))
    i = torch.where(ok, torch.gather(iE, -1, order), -1)
    return d, i, ok


def _gathered_dists_batch(X, idx, ok, *, E, tau):
    """Euclidean distances of the selected neighbour pairs of B series.

    X (B, L); idx/ok (B, rows, k). The per-lag strict chain of the
    all-kNN kernels on the gathered values, so the values equal the
    per-E tables' at O(rows·k·E). Invalid slots → inf.
    """
    Lp = num_embedded(X.shape[-1], E, tau)
    B, rows, k = idx.shape
    jj = torch.clamp(idx, min=0).long().reshape(B, rows * k)
    acc = torch.zeros(idx.shape, dtype=torch.float32, device=X.device)
    xf = X.float()
    for lag in range(E):
        xk = xf[:, lag * tau:lag * tau + Lp]
        d = xk[:, :rows, None] - torch.gather(xk, 1, jj).reshape(B, rows, k)
        acc = acc + strict_sq(d)
    return torch.where(ok, sqrt_rn(acc), float("inf"))


def _gathered_dists(x, idx, ok, *, E, tau):
    """``_gathered_dists_batch`` for one series: x (L,), idx/ok (rows, k)."""
    return _gathered_dists_batch(x[None], idx[None], ok[None], E=E,
                                 tau=tau)[0]


# ------------------------------------------------ cached-table functions


def rho_curves_from_master(X, dM, iM, *, E_max, tau, Tp, impl):
    """ρ(E) for every series from the master tables → (N, E_max).

    Reads the master's own distances and derives each level's Tp-capped
    table post hoc; one own-target lookup-ρ launch per E covers the panel.
    Traced, the per-E loop is one ``plan.derive`` device span.
    """
    L = X.shape[-1]
    rhos = []
    with telemetry.device_span("plan.derive", X.device, E_max=E_max):
        for E in range(1, E_max + 1):
            rows = pred_rows(L, E, tau, Tp)
            mx = num_embedded(L, E, tau) - 1 - Tp
            off = embed_offset(E, tau, Tp)
            dk, ik, _ = _derive(dM[:, E - 1, :rows], iM[:, E - 1, :rows],
                                k=E + 1, max_idx=mx)
            w = ops.make_weights(dk)
            rhos.append(ops.lookup_rho_own(X, ik, w, offset=off,
                                           impl=impl))
    return torch.stack(rhos, dim=1)


def simplex_skill_from_master(X, iM_E, *, E, tau, Tp, k, impl):
    """Leave-one-out simplex skill per series from cached indices → (N,).

    iM_E: (N, L, k_master) master index level E. Indices are derived, the
    k selected distances recomputed.
    """
    L = X.shape[-1]
    Lp = num_embedded(L, E, tau)
    rows = pred_rows(L, E, tau, Tp)
    off = embed_offset(E, tau, Tp)
    ik, ok = _derive_idx(iM_E[:, :Lp], k=k, max_idx=Lp - 1 - Tp)
    d = _gathered_dists_batch(X, ik, ok, E=E, tau=tau)
    w = ops.make_weights(d)
    return ops.lookup_rho_own(X, ik[:, :rows], w[:, :rows], offset=off,
                              impl=impl)


def master_slack_covers(caps, *, Lp: int, k: int, k_master: int) -> bool:
    """Can capped tables be derived from the master? A cap at index m
    excludes ``Lp − 1 − m`` columns, all of which may outrank every valid
    candidate, so the master needs ``k_master >= k + (Lp − 1 − min(caps))``.
    """
    return k_master >= k + (Lp - 1 - min(caps))


def ccm_convergence_from_master(x, iM_E, targets, *, E, tau, Tp, caps, k,
                                impl):
    """Convergence curve grid from cached master indices → (|caps|, Nt).

    The cached-session counterpart of ``core.ccm.ccm_convergence``: each
    library cap's table is derived from ONE master index level (callers
    check ``master_slack_covers`` first) and only the k selected distances
    are recomputed — no pairwise pass, no top-k launch.
    """
    L = x.shape[-1]
    Lp = num_embedded(L, E, tau)
    rows = pred_rows(L, E, tau, Tp)
    off = embed_offset(E, tau, Tp)
    iE = iM_E[:Lp]
    Yt = ops.lookup_targets(targets, impl=impl)
    curves = []
    for m in caps:
        ik, ok = _derive_idx(iE, k=k, max_idx=m)
        d = _gathered_dists(x, ik, ok, E=E, tau=tau)
        w = ops.make_weights(d)
        curves.append(ops.lookup_rho(targets, ik[:rows], w[:rows],
                                     offset=off, impl=impl, Yt=Yt))
    return torch.stack(curves)


def _master_group_step(Xb, iMb, targets, *, E, tau, Tp, k, impl, Yt=None):
    """One master-derived engine launch: (B, Nt) ρ for B libraries.

    The cached-session twin of ``core.ccm._group_step``: indices from the
    stable filter over the master level (zero kNN work), the k selected
    distances recomputed, then the shared weights + fused-ρ stage.
    """
    L = Xb.shape[-1]
    Lp = num_embedded(L, E, tau)
    rows = pred_rows(L, E, tau, Tp)
    off = embed_offset(E, tau, Tp)
    hard_max = Lp - 1 - max(Tp, 0)
    ik, ok = _derive_idx(iMb[:, :Lp], k=k, max_idx=hard_max)
    d = _gathered_dists_batch(Xb, ik, ok, E=E, tau=tau)
    return post_lookup_rho(targets, d, ik, rows=rows, off=off, impl=impl,
                           Yt=Yt)


def make_master_group_launch(X, iM_E, targets, *, E, tau, Tp, k, impl):
    """Launch closure of the master-derived engine: ``launch(a, b, B)``."""
    ops.check_impl(impl)
    master_launches = telemetry.counter("edm_master_launches")
    Yt = ops.lookup_targets(targets, impl=impl)

    def launch(a, b, B):
        master_launches.inc()
        return _master_group_step(
            pad_batch(X[a:b], B), pad_batch(iM_E[a:b], B), targets, E=E,
            tau=tau, Tp=Tp, k=k, impl=impl, Yt=Yt)

    return launch


def master_group_batch_bytes(Lp: int, k_master: int) -> int:
    """Per-series in-flight bytes of one master-derived launch (~4 live
    (Lp, k_master)-sized buffers: validity, sort keys/order, distances)."""
    return 16 * Lp * int(k_master)


def ccm_group_from_master_batched(X, iM_E, targets, *, E, tau, Tp, k, impl,
                                  batch_libs=None,
                                  budget_mb=None) -> np.ndarray:
    """Library-batched CCM block from cached master indices → (N, Nt) ρ."""
    Nl = X.shape[0]
    Lp = num_embedded(X.shape[-1], E, tau)
    if Nl == 0:
        return np.zeros((0, targets.shape[0]), np.float32)
    if batch_libs is not None:
        B = batch_libs
    else:
        B = auto_batch_libs(
            Lp, Nl, budget_mb, device=X.device,
            per_series_bytes=master_group_batch_bytes(Lp, iM_E.shape[-1]))
    B = max(1, min(int(B), Nl))
    telemetry.gauge("edm_batch_libs_effective").set(B)
    launch = make_master_group_launch(X, iM_E, targets, E=E, tau=tau, Tp=Tp,
                                      k=k, impl=impl)
    return drive_batched(Nl, B, launch)


def ccm_group_from_master(X, iM_E, targets, *, E, tau, Tp, k,
                          impl) -> torch.Tensor:
    """Per-series CCM block from cached neighbour indices → (N_lib, N_tgt).

    The cached-session counterpart of ``core.ccm.ccm_group``, one library
    at a time: its indices derived from its master level iM_E (N, L,
    k_master), the k selected distances recomputed, then weights and the
    fused lookup-ρ. The legacy per-series form; the session runs
    ``ccm_group_from_master_batched``, whose rows are the same bits.
    """
    if targets.ndim == 1:
        targets = targets[None, :]
    L = X.shape[-1]
    Lp = num_embedded(L, E, tau)
    rows = pred_rows(L, E, tau, Tp)
    off = embed_offset(E, tau, Tp)
    hard_max = Lp - 1 - max(Tp, 0)
    Yt = ops.lookup_targets(targets, impl=impl)
    out = []
    for x, iE in zip(X, iM_E):
        ik, ok = _derive_idx(iE[:Lp], k=k, max_idx=hard_max)
        d = _gathered_dists(x, ik, ok, E=E, tau=tau)
        w = ops.make_weights(d)
        out.append(ops.lookup_rho(targets, ik[:rows], w[:rows], offset=off,
                                  impl=impl, Yt=Yt))
    if not out:
        return torch.zeros((0, targets.shape[0]), dtype=torch.float32,
                           device=targets.device)
    return torch.stack(out)
