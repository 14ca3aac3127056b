"""The ``EDM`` session — one facade over the ported EDM main path.

Bind a panel and a config once::

    sess = EDM(panel)                  # on the GPU (device="cuda")
    E_opt, rho = sess.optimal_E()      # one multi-E kNN launch, cached
    skill = sess.simplex()             # read off the cached sweep
    causal = sess.xmap()               # reuses the SAME kNN master tables
    curve = sess.ccm(0, 1, lib_sizes=(50, 200, 500))  # convergence sweep
    sig = sess.surrogate_test(0, 1)    # CCM significance vs a null ensemble
    curves = sess.smap()               # S-Map ρ(θ) per series
    smap_xm = sess.xmap(method="smap") # S-Map cross-map matrix
    sess.append(delta)                 # grow the panel; the master grows

Every method builds a ``Plan`` (``sess.plan(task)`` shows it), then runs
it. The multi-E kNN master built by ``optimal_E`` is held in the session
and reused by ``simplex``/``xmap``/``ccm_batch``/``ccm``; a fixed-E
session's first ``xmap`` takes the direct batched engine instead
(``core.ccm.make_group_launch``), and a ``ccm`` sweep whose library caps
the master's slack cannot cover runs one pass of the convergence engine
(``core.ccm.ccm_convergence_caps``). ``cache=False`` sessions hold no
master: ``optimal_E`` and ``simplex`` run the per-series primitives of
``core.simplex``. ``smap`` and ``xmap(method="smap")`` run the batched
S-Map Gram engine (``core.smap_engine``) once per E-group. ``append``
grows the panel and a cached master in one merge launch
(``plan.panel_master_append``), bit-identical to a rebuild.

``xmap(run_dir=...)`` journals the matrix run through
``edm.runner.MatrixRunner``: resumable, preemptible, and halving its batch
on a CUDA out-of-memory error.

A ``mesh=`` in the config (a ``DeviceMesh``, ``distributed.make_ccm_mesh``)
routes ``optimal_E``, ``smap`` and ``xmap`` through the zero-collective
sharded engines of ``distributed.sharded_ccm``: every rank binds the same
panel, calls the same methods, computes its own block and gets the same
results. Such a session holds no master; ``simplex``, ``ccm``,
``ccm_batch`` and ``surrogate_test`` run the per-series engines locally on
every rank.
"""

from __future__ import annotations

import collections
import dataclasses

import numpy as np
import torch

from repro_torch import telemetry
from repro_torch.core.ccm import (auto_batch_libs, ccm_convergence_caps,
                                  direct_batch_libs, drive_batched,
                                  make_group_launch, normalize_lib_sizes,
                                  pad_batch)
from repro_torch.core.embedding import num_embedded
from repro_torch.core.simplex import optimal_E_batch, simplex_skill
from repro_torch.core.smap_engine import smap_group, smap_theta_sweep
from repro_torch.edm.config import EDMConfig
from repro_torch.edm.dataset import Dataset, resolve_device
from repro_torch.edm.plan import (
    Plan,
    ccm_convergence_from_master,
    ccm_group_from_master_batched,
    make_master_group_launch,
    master_group_batch_bytes,
    master_slack_covers,
    panel_master,
    panel_master_append,
    rho_curves_from_master,
    simplex_skill_from_master,
)
from repro_torch.edm.surrogates import make_surrogates


def _e_groups(E_opt, N: int):
    """Per-series E table → {E: member indices}, kEDM §3.4's grouping."""
    E_opt = np.broadcast_to(np.asarray(E_opt, np.int32), (N,)).copy()
    return E_opt, {
        int(E): np.nonzero(E_opt == E)[0]
        for E in sorted(collections.Counter(E_opt.tolist()))
    }


def session_device(config: EDMConfig) -> torch.device:
    """The session's device; raises when it asks for CUDA and none exists."""
    return resolve_device(config.device, "EDMConfig")


@dataclasses.dataclass
class SurrogateResult:
    """Outcome of one ``EDM.surrogate_test``: score, null ensemble, p."""

    rho: float | np.ndarray            # actual skill ((S,) with lib_sizes)
    surrogate_rho: np.ndarray          # (M,) or (S, M) null ensemble skills
    pvalue: float | np.ndarray         # rank-based, (1 + #{null ≥ ρ})/(1 + M)
    method: str
    num_surrogates: int

    @property
    def significant(self) -> bool | np.ndarray:
        """p < 0.05 (per size when a convergence sweep was run)."""
        return self.pvalue < 0.05


@dataclasses.dataclass
class PanelResult:
    """Results of one queued ``submit_panel`` ticket."""

    E_opt: np.ndarray | None = None
    rho: np.ndarray | None = None          # (N, E_max) optimal-E curves
    xmap: np.ndarray | None = None         # (N, N) cross-map matrix
    smap: np.ndarray | None = None         # (N, |thetas|) θ-sweep skill


class EDM:
    """Session facade: shared kNN state + plan-based dispatch."""

    def __init__(self, data, config: EDMConfig | None = None, **overrides):
        if config is None:
            config = EDMConfig(**overrides)
        elif overrides:
            config = config.replace(**overrides)
        self.device = session_device(config)
        self.data = data if isinstance(data, Dataset) else Dataset(
            data, on_invalid=config.on_invalid, device=self.device)
        if self.data.panel.device != self.device:
            raise ValueError(
                f"Dataset lives on {self.data.panel.device}, config asks "
                f"for {self.device}")
        self.config = config
        config.validate_panel(self.data.N, self.data.L)
        self._impl = config.impl
        self._cache: dict[str, object] = {}
        self.stats: collections.Counter = collections.Counter()
        self._queue: list[tuple[int, np.ndarray, tuple[str, ...]]] = []
        self._next_ticket = 0

    @property
    def impl_name(self) -> str:
        """What runs: "cuda" (the kernels) or "ref" (the plain versions)."""
        return ("ref" if self._impl == "ref" or self.device.type == "cpu"
                else "cuda")

    def _bump(self, key: str, n: int = 1) -> None:
        """Session statistic: ``stats`` and the ``edm_<key>`` counter."""
        self.stats[key] += n
        telemetry.counter(f"edm_{key}").inc(n)

    def _plan_event(self, task: str) -> None:
        if telemetry.active():
            telemetry.event("plan.execute", task=task,
                            plan=self.plan(task).describe())

    # ---------------------------------------------------- validity masking

    @property
    def _invalid(self):
        """Indices of masked-invalid series, or None for clean panels."""
        if self.data.num_invalid == 0:
            return None
        return np.nonzero(~self.data.valid)[0]

    def _mask_rows(self, out: np.ndarray) -> np.ndarray:
        bad = self._invalid
        if bad is not None:
            out = np.array(out, np.float32)
            out[bad] = np.nan
        return out

    def _mask_matrix(self, rho: np.ndarray) -> np.ndarray:
        bad = self._invalid
        if bad is not None:
            rho = np.array(rho, np.float32)
            rho[bad, :] = np.nan
            rho[:, bad] = np.nan
        return rho

    def _pair_invalid(self, *indices) -> bool:
        return any(not self.data.is_valid(i) for i in indices)

    # ------------------------------------------------------------- plans

    def plan(self, task: str, *, E=None) -> Plan:
        """The Plan a method call would execute (introspection)."""
        c = self.config
        sharded = c.mesh is not None
        placement = "sharded" if sharded else "local"
        cached = c.cache and not sharded
        have_master = "master" in self._cache
        have_rho = "rho" in self._cache
        impl = self.impl_name
        if task == "optimal_E":
            return Plan(
                task=task, impl=impl, placement=placement,
                E=f"sweep:1..{c.E_max}", Tp=c.Tp,
                reuse=(("rho",) if have_rho else
                       ("master",) if (cached and have_master) else ()),
                builds=() if have_rho else (
                    ("master", "rho") if cached else ("rho",)),
                detail=("sharded_optimal_E" if sharded else
                        "derive per-E tables from kNN master" if cached
                        else "per-series optimal_E_batch, one multi-E "
                             "launch per series"))
        if task == "simplex":  # local on a mesh too, without a master
            fixed = E or c.E
            if not fixed:
                reuse, detail = ("rho",), "skill read off the cached ρ(E) sweep"
            elif cached:
                reuse, detail = ("master",), ("indices from kNN master, k "
                                              "distances recomputed")
            else:
                reuse, detail = (), ("per-series simplex_skill: pairwise, "
                                     "top-k and lookup launches per series")
            return Plan(
                task=task, impl=impl, placement="local",
                E=f"fixed:{fixed}" if fixed else "per-series", Tp=c.Tp,
                reuse=reuse, builds=(), detail=detail)
        if task == "ccm":
            return Plan(
                task=task, impl=impl, placement="local",
                E=f"fixed:{E or c.E}" if (E or c.E) else "per-series",
                Tp=c.Tp_cross,
                reuse=(("master",) if (cached and have_master) else ())
                + (() if (E or c.E) else ("rho",)), builds=(),
                detail="sweep: capped tables from kNN master when "
                       "k_master slack covers, else one-pass multi-cap "
                       "convergence engine (pairwise + multi-cap top-k)")
        if task == "xmap":
            hit = self._cache.get("master")
            levels = (c.E if c.E else
                      int(self._cache["rho"][0].max()) if have_rho
                      else c.E_max)
            covered = hit is not None and hit[3] >= levels
            master_next = cached and (
                covered or self.stats["xmap_direct_runs"] > 0
                or not (c.E or have_rho))
            return Plan(
                task=task, impl=impl, placement=placement,
                E=f"fixed:{c.E}" if c.E else "per-series", Tp=c.Tp_cross,
                reuse=(("master",) if (cached and covered) else ()) + (
                    () if c.E else ("rho",)),
                builds=(("master",) if (master_next and not covered)
                        else ()) + (() if (c.E or have_rho) else ("rho",)),
                detail=("E-grouped sharded matrix, zero collectives"
                        if sharded else
                        "library-batched lookups on cached kNN master"
                        if master_next
                        else "library-batched direct engine, ceil(N/B) "
                             "launches per E-group"))
        if task == "smap":
            return Plan(
                task=task, impl=impl, placement=placement,
                E=f"fixed:{E or c.E}" if (E or c.E) else "per-series",
                Tp=c.Tp, reuse=() if (E or c.E) else ("rho",), builds=(),
                detail="sharded_smap_theta per E-group" if sharded
                else "batched Gram engine per E-group")
        raise ValueError(f"unknown task {task!r}")

    # ------------------------------------------------------------ caches

    def _master(self, E_levels: int):
        """Multi-E kNN master tables covering levels 1..E_levels.

        Returns (dists, idx, k_master, levels), dists/idx of shape
        (N, E_levels, L, k_master) on the session's device. Built lazily
        at the highest level any method has needed so far; a deeper
        request rebuilds once and re-caches.
        """
        c = self.config
        hit = self._cache.get("master")
        if hit is not None and hit[3] >= E_levels:
            self._bump("knn_master_hits")
            return hit
        k_m = max(E_levels + 1, c.k or 0) + c.slack
        with telemetry.device_span("session.master_build", self.device,
                                   E_levels=E_levels, k_master=k_m,
                                   N=self.data.N):
            dM, iM = panel_master(self.data.panel, E_max=E_levels,
                                  tau=c.tau, k=k_m, impl=self._impl)
        self._bump("knn_master_builds")
        hit = self._cache["master"] = (dM, iM, k_m, E_levels)
        return hit

    def master_nbytes(self) -> int:
        """Resident bytes of the cached multi-E kNN master (0 if none):
        the session's one O(N·E·L·k) cache."""
        hit = self._cache.get("master")
        if hit is None:
            return 0
        return sum(t.numel() * t.element_size() for t in hit[:2])

    def evict_master(self) -> int:
        """Drop the cached kNN master; returns the bytes freed.

        Only a memory event: the next method that needs the master
        rebuilds it from the current panel, and append ≡ cold rebuild
        (bit-identical) makes every later answer, and every later append,
        the same bits as a never-evicted session's.
        """
        freed = self.master_nbytes()
        if freed:
            self._cache.pop("master", None)
            self._bump("knn_master_evictions")
        return freed

    def append(self, delta) -> list[dict]:
        """Grow the bound panel by Δt points, updating the caches.

        The serving tick: the screen covers only the new columns
        (``Dataset.append``), and a cached kNN master grows by
        ``panel_master_append`` — one merge launch for the panel,
        bit-identical to the cold O(L²) rebuild — so a warm session
        absorbs a tick without paying its build again. The optimal-E
        curves summarize the whole panel and are dropped; the master is
        kept. Under ``on_invalid="drop"`` the master rows of dropped
        series are removed to match the panel. A session without a
        master stays without one. Returns ``Dataset.append``'s records
        (pre-append indices).
        """
        c = self.config
        old_N = self.data.N
        with telemetry.span("session.append", N=old_N):
            records = self.data.append(delta)  # raises before mutating
            self._cache.pop("rho", None)
            hit = self._cache.get("master")
            if hit is not None and c.cache:
                dM, iM, k_m, lv = hit
                if records and self.data.N != old_N:  # drop compaction
                    keep = torch.as_tensor(np.setdiff1d(
                        np.arange(old_N), [r["index"] for r in records]),
                        device=self.device)
                    dM, iM = dM[keep], iM[keep]
                dt = self.data.L - int(dM.shape[2])
                with telemetry.span("session.master_append", dt=dt,
                                    E_levels=lv, N=self.data.N):
                    dM, iM = panel_master_append(
                        self.data.panel, dM, iM, tau=c.tau, impl=self._impl)
                self._cache["master"] = (dM, iM, k_m, lv)
                self._bump("knn_master_appends")
            else:
                self._cache.pop("master", None)
            self._bump("appends")
        return records

    def _rho(self):
        """Cached (E_opt, rho-curve) pair, computing it on first use."""
        hit = self._cache.get("rho")
        if hit is None:
            hit = self._cache["rho"] = self._run_optimal_E()
        else:
            self._bump("rho_hits")
        return hit

    # ---------------------------------------------------------- optimal E

    def _run_optimal_E(self) -> tuple[np.ndarray, np.ndarray]:
        c = self.config
        if c.mesh is not None:
            from repro_torch.distributed.sharded_ccm import (
                _agreed, gather_host, pad_to_multiple, sharded_optimal_E)
            Xp = pad_to_multiple(self.data.panel,
                                 c.mesh_axis_size(c.lib_axes))
            E_dt, rho_dt = _agreed(lambda: sharded_optimal_E(
                Xp, E_max=c.E_max, tau=c.tau, Tp=c.Tp, mesh=c.mesh,
                axes=c.lib_axes, impl=self._impl))
            E_opt = gather_host(E_dt)[: self.data.N]
            rho = gather_host(rho_dt)[: self.data.N]
        elif c.cache:
            dM, iM, _, _ = self._master(c.E_max)
            rho = rho_curves_from_master(
                self.data.panel, dM[:, :c.E_max], iM[:, :c.E_max],
                E_max=c.E_max, tau=c.tau, Tp=c.Tp, impl=self._impl)
            rho = rho.cpu().numpy()
            E_opt = (np.argmax(rho, axis=1) + 1).astype(np.int32)
        else:
            E_opt, rho = optimal_E_batch(self.data.panel, E_max=c.E_max,
                                         tau=c.tau, Tp=c.Tp, impl=self._impl)
            E_opt, rho = E_opt.cpu().numpy(), rho.cpu().numpy()
        bad = self._invalid
        if bad is not None:
            # Masked-invalid series: pin E to 1 (a deterministic group)
            # and NaN the ρ(E) curve so everything read off it inherits it.
            E_opt = E_opt.copy()
            E_opt[bad] = 1
            rho = np.array(rho, np.float32)
            rho[bad] = np.nan
        return E_opt, rho

    def optimal_E(self) -> tuple[np.ndarray, np.ndarray]:
        """Per-series optimal embedding dimension and the ρ(E) sweep.

        Returns (E_opt (N,) int32, rho (N, E_max)). Cached, as is the kNN
        master built for it.
        """
        with telemetry.span("session.optimal_E", E_max=self.config.E_max,
                            N=self.data.N):
            self._plan_event("optimal_E")
            E_opt, rho = self._rho()
        return E_opt.copy(), rho.copy()

    # ------------------------------------------------------------ simplex

    def simplex(self, E: int | None = None) -> np.ndarray:
        """Leave-one-out simplex forecast skill per series → (N,) ρ.

        ``E=None`` with a per-series config reads the skill off the cached
        optimal-E sweep; a fixed E derives its table from the cached master.
        """
        c = self.config
        E = E if E is not None else c.E
        with telemetry.span("session.simplex", N=self.data.N,
                            E=E or "per-series"):
            if E is None:
                E_opt, rho = self._rho()
                return rho[np.arange(self.data.N), E_opt - 1].copy()
            if not c.cache or c.mesh is not None:
                return self._mask_rows(torch.stack([
                    simplex_skill(x, E=E, tau=c.tau, Tp=c.Tp,
                                  impl=self._impl)
                    for x in self.data.panel]).cpu().numpy())
            _, iM, _, _ = self._master(E)
            return self._mask_rows(simplex_skill_from_master(
                self.data.panel, iM[:, E - 1], E=E, tau=c.tau, Tp=c.Tp,
                k=c.k_for(E), impl=self._impl).cpu().numpy())

    # -------------------------------------------------------------- smap

    def smap(self, E: int | None = None, thetas=None) -> np.ndarray:
        """S-Map θ-sweep (nonlinearity test) per series → (N, |θ|) ρ.

        Per-series E (the default) groups the series by their cached
        optimal E; each group is one ``core.smap_theta_sweep`` call.
        """
        c = self.config
        thetas = c.thetas if thetas is None else tuple(
            float(t) for t in thetas)
        E = E if E is not None else c.E
        with telemetry.span("session.smap", N=self.data.N,
                            E=E or "per-series", thetas=len(thetas)):
            self._plan_event("smap")
            if E is not None:
                groups = {int(E): np.arange(self.data.N)}
            else:
                _, groups = _e_groups(self._rho()[0], self.data.N)
            out = np.zeros((self.data.N, len(thetas)), np.float32)
            for Eg, members in groups.items():
                out[members] = self._smap_group_sweep(Eg, members, thetas)
            return self._mask_rows(out)

    def _smap_group_sweep(self, E, members, thetas) -> np.ndarray:
        c = self.config
        if c.mesh is not None:
            from repro_torch.distributed.sharded_ccm import (
                _agreed, gather_host, pad_members, sharded_smap_theta)
            padded = pad_members(np.asarray(members),
                                 c.mesh_axis_size(c.lib_axes))
            X = self.data.panel[torch.as_tensor(padded, device=self.device)]
            rho = _agreed(lambda: sharded_smap_theta(
                X, E=E, tau=c.tau, Tp=c.Tp, thetas=thetas, ridge=c.ridge,
                mesh=c.mesh, axes=c.lib_axes, impl=self._impl))
            return gather_host(rho)[: len(members)]
        X = self.data.panel[torch.as_tensor(members, device=self.device)]
        return smap_theta_sweep(X, E=E, tau=c.tau, Tp=c.Tp, thetas=thetas,
                                ridge=c.ridge,
                                impl=self._impl).cpu().numpy()

    # --------------------------------------------------------------- ccm

    def _resolve_pair_E(self, target_index: int, E: int | None) -> int:
        """E for a pairwise call: arg > config > target's cached optimum."""
        if E is None:
            E = self.config.E
        if E is None:
            E_opt, _ = self._rho()
            E = int(E_opt[target_index])
        return int(E)

    def ccm(self, lib, target, *, lib_sizes=None,
            E: int | None = None) -> np.ndarray:
        """Convergent cross mapping between two panel series.

        Embeds series ``lib``'s manifold and cross-maps ``target`` (high
        skill = evidence "target causes lib"). ``lib_sizes`` returns the
        convergence curve — ρ rising with library size is CCM's causality
        criterion. E defaults to the target's cached optimal E.

        A sweep never re-scans per size: when the cached kNN master's
        slack covers every cap (``master_slack_covers``) the per-size
        tables are derived from it with no kNN launch, otherwise one
        pairwise and one multi-cap top-k launch serve all sizes.
        """
        li = self.data.index_of(lib)
        ti = self.data.index_of(target)
        if self._pair_invalid(li, ti):  # masked series: NaN, no engine run
            if lib_sizes is None:
                return np.float32(np.nan)
            return np.full(len(tuple(lib_sizes)), np.nan, np.float32)
        E = self._resolve_pair_E(ti, E)
        with telemetry.span("session.ccm", lib=li, target=ti, E=E,
                            sweep=lib_sizes is not None):
            self._plan_event("ccm")
            curves = self._ccm_curves(li, self.data.panel[ti][None, :], E=E,
                                      lib_sizes=self._lib_sizes(E, lib_sizes))
        return curves[0, 0] if lib_sizes is None else curves[:, 0]

    def _lib_sizes(self, E: int, lib_sizes):
        """The sizes asked for, or the one full usable library."""
        if lib_sizes is not None:
            return lib_sizes
        Lp = num_embedded(self.data.L, E, self.config.tau)
        return (Lp - max(self.config.Tp_cross, 0),)

    def _ccm_curves(self, li: int, targets, *, E: int,
                    lib_sizes) -> np.ndarray:
        """(num_sizes, Nt) convergence grid against library ``li``.

        Derived from the cached master when its slack covers every cap,
        else one pass of the convergence engine. k is the simplex default
        E + 1, whatever ``config.k`` says.
        """
        c = self.config
        x = self.data.panel[li]
        Lp = num_embedded(self.data.L, E, c.tau)
        caps, inv = normalize_lib_sizes(lib_sizes, Lp=Lp, Tp=c.Tp_cross)
        k = E + 1
        hit = self._cache.get("master")
        if (c.cache and c.mesh is None and hit is not None and hit[3] >= E
                and master_slack_covers(caps, Lp=Lp, k=k, k_master=hit[2])):
            self._bump("knn_master_hits")
            curves = ccm_convergence_from_master(
                x, hit[1][li, E - 1], targets, E=E, tau=c.tau,
                Tp=c.Tp_cross, caps=caps, k=k, impl=self._impl)
        else:
            curves = ccm_convergence_caps(
                x, targets, E=E, tau=c.tau, Tp=c.Tp_cross, caps=caps,
                exclude_self=True, impl=self._impl)
        return curves.cpu().numpy()[inv]

    def surrogate_test(self, lib, target, *, num_surrogates: int = 100,
                       method: str = "shuffle", period: int | None = None,
                       lib_sizes=None, E: int | None = None,
                       seed: int = 0) -> SurrogateResult:
        """CCM significance: rank the real skill against a null ensemble.

        Makes ``num_surrogates`` null versions of ``target``
        (``edm.surrogates``) and cross-maps all of them with the real
        series as one (M+1)-target curve grid, sharing the library's
        neighbour tables. Returns a ``SurrogateResult`` with the one-sided
        rank p-value ``(1 + #{ρ_null ≥ ρ}) / (1 + M)`` (per size when
        ``lib_sizes`` is given).
        """
        li = self.data.index_of(lib)
        ti = self.data.index_of(target)
        if self._pair_invalid(li, ti):  # masked series: NaN verdict
            if lib_sizes is None:
                return SurrogateResult(
                    float("nan"),
                    np.full(num_surrogates, np.nan, np.float32),
                    float("nan"), method, num_surrogates)
            S = len(tuple(lib_sizes))
            return SurrogateResult(
                np.full(S, np.nan, np.float32),
                np.full((S, num_surrogates), np.nan, np.float32),
                np.full(S, np.nan), method, num_surrogates)
        E = self._resolve_pair_E(ti, E)
        with telemetry.span("session.surrogate_test", lib=li, target=ti,
                            E=E, M=num_surrogates, method=method):
            y = self.data.panel[ti]
            surr = make_surrogates(y.cpu().numpy(), num_surrogates,
                                   method=method, period=period, seed=seed)
            targets = torch.cat([y[None, :],
                                 torch.as_tensor(surr, device=self.device)])
            curves = self._ccm_curves(li, targets, E=E,
                                      lib_sizes=self._lib_sizes(E, lib_sizes))
        rho = curves[:, 0]
        null = curves[:, 1:]
        pval = ((1.0 + (null >= rho[:, None]).sum(axis=1))
                / (1.0 + num_surrogates))
        self._bump("surrogate_tests")
        if lib_sizes is None:
            return SurrogateResult(float(rho[0]), null[0], float(pval[0]),
                                   method, num_surrogates)
        return SurrogateResult(rho, null, pval, method, num_surrogates)

    def ccm_batch(self, pairs, *, E: int) -> np.ndarray:
        """Full-library CCM skill for many (lib, target) pairs → (n,) ρ.

        One library-batched master-derived launch per call; a pair's ρ is
        the same whatever other pairs share its batch (batch invariance).
        Pairs touching masked-invalid series come back NaN. Without a
        covering cached master (``cache=False``, or a master whose slack
        the horizon exhausts) each pair runs through ``ccm``.
        """
        c = self.config
        E = int(E)
        idx = [(self.data.index_of(l), self.data.index_of(t))
               for l, t in pairs]
        out = np.full(len(idx), np.nan, np.float32)
        live = [(j, li, ti) for j, (li, ti) in enumerate(idx)
                if not self._pair_invalid(li, ti)]
        if not live:
            return out
        Lp = num_embedded(self.data.L, E, c.tau)
        cap = Lp - max(c.Tp_cross, 0)
        k = E + 1
        hit = self._master(E) if c.cache and c.mesh is None else None
        if hit is None or not master_slack_covers(
                (cap,), Lp=Lp, k=k, k_master=hit[2]):
            for j, li, ti in live:
                out[j] = self.ccm(li, ti, E=E)
            return out
        libs = sorted({li for _, li, _ in live})
        lpos = {li: i for i, li in enumerate(libs)}
        la = torch.as_tensor(libs, device=self.device)
        with telemetry.span("session.ccm_batch", pairs=len(idx),
                            libs=len(libs), E=E):
            self._plan_event("ccm")
            g = ccm_group_from_master_batched(
                self.data.panel[la], hit[1][la, E - 1], self.data.panel,
                E=E, tau=c.tau, Tp=c.Tp_cross, k=k, impl=self._impl)
        for j, li, ti in live:
            out[j] = g[lpos[li], ti]
        self._bump("ccm_batch_pairs", len(live))
        return out

    # -------------------------------------------------------------- xmap

    def xmap(self, method: str = "simplex", *, E_opt=None,
             theta: float | None = None,
             run_dir: str | None = None) -> np.ndarray:
        """All-pairs cross-map skill matrix → (N, N) ρ.

        Entry (l, t) = skill of cross-mapping series t from series l's
        manifold at t's optimal E (evidence "t causes l"). Each E-group
        runs as ceil(N/B) library-batched launches double-buffered against
        host assembly; a cached kNN master supplies the neighbour indices,
        otherwise the direct ``all_knn_batch`` engine runs.
        ``method="smap"`` swaps both for the batched S-Map engine
        (``core.smap_group``) at locality ``theta`` (default
        ``config.theta``). Where float32 cannot solve a library's ridge
        systems — a rank-deficient Gram (a period-3 series at E 3) or
        repeated points (a periodic orbit) — those systems are solved
        again from the series in float64, so the library's row is the
        float64 S-Map's (its own entry 1.0 for a period-3 series), where
        the JAX reference returns ρ 0 on a failed factorization
        (``core.smap_engine``).

        ``run_dir=`` makes the run fault-tolerant and resumable
        (``edm.runner``): every engine tile is journaled under that
        directory, SIGTERM/SIGINT checkpoints and exits with code
        ``runner.PREEMPTED_EXIT`` (17), a CUDA out-of-memory error halves
        the batch and retries, and calling again with the same run_dir
        resumes bit-identically from the last committed tile — a
        completed journal returns the stored matrix with no launch. The
        journal is keyed by a content hash of panel + config (device type
        included) + task, so a stale run_dir is refused, never reused.
        Masked-invalid series are NaN rows/columns of the result (and
        named in ``run_dir/report.json``).
        """
        if method not in ("simplex", "smap"):
            raise ValueError(f"unknown xmap method {method!r}")
        c = self.config
        N = self.data.N
        with telemetry.span("session.xmap", method=method, N=N,
                            journaled=run_dir is not None,
                            placement=("sharded" if c.mesh is not None
                                       else "local")):
            self._plan_event("xmap")
            if E_opt is None:
                E_opt = np.full(N, c.E, np.int32) if c.E else self._rho()[0]
            E_opt, groups = _e_groups(E_opt, N)
            if c.mesh is not None:
                rho = self._xmap_sharded(method, E_opt, theta, run_dir)
            else:
                rho = self._xmap_local(method, groups, theta, run_dir,
                                       E_opt)
            return self._mask_matrix(rho)

    def _xmap_group_launch(self, method, E, members, theta, iM):
        """One E-group's engine as a ``launch(a, b, B)`` closure + its B."""
        c = self.config
        X = self.data.panel
        N = self.data.N
        tgts = X[torch.as_tensor(members, device=self.device)]
        Lp = num_embedded(self.data.L, E, c.tau)
        if method == "smap":
            th = float(c.theta if theta is None else theta)

            def launch(a, b, B):
                return smap_group(pad_batch(X[a:b], B), tgts, E=E,
                                  tau=c.tau, Tp=c.Tp_cross, theta=th,
                                  ridge=c.ridge, impl=self._impl)

            return launch, min(N, c.batch_libs) if c.batch_libs else N
        if iM is not None:
            launch = make_master_group_launch(
                X, iM[:, E - 1], tgts, E=E, tau=c.tau, Tp=c.Tp_cross,
                k=c.k_for(E), impl=self._impl)
            B = c.batch_libs or auto_batch_libs(
                Lp, N, c.batch_budget_mb, device=self.device,
                per_series_bytes=master_group_batch_bytes(
                    Lp, iM.shape[-1]))
            return launch, max(1, min(int(B), N))
        launch = make_group_launch(X, tgts, E=E, tau=c.tau, Tp=c.Tp_cross,
                                   k=c.k_for(E), impl=self._impl)
        return launch, direct_batch_libs(
            N, self.data.L, len(members), E=E, tau=c.tau, Tp=c.Tp_cross,
            k=c.k_for(E), impl=self._impl, device=self.device,
            batch_libs=c.batch_libs, budget_mb=c.batch_budget_mb)

    def _xmap_local(self, method, groups, theta, run_dir=None,
                    E_opt=None) -> np.ndarray:
        """Local all-pairs matrix: library-batched engine per E-group.

        For simplex, a cached master covering the needed levels supplies
        the indices; otherwise the direct engine runs — a one-shot matrix
        does not pay for a master it would use once, a repeated one
        (second direct run on a caching session) builds it. S-Map uses
        no kNN state. With ``run_dir`` the same launches run under the
        journaled ``MatrixRunner``.
        """
        c = self.config
        N = self.data.N
        simplex = method == "simplex"
        hit = self._cache.get("master")
        use_master = (simplex and c.cache and hit is not None
                      and hit[3] >= max(groups))
        if (simplex and c.cache and not use_master
                and self.stats["xmap_direct_runs"] > 0):
            use_master = True
        if use_master:
            iM = self._master(max(groups))[1]
        else:
            iM = None
            if simplex and c.cache:
                self._bump("xmap_direct_runs")
        entries = [
            (E, members) + self._xmap_group_launch(method, E, members,
                                                   theta, iM)
            for E, members in groups.items()]
        if run_dir is not None:
            return self._run_journaled(run_dir, method, theta, entries,
                                       E_opt)
        rho = np.zeros((N, N), np.float32)
        for E, members, launch, B in entries:
            block = drive_batched(N, B, launch)
            with telemetry.span("session.assemble", E=E, n=len(members)):
                rho[:, members] = block
        return rho

    def _xmap_sharded(self, method, E_opt, theta,
                      run_dir=None) -> np.ndarray:
        """Mesh all-pairs matrix: one E-grouped sharded matrix call (each
        rank its block, one gather at delivery).

        Journaled, the library rows are cut into chunks of
        ``run_tile_rows`` rounded up to full lib shards (by default about
        8 chunks), each chunk one sharded call through the same
        ``MatrixRunner`` (rows are independent, so chunking keeps the
        bits), with the E-group target layout computed once.
        """
        from repro_torch.distributed.sharded_ccm import (
            _egroup_layout, sharded_ccm_matrix, sharded_smap_matrix)
        c = self.config
        X = self.data.panel
        N = self.data.N

        def matrix(X_lib, layout=None):
            if method == "smap":
                return sharded_smap_matrix(
                    X_lib, X, E_opt=E_opt, tau=c.tau, Tp=c.Tp_cross,
                    theta=float(c.theta if theta is None else theta),
                    ridge=c.ridge, mesh=c.mesh, lib_axes=c.lib_axes,
                    tgt_axes=c.tgt_axes, impl=self._impl, layout=layout)
            return sharded_ccm_matrix(
                X_lib, X, E_opt=E_opt, tau=c.tau, Tp=c.Tp_cross,
                mesh=c.mesh, lib_axes=c.lib_axes, tgt_axes=c.tgt_axes,
                impl=self._impl, batch_libs=c.batch_libs,
                batch_budget_mb=c.batch_budget_mb, layout=layout)

        if run_dir is None:
            return matrix(X)
        S_l = c.mesh_axis_size(c.lib_axes)
        layout = _egroup_layout(torch.as_tensor(E_opt, device=self.device),
                                c.mesh_axis_size(c.tgt_axes))
        tile = c.run_tile_rows or max(S_l, -(-N // 8))
        tile = -(-int(tile) // S_l) * S_l  # round up to full lib shards

        def launch(a, b, B):
            return torch.from_numpy(matrix(X[a:b], layout=layout))

        return self._run_journaled(run_dir, method, theta,
                                   [(0, np.arange(N), launch, tile)], E_opt)

    def _run_journaled(self, run_dir, method, theta, entries,
                       E_opt) -> np.ndarray:
        """Drive xmap tile groups through a journaled ``MatrixRunner``."""
        from repro_torch.edm.runner import MatrixRunner, run_key
        c = self.config
        N = self.data.N
        groups_sig = [[E, len(members)] for E, members, _, _ in entries]
        th = (float(c.theta if theta is None else theta)
              if method == "smap" else None)
        # The task signature hashes the FULL per-series E table, not a
        # group-size summary: E_opt=[2,3] vs [3,2] keep group sizes but
        # assign different manifolds, and must key to different runs.
        e_table = np.ascontiguousarray(
            np.broadcast_to(np.asarray(E_opt, np.int32), (N,)))
        key = run_key(self.data.panel, c,
                      ("xmap", method, th, e_table.tobytes()))
        runner = MatrixRunner(
            run_dir, key=key, shape=(N, N), groups_sig=groups_sig,
            keep=c.checkpoint_keep, checkpoint_every=c.checkpoint_every,
            oom_retries=c.oom_retries,
            invalid_series=self.data.invalid_report,
            straggler_threshold=c.straggler_threshold, mesh=c.mesh)
        if runner.complete:
            # Finished journal: the stored matrix IS the result — zero
            # engine launches (restart loops may re-run unconditionally).
            self._bump("runs_short_circuited")
            runner.close()  # release the run_dir lock
            return runner.result()
        with runner:
            for g, (E, members, launch, B) in enumerate(entries):
                runner.drive_group(g, launch, B, members)
            out = runner.finalize()
        self._bump("rows_resumed", runner.resumed_rows)
        return out

    # ------------------------------------------------------ batched entry

    def submit_panel(self, panel, tasks=("optimal_E",)) -> int:
        """Queue a panel for batched execution; returns a ticket id.

        Queued panels of the same length are concatenated and driven
        through one session per task at ``flush()``.
        """
        allowed = ("optimal_E", "smap", "xmap")
        tasks = tuple(tasks)
        for t in tasks:
            if t not in allowed:
                raise ValueError(f"unknown task {t!r}; expected {allowed}")
        panel = np.asarray(panel, np.float32)
        if panel.ndim == 1:
            panel = panel[None, :]
        ticket = self._next_ticket
        self._next_ticket += 1
        self._queue.append((ticket, panel, tasks))
        return ticket

    def flush(self) -> dict[int, PanelResult]:
        """Run every queued panel; returns {ticket: PanelResult}."""
        queue, self._queue = self._queue, []
        with telemetry.span("session.flush", panels=len(queue)):
            return self._flush_batches(queue)

    def _flush_batches(self, queue) -> dict[int, PanelResult]:
        results = {t: PanelResult() for t, _, _ in queue}
        batches: dict[tuple, list] = collections.defaultdict(list)
        for ticket, panel, tasks in queue:
            batches[(panel.shape[1], tasks)].append((ticket, panel))
        for (L, tasks), items in batches.items():
            big = np.concatenate([p for _, p in items], axis=0)
            sess = EDM(big, self.config)
            offs = np.cumsum([0] + [p.shape[0] for _, p in items])
            if "optimal_E" in tasks:
                E_opt, rho = sess.optimal_E()
                for (ticket, _), a, b in zip(items, offs, offs[1:]):
                    results[ticket].E_opt = E_opt[a:b]
                    results[ticket].rho = rho[a:b]
            if "smap" in tasks:
                sweep = sess.smap()
                for (ticket, _), a, b in zip(items, offs, offs[1:]):
                    results[ticket].smap = sweep[a:b]
            if "xmap" in tasks:
                # Cross terms force per-panel matrices, but the batch
                # session's per-series state slices cleanly: each panel
                # gets its E_opt slice and its rows of the kNN master.
                E_all = None if self.config.E else sess._rho()[0]
                master = sess._cache.get("master")
                for (ticket, panel), a, b in zip(items, offs, offs[1:]):
                    psess = EDM(panel, self.config)
                    if master is not None:
                        dM, iM, k_m, lv = master
                        psess._cache["master"] = (dM[a:b], iM[a:b], k_m, lv)
                    results[ticket].xmap = psess.xmap(
                        E_opt=None if E_all is None else E_all[a:b])
            self._bump("panels_flushed", len(items))
        return results
