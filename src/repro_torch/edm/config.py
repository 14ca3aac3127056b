"""``EDMConfig`` — one frozen, validated home for the EDM hyperparameters.

Mirrors ``repro.edm.config`` for the fields the port's session uses, plus
``device``. ``__post_init__`` checks what is knowable without data;
``validate_panel`` checks the config against a concrete (N, L) panel.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.core.embedding import num_embedded, pred_rows
from repro_torch.core.smap_engine import DEFAULT_THETAS
from repro_torch.kernels import ops

#: Accepted ``on_invalid`` panel policies (see ``edm.dataset``).
INVALID_POLICIES = ("raise", "mask", "drop")


@dataclasses.dataclass(frozen=True)
class EDMConfig:
    """Frozen EDM session configuration.

    E:        fixed embedding dimension; ``None`` means per-series optimal
              E (the session sweeps 1..E_max and caches it).
    E_max:    upper bound of the optimal-E sweep.
    tau:      time-delay lag.
    Tp:       forecast horizon of simplex / optimal-E.
    Tp_cross: cross-map horizon of ccm / xmap (kEDM uses 0).
    theta, thetas, ridge: S-Map locality of ``xmap(method="smap")``, θ
              grid of ``smap()``, and ridge strength.
    k:        neighbour count; ``None`` means the simplex default E + 1.
    extra_slack: kNN-master columns beyond the horizon minimum.
    batch_libs: library batch size B of the all-pairs engine; ``None``
              sizes it to ``batch_budget_mb``. Results are bit-invariant
              in B.
    batch_budget_mb: memory budget (MB) of that rule, counting what one
              launch holds in flight on the path it takes (the direct
              engine: ``core.ccm.direct_batch_bytes``, a library's
              (Lp, Lp) distances on the plain path, its (Lp, k) tables,
              weights and ρ partials on the kernel path); ``None`` picks
              the device default (32 on the CPU, 256 on the GPU).
    impl:     "auto" (kernels on CUDA tensors, plain versions on the CPU)
              or "ref" (plain versions everywhere).
    device:   torch device of the session's tensors. "cuda" (default)
              raises at bind time when CUDA is absent; nothing falls back
              to the CPU unless ``device="cpu"`` is asked for.
    mesh:     a ``torch.distributed.device_mesh.DeviceMesh`` with named
              dims (``distributed.make_ccm_mesh``) routes ``optimal_E``,
              ``smap`` and ``xmap`` through the zero-collective sharded
              engines of ``distributed.sharded_ccm``; every rank binds the
              same panel and calls the same methods. ``None`` stays local.
              Its device type must be ``device``'s.
    lib_axes / tgt_axes: mesh axis names of the library / target
              decomposition (matching ``distributed.sharded_ccm``).
    pad:      auto-pad panels to mesh multiples (``False`` = reject
              panels the mesh does not divide evenly).
    cache:    hold the kNN master / E_opt in the session for reuse.
    on_invalid: NaN/Inf/constant-series policy ("raise" | "mask" |
              "drop", see ``edm.dataset.Dataset``).
    checkpoint_keep, checkpoint_every, oom_retries, straggler_threshold:
              the journaled ``xmap(run_dir=)``'s snapshots kept, tiles per
              snapshot (``None``: about 8 a group), halve-B rungs on OOM,
              and straggler factor over the rolling median
              (``edm.runner.MatrixRunner``).
    run_tile_rows: journal tile height (library rows) of a sharded
              ``xmap(run_dir=...)``: the mesh path runs one sharded matrix
              call per chunk of library rows so completed chunks persist;
              ``None`` auto-sizes about 8 tiles, rounded up to the lib-shard
              count. Local runs tile at the engine's batch B and ignore it.
    """

    E: int | None = None
    E_max: int = 20
    tau: int = 1
    Tp: int = 1
    Tp_cross: int = 0
    theta: float = 1.0
    thetas: tuple[float, ...] = DEFAULT_THETAS
    k: int | None = None
    extra_slack: int = 0
    batch_libs: int | None = None
    batch_budget_mb: float | None = None
    ridge: float = 1e-6
    impl: str = "auto"
    device: str = "cuda"
    mesh: Any = None
    lib_axes: tuple[str, ...] = ("data",)
    tgt_axes: tuple[str, ...] = ("model",)
    pad: bool = True
    cache: bool = True
    on_invalid: str = "raise"
    checkpoint_keep: int = 3
    checkpoint_every: int | None = None
    oom_retries: int = 4
    run_tile_rows: int | None = None
    straggler_threshold: float = 2.0

    def __post_init__(self):
        if self.E is not None and self.E < 1:
            raise ValueError(f"E must be >= 1, got {self.E}")
        if self.E_max < 1:
            raise ValueError(f"E_max must be >= 1, got {self.E_max}")
        if self.E is not None and self.E > self.E_max:
            object.__setattr__(self, "E_max", self.E)
        if self.tau < 1:
            raise ValueError(f"tau must be >= 1, got {self.tau}")
        if self.Tp < 0 or self.Tp_cross < 0:
            raise ValueError(
                f"horizons must be >= 0, got Tp={self.Tp}, "
                f"Tp_cross={self.Tp_cross}")
        if self.theta < 0:
            raise ValueError(f"theta must be >= 0, got {self.theta}")
        thetas = tuple(float(t) for t in self.thetas)
        if not thetas:
            raise ValueError("thetas grid must not be empty")
        if any(t < 0 for t in thetas):
            raise ValueError(f"thetas must all be >= 0, got {thetas}")
        object.__setattr__(self, "thetas", thetas)
        if self.k is not None and self.k < 1:
            raise ValueError(f"k must be >= 1, got {self.k}")
        if self.extra_slack < 0:
            raise ValueError(
                f"extra_slack must be >= 0, got {self.extra_slack}")
        if self.batch_libs is not None and self.batch_libs < 1:
            raise ValueError(
                f"batch_libs must be >= 1, got {self.batch_libs}")
        if self.batch_budget_mb is not None and self.batch_budget_mb <= 0:
            raise ValueError(
                f"batch_budget_mb must be > 0, got {self.batch_budget_mb}")
        if self.ridge < 0:
            raise ValueError(f"ridge must be >= 0, got {self.ridge}")
        ops.check_impl(self.impl)
        if self.on_invalid not in INVALID_POLICIES:
            raise ValueError(
                f"unknown on_invalid policy {self.on_invalid!r}; expected "
                f"one of {INVALID_POLICIES}")
        if self.checkpoint_keep < 1:
            raise ValueError(
                f"checkpoint_keep must be >= 1, got {self.checkpoint_keep}")
        if self.checkpoint_every is not None and self.checkpoint_every < 1:
            raise ValueError(
                f"checkpoint_every must be >= 1, got {self.checkpoint_every}")
        if self.oom_retries < 0:
            raise ValueError(
                f"oom_retries must be >= 0, got {self.oom_retries}")
        if self.run_tile_rows is not None and self.run_tile_rows < 1:
            raise ValueError(
                f"run_tile_rows must be >= 1, got {self.run_tile_rows}")
        if not self.straggler_threshold > 0:
            raise ValueError(
                f"straggler_threshold must be > 0, got "
                f"{self.straggler_threshold}")
        object.__setattr__(self, "lib_axes", tuple(self.lib_axes))
        object.__setattr__(self, "tgt_axes", tuple(self.tgt_axes))
        if self.mesh is not None:
            self._check_mesh()

    def _check_mesh(self) -> None:
        from torch.distributed.device_mesh import DeviceMesh

        if not isinstance(self.mesh, DeviceMesh):
            raise ValueError(
                f"mesh must be a torch.distributed DeviceMesh "
                f"(distributed.make_ccm_mesh), got {type(self.mesh).__name__}")
        names = tuple(self.mesh.mesh_dim_names or ())
        for ax in self.lib_axes + self.tgt_axes:
            if ax not in names:
                raise ValueError(f"mesh has axes {names}, missing {ax!r}")
        if self.mesh.device_type != torch.device(self.device).type:
            raise ValueError(
                f"a {self.mesh.device_type} mesh for device={self.device!r}: "
                f"the mesh's device type must be the session's")

    # ------------------------------------------------------------ derived

    def k_for(self, E: int) -> int:
        """Neighbour count at dimension E (simplex default E + 1)."""
        return (E + 1) if self.k is None else self.k

    @property
    def slack(self) -> int:
        """Extra master columns so every planned ``max_idx`` cap can be
        applied post hoc: one candidate per horizon step, plus
        ``extra_slack``."""
        return max(1, self.Tp, self.Tp_cross) + self.extra_slack

    def mesh_axis_size(self, axes: tuple[str, ...]) -> int:
        from repro_torch.distributed.sharded_ccm import mesh_axes_size
        return mesh_axes_size(self.mesh, axes)

    # --------------------------------------------------------- validation

    def validate_panel(self, N: int, L: int) -> None:
        """Bind-time checks against a concrete (N, L) panel."""
        E_chk = self.E if self.E is not None else self.E_max
        num_embedded(L, E_chk, self.tau)  # raises "series too short"
        rows = pred_rows(L, E_chk, self.tau, self.Tp)
        if self.k is not None and self.k > rows:
            raise ValueError(
                f"k={self.k} exceeds the {rows} prediction rows of an "
                f"(L={L}, E={E_chk}, tau={self.tau}, Tp={self.Tp}) panel")
        if self.mesh is not None and not self.pad:
            for axes in (self.lib_axes, self.tgt_axes):
                size = self.mesh_axis_size(axes)
                if N % size != 0:
                    raise ValueError(
                        f"mesh axes {axes} (size {size}) do not divide the "
                        f"{N}-series panel; pass pad=True or pad the panel")

    def replace(self, **changes) -> "EDMConfig":
        """A copy with ``changes`` applied (and re-validated)."""
        return dataclasses.replace(self, **changes)
