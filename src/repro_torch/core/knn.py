"""All-k-nearest-neighbour search over one library series (paper §3.3)."""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels import ops


@dataclasses.dataclass(frozen=True)
class KnnTable:
    """Neighbour tables of one library series, computed once and reused
    for every target lookup (paper §2.1)."""

    dists: torch.Tensor  # (Lp, k) Euclidean, ascending
    idx: torch.Tensor    # (Lp, k) int32 embedded indices
    E: int
    tau: int
    k: int

    @property
    def weights(self) -> torch.Tensor:
        """Normalized simplex weights, paper step (3)."""
        return ops.make_weights(self.dists)


def all_knn(x: torch.Tensor, *, E: int, tau: int = 1, k: int | None = None,
            exclude_self: bool = True, max_idx=None, impl: str = "auto",
            variant: str = "vpu", fused: bool = False) -> KnnTable:
    """Pairwise distances + top-k over one series. k defaults to E + 1.

    ``variant`` and ``fused`` pass through to ``ops.all_knn``.
    """
    k = E + 1 if k is None else int(k)
    dists, idx = ops.all_knn(x, E=E, tau=tau, k=k, exclude_self=exclude_self,
                             max_idx=max_idx, impl=impl, variant=variant,
                             fused=fused)
    return KnnTable(dists=dists, idx=idx, E=E, tau=tau, k=k)
