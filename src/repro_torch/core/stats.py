"""Numerically stable correlation/covariance (paper §3.4, ref. [15]).

The Schubert–Gertz pairwise-merge scheme that the lookup-ρ kernel uses
between its row tiles, exposed for tests and host-side streaming use
(merging partial statistics of checkpointed shards). ``pearson_rows`` is
the canonical two-pass form (``kernels.ref.pearson_rows``).
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels.ref import pearson_rows, sqrt_rn

__all__ = ["CoMoments", "pearson_rows"]


@dataclasses.dataclass
class CoMoments:
    """Running (co-)moments of two aligned batches: n, means, M2s, C."""

    n: torch.Tensor
    mean_a: torch.Tensor
    mean_b: torch.Tensor
    m2_a: torch.Tensor
    m2_b: torch.Tensor
    c_ab: torch.Tensor

    @classmethod
    def zeros(cls, shape=(), dtype=torch.float32,
              device=None) -> "CoMoments":
        z = torch.zeros(shape, dtype=dtype, device=device)
        return cls(n=z, mean_a=z, mean_b=z, m2_a=z, m2_b=z, c_ab=z)

    @classmethod
    def from_batch(cls, a: torch.Tensor, b: torch.Tensor, axis: int = -1,
                   where=None) -> "CoMoments":
        """Two-pass moments of one batch (optionally masked)."""
        a = torch.as_tensor(a).float()
        b = torch.as_tensor(b).float()
        if where is None:
            n = torch.full(a.sum(dim=axis).shape, float(a.shape[axis]),
                           dtype=torch.float32, device=a.device)
            ma = a.mean(dim=axis)
            mb = b.mean(dim=axis)
            da, db = a - ma.unsqueeze(axis), b - mb.unsqueeze(axis)
        else:
            w = torch.as_tensor(where, device=a.device).float()
            n = w.sum(dim=axis)
            ns = torch.clamp(n, min=1.0)
            ma = (a * w).sum(dim=axis) / ns
            mb = (b * w).sum(dim=axis) / ns
            da = (a - ma.unsqueeze(axis)) * w
            db = (b - mb.unsqueeze(axis)) * w
        return cls(n=n, mean_a=ma, mean_b=mb,
                   m2_a=(da * da).sum(dim=axis),
                   m2_b=(db * db).sum(dim=axis),
                   c_ab=(da * db).sum(dim=axis))

    def merge(self, other: "CoMoments") -> "CoMoments":
        """Schubert & Gertz (2018) parallel merge — associative, stable."""
        n = self.n + other.n
        ns = torch.clamp(n, min=1.0)
        da = other.mean_a - self.mean_a
        db = other.mean_b - self.mean_b
        f = self.n * other.n / ns
        return CoMoments(
            n=n,
            mean_a=self.mean_a + da * other.n / ns,
            mean_b=self.mean_b + db * other.n / ns,
            m2_a=self.m2_a + other.m2_a + da * da * f,
            m2_b=self.m2_b + other.m2_b + db * db * f,
            c_ab=self.c_ab + other.c_ab + da * db * f,
        )

    @property
    def pearson(self) -> torch.Tensor:
        denom = sqrt_rn(self.m2_a * self.m2_b)
        return torch.where(denom > 0,
                           self.c_ab / torch.clamp(denom, min=1e-30),
                           torch.zeros_like(denom))
