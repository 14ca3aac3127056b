"""Time-delay embedding (Takens) — index conventions.

Embedded point ``i`` has components ``x[i + k*tau], k in [0, E)`` and
corresponds to *time* ``t = i + (E-1)*tau``; ``Lp = L - (E-1)*tau``.
The distance kernels fuse the embedding; ``delay_embed`` materializes it
for tests and yardsticks.
"""

from __future__ import annotations

from repro_torch.kernels.ref import delay_embed, num_embedded  # noqa: F401


def embed_offset(E: int, tau: int, Tp: int = 0) -> int:
    """Embedded-index → time-index offset used by lookups (+ horizon Tp)."""
    return (E - 1) * tau + Tp


def pred_rows(L: int, E: int, tau: int, Tp: int) -> int:
    """Number of embedded rows whose Tp-ahead truth exists in the series."""
    return num_embedded(L, E, tau) - max(Tp, 0)
