"""CUDA kernel: library-batched all-kNN at one E, one launch for B series.

Port of ``repro/kernels/knn_batch.py`` (Pallas ``_kernel``): the direct
all-pairs CCM engine's neighbour tables, bit-invariant in B. Design and
bound: ``csrc/knn_batch.cu``. The plain version is ``plain``
(``kernels.ref.all_knn_batch``), held bit-exact against it.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref as _ref

plain = _ref.all_knn_batch

#: Rows per block, one warp each.
WARPS_PER_BLOCK = 8
SMEM_MAX = 232_448


def all_knn_batch(X: torch.Tensor, *, E: int, tau: int = 1,
                  k: int | None = None, exclude_self: bool = True,
                  max_idx=None) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, L) CUDA stack → (dists, idx), both (B, Lp, k)."""
    if X.device.type != "cuda":
        raise ValueError(f"knn_batch kernel needs a CUDA tensor, got "
                         f"{X.device}")
    if X.ndim != 2:
        raise ValueError(f"X must be (B, L), got shape {tuple(X.shape)}")
    B, L = X.shape
    Lp = _ref.num_embedded(L, E, tau)
    k = E + 1 if k is None else int(k)
    if k > Lp:
        raise ValueError(f"k={k} exceeds the {Lp} candidates per row")
    if k * WARPS_PER_BLOCK * 8 > SMEM_MAX:
        raise ValueError(f"k={k} does not fit one block's shared memory")
    mx = Lp - 1 if max_idx is None else min(int(max_idx), Lp - 1)
    Xc = X.float().contiguous()
    out_d = torch.empty((B, Lp, k), dtype=torch.float32, device=X.device)
    out_i = torch.empty((B, Lp, k), dtype=torch.int32, device=X.device)
    if B == 0:
        return out_d, out_i
    fn = _build.entry("knn_batch_launch")
    with torch.cuda.device(X.device):
        err = fn(Xc.data_ptr(), B, L, E, tau, k, mx, int(exclude_self),
                 WARPS_PER_BLOCK, out_d.data_ptr(), out_i.data_ptr(),
                 torch.cuda.current_stream().cuda_stream)
    _build.check(err, "knn_batch")
    all_knn_batch.launches += 1
    return out_d, out_i


all_knn_batch.launches = 0
