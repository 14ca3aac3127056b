"""CUDA kernel: fused all-kNN over one series, the distance matrix never in
global memory.

Port of ``repro/kernels/knn_fused.py`` (Pallas ``_kernel``, wrapper
``all_knn_fused``). Design and bound: ``csrc/knn_fused.cu``. Unlike the
TPU wrapper it does not mean-center the series: neither does the port's
pairwise kernel nor the reference's ``ref.pairwise_distances``, so its
tables are bit-equal to the two-kernel path (``pairwise_dist`` then
``topk``) and to the plain version ``plain`` (``kernels.ref.all_knn``).
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref as _ref

plain = _ref.all_knn

#: Rows per block, one warp each (one copy of the series per block).
WARPS_PER_BLOCK = 16
#: Hopper's per-block dynamic shared memory ceiling.
SMEM_MAX = 232_448


def all_knn_fused(x: torch.Tensor, *, E: int, tau: int = 1,
                  k: int | None = None, exclude_self: bool = True,
                  max_idx=None) -> tuple[torch.Tensor, torch.Tensor]:
    """(L,) CUDA series → (dists, idx), both (Lp, k), ascending.

    ``max_idx`` is a host int (inclusive column cap) or None. Raises when
    L + 32·k passes 58,112 floats: the series and 16 warps' lists must fit
    one block's shared memory.
    """
    if x.device.type != "cuda":
        raise ValueError(f"knn_fused kernel needs a CUDA tensor, got "
                         f"{x.device}")
    if x.ndim != 1:
        raise ValueError(f"x must be (L,), got shape {tuple(x.shape)}")
    L = x.shape[0]
    Lp = _ref.num_embedded(L, E, tau)
    k = E + 1 if k is None else int(k)
    if not 1 <= k <= Lp:
        raise ValueError(f"k={k} must lie in [1, {Lp}] (the row length)")
    smem = (L + 2 * k * WARPS_PER_BLOCK) * 4
    if smem > SMEM_MAX:
        raise ValueError(f"L={L}, k={k} needs {smem} B of shared memory, "
                         f"more than a block has ({SMEM_MAX} B)")
    mx = Lp - 1 if max_idx is None else min(int(max_idx), Lp - 1)
    xc = x.float().contiguous()
    out_d = torch.empty((Lp, k), dtype=torch.float32, device=x.device)
    out_i = torch.empty((Lp, k), dtype=torch.int32, device=x.device)
    fn = _build.entry("knn_fused_launch")
    with torch.cuda.device(x.device):
        err = fn(xc.data_ptr(), L, E, tau, k, max(mx, -1), int(exclude_self),
                 WARPS_PER_BLOCK, out_d.data_ptr(), out_i.data_ptr(),
                 torch.cuda.current_stream().cuda_stream)
    _build.check(err, "knn_fused")
    all_knn_fused.launches += 1
    return out_d, out_i


all_knn_fused.launches = 0
