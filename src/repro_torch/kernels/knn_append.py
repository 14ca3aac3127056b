"""CUDA kernel: grow a panel's multi-E kNN master by dt appended points.

Port of ``repro/kernels/knn_append.py`` (Pallas ``_select_kernel`` inside
``_master_append``). The TPU path runs per series, XLA forming the
candidate values and the Pallas kernel selecting; here one launch forms
and selects for the whole panel and every level. Design and bound:
``csrc/knn_append.cu``. The plain version is ``plain``
(``kernels.ref.master_append``), held bit-exact against it, and both are
bit-identical to a cold ``all_knn_multi_e`` build of the grown panel.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref as _ref

plain = _ref.master_append

#: Rows per block, one warp each.
WARPS_PER_BLOCK = 8
#: Hopper's per-block dynamic shared memory ceiling.
SMEM_MAX = 232_448


def master_append(X: torch.Tensor, dists: torch.Tensor, idx: torch.Tensor,
                  *, tau: int = 1) -> tuple[torch.Tensor, torch.Tensor]:
    """(N, L_new) CUDA panel + its prefix's (N, E_max, L_old, k) master →
    the grown (N, E_max, L_new, k) master, in one launch."""
    if X.device.type != "cuda":
        raise ValueError(f"knn_append kernel needs a CUDA tensor, got "
                         f"{X.device}")
    if dists.device != X.device or idx.device != X.device:
        raise ValueError("X and the master tables must share one device")
    dt = _ref.check_append_args(X, dists, idx, tau)
    N, E_max, L_old, k = dists.shape
    if k * WARPS_PER_BLOCK * 8 > SMEM_MAX:
        raise ValueError(f"k={k} does not fit one block's shared memory")
    L_new = L_old + dt
    Lx = L_new + (E_max - 1) * tau
    xpad = torch.nn.functional.pad(X.float(), (0, Lx - L_new)).contiguous()
    dM = dists.float().contiguous()
    iM = idx.to(torch.int32).contiguous()
    out_d = torch.empty((N, E_max, L_new, k), dtype=torch.float32,
                        device=X.device)
    out_i = torch.empty((N, E_max, L_new, k), dtype=torch.int32,
                        device=X.device)
    fn = _build.entry("knn_append_launch")
    with torch.cuda.device(X.device):
        err = fn(xpad.data_ptr(), N, Lx, L_old, L_new, E_max, tau, k,
                 dM.data_ptr(), iM.data_ptr(), WARPS_PER_BLOCK,
                 out_d.data_ptr(), out_i.data_ptr(),
                 torch.cuda.current_stream().cuda_stream)
    _build.check(err, "knn_append")
    master_append.launches += 1
    return out_d, out_i


master_append.launches = 0
