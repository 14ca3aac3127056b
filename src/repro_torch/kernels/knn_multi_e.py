"""CUDA kernel: incremental multi-E all-kNN over a whole panel, one launch.

Port of ``repro/kernels/knn_multi_e.py`` (Pallas ``_kernel``). The TPU
wrapper runs one series per call under the session's ``lax.map``; this
one launches once for an (N, L) panel with a grid over series × row
blocks, and each series' tables equal those of a call on that series
alone. Design and bound: ``csrc/knn_multi_e.cu``. The plain version is
``plain`` (``kernels.ref.all_knn_multi_e``), held bit-exact against it.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref as _ref

plain = _ref.all_knn_multi_e

#: Rows per block, one warp each.
WARPS_PER_BLOCK = 8
#: Shared memory one block may use for its k-best lists (four blocks, 32
#: warps, per SM at most); levels that do not fit are taken in chunks.
SMEM_BUDGET = 56 * 1024
#: Hopper's per-block dynamic shared memory ceiling.
SMEM_MAX = 232_448
MAX_LEVELS = 64  # kbest::kMaxLevels


def all_knn_multi_e(X: torch.Tensor, *, E_max: int, tau: int = 1,
                    k: int | None = None, exclude_self: bool = True,
                    max_idx=None) -> tuple[torch.Tensor, torch.Tensor]:
    """(N, L) CUDA panel → (dists, idx), both (N, E_max, L, k_max).

    ``[s, E-1, :Lp_E, :k_E]`` is series s's table at dimension E, padded
    with inf / -1 outside that block (``ref.all_knn_multi_e``).
    """
    if X.device.type != "cuda":
        raise ValueError(f"knn_multi_e kernel needs a CUDA tensor, got "
                         f"{X.device}")
    if X.ndim != 2:
        raise ValueError(f"X must be (N, L), got shape {tuple(X.shape)}")
    N, L = X.shape
    _ref.num_embedded(L, E_max, tau)  # raises on too-short series
    if E_max > MAX_LEVELS:
        raise ValueError(f"E_max={E_max} exceeds the kernel's {MAX_LEVELS}")
    ks = _ref.multi_e_ks(E_max, k)
    mxs = _ref.multi_e_max_idx(L, E_max, tau, max_idx)
    k_max = max(ks)
    if k_max > L:
        raise ValueError(f"k={k_max} exceeds the {L} candidates per row")
    level_bytes = k_max * WARPS_PER_BLOCK * 8
    if level_bytes > SMEM_MAX:
        raise ValueError(
            f"k={k_max} needs {level_bytes} B of shared memory per level, "
            f"more than a block has ({SMEM_MAX} B)")
    chunk = max(1, min(E_max, SMEM_BUDGET // level_bytes))
    Lx = L + (E_max - 1) * tau
    xpad = torch.nn.functional.pad(X.float(), (0, Lx - L)).contiguous()
    out_d = torch.empty((N, E_max, L, k_max), dtype=torch.float32,
                        device=X.device)
    out_i = torch.empty((N, E_max, L, k_max), dtype=torch.int32,
                        device=X.device)
    if N == 0:
        return out_d, out_i
    ks_a = (ctypes.c_int * E_max)(*ks)
    mxs_a = (ctypes.c_int * E_max)(*mxs)
    fn = _build.entry("knn_multi_e_launch")
    with torch.cuda.device(X.device):
        err = fn(xpad.data_ptr(), N, L, Lx, E_max, tau, ks_a, mxs_a, k_max,
                 int(exclude_self), WARPS_PER_BLOCK, chunk, out_d.data_ptr(),
                 out_i.data_ptr(), torch.cuda.current_stream().cuda_stream)
    _build.check(err, "knn_multi_e")
    all_knn_multi_e.launches += 1
    return out_d, out_i


all_knn_multi_e.launches = 0
