"""CUDA kernels: k smallest per row of a distance matrix, under one cap or
under every cap of a convergence sweep in one column stream.

Ports of ``repro/kernels/topk.py``: ``topk_select`` (Pallas ``_kernel``;
paper Algorithm 2) and ``topk_select_sizes`` (Pallas ``_sizes_kernel``
with ``_merge_kbest``). Design and bound: ``csrc/topk.cu``. The plain
versions are ``plain_select`` and ``plain_sizes`` (``kernels.ref``), held
bit-exact against them.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref as _ref

plain_select = _ref.topk_select
plain_sizes = _ref.topk_select_sizes

#: Rows per block (one warp each), fewer when k's lists need the room.
WARPS_PER_BLOCK = 8
#: Hopper's per-block dynamic shared memory ceiling.
SMEM_MAX = 232_448


def _check(D: torch.Tensor, k: int) -> tuple[int, int]:
    """(Lp, warps per block) for a square CUDA matrix and k; raises."""
    if D.device.type != "cuda":
        raise ValueError(f"topk kernel needs a CUDA tensor, got {D.device}")
    if D.ndim != 2 or D.shape[0] != D.shape[1]:
        raise ValueError(f"D must be square (Lp, Lp), got {tuple(D.shape)}")
    Lp = D.shape[0]
    if not 1 <= k <= Lp:
        raise ValueError(f"k={k} must lie in [1, {Lp}] (the row length)")
    warps = min(WARPS_PER_BLOCK, SMEM_MAX // (8 * k))
    if warps < 1:
        raise ValueError(f"k={k} does not fit one block's shared memory "
                         f"({SMEM_MAX} B)")
    return Lp, warps


def topk_select(D: torch.Tensor, *, k: int, exclude_self: bool = True,
                max_idx=None) -> tuple[torch.Tensor, torch.Tensor]:
    """(Lp, Lp) CUDA matrix → (dists, idx), both (Lp, k), ascending.

    ``max_idx`` is a host int (inclusive column cap) or None. Raises for
    k > 29,056, where one warp's list passes a block's shared memory (as
    ``topk_select_sizes``).
    """
    Lp, warps = _check(D, k)
    mx = Lp - 1 if max_idx is None else min(int(max_idx), Lp - 1)
    Dc = D.float().contiguous()
    out_d = torch.empty((Lp, k), dtype=torch.float32, device=D.device)
    out_i = torch.empty((Lp, k), dtype=torch.int32, device=D.device)
    fn = _build.entry("topk_select_launch")
    with torch.cuda.device(D.device):
        err = fn(Dc.data_ptr(), Lp, k, max(mx, -1), int(exclude_self), warps,
                 out_d.data_ptr(), out_i.data_ptr(),
                 torch.cuda.current_stream().cuda_stream)
    _build.check(err, "topk_select")
    topk_select.launches += 1
    return out_d, out_i


def topk_select_sizes(D: torch.Tensor, *, k: int, max_idxs,
                      exclude_self: bool = True
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """(Lp, Lp) CUDA matrix → (dists, idx), both (S, Lp, k), one pass.

    ``max_idxs`` are ascending inclusive caps (``ref.check_sizes_caps``);
    caps past the last column act as Lp − 1. Slots with no valid
    candidate are dist = inf / idx = ``ref.PAD_IDX``.
    """
    Lp, warps = _check(D, k)
    caps = [min(c, Lp - 1) for c in _ref.check_sizes_caps(max_idxs)]
    S = len(caps)
    caps_d = torch.tensor(caps, dtype=torch.int32).to(D.device)
    Dc = D.float().contiguous()
    out_d = torch.empty((S, Lp, k), dtype=torch.float32, device=D.device)
    out_i = torch.empty((S, Lp, k), dtype=torch.int32, device=D.device)
    fn = _build.entry("topk_sizes_launch")
    with torch.cuda.device(D.device):
        err = fn(Dc.data_ptr(), Lp, k, caps_d.data_ptr(), S, caps[-1],
                 int(exclude_self), warps, out_d.data_ptr(), out_i.data_ptr(),
                 torch.cuda.current_stream().cuda_stream)
    _build.check(err, "topk_select_sizes")
    topk_select_sizes.launches += 1
    return out_d, out_i


topk_select.launches = 0
topk_select_sizes.launches = 0
