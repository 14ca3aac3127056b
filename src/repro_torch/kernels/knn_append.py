"""CUDA kernel: grow a panel's multi-E kNN master by dt appended points.

Port of ``repro/kernels/knn_append.py`` (Pallas ``_select_kernel`` inside
``_master_append``). The TPU path runs per series, XLA forming the
candidate values and the Pallas kernel selecting; here one launch forms
and selects for the whole panel and every level. Two hand-written
designs, picked by shape (``route``): the stream kernel (tiles of old
rows merged by the root rule, one walk per new row) for k ≤ 32 and
E_max ≤ 32 (the session's shapes), the warp-wide insertion kernel for the
rest. Design and bound: ``csrc/knn_append.cu``. The plain version is
``plain`` (``kernels.ref.master_append``), held bit-exact against both,
and all three are bit-identical to a cold ``all_knn_multi_e`` build of
the grown panel.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref as _ref

plain = _ref.master_append

#: Hopper's per-block dynamic shared memory ceiling.
SMEM_MAX = 232_448
#: The stream kernel: 128-row tiles (two levels in flight, roots and
#: indices) or 4 walk warps of 64-slot buffers per new level; its sorts
#: hold one key per lane and one lane per new level.
STREAM_MAX = 32
STREAM_ROWS = 128
STREAM_BUF = 64
#: The insertion kernel: rows per block, one warp each, fewer when k's
#: lists need the room. One warp's list of K_LIMIT slots fills a block.
WARPS_PER_BLOCK = 8
K_LIMIT = SMEM_MAX // 8  # 29,056


def stream_smem(L_new: int, E_max: int, tau: int, k: int, dt: int) -> int:
    """Shared memory of one stream-kernel block (``csrc``'s layout)."""
    xs_len = (L_new + (E_max - 1) * tau + 32 + 3) // 4 * 4
    nsel = min(E_max, -(-dt // tau))
    return 4 * (xs_len + max(4 * STREAM_ROWS * k, 8 * nsel * STREAM_BUF))


def route(L_new: int, E_max: int, tau: int, k: int, dt: int) -> str:
    """Which kernel takes a shape: ``"stream"`` or ``"insert"`` (the
    warp-wide insertion kernel)."""
    if (k <= STREAM_MAX and E_max <= STREAM_MAX
            and stream_smem(L_new, E_max, tau, k, dt) <= SMEM_MAX):
        return "stream"
    return "insert"


def insert_warps(k: int) -> int:
    """Warps (rows) per block of the insertion kernel for k; raises past
    ``K_LIMIT``, where one warp's list no longer fits a block."""
    warps = min(WARPS_PER_BLOCK, SMEM_MAX // (8 * k))
    if warps < 1:
        raise ValueError(f"k={k} exceeds the insertion kernel's limit of "
                         f"{K_LIMIT}: one row's list must fit a block's "
                         f"shared memory ({SMEM_MAX} B)")
    return warps


def master_append(X: torch.Tensor, dists: torch.Tensor, idx: torch.Tensor,
                  *, tau: int = 1) -> tuple[torch.Tensor, torch.Tensor]:
    """(N, L_new) CUDA panel + its prefix's (N, E_max, L_old, k) master →
    the grown (N, E_max, L_new, k) master, in one launch.

    ``route`` picks the kernel; both give the same bits. k above
    ``K_LIMIT`` (29,056) raises.
    """
    out = _launch(X, dists, idx, None, tau=tau)
    master_append.launches += 1
    return out


master_append.launches = 0


def _launch(X, dists, idx, kind, *, tau=1):
    """One launch of the kernel ``kind`` (``route``'s pick for None); the
    kernel comparisons run the insertion kernel at a stream shape through
    it, uncounted."""
    if X.device.type != "cuda":
        raise ValueError(f"knn_append kernel needs a CUDA tensor, got "
                         f"{X.device}")
    if dists.device != X.device or idx.device != X.device:
        raise ValueError("X and the master tables must share one device")
    dt = _ref.check_append_args(X, dists, idx, tau)
    N, E_max, L_old, k = dists.shape
    L_new = L_old + dt
    kind = kind or route(L_new, E_max, tau, k, dt)
    warps = insert_warps(k) if kind == "insert" else 0
    Lx = L_new + (E_max - 1) * tau
    xpad = torch.nn.functional.pad(X.float(), (0, Lx - L_new)).contiguous()
    dM = dists.float().contiguous()
    iM = idx.to(torch.int32).contiguous()
    out_d = torch.empty((N, E_max, L_new, k), dtype=torch.float32,
                        device=X.device)
    out_i = torch.empty((N, E_max, L_new, k), dtype=torch.int32,
                        device=X.device)
    with torch.cuda.device(X.device):
        stream = torch.cuda.current_stream().cuda_stream
        if kind == "stream":
            err = _build.entry("knn_append_stream_launch")(
                xpad.data_ptr(), N, Lx, L_old, L_new, E_max, tau, k,
                dM.data_ptr(), iM.data_ptr(), out_d.data_ptr(),
                out_i.data_ptr(), stream)
        else:
            err = _build.entry("knn_append_launch")(
                xpad.data_ptr(), N, Lx, L_old, L_new, E_max, tau, k,
                dM.data_ptr(), iM.data_ptr(), warps, out_d.data_ptr(),
                out_i.data_ptr(), stream)
    _build.check(err, "knn_append")
    return out_d, out_i
