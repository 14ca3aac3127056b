"""CUDA kernel: library-batched all-kNN at one E, one launch for B series.

Port of ``repro/kernels/knn_batch.py`` (Pallas ``_kernel``): the direct
all-pairs CCM engine's neighbour tables, bit-invariant in B. Two
hand-written designs, picked by shape (``route``): one thread a row with
its list in registers for k ≤ 32 and E ≤ 32 (the session's shapes), the
warp-wide insertion kernel for the rest. Design and bound:
``csrc/knn_batch.cu``. The plain version is ``plain``
(``kernels.ref.all_knn_batch``), held bit-exact against both.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref as _ref

plain = _ref.all_knn_batch

#: Hopper's per-block dynamic shared memory ceiling.
SMEM_MAX = 232_448
#: The thread-per-row kernel: register lists of up to 32 slots and up to
#: 32 lag values a row; a block stages CHUNK columns of its series (and
#: the (E-1)·τ values past them) per pass.
THREAD_MAX = 32
CHUNK = 4096
#: The insertion kernel: rows per block, one warp each, fewer when k's
#: lists need the room. One warp's list of K_LIMIT slots fills a block.
WARPS_PER_BLOCK = 8
K_LIMIT = SMEM_MAX // 8  # 29,056


def route(Lp: int, E: int, tau: int, k: int) -> str:
    """Which kernel takes a shape: ``"thread"`` (one thread a row) or
    ``"insert"`` (the warp-wide insertion kernel)."""
    smem = 4 * (min(Lp, CHUNK) + (E - 1) * tau)
    if k <= THREAD_MAX and E <= THREAD_MAX and smem <= SMEM_MAX:
        return "thread"
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


def all_knn_batch(X: torch.Tensor, *, E: int, tau: int = 1,
                  k: int | None = None, exclude_self: bool = True,
                  max_idx=None) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, L) CUDA stack → (dists, idx), both (B, Lp, k).

    ``route`` picks the kernel; both give the same bits. k above
    ``K_LIMIT`` (29,056) raises.
    """
    out = _launch(X, None, E=E, tau=tau, k=k, exclude_self=exclude_self,
                  max_idx=max_idx)
    all_knn_batch.launches += 1
    return out


all_knn_batch.launches = 0


def _launch(X, kind, *, E, tau=1, k=None, exclude_self=True, max_idx=None):
    """One launch of the kernel ``kind`` (``route``'s pick for None); the
    kernel comparisons run the insertion kernel at a thread shape through
    it, uncounted."""
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
    kind = kind or route(Lp, E, tau, k)
    warps = insert_warps(k) if kind == "insert" else 0
    mx = Lp - 1 if max_idx is None else min(int(max_idx), Lp - 1)
    Xc = X.float().contiguous()
    out_d = torch.empty((B, Lp, k), dtype=torch.float32, device=X.device)
    out_i = torch.empty((B, Lp, k), dtype=torch.int32, device=X.device)
    if B == 0:
        return out_d, out_i
    with torch.cuda.device(X.device):
        stream = torch.cuda.current_stream().cuda_stream
        if kind == "thread":
            err = _build.entry("knn_batch_thread_launch")(
                Xc.data_ptr(), B, L, E, tau, k, mx, int(exclude_self),
                out_d.data_ptr(), out_i.data_ptr(), stream)
        else:
            err = _build.entry("knn_batch_launch")(
                Xc.data_ptr(), B, L, E, tau, k, mx, int(exclude_self), warps,
                out_d.data_ptr(), out_i.data_ptr(), stream)
    _build.check(err, "knn_batch")
    return out_d, out_i
