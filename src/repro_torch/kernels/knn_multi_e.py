"""CUDA kernel: incremental multi-E all-kNN over a whole panel, one launch.

Port of ``repro/kernels/knn_multi_e.py`` (Pallas ``_kernel``). The TPU
wrapper runs one series per call under the session's ``lax.map``; this
one launches once for an (N, L) panel with a grid over series × row
blocks, and each series' tables equal those of a call on that series
alone. Two hand-written designs, picked by shape (``route``): buffered
warp selection for k ≤ 32 and E_max ≤ 32 (the session's shapes), the
warp-wide insertion kernel for the rest. Design and bound:
``csrc/knn_multi_e.cu``. The plain version is ``plain``
(``kernels.ref.all_knn_multi_e``), held bit-exact against both.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref as _ref

plain = _ref.all_knn_multi_e

#: Hopper's per-block dynamic shared memory ceiling.
SMEM_MAX = 232_448
#: The buffered selection: its sorts hold one key per lane (k ≤ 32), its
#: levels are unrolled up to 32; a block holds its series whole beside a
#: 64-slot (value, index) buffer and its fill per (warp, level).
SELECT_MAX = 32
SELECT_WARPS = 8
SELECT_BUF = 64
#: The insertion kernel (k > 32, E_max > 32, or a series too long to stage
#: beside the buffers): rows per block, one warp each, and the shared
#: memory a block may use for its k-best lists (four blocks, 32 warps, per
#: SM at most); levels that do not fit are taken in chunks.
WARPS_PER_BLOCK = 8
SMEM_BUDGET = 56 * 1024
MAX_LEVELS = 64  # kbest::kMaxLevels


def select_smem(L: int, E_max: int, tau: int) -> int:
    """Shared memory of one buffered-selection block (``csrc``'s layout)."""
    return (4 * (L + (E_max - 1) * tau + 64)
            + SELECT_WARPS * E_max * (SELECT_BUF * 8 + 4))


def route(L: int, E_max: int, tau: int, k_max: int) -> str:
    """Which kernel takes a shape: ``"select"`` (buffered warp selection)
    or ``"insert"`` (the warp-wide insertion kernel)."""
    if (k_max <= SELECT_MAX and E_max <= SELECT_MAX
            and select_smem(L, E_max, tau) <= SMEM_MAX):
        return "select"
    return "insert"


def all_knn_multi_e(X: torch.Tensor, *, E_max: int, tau: int = 1,
                    k: int | None = None, exclude_self: bool = True,
                    max_idx=None) -> tuple[torch.Tensor, torch.Tensor]:
    """(N, L) CUDA panel → (dists, idx), both (N, E_max, L, k_max).

    ``[s, E-1, :Lp_E, :k_E]`` is series s's table at dimension E, padded
    with inf / -1 outside that block (``ref.all_knn_multi_e``). ``route``
    picks the kernel; both give the same bits. Raises for E_max above
    ``MAX_LEVELS`` (64), and on the insertion kernel for k_max whose lists
    of 8 warps pass a block's shared memory (k_max > 3,632).
    """
    out = _launch(X, None, E_max=E_max, tau=tau, k=k,
                  exclude_self=exclude_self, max_idx=max_idx)
    all_knn_multi_e.launches += 1
    return out


all_knn_multi_e.launches = 0


def _launch(X, kind, *, E_max, tau, k, exclude_self, max_idx):
    """One launch of the kernel ``kind`` (``route``'s pick for None); the
    kernel comparisons run the insertion kernel at a selection shape
    through it, uncounted."""
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
    kind = kind or route(L, E_max, tau, k_max)
    level_bytes = k_max * WARPS_PER_BLOCK * 8
    if kind == "insert" and level_bytes > SMEM_MAX:
        raise ValueError(
            f"k={k_max} needs {level_bytes} B of shared memory per level, "
            f"more than a block has ({SMEM_MAX} B)")
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
    with torch.cuda.device(X.device):
        stream = torch.cuda.current_stream().cuda_stream
        if kind == "select":
            err = _build.entry("knn_multi_e_select_launch")(
                xpad.data_ptr(), N, L, Lx, E_max, tau, ks_a, mxs_a, k_max,
                int(exclude_self), out_d.data_ptr(), out_i.data_ptr(), stream)
        else:
            chunk = max(1, min(E_max, SMEM_BUDGET // level_bytes))
            err = _build.entry("knn_multi_e_launch")(
                xpad.data_ptr(), N, L, Lx, E_max, tau, ks_a, mxs_a, k_max,
                int(exclude_self), WARPS_PER_BLOCK, chunk, out_d.data_ptr(),
                out_i.data_ptr(), stream)
    _build.check(err, "knn_multi_e")
    return out_d, out_i
