"""CUDA kernel: fused all-kNN over one series, the distance matrix never in
global memory.

Port of ``repro/kernels/knn_fused.py`` (Pallas ``_kernel``, wrapper
``all_knn_fused``). Two hand-written designs, picked by ``route``: the
selection kernel for k ≤ 32 and E ≤ 32 (R rows a warp in registers,
columns streamed through shared-memory tiles, buffered warp selection
behind a threshold from the columns around the rows), the warp-wide
insertion kernel otherwise. Design and bound: ``csrc/knn_fused.cu``.
Unlike the TPU wrapper it does not mean-center the series: neither does
the port's pairwise kernel nor the reference's ``ref.pairwise_distances``,
so its tables are bit-equal to the two-kernel path (``pairwise_dist`` then
``topk``) and to the plain version ``plain`` (``kernels.ref.all_knn``).
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref as _ref

plain = _ref.all_knn

#: Hopper's per-block dynamic shared memory ceiling.
SMEM_MAX = 232_448
#: The selection kernel: k and E it takes, warps a block, buffer slots
#: per (warp, row), columns a streamed tile, and the warps the launch
#: should reach (12 an SM of 132) before column slices stop growing.
SELECT_MAX = 32
SELECT_WARPS = 8
SELECT_BUF = 96
TILE_COLS = 1024
FILL_WARPS = 132 * 12
#: The insertion kernel: rows (warps) a block at most; fewer when k's
#: lists need the room. k past K_LIMIT fits no list in a block.
WARPS_PER_BLOCK = 16
K_LIMIT = SMEM_MAX // 8


def rows_per_warp(E: int) -> int:
    """R, the rows a warp of the selection kernel carries (``csrc``'s
    template: 6 up to E = 20, 4 above)."""
    return 6 if E <= 20 else 4


def row_groups(Lp: int, E: int, tau: int) -> int:
    """The selection kernel's row groups: the rows split by residue mod τ
    into runs of R, ⌈⌈Lp/τ⌉/R⌉ runs a residue."""
    return tau * -(-(-(-Lp // tau)) // rows_per_warp(E))


def slices(Lp: int, E: int, tau: int = 1) -> int:
    """S, the column slices of a block: the fewest (1, 2, 4 or 8) whose
    launch has ``FILL_WARPS`` warps, 8 if none does."""
    for S in (1, 2, 4):
        blocks = -(-row_groups(Lp, E, tau) // (SELECT_WARPS // S))
        if blocks * SELECT_WARPS >= FILL_WARPS:
            return S
    return 8


def tile_floats(E: int, tau: int, C: int = TILE_COLS) -> int:
    """One streamed tile: C diagonals and their (E + R - 2)τ lags, to 16
    bytes."""
    return -(-(C + (E + rows_per_warp(E) - 2) * tau) // 4) * 4


def select_smem(E: int, tau: int) -> int:
    """Shared memory of one selection block (``csrc``'s layout)."""
    return (2 * tile_floats(E, tau) * 4
            + SELECT_WARPS * rows_per_warp(E) * SELECT_BUF * 8)


def route(L: int, E: int, tau: int, k: int) -> str:
    """Which kernel takes a shape: ``"select"`` or ``"insert"``."""
    if k <= SELECT_MAX and E <= SELECT_MAX and \
            select_smem(E, tau) <= SMEM_MAX:
        return "select"
    return "insert"


def all_knn_fused(x: torch.Tensor, *, E: int, tau: int = 1,
                  k: int | None = None, exclude_self: bool = True,
                  max_idx=None) -> tuple[torch.Tensor, torch.Tensor]:
    """(L,) CUDA series → (dists, idx), both (Lp, k), ascending.

    ``max_idx`` is a host int (inclusive column cap) or None. Any length:
    the selection kernel streams the series, the insertion kernel reads it
    from global memory when it does not fit a block beside the lists.
    Raises for k outside [1, Lp] and, on the insertion kernel (k > 32 or
    E > 32), for k past ``K_LIMIT`` (29,056: one warp's list fills a
    block).
    """
    out = _launch(x, None, E=E, tau=tau, k=k, exclude_self=exclude_self,
                  max_idx=max_idx)
    all_knn_fused.launches += 1
    return out


all_knn_fused.launches = 0


def _launch(x, kind, *, E, tau=1, k=None, exclude_self=True, max_idx=None,
            tile_cols=TILE_COLS):
    """One launch of the kernel ``kind`` (``route``'s pick for None); the
    kernel comparisons reach the insertion kernel at a selection shape,
    and the selection kernel at a small ``tile_cols``, through it,
    uncounted."""
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
    kind = kind or route(L, E, tau, k)
    if kind == "select" and (k > SELECT_MAX or E > SELECT_MAX
                             or tile_cols % (32 * slices(Lp, E, tau))):
        raise ValueError(f"the selection kernel takes k, E <= {SELECT_MAX} "
                         f"and tiles of a multiple of 32·S columns; got "
                         f"k={k}, E={E}, tile_cols={tile_cols}")
    mx = Lp - 1 if max_idx is None else min(int(max_idx), Lp - 1)
    out_d = torch.empty((Lp, k), dtype=torch.float32, device=x.device)
    out_i = torch.empty((Lp, k), dtype=torch.int32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        if kind == "select":
            S = slices(Lp, E, tau)
            C = int(tile_cols)
            tw = tile_floats(E, tau, C)
            pre = (rows_per_warp(E) - 1) * tau  # diagonals start at -pre
            ntiles = -(-(Lp + pre) // C)
            xpad = torch.zeros(ntiles * C + tw + 64 + 2 * pre + L,
                               dtype=torch.float32, device=x.device)
            xpad[pre:pre + L] = x
            err = _build.entry("knn_fused_select_launch")(
                xpad.data_ptr(), L, E, tau, k, max(mx, -1),
                int(exclude_self), S, C, tw, pre, out_d.data_ptr(),
                out_i.data_ptr(), stream)
        else:
            if k > K_LIMIT:
                raise ValueError(
                    f"k={k} passes the insertion kernel's limit of {K_LIMIT}: "
                    f"one warp's list passes a block's shared memory "
                    f"({SMEM_MAX} B)")
            W = max(1, min(WARPS_PER_BLOCK, SMEM_MAX // (8 * k)))
            staged = (L + 2 * k * W) * 4 <= SMEM_MAX
            xc = x.float().contiguous()
            err = _build.entry("knn_fused_launch")(
                xc.data_ptr(), L, E, tau, k, max(mx, -1), int(exclude_self),
                W, int(staged), out_d.data_ptr(), out_i.data_ptr(), stream)
    _build.check(err, "knn_fused")
    return out_d, out_i
