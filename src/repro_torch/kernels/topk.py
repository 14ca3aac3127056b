"""CUDA kernels: k smallest per row of a distance matrix, under one cap or
under every cap of a convergence sweep in one launch.

Ports of ``repro/kernels/topk.py``: ``topk_select`` (Pallas ``_kernel``;
paper Algorithm 2) and ``topk_select_sizes`` (Pallas ``_sizes_kernel``
with ``_merge_kbest``). Two hand-written designs, picked by ``route``: the
selection kernels for k ≤ 32 (and at most ``MAX_LEVELS`` caps, passed by
value) — one warp a row, 512-column chunks staged in shared memory, a
bound from each lane's smallest value, buffered (value, index) selection
under it, each level written at its cap — and the warp-wide insertion
kernels otherwise. Design
and bound: ``csrc/topk.cu``. The plain versions are ``plain_select`` and
``plain_sizes`` (``kernels.ref``), held bit-exact against both designs;
``_emulate`` repeats the selection kernels' order of work on the CPU for
the tests.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref as _ref

plain_select = _ref.topk_select
plain_sizes = _ref.topk_select_sizes

#: Hopper's per-block dynamic shared memory ceiling.
SMEM_MAX = 232_448
#: The insertion kernels: rows (warps) a block, fewer when k's lists need
#: the room; k past K_LIMIT fits no list in a block.
WARPS_PER_BLOCK = 8
K_LIMIT = SMEM_MAX // 8
#: The selection kernels: the k and the caps by value they take
#: (``kbest::kMaxLevels``), and the columns a warp holds at once (16 a
#: lane).
SELECT_MAX = 32
MAX_LEVELS = 64
CHUNK_COLS = 512


def route(k: int, S: int = 1) -> str:
    """Which kernel takes k with S caps: ``"select"`` or ``"insert"``."""
    return "select" if k <= SELECT_MAX and S <= MAX_LEVELS else "insert"


def _check(D: torch.Tensor, k: int) -> tuple[torch.Tensor, int]:
    """(D as float32 and contiguous, Lp) for a square CUDA matrix; raises."""
    if D.device.type != "cuda":
        raise ValueError(f"topk kernel needs a CUDA tensor, got {D.device}")
    if D.ndim != 2 or D.shape[0] != D.shape[1]:
        raise ValueError(f"D must be square (Lp, Lp), got {tuple(D.shape)}")
    Lp = D.shape[0]
    if not 1 <= k <= Lp:
        raise ValueError(f"k={k} must lie in [1, {Lp}] (the row length)")
    return _build.as_contiguous(D, torch.float32), Lp


def _insert_warps(k: int) -> int:
    if k > K_LIMIT:
        raise ValueError(f"k={k} passes the insertion kernel's limit of "
                         f"{K_LIMIT}: one warp's list passes a block's "
                         f"shared memory ({SMEM_MAX} B)")
    return min(WARPS_PER_BLOCK, SMEM_MAX // (8 * k))


def topk_select(D: torch.Tensor, *, k: int, exclude_self: bool = True,
                max_idx=None) -> tuple[torch.Tensor, torch.Tensor]:
    """(Lp, Lp) CUDA matrix → (dists, idx), both (Lp, k), ascending.

    ``max_idx`` is a host int (inclusive column cap) or None. Raises for
    k > 29,056 (``K_LIMIT``), where one warp's list of the insertion kernel
    (k > 32) passes a block's shared memory (as ``topk_select_sizes``).
    """
    out = _launch_select(D, None, k=k, exclude_self=exclude_self,
                         max_idx=max_idx)
    topk_select.launches += 1
    return out


def topk_select_sizes(D: torch.Tensor, *, k: int, max_idxs,
                      exclude_self: bool = True
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """(Lp, Lp) CUDA matrix → (dists, idx), both (S, Lp, k), one launch.

    ``max_idxs`` are ascending inclusive caps (``ref.check_sizes_caps``);
    caps past the last column act as Lp − 1. Slots with no valid
    candidate are dist = inf / idx = ``ref.PAD_IDX``.
    """
    out = _launch_sizes(D, None, k=k, max_idxs=max_idxs,
                        exclude_self=exclude_self)
    topk_select_sizes.launches += 1
    return out


topk_select.launches = 0
topk_select_sizes.launches = 0


def _launch_select(D, kind, *, k, exclude_self=True, max_idx=None):
    """One ``topk_select`` launch of the kernel ``kind`` (``route``'s pick
    for None); the kernel comparisons reach both designs through it,
    uncounted."""
    D, Lp = _check(D, k)
    mx = Lp - 1 if max_idx is None else min(int(max_idx), Lp - 1)
    kind = kind or route(k)
    out_d = torch.empty((Lp, k), dtype=torch.float32, device=D.device)
    out_i = torch.empty((Lp, k), dtype=torch.int32, device=D.device)
    if kind == "select":
        if k > SELECT_MAX:
            raise ValueError(f"the selection kernel takes k <= {SELECT_MAX},"
                             f" got k={k}")
        _build.launch(D.device, "topk_select32_launch", D.data_ptr(), Lp, k,
                      max(mx, -1), int(exclude_self), out_d.data_ptr(),
                      out_i.data_ptr())
    else:
        _build.launch(D.device, "topk_select_launch", D.data_ptr(), Lp, k,
                      max(mx, -1), int(exclude_self), _insert_warps(k),
                      out_d.data_ptr(), out_i.data_ptr())
    return out_d, out_i


@functools.lru_cache(maxsize=256)
def _caps(max_idxs: tuple, Lp: int):
    """The caps checked (``ref.check_sizes_caps``) and clipped to Lp − 1,
    and as a C int array, remembered: a sweep passes the same caps call
    after call."""
    caps = [min(c, Lp - 1) for c in _ref.check_sizes_caps(max_idxs)]
    return caps, (ctypes.c_int * len(caps))(*caps)


def _launch_sizes(D, kind, *, k, max_idxs, exclude_self=True):
    """One ``topk_select_sizes`` launch, as ``_launch_select``. The caps go
    by value; a device copy is made only for the insertion kernel past
    ``MAX_LEVELS`` caps."""
    D, Lp = _check(D, k)
    caps, caps_h = _caps(tuple(max_idxs), Lp)
    S = len(caps)
    kind = kind or route(k, S)
    out_d = torch.empty((S, Lp, k), dtype=torch.float32, device=D.device)
    out_i = torch.empty((S, Lp, k), dtype=torch.int32, device=D.device)
    if kind == "select":
        if k > SELECT_MAX or S > MAX_LEVELS:
            raise ValueError(f"the selection kernel takes k <= {SELECT_MAX} "
                             f"and at most {MAX_LEVELS} caps, got k={k}, "
                             f"{S} caps")
        _build.launch(D.device, "topk_sizes32_launch", D.data_ptr(), Lp, k,
                      caps_h, S, int(exclude_self), out_d.data_ptr(),
                      out_i.data_ptr())
    else:
        caps_d = None
        if S > MAX_LEVELS:
            caps_d = torch.tensor(caps, dtype=torch.int32).to(D.device)
        _build.launch(D.device, "topk_sizes_launch", D.data_ptr(), Lp, k,
                      caps_h, None if caps_d is None else caps_d.data_ptr(),
                      S, int(exclude_self), _insert_warps(k),
                      out_d.data_ptr(), out_i.data_ptr())
    return out_d, out_i


# --------------------------------------------------------------------------
# The selection kernels' order of work on the CPU (tests only).
# --------------------------------------------------------------------------

_KEMPTY = 0x7FFFFFFF  # kbest::kEmpty: an unfilled slot's index
_QUAD = 4  # groups of 32 columns the kernel votes on at once (kQuad)
_SEEN = 128  # columns a warp has seen when its k-th key bounds (kSeen)
_PAD = (float("inf"), _KEMPTY)


def _before(a, b) -> bool:
    """kbest::before on (value, index) keys; a NaN value precedes none."""
    return a[0] < b[0] or (a[0] == b[0] and a[1] < b[1])


def _emulate(D: torch.Tensor, *, k: int, exclude_self: bool = True,
             max_idx=None, max_idxs=None, chunk_cols: int = CHUNK_COLS,
             stats: dict | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """``csrc/topk.cu``'s selection kernels step for step on the CPU (tests
    only; no path calls it): ``topk_select``'s result for ``max_idxs`` None,
    else ``topk_select_sizes``'s. One warp takes a row's columns 0..last in
    chunks of ``chunk_cols`` (a multiple of 32; lane = column mod 32). At
    the first chunk's start, and after a cap when fewer than 128 columns
    lie behind, the k-th smallest of the lanes' smallest values over the
    chunk's columns up to the next cap (or over all of them) tightens the
    row's bound; until the buffer has a k-th key, a later chunk first cuts
    the buffer to its k first and takes such a bound if that found none.
    Four groups of 32 columns at a time (one group where a cap falls), the
    keys that precede both that bound and the k-th key of the last
    compaction go to a buffer that is cut to its k first when it holds
    more than 64 before them; the k first at each cap are that level.
    ``stats``, if given, counts bounds, appended keys and compactions."""
    sizes = max_idxs is not None
    Dn = D.detach().float().cpu().numpy()
    Lp = Dn.shape[0]
    if not 1 <= k <= min(Lp, SELECT_MAX):
        raise ValueError(f"k={k} must lie in [1, min({Lp}, {SELECT_MAX})]")
    if sizes:
        caps = [min(c, Lp - 1) for c in _ref.check_sizes_caps(max_idxs)]
        mx = Lp - 1
    else:
        caps = [Lp - 1]
        mx = Lp - 1 if max_idx is None else min(int(max_idx), Lp - 1)
    S, last = len(caps), caps[-1]
    st = stats if stats is not None else {}
    for key in ("bounds", "appended", "compactions"):
        st.setdefault(key, 0)
    cols = np.arange(last + 1)
    keys = np.zeros((S, Lp, k, 2))
    for i in range(Lp):
        x = Dn[i, :last + 1].astype(np.float32)
        if sizes:
            x[(cols == i) & exclude_self] = np.nan
        else:
            x[(cols > mx) | ((cols == i) & exclude_self)] = np.inf
        run, bound, buf, srt = _PAD, np.inf, [], False

        def compact():
            nonlocal run, buf, srt
            buf = sorted(buf)
            run = buf[k - 1] if len(buf) >= k else _PAD
            buf = buf[:k]
            srt = True
            st["compactions"] += 1

        def offer(lo, hi):
            """The keys of columns lo..hi that precede the threshold into
            the buffer."""
            nonlocal buf, srt
            thr = min((bound, _KEMPTY), run)
            took = [(float(x[j]), j) for j in range(lo, hi + 1)
                    if _before((float(x[j]), j), thr)]
            if took:
                buf += took
                srt = False
                st["appended"] += len(took)

        def tighten(pos, end, q):
            """The bound of the segment from level q on: over the chunk's
            columns up to its cap or to the chunk's end."""
            nonlocal bound
            c = caps[q] if q < S and caps[q] <= end else end
            m = np.full(32, np.inf, np.float32)  # fminf: NaN ignored
            np.fmin.at(m, cols[pos:c + 1] % 32, x[pos:c + 1])
            bound = min(bound, float(np.sort(m)[k - 1]))
            st["bounds"] += 1

        s = 0
        for pos in range(0, last + 1, chunk_cols):
            end = min(last, pos + chunk_cols - 1)
            if pos > 0 and not run[0] < np.inf and not srt:
                compact()  # the k first so far bound later columns
            if pos == 0 or not run[0] < np.inf:
                tighten(pos, end, s)
            g0 = pos
            while g0 <= end:
                if len(buf) > 64:  # room for the next _QUAD groups
                    compact()
                g1 = g0 + 32 * _QUAD
                if g1 - 1 <= end and (s >= S or caps[s] >= g1):
                    # _QUAD groups voted against one threshold.
                    offer(g0, g1 - 1)
                    g0 = g1
                    continue
                lo = g0
                while s < S and caps[s] < g0 + 32:
                    offer(lo, caps[s])
                    if not srt:
                        compact()
                    keys[s, i] = buf + [_PAD] * (k - len(buf))
                    if caps[s] < end and not (run[0] < np.inf and
                                              caps[s] >= _SEEN):
                        tighten(pos, end, s + 1)
                    lo = caps[s] + 1
                    s += 1
                offer(lo, min(end, g0 + 31))
                g0 += 32
    v = torch.from_numpy(keys[..., 0].astype(np.float32))
    ix = torch.from_numpy(keys[..., 1].astype(np.int64)).to(torch.int32)
    roots = _ref._sorted_roots(v)
    if not sizes:
        return roots[0], ix[0]
    ok = torch.isfinite(v)
    return (torch.where(ok, roots, float("inf")),
            torch.where(ok, ix, _ref.PAD_IDX))
