"""CUDA kernels: the simplex lookup, and the fused lookup + Pearson ρ for a
batch of tables.

``lookup`` ports ``repro/kernels/lookup.py::lookup`` (Pallas
``_kernel_lookup``; paper Algorithm 3): (N, rows) predictions from one
(rows, k) table, bit-equal to its plain version ``plain_lookup``
(``kernels.ref.lookup``, a fixed-order k-sum). Design and bound:
``csrc/lookup.cu`` (64 rows a block, a row's slots four at a time: one
16-byte load of the indices and one of the weights, then the four
gathers in flight together; straight-line code for k ≤ 4).

``lookup_rho`` ports ``repro/kernels/lookup.py::lookup_rho`` (Pallas
``_kernel_rho`` with ``_gather_tile``). The TPU wrapper takes one
(rows, k) table per call; the session would then launch once per series
and E (3,080 calls for ``optimal_E`` at N = 154, E_max = 20), so this
wrapper takes a batch of B tables in one launch, in two forms:

* all targets — (B, rows, k) tables against (Nt, L) targets → (B, Nt);
* own target  — (B, rows, k) tables against (B, L) series, table b
  against series b only → (B,): the ρ(E) sweep of the optimal-E search.

The kernel's moment order is fixed by ``rows`` alone: tiles of
``TILE_ROWS`` rows with two-pass float32 moments, merged in float64 as a
tree into chunks of ``CHUNK_ROWS`` rows, the chunks merged in order
(``csrc/lookup_rho.cu``; ``_emulate`` repeats it on the CPU for the
tests). So each (b, n) result has the same bits at any B and Nt, in
either form. The plain versions are ``plain`` and ``plain_own``
(``kernels.ref``): a two-pass Pearson in another order, so the two agree
to a tolerance, not bit for bit.

Tables may be row-sliced views (their batch and row strides go to the
kernel; only the last axis must be contiguous). The all-targets form
reads the targets transposed, ``transpose_targets(Y)``: a caller that
launches several times against one panel makes it once and passes it as
``Yt``.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref as _ref

plain = _ref.lookup_rho_batch
plain_own = _ref.lookup_rho_own
plain_lookup = _ref.lookup

#: The moment order: tiles of TILE_ROWS rows, chunks of CHUNK_TILES tiles.
TILE_ROWS = 32
CHUNK_TILES = 8
CHUNK_ROWS = TILE_ROWS * CHUNK_TILES
#: Targets a block of the all-targets kernel: ``transpose_targets``
#: zero-pads the target axis to a multiple of it.
TARGET_TILE = 32
#: Tables with k above this are read in place, not staged in shared memory;
#: so is the own-target series past SERIES_STAGE_MAX points.
STAGE_K_MAX = 32
SERIES_STAGE_MAX = 12_288


def transpose_targets(Y: torch.Tensor) -> torch.Tensor:
    """(Nt, L) targets → (L, Ntp) float32, Ntp the next multiple of
    ``TARGET_TILE``, zero past Nt: the all-targets kernel's layout."""
    Nt, L = Y.shape
    ntp = -(-Nt // TARGET_TILE) * TARGET_TILE
    Yt = torch.zeros((L, ntp), dtype=torch.float32, device=Y.device)
    Yt[:, :Nt] = Y.t()
    return Yt


def _table(t: torch.Tensor, dtype) -> torch.Tensor:
    """The table as the kernel reads it: its dtype, last axis contiguous
    (row-sliced views pass as they are)."""
    t = t.to(dtype)
    return t if t.stride(-1) == 1 else t.contiguous()


def lookup_rho(Y: torch.Tensor, idx: torch.Tensor, w: torch.Tensor, *,
               offset: int = 0, own: bool = False,
               Yt: torch.Tensor | None = None) -> torch.Tensor:
    """Batched fused lookup-ρ on CUDA tensors (see the module docstring).

    ``Yt``: ``transpose_targets(Y)``, made once by a caller that launches
    several times against one panel (all-targets form only)."""
    if Y.device.type != "cuda":
        raise ValueError(f"lookup_rho kernel needs CUDA tensors, got "
                         f"{Y.device}")
    if idx.ndim != 3 or w.shape != idx.shape:
        raise ValueError(f"idx and w must be (B, rows, k) alike, got "
                         f"{tuple(idx.shape)} and {tuple(w.shape)}")
    if Y.ndim != 2:
        raise ValueError(f"Y must be (N, L), got {tuple(Y.shape)}")
    B, rows, k = idx.shape
    Nt, L = Y.shape
    if own and Nt != B:
        raise ValueError(f"own-target form needs one series per table, got "
                         f"{Nt} series for {B} tables")
    if offset < 0 or offset + rows > L:
        raise ValueError(f"truth rows [{offset}, {offset + rows}) fall "
                         f"outside the series length {L}")
    out = torch.empty((B,) if own else (B, Nt), dtype=torch.float32,
                      device=Y.device)
    if B == 0 or Nt == 0:
        return out
    if rows == 0 or k == 0:  # no rows, or no neighbour: zero variance
        return out.zero_()
    ic = _table(idx, torch.int32)
    wc = _table(w, torch.float32)
    nch = -(-rows // CHUNK_ROWS)
    one = own or Nt == 1  # the one-target kernel (series stride 0: shared)
    part = (torch.empty(nch * 6 * (B if one else B * Nt), dtype=torch.float64,
                        device=Y.device) if nch > 1 else out)
    staged = int(k <= STAGE_K_MAX and (not one or L <= SERIES_STAGE_MAX))
    with torch.cuda.device(Y.device):
        stream = torch.cuda.current_stream().cuda_stream
        tabs = (ic.data_ptr(), ic.stride(0), ic.stride(1), wc.data_ptr(),
                wc.stride(0), wc.stride(1), B, rows, k, int(offset), staged,
                part.data_ptr(), out.data_ptr(), stream)
        if one:
            Yc = Y.float()
            if Yc.stride(-1) != 1:
                Yc = Yc.contiguous()
            err = _build.entry("lookup_rho_own_launch")(
                Yc.data_ptr(), Yc.stride(0) if own else 0, L, *tabs)
        else:
            if Yt is None:
                Yt = transpose_targets(Y)
            ntp = -(-Nt // TARGET_TILE) * TARGET_TILE
            if (Yt.shape != (L, ntp) or Yt.dtype != torch.float32
                    or not Yt.is_contiguous() or Yt.device != Y.device):
                raise ValueError(f"Yt must be transpose_targets(Y): float32 "
                                 f"({L}, {ntp}) on {Y.device}, got "
                                 f"{Yt.dtype} {tuple(Yt.shape)}")
            err = _build.entry("lookup_rho_all_launch")(
                Yt.data_ptr(), L, ntp, Nt, *tabs)
    _build.check(err, "lookup_rho")
    lookup_rho.launches += 1
    return out


lookup_rho.launches = 0


def _emulate(Y: torch.Tensor, idx: torch.Tensor, w: torch.Tensor, *,
             offset: int = 0, own: bool = False) -> torch.Tensor:
    """The kernel's arithmetic on the CPU, operation for operation (tests
    only; no path calls it): the plain k-sum predictions, then the moment
    order of ``csrc/lookup_rho.cu``. Same shapes as ``lookup_rho``."""
    B, rows, k = idx.shape
    Y = Y.float()
    if own:
        yh = torch.stack([_ref.lookup(Y[b:b + 1], idx[b], w[b],
                                      offset=offset)[0] for b in range(B)])
        yt = Y[:, offset:offset + rows]
    else:
        yh = torch.stack([_ref.lookup(Y, idx[b], w[b], offset=offset)
                          for b in range(B)])
        yt = Y[None, :, offset:offset + rows].expand(B, -1, -1)
    return _moment_order(yh, yt)


def _moment_order(yh: torch.Tensor, yt: torch.Tensor) -> torch.Tensor:
    """ρ of predictions ``yh`` against truth ``yt`` (both (..., rows)
    float32) in the kernel's order → (...) float32."""
    rows = yh.shape[-1]
    if rows == 0:
        return torch.zeros(yh.shape[:-1])
    nch = -(-rows // CHUNK_ROWS)
    pad = nch * CHUNK_ROWS - rows
    tiles = (nch, CHUNK_TILES, 8, 4)  # chunk, tile, r, slot: row 4r + s
    ok = (torch.arange(nch * CHUNK_ROWS) < rows).reshape(tiles)
    zero = torch.zeros((), dtype=torch.float32)

    def split(v):
        v = torch.nn.functional.pad(v.float(), (0, pad))
        return torch.where(ok, v.reshape(*v.shape[:-1], *tiles), zero)

    def tile_sum(v):  # slot partials left to right, then a pairwise tree
        p = [zero] * 4
        for s in range(4):
            for r in range(8):
                p[s] = p[s] + v[..., r, s]
        while len(p) > 1:
            p = [p[i] + p[i + 1] for i in range(0, len(p), 2)]
        return p[0]

    a, b = split(yh), split(yt)
    nt = ok.sum((-2, -1)).float().expand(a.shape[:-2])
    live = nt > 0
    ntz = torch.where(live, nt, torch.ones_like(nt))
    ma = tile_sum(a) / ntz
    mb = tile_sum(b) / ntz
    da = torch.where(ok, a - ma[..., None, None], zero)
    db = torch.where(ok, b - mb[..., None, None], zero)
    mom = [nt, ma, mb, tile_sum(da * da), tile_sum(db * db),
           tile_sum(da * db)]
    mom = [torch.where(live, m, zero).double() for m in mom]

    def merge(x, y):
        n = x[0] + y[0]
        t = y[0] / torch.where(n > 0, n, torch.ones_like(n))
        da, db = y[1] - x[1], y[2] - x[2]
        f = x[0] * t
        r = [n, x[1] + da * t, x[2] + db * t,
             x[3] + y[3] + da * da * f, x[4] + y[4] + db * db * f,
             x[5] + y[5] + da * db * f]
        return [torch.where(y[0] == 0, xv, torch.where(x[0] == 0, yv, rv))
                for xv, yv, rv in zip(x, y, r)]

    h = CHUNK_TILES // 2
    while h >= 1:  # tile w with w + h
        mom = merge([m[..., :h] for m in mom], [m[..., h:2 * h] for m in mom])
        h //= 2
    acc = [m[..., 0, 0] for m in mom]
    for c in range(1, nch):
        acc = merge(acc, [m[..., c, 0] for m in mom])
    den = torch.sqrt(acc[3] * acc[4])
    rho = torch.where(den > 0, acc[5] / torch.clamp(den, min=1e-30),
                      torch.zeros_like(den))
    return rho.float()


def lookup(Y: torch.Tensor, idx: torch.Tensor, w: torch.Tensor, *,
           offset: int = 0) -> torch.Tensor:
    """(N, L) CUDA targets, (rows, k) table → (N, rows) predictions."""
    if Y.device.type != "cuda":
        raise ValueError(f"lookup kernel needs CUDA tensors, got {Y.device}")
    if idx.ndim != 2 or w.shape != idx.shape:
        raise ValueError(f"idx and w must be (rows, k) alike, got "
                         f"{tuple(idx.shape)} and {tuple(w.shape)}")
    if Y.ndim != 2:
        raise ValueError(f"Y must be (N, L), got {tuple(Y.shape)}")
    N, L = Y.shape
    rows, k = idx.shape
    if k < 1:
        raise ValueError("the table needs k >= 1 neighbours")
    out = torch.empty((N, rows), dtype=torch.float32, device=Y.device)
    if N == 0 or rows == 0:
        return out
    Y = _build.as_contiguous(Y, torch.float32)
    idx = _build.as_contiguous(idx, torch.int32)
    w = _build.as_contiguous(w, torch.float32)
    _build.launch(Y.device, "lookup_launch", Y.data_ptr(), L, N,
                  idx.data_ptr(), w.data_ptr(), rows, k, int(offset),
                  out.data_ptr())
    lookup.launches += 1
    return out


lookup.launches = 0
