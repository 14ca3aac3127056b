"""CUDA kernels: squared pairwise distances of one series' delay embedding.

Ports of ``repro/kernels/pairwise_dist.py``:

* ``pairwise_distances`` — Pallas ``_kernel_vpu`` (paper Algorithm 1),
  design and bound in ``csrc/pairwise_dist.cu``: 32 × 128 tiles, register
  micro-tiles of 4 columns a lane, in two designs picked by ``route``
  (E ≤ ``VECTOR_E_MAX``: aligned 16-byte stores built across lanes; else
  word stores). Its plain version ``plain``
  (``kernels.ref.pairwise_distances``) is held bit-exact against both;
  ``_emulate`` repeats their tiles and stores on the CPU for the tests.
  Neither mean-centers the series (the TPU wrapper does; the reference's
  ``ref`` does not).
* ``pairwise_distances_mxu`` — Pallas ``_kernel_mxu`` (``variant="mxu"``),
  the norm expansion ‖zᵢ‖² + ‖zⱼ‖² − 2⟨zᵢ, zⱼ⟩ of the series centered by
  its float32 mean, as the TPU wrapper centers it; design and bound in
  ``csrc/pairwise_mxu.cu``. Its plain version ``plain_mxu``
  (``kernels.ref.pairwise_distances_mxu``) is held to ``MXU_RTOL`` of
  ‖zᵢ‖² + ‖zⱼ‖² (``mxu_scale``): the cross term is a float32 sum of
  products, taken in another order by each.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref as _ref

plain = _ref.pairwise_distances
plain_mxu = _ref.pairwise_distances_mxu

#: The mxu distances' tolerance, relative to ‖zᵢ‖² + ‖zⱼ‖²: a float32 sum
#: of E products (a norm, or the cross term, |⟨zᵢ, zⱼ⟩| ≤ (‖zᵢ‖² + ‖zⱼ‖²)/2)
#: is within E·2⁻²⁴ of that scale, so one expansion is within
#: (2E + 3)·2⁻²⁴ ≈ 2.6e-6 of it at E = 20, and two summation orders within
#: twice that.
MXU_RTOL = 1e-5

#: Hopper's per-block dynamic shared memory ceiling.
SMEM_MAX = 232_448
TILE = 64  # the mxu kernel's output tile edge
#: The vpu kernel's tile: TILE_ROWS rows by TILE_COLS columns (32 lanes of
#: 4); its vector design (16-byte stores) takes E up to VECTOR_E_MAX, the
#: word design larger E, where the arithmetic is the limit.
TILE_ROWS, TILE_COLS = 32, 128
VECTOR_E_MAX = 6
_DESIGNS = ("vector", "word")


def route(E: int) -> str:
    """Which design of the vpu kernel takes E: ``"vector"`` or ``"word"``."""
    return "vector" if E <= VECTOR_E_MAX else "word"


def _window_words(n: int, span: int) -> int:
    """Words of one of the four shifted copies of a tile's series window."""
    return (n + span + 3) & ~3


def vpu_smem_bytes(E: int, tau: int) -> int:
    """The vpu kernel's shared memory: four shifted copies of the rows'
    and of the columns' series windows."""
    span = (E - 1) * tau
    return 16 * (_window_words(TILE_ROWS, span)
                 + _window_words(TILE_COLS, span))


def pairwise_distances(x: torch.Tensor, *, E: int,
                       tau: int = 1) -> torch.Tensor:
    """(L,) CUDA series → (Lp, Lp) float32 squared distances."""
    out = _launch(x, None, E=E, tau=tau)
    pairwise_distances.launches += 1
    return out


def _launch(x: torch.Tensor, kind: str | None, *, E: int,
            tau: int = 1) -> torch.Tensor:
    """One launch of the vpu kernel's design ``kind`` (``route``'s pick for
    None); the kernel comparisons reach both designs through it,
    uncounted."""
    if x.device.type != "cuda":
        raise ValueError(f"pairwise_dist kernel needs a CUDA tensor, got "
                         f"{x.device}")
    if x.ndim != 1:
        raise ValueError(f"x must be (L,), got shape {tuple(x.shape)}")
    L = x.shape[0]
    Lp = _ref.num_embedded(L, E, tau)
    smem = vpu_smem_bytes(E, tau)
    if smem > SMEM_MAX:
        raise ValueError(f"E={E}, tau={tau} needs {smem} B of shared memory, "
                         f"more than a block has ({SMEM_MAX} B)")
    x = _build.as_contiguous(x, torch.float32)
    out = torch.empty((Lp, Lp), dtype=torch.float32, device=x.device)
    _build.launch(x.device, "pairwise_dist_launch", x.data_ptr(), L, E, tau,
                  _DESIGNS.index(kind or route(E)), out.data_ptr())
    return out


def mxu_scale(x: torch.Tensor, *, E: int, tau: int = 1) -> torch.Tensor:
    """(Lp, Lp) ‖zᵢ‖² + ‖zⱼ‖² of the centered embedding, in float64: the
    scale the mxu distances are held to (``MXU_RTOL``)."""
    xd = x.double()
    Z = _ref.delay_embed(xd - xd.mean(), E, tau)
    n = (Z * Z).sum(-1)
    return n[:, None] + n[None, :]


def pairwise_distances_mxu(x: torch.Tensor, *, E: int,
                           tau: int = 1) -> torch.Tensor:
    """(L,) CUDA series → (Lp, Lp) float32 squared distances by norm
    expansion of the mean-centered embedding, clamped at ≥ 0."""
    if x.device.type != "cuda":
        raise ValueError(f"pairwise_mxu kernel needs a CUDA tensor, got "
                         f"{x.device}")
    if x.ndim != 1:
        raise ValueError(f"x must be (L,), got shape {tuple(x.shape)}")
    L = x.shape[0]
    Lp = _ref.num_embedded(L, E, tau)
    smem = (2 * (TILE + (E - 1) * tau) + 2 * TILE) * 4
    if smem > SMEM_MAX:
        raise ValueError(f"E={E}, tau={tau} needs {smem} B of shared memory, "
                         f"more than a block has ({SMEM_MAX} B)")
    xf = x.float()
    xc = (xf - xf.mean()).contiguous()  # the plain version's centering
    out = torch.empty((Lp, Lp), dtype=torch.float32, device=x.device)
    _build.launch(x.device, "pairwise_mxu_launch", xc.data_ptr(), L, E, tau,
                  out.data_ptr())
    pairwise_distances_mxu.launches += 1
    return out


pairwise_distances.launches = 0
pairwise_distances_mxu.launches = 0


def _emulate(x: torch.Tensor, *, E: int, tau: int = 1,
             kind: str | None = None,
             stats: dict | None = None) -> torch.Tensor:
    """``csrc/pairwise_dist.cu`` on the CPU, tile by tile and store by
    store (tests only; no path calls it) → (Lp, Lp) float32.

    Each TILE_ROWS × TILE_COLS tile reads its two series windows from
    four shifted copies of P words (zero past L), as the kernel stages
    them, and runs the strict lag chain on them. Each row of a tile is
    written as the design ``kind`` (``route``'s pick for None) writes it;
    lane t holds columns 4t .. 4t + 3. The word design stores each of
    them. The vector design, with s = (i·Lp + j0) mod 4, makes lane t's
    group of lane t − 1's last s values (a shuffle up by one; lane 0 gets
    its own) and its own first 4 − s: one 16-byte store when the group
    lies inside the row, word stores for the part that does; lane 31
    writes its last s values word by word. Raises if a 16-byte store is
    misaligned or if any entry is written other than once. ``stats``, if
    given, counts the 16-byte and the word stores."""
    xn = x.detach().float().cpu().numpy()
    L = xn.shape[0]
    Lp = _ref.num_embedded(L, E, tau)
    span = (E - 1) * tau
    flat = np.full(Lp * Lp, np.nan, np.float32)
    writes = np.zeros(Lp * Lp, np.int64)
    st = stats if stats is not None else {}
    st.setdefault("v4", 0)
    st.setdefault("words", 0)
    lanes = np.arange(32)
    vector = (kind or route(E)) == "vector"

    def copies(base, n):  # win[s, u] = x[base + u + s], 0 past L
        P = _window_words(n, span)
        g = base + np.arange(P)[None, :] + np.arange(4)[:, None]
        return np.where(g < L, xn[np.minimum(g, L - 1)], np.float32(0))

    def store(at, pos, vals):
        flat[at + pos] = vals
        np.add.at(writes, at + pos, 1)

    for i0 in range(0, Lp, TILE_ROWS):
        wr = copies(i0, TILE_ROWS)
        for j0 in range(0, Lp, TILE_COLS):
            wc = copies(j0, TILE_COLS)
            acc = np.zeros((TILE_ROWS, TILE_COLS), np.float32)
            for e in range(E):
                o = e * tau
                s, q = o % 4, o - o % 4
                a = wr[s, q:q + TILE_ROWS]
                b = wc[s, q:q + TILE_COLS]
                if a.size != TILE_ROWS or b.size != TILE_COLS:
                    raise RuntimeError("a lag reads past its staged copy")
                d = a[:, None] - b[None, :]
                acc = acc + d * d
            n = min(TILE_COLS, Lp - j0)
            for r in range(min(TILE_ROWS, Lp - i0)):
                at = (i0 + r) * Lp + j0
                s = at % 4
                v = acc[r].reshape(32, 4)
                if not vector:
                    keep = np.arange(TILE_COLS) < n
                    store(at, np.arange(TILE_COLS)[keep], acc[r][keep])
                    st["words"] += int(keep.sum())
                    continue
                prev = np.concatenate([v[:1], v[:-1]])
                g = np.concatenate([prev[:, 4 - s:], v[:, :4 - s]], axis=1)
                u0 = 4 * lanes - s
                pos = u0[:, None] + np.arange(4)
                full = (u0 >= 0) & (u0 + 4 <= n)
                if ((at + u0[full]) % 4).any():
                    raise RuntimeError("a 16-byte store is misaligned")
                store(at, pos[full].ravel(), g[full].ravel())
                part = ~full[:, None] & (pos >= 0) & (pos < n)
                store(at, pos[part], g[part])
                st["v4"] += int(full.sum())
                st["words"] += int(part.sum())
                if s:  # lane 31's last s values
                    tail = np.arange(128 - s, 128)
                    keep = tail < n
                    store(at, tail[keep], v[31, 4 - s:][keep])
                    st["words"] += int(keep.sum())
    if not (writes == 1).all():
        raise RuntimeError(f"{int((writes != 1).sum())} entries were written "
                           f"other than once")
    return torch.from_numpy(flat.reshape(Lp, Lp))
