"""CUDA kernel: S-Map weighted Gram matrices and moments.

Port of ``repro/kernels/smap_gram.py`` (Pallas ``_kernel``): for every
(query row, θ, target) the (E+1, E+1) Gram matrix AᵀWA and the moments
AᵀWy that the batched S-Map engine solves (``core/smap_engine.py``).
Design and bound: ``csrc/smap_gram.cu`` (a 3×TF32 tensor-core product
of weights formed once per (library, θ)). It takes an optional leading
library axis: B libraries against shared targets (``smap_group``) or
each against its own (the θ-sweep), one wrapper call for all — in slices
of libraries, or of one library's query rows, when their scratch would
pass ``SCRATCH_BYTES`` — each library's G and M bit-identical to a B = 1
call and to an unsliced one.

The plain version is ``plain`` (``kernels.ref.smap_gram``, library by
library). The two sum in different orders, so they are held to a bound
relative to Σ|terms| (``kernels.ref.smap_gram_abs``), not bit for bit.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref as _ref

#: Scratch the wrapper may hold for one call: per library R's transpose,
#: and per query row its distances, d̄ and, for the wide product, each θ's
#: weights (``scratch_floats``). A batch above it goes through the one
#: launch in slices of libraries; a library above it, in slices of
#: ``ROW_STEP``-multiple query rows (at least one step, so a library whose R
#: alone passes the bound still runs).
SCRATCH_BYTES = 1 << 30
ROW_STEP = 128  # the wide product's rows per block
MAX_THETAS = 64


def scratch_floats(rows: int, C: int, T: int, nj: int | None = None) -> int:
    """Scratch 4-byte words one library takes (``csrc/smap_gram.cu``) with
    its query rows in slices of ``nj`` (default: all ``rows``): R
    (C · ldr, twice for the wide product's TF32 pairs), the slice's
    distances (nj · ldr) and d̄ (nj, padded to 4), and for the wide product
    (C > 32 or T = 1) each θ's weights as TF32 pairs (2T · nj · ldr);
    ldr = rows rounded up to a multiple of 4."""
    nj = rows if nj is None else nj
    ldr = -(-rows // 4) * 4
    wide = C > 32 or T == 1
    return ((2 if wide else 1) * C + nj * (1 + (2 * T if wide else 0))) \
        * ldr + -(-nj // 4) * 4


def slices(rows: int, C: int, T: int, B: int) -> tuple[int, int]:
    """(libraries, query rows) per slice that keep the scratch within
    ``SCRATCH_BYTES``: whole libraries while one fits, else one library in
    row slices of a multiple of ``ROW_STEP``."""
    budget = SCRATCH_BYTES // 4
    whole = scratch_floats(rows, C, T)
    if whole <= budget:
        return max(1, min(B, budget // whole)), rows
    fixed = scratch_floats(rows, C, T, 0)
    step = scratch_floats(rows, C, T, ROW_STEP) - fixed
    return 1, min(rows, max(1, (budget - fixed) // step) * ROW_STEP)


def _shapes(x: torch.Tensor, Y: torch.Tensor):
    """(X (B, L), targets (N, L) or (B, N, L), whether ``x`` had a
    library axis), checked."""
    if x.ndim not in (1, 2):
        raise ValueError(f"x must be (L,) or (B, L), got {tuple(x.shape)}")
    batched = x.ndim == 2
    X = x if batched else x[None]
    B, L = X.shape
    if Y.ndim == 1:
        Y = Y[None]
    if Y.shape[-1] != L:
        raise ValueError("library/target series length mismatch")
    if Y.ndim == 3 and not (batched and Y.shape[0] == B):
        raise ValueError(f"per-library targets must be (B={B}, N, L), got "
                         f"{tuple(Y.shape)}")
    if Y.ndim not in (2, 3):
        raise ValueError(f"Y must be (N, L) or (B, N, L), got "
                         f"{tuple(Y.shape)}")
    return X, Y, batched


def plain(x: torch.Tensor, Y: torch.Tensor, *, E: int, tau: int = 1,
          Tp: int = 1, thetas, exclude_self: bool = True):
    """The plain version at the wrapper's shapes: ``ref.smap_gram`` for
    each library (x (B, L); Y (N, L) shared or (B, N, L) per library)."""
    X, Yb, batched = _shapes(x, Y)
    thetas = tuple(float(t) for t in thetas)
    outs = [_ref.smap_gram(X[b], Yb[b] if Yb.ndim == 3 else Yb, E=E,
                           tau=tau, Tp=Tp, thetas=thetas,
                           exclude_self=exclude_self)
            for b in range(X.shape[0])]
    if not batched:
        return outs[0]
    return (torch.stack([g for g, _ in outs]),
            torch.stack([m for _, m in outs]))


def smap_gram(x: torch.Tensor, Y: torch.Tensor, *, E: int, tau: int = 1,
              Tp: int = 1, thetas, exclude_self: bool = True):
    """CUDA library series → (G, M).

    x (L,) with Y (N, L) gives G (rows, T, E+1, E+1), M (rows, T, N, E+1);
    x (B, L) with Y (N, L) (shared targets) or (B, N, L) (each library its
    own) gives both with a leading B. rows = L − (E−1)τ − Tp, Tp ≥ 0.
    Raises for more than ``MAX_THETAS`` (64) θ.
    """
    if x.device.type != "cuda":
        raise ValueError(f"smap_gram kernel needs a CUDA tensor, got "
                         f"{x.device}")
    X, Yb, batched = _shapes(x, Y)
    if Yb.device != X.device:
        raise ValueError(f"targets on {Yb.device}, library on {X.device}")
    B, L = X.shape
    N = Yb.shape[-2]
    thetas = tuple(float(t) for t in thetas)
    T = len(thetas)
    if not 1 <= T <= MAX_THETAS:
        raise ValueError(f"the kernel takes 1 to {MAX_THETAS} thetas, got {T}")
    if Tp < 0:
        raise ValueError(f"smap_gram needs Tp >= 0, got {Tp}")
    rows = _ref.num_embedded(L, E, tau) - Tp
    if rows <= 0:
        raise ValueError(f"no library rows: L={L}, E={E}, tau={tau}, Tp={Tp}")
    E1 = E + 1
    Xc = X.float().contiguous()
    Yc = Yb.float().contiguous()
    G = torch.empty((B, rows, T, E1, E1), dtype=torch.float32,
                    device=X.device)
    M = torch.empty((B, rows, T, N, E1), dtype=torch.float32,
                    device=X.device)
    if B == 0:  # an empty library batch
        return G, M
    C = E1 * E1 + N * E1
    slice_libs, row_slice = slices(rows, C, T, B)
    scratch = torch.empty(slice_libs * scratch_floats(rows, C, T, row_slice),
                          dtype=torch.float32, device=X.device)
    th = (ctypes.c_float * T)(*thetas)
    fn = _build.entry("smap_gram_launch")
    with torch.cuda.device(X.device):
        err = fn(Xc.data_ptr(), B, L, Yc.data_ptr(),
                 N * L if Yc.ndim == 3 else 0, N, th, T, E, tau, Tp,
                 int(exclude_self), scratch.data_ptr(), slice_libs,
                 row_slice, G.data_ptr(), M.data_ptr(),
                 torch.cuda.current_stream().cuda_stream)
    _build.check(err, "smap_gram")
    smap_gram.launches += 1
    return (G, M) if batched else (G[0], M[0])


smap_gram.launches = 0
