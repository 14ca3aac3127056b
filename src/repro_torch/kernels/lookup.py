"""CUDA kernels: the simplex lookup, and the fused lookup + Pearson ρ for a
batch of tables.

``lookup`` ports ``repro/kernels/lookup.py::lookup`` (Pallas
``_kernel_lookup``; paper Algorithm 3): (N, rows) predictions from one
(rows, k) table, bit-equal to its plain version ``plain_lookup``
(``kernels.ref.lookup``, a fixed-order k-sum). Design and bound:
``csrc/lookup.cu``.

``lookup_rho`` ports ``repro/kernels/lookup.py::lookup_rho`` (Pallas
``_kernel_rho`` with ``_gather_tile``). The TPU wrapper takes one
(rows, k) table per call; the session would then launch once per series
and E (3,080 calls for ``optimal_E`` at N = 154, E_max = 20), so this
wrapper takes a batch of B tables in one launch, in two forms:

* all targets — (B, rows, k) tables against (Nt, L) targets → (B, Nt);
* own target  — (B, rows, k) tables against (B, L) series, table b
  against series b only → (B,): the ρ(E) sweep of the optimal-E search.

Each (b, n) result does not depend on B. Design and bound:
``csrc/lookup_rho.cu``. The plain versions are ``plain`` and
``plain_own`` (``kernels.ref``); the kernel merges Welford moments in
another order than their two-pass Pearson, so the two agree to a
tolerance, not bit for bit.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref as _ref

plain = _ref.lookup_rho_batch
plain_own = _ref.lookup_rho_own
plain_lookup = _ref.lookup

_THREADS = 256


def _block(Nt: int, own: bool) -> tuple[int, int]:
    """(targets, row slices) per block: 32 targets a warp, or 1 when own."""
    tn = 1 if own else min(32, Nt)
    tj = 1
    while tj * 2 * tn <= _THREADS:
        tj *= 2
    return tn, tj


def lookup_rho(Y: torch.Tensor, idx: torch.Tensor, w: torch.Tensor, *,
               offset: int = 0, own: bool = False) -> torch.Tensor:
    """Batched fused lookup-ρ on CUDA tensors (see the module docstring)."""
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
    idx_c = idx.to(torch.int32).contiguous()
    w_c = w.float().contiguous()
    if own:  # each thread reads its own series along its row
        Yc = Y.float().contiguous()
        sn, sc = L, 1
    else:  # a warp's 32 targets read 32 consecutive words
        Yc = Y.float().t().contiguous()
        sn, sc = 1, Nt
    tn, tj = _block(Nt, own)
    fn = _build.entry("lookup_rho_launch")
    with torch.cuda.device(Y.device):
        err = fn(Yc.data_ptr(), sn, sc, L, Nt, idx_c.data_ptr(),
                 w_c.data_ptr(), B, rows, k, int(offset), int(own), tn, tj,
                 out.data_ptr(), torch.cuda.current_stream().cuda_stream)
    _build.check(err, "lookup_rho")
    lookup_rho.launches += 1
    return out


lookup_rho.launches = 0


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
    Yc = Y.float().contiguous()
    idx_c = idx.to(torch.int32).contiguous()
    w_c = w.float().contiguous()
    fn = _build.entry("lookup_launch")
    with torch.cuda.device(Y.device):
        err = fn(Yc.data_ptr(), L, N, idx_c.data_ptr(), w_c.data_ptr(), rows,
                 k, int(offset), out.data_ptr(),
                 torch.cuda.current_stream().cuda_stream)
    _build.check(err, "lookup")
    lookup.launches += 1
    return out


lookup.launches = 0
