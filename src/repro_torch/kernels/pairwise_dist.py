"""CUDA kernel: squared pairwise distances of one series' delay embedding.

Port of ``repro/kernels/pairwise_dist.py`` (Pallas ``_kernel_vpu``; paper
Algorithm 1). Design and bound: ``csrc/pairwise_dist.cu``. The plain
version is ``plain`` (``kernels.ref.pairwise_distances``), held bit-exact
against it. Neither mean-centers the series (the TPU wrapper does; the
reference's ``ref`` does not).
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref as _ref

plain = _ref.pairwise_distances

#: Hopper's per-block dynamic shared memory ceiling.
SMEM_MAX = 232_448
TILE = 64  # the kernel's output tile edge


def pairwise_distances(x: torch.Tensor, *, E: int,
                       tau: int = 1) -> torch.Tensor:
    """(L,) CUDA series → (Lp, Lp) float32 squared distances."""
    if x.device.type != "cuda":
        raise ValueError(f"pairwise_dist kernel needs a CUDA tensor, got "
                         f"{x.device}")
    if x.ndim != 1:
        raise ValueError(f"x must be (L,), got shape {tuple(x.shape)}")
    L = x.shape[0]
    Lp = _ref.num_embedded(L, E, tau)
    smem = 2 * (TILE + (E - 1) * tau) * 4
    if smem > SMEM_MAX:
        raise ValueError(f"E={E}, tau={tau} needs {smem} B of shared memory, "
                         f"more than a block has ({SMEM_MAX} B)")
    xc = x.float().contiguous()
    out = torch.empty((Lp, Lp), dtype=torch.float32, device=x.device)
    fn = _build.entry("pairwise_dist_launch")
    with torch.cuda.device(x.device):
        err = fn(xc.data_ptr(), L, E, tau, out.data_ptr(),
                 torch.cuda.current_stream().cuda_stream)
    _build.check(err, "pairwise_dist")
    pairwise_distances.launches += 1
    return out


pairwise_distances.launches = 0
