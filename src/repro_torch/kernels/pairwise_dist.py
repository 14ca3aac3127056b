"""CUDA kernels: squared pairwise distances of one series' delay embedding.

Ports of ``repro/kernels/pairwise_dist.py``:

* ``pairwise_distances`` — Pallas ``_kernel_vpu`` (paper Algorithm 1),
  design and bound in ``csrc/pairwise_dist.cu``. Its plain version
  ``plain`` (``kernels.ref.pairwise_distances``) is held bit-exact
  against it. Neither mean-centers the series (the TPU wrapper does; the
  reference's ``ref`` does not).
* ``pairwise_distances_mxu`` — Pallas ``_kernel_mxu`` (``variant="mxu"``),
  the norm expansion ‖zᵢ‖² + ‖zⱼ‖² − 2⟨zᵢ, zⱼ⟩ of the series centered by
  its float32 mean, as the TPU wrapper centers it; design and bound in
  ``csrc/pairwise_mxu.cu``. Its plain version ``plain_mxu``
  (``kernels.ref.pairwise_distances_mxu``) is held to ``MXU_RTOL`` of
  ‖zᵢ‖² + ‖zⱼ‖² (``mxu_scale``): the cross term is a float32 sum of
  products, taken in another order by each.
"""

from __future__ import annotations

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
    fn = _build.entry("pairwise_mxu_launch")
    with torch.cuda.device(x.device):
        err = fn(xc.data_ptr(), L, E, tau, out.data_ptr(),
                 torch.cuda.current_stream().cuda_stream)
    _build.check(err, "pairwise_mxu")
    pairwise_distances_mxu.launches += 1
    return out


pairwise_distances.launches = 0
pairwise_distances_mxu.launches = 0
