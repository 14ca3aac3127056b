"""Dispatch seam for the EDM kernels: the device picks the implementation.

Every caller goes through these entry points. A tensor on a CUDA device
goes to the hand-written kernel (or the kernel's wrapper raises — there
is no fallback), a tensor on the CPU goes to the plain PyTorch version in
``kernels/ref.py``. ``impl="ref"`` is the one explicit way to run the
plain versions on CUDA tensors (the on-card comparison in
``chip_smoke.py``); ``impl="auto"`` is the device rule above.

Each dispatch bumps an ``edm_ops_<op>_calls`` counter (the invocation
counts the session tests assert on) and emits no telemetry event: dispatch
is counters only, and time is taken by the spans of the layers above
(``repro_torch.telemetry``). Each kernel wrapper also keeps a plain
integer ``launches`` count of the kernels it actually launched.
"""

from __future__ import annotations

import torch

from repro_torch import telemetry
from repro_torch.kernels import (knn_append, knn_batch, knn_fused,
                                 knn_multi_e, pairwise_dist, topk)
from repro_torch.kernels import lookup as _lookup_k
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import smap_gram as _smap_gram_k

make_weights = _ref.make_weights
pearson_rows = _ref.pearson_rows
num_embedded = _ref.num_embedded
delay_embed = _ref.delay_embed

#: Every implementation name the dispatch layer accepts.
IMPLS = ("auto", "ref")
#: The pairwise-distance variants: the strict lag chain ("vpu", bit-exact)
#: and the norm expansion of the centered embedding ("mxu", a tolerance).
VARIANTS = ("vpu", "mxu")


def check_impl(impl: str) -> str:
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r}; expected one of {IMPLS}")
    return impl


def kernel_path(device: torch.device | str, impl: str) -> bool:
    """Does a call on ``device`` launch the CUDA kernel (else the plain
    version)?"""
    return check_impl(impl) == "auto" and torch.device(device).type != "cpu"


def _tel(op: str) -> None:
    telemetry.counter(f"edm_ops_{op}_calls").inc()


def _check_variant(variant: str) -> None:
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}; expected one of "
                         f"{VARIANTS}")


def pairwise_distances(x: torch.Tensor, *, E: int, tau: int = 1,
                       variant: str = "vpu",
                       impl: str = "auto") -> torch.Tensor:
    """(Lp, Lp) squared distances of one series' delay embedding (fused,
    paper Alg. 1). ``"vpu"``: the strict lag chain, not mean-centered;
    ``"mxu"``: ‖zᵢ‖² + ‖zⱼ‖² − 2⟨zᵢ, zⱼ⟩ of the mean-centered embedding,
    clamped at ≥ 0, within ``pairwise_dist.MXU_RTOL`` of that scale. (The
    reference's ``impl="ref"`` ignores the variant; here each variant
    has its own plain version.)"""
    _check_variant(variant)
    kernel = kernel_path(x.device, impl)
    _tel("pairwise_distances")
    if variant == "mxu":
        fn = (pairwise_dist.pairwise_distances_mxu if kernel
              else _ref.pairwise_distances_mxu)
    else:
        fn = (pairwise_dist.pairwise_distances if kernel
              else _ref.pairwise_distances)
    return fn(x, E=E, tau=tau)


def topk_select(D: torch.Tensor, *, k: int, exclude_self: bool = True,
                max_idx=None, impl: str = "auto"):
    """k nearest per row → (Euclidean dists, int32 idx), ascending
    (paper Alg. 2)."""
    kernel = kernel_path(D.device, impl)
    _tel("topk_select")
    if not kernel:
        return _ref.topk_select(D, k=k, exclude_self=exclude_self,
                                max_idx=max_idx)
    return topk.topk_select(D, k=k, exclude_self=exclude_self,
                            max_idx=max_idx)


def topk_select_sizes(D: torch.Tensor, *, k: int, max_idxs,
                      exclude_self: bool = True, impl: str = "auto"):
    """k nearest per row under every ascending prefix cap in one pass →
    (S, Lp, k) each; dist = inf / idx = ``ref.PAD_IDX`` where a cap leaves
    fewer than k candidates. The CCM convergence-sweep primitive."""
    kernel = kernel_path(D.device, impl)
    _tel("topk_select_sizes")
    if not kernel:
        return _ref.topk_select_sizes(D, k=k, max_idxs=max_idxs,
                                      exclude_self=exclude_self)
    return topk.topk_select_sizes(D, k=k, max_idxs=max_idxs,
                                  exclude_self=exclude_self)


def all_knn(x: torch.Tensor, *, E: int, tau: int = 1, k: int | None = None,
            exclude_self: bool = True, max_idx=None, impl: str = "auto",
            variant: str = "vpu", fused: bool = False):
    """All-kNN over one library series (paper §3.3): pairwise distances
    then top-k → (dists (Lp, k), idx (Lp, k)); k defaults to E + 1.

    ``fused=True`` runs one kernel that never writes the (Lp, Lp) matrix
    (``knn_fused``), bit-equal to the two-kernel ``"vpu"`` path; it takes
    no other variant. ``variant="mxu"`` selects on the norm-expansion
    distances, whose indices equal ``"vpu"``'s wherever the k-th and
    (k+1)-th distances are further apart than the variant's tolerance.
    """
    _check_variant(variant)
    if fused and variant != "vpu":
        raise ValueError("fused=True computes the strict-chain ('vpu') "
                         f"distances; got variant={variant!r}")
    k = E + 1 if k is None else int(k)
    kernel = kernel_path(x.device, impl)
    _tel("all_knn")
    if fused:
        fn = knn_fused.all_knn_fused if kernel else _ref.all_knn
        return fn(x, E=E, tau=tau, k=k, exclude_self=exclude_self,
                  max_idx=max_idx)
    D = pairwise_distances(x, E=E, tau=tau, variant=variant, impl=impl)
    return topk_select(D, k=k, exclude_self=exclude_self, max_idx=max_idx,
                       impl=impl)


def lookup(Y: torch.Tensor, idx: torch.Tensor, w: torch.Tensor, *,
           offset: int = 0, impl: str = "auto") -> torch.Tensor:
    """Batched simplex lookup → (N, rows) predictions (paper Alg. 3)."""
    kernel = kernel_path(Y.device, impl)
    _tel("lookup")
    if not kernel:
        return _ref.lookup(Y, idx, w, offset=offset)
    return _lookup_k.lookup(Y, idx, w, offset=offset)


def all_knn_multi_e(X: torch.Tensor, *, E_max: int, tau: int = 1,
                    k: int | None = None, exclude_self: bool = True,
                    max_idx=None, impl: str = "auto"):
    """Incremental all-kNN for every E in 1..E_max in one pass.

    ``X`` is one (L,) series → (E_max, L, k_max) tables, or an (N, L)
    panel → (N, E_max, L, k_max) (one kernel launch for the panel).
    Padding is inf / -1; ``[.., E-1, :Lp_E, :k_E]`` is the table at E.
    """
    kernel = kernel_path(X.device, impl)
    _tel("all_knn_multi_e")
    if not kernel:
        return _ref.all_knn_multi_e(X, E_max=E_max, tau=tau, k=k,
                                    exclude_self=exclude_self,
                                    max_idx=max_idx)
    if X.ndim == 1:
        d, i = knn_multi_e.all_knn_multi_e(
            X[None], E_max=E_max, tau=tau, k=k, exclude_self=exclude_self,
            max_idx=max_idx)
        return d[0], i[0]
    return knn_multi_e.all_knn_multi_e(
        X, E_max=E_max, tau=tau, k=k, exclude_self=exclude_self,
        max_idx=max_idx)


def master_append(X: torch.Tensor, dists: torch.Tensor, idx: torch.Tensor,
                  *, tau: int = 1, impl: str = "auto"):
    """Grow multi-E master tables by the points appended to ``X``.

    ``X`` is the grown (N, L_new) panel (or one (L_new,) series);
    ``dists``/``idx`` the stored uniform-k ``all_knn_multi_e`` tables of
    its prefix, (N, E_max, L_old, k_m) (or without N). Returns the grown
    tables, bit-identical to a cold ``all_knn_multi_e`` on ``X``; one
    kernel launch for the whole panel on the GPU.
    """
    kernel = kernel_path(X.device, impl)
    _tel("master_append")
    fn = knn_append.master_append if kernel else _ref.master_append
    if X.ndim == 1:
        d, i = fn(X[None], dists[None], idx[None], tau=tau)
        return d[0], i[0]
    return fn(X, dists, idx, tau=tau)


def all_knn_batch(X: torch.Tensor, *, E: int, tau: int = 1,
                  k: int | None = None, exclude_self: bool = True,
                  max_idx=None, impl: str = "auto"):
    """All-kNN tables for B library series in one launch → (B, Lp, k),
    bit-invariant in B."""
    kernel = kernel_path(X.device, impl)
    _tel("all_knn_batch")
    if not kernel:
        return _ref.all_knn_batch(X, E=E, tau=tau, k=k,
                                  exclude_self=exclude_self, max_idx=max_idx)
    return knn_batch.all_knn_batch(X, E=E, tau=tau, k=k,
                                   exclude_self=exclude_self, max_idx=max_idx)


def lookup_targets(Y: torch.Tensor, *, impl: str = "auto"):
    """The targets as ``lookup_rho``'s kernel reads them (transposed and
    padded), for a caller that launches several times against one panel
    to make once and pass as ``Yt``; None where no kernel reads them (the
    plain versions, or a single target)."""
    if not kernel_path(Y.device, impl) or Y.shape[0] == 1:
        return None
    return _lookup_k.transpose_targets(Y)


def lookup_rho(Y: torch.Tensor, idx: torch.Tensor, w: torch.Tensor, *,
               offset: int = 0, impl: str = "auto",
               Yt: torch.Tensor | None = None) -> torch.Tensor:
    """Fused lookup + Pearson ρ of every target (paper §3.4).

    ``idx``/``w`` (rows, k) → (N,); a batch (B, rows, k) → (B, N), each
    row independent of B. ``Yt``: ``lookup_targets(Y)``, made once per
    panel by a caller that launches repeatedly (optional).
    """
    kernel = kernel_path(Y.device, impl)
    _tel("lookup_rho")
    if not kernel:
        if idx.ndim == 2:
            return _ref.lookup_rho(Y, idx, w, offset=offset)
        return _ref.lookup_rho_batch(Y, idx, w, offset=offset)
    if idx.ndim == 2:
        return _lookup_k.lookup_rho(Y, idx[None], w[None], offset=offset,
                                    Yt=Yt)[0]
    return _lookup_k.lookup_rho(Y, idx, w, offset=offset, Yt=Yt)


def lookup_rho_own(X: torch.Tensor, idx: torch.Tensor, w: torch.Tensor, *,
                   offset: int = 0, impl: str = "auto") -> torch.Tensor:
    """Table b against its own series X[b] only → (B,) ρ (one launch)."""
    kernel = kernel_path(X.device, impl)
    _tel("lookup_rho")
    if not kernel:
        return _ref.lookup_rho_own(X, idx, w, offset=offset)
    return _lookup_k.lookup_rho(X, idx, w, offset=offset, own=True)


def smap_gram(x: torch.Tensor, Y: torch.Tensor, *, E: int, tau: int = 1,
              Tp: int = 1, thetas, exclude_self: bool = True,
              impl: str = "auto"):
    """S-Map weighted normal-equations accumulation for every (row, θ,
    target) → (G (rows, T, E+1, E+1), M (rows, T, N, E+1)).

    The AᵀWA Gram matrices and AᵀWy moments the batched S-Map engine
    solves (core/smap_engine.py). ``x`` may carry a leading library axis
    (B, L), with ``Y`` (N, L) shared or (B, N, L) per library; G and M
    then gain a leading B. The kernel forms W tile by tile in shared
    memory; the plain version holds one (rows, rows) W at a time.
    """
    thetas = tuple(float(t) for t in thetas)
    kernel = kernel_path(x.device, impl)
    _tel("smap_gram")
    fn = _smap_gram_k.smap_gram if kernel else _smap_gram_k.plain
    return fn(x, Y, E=E, tau=tau, Tp=Tp, thetas=thetas,
              exclude_self=exclude_self)
