"""Plain PyTorch versions of the main-path EDM kernels (eager, uncompiled).

Op-for-op counterparts of ``repro/kernels/ref.py``: the CPU tests run
them against the JAX reference, and on the GPU they are what each CUDA
kernel is held against. They stay eager on purpose: every op rounds on
its own, so a distance chain is the strict two-rounding
``fl(acc + fl(d·d))`` at any shape (no FMA contraction), exactly as the
reference pins it.

Index conventions (0-based, as in the reference):
  - delay embedding of a series ``x`` of length L with dimension E, lag tau:
        z_i[k] = x[i + k*tau],   k in [0, E),  i in [0, Lp),
    with ``Lp = L - (E-1)*tau`` embedded points.
  - a lookup with horizon Tp reads target values at
    ``I[j, k] + (E-1)*tau + Tp`` — callers pass that combined ``offset``.

Selection is an exact stable (value, index) order: masked candidates
enter as +inf with their real column index, and ``torch.sort(stable=True)``
keeps equal values in ascending column order — ``lax.top_k``'s tie rule
in the reference. (``torch.topk`` promises no tie order.)
"""

from __future__ import annotations

import numpy as np
import torch

PAD_IDX = -1  # idx padding outside the valid (Lp_E, k_E) block per level

_INF = float("inf")


def strict_sq(d: torch.Tensor) -> torch.Tensor:
    """The rounded square fl(d·d); NaN products select 0.0 as in the
    reference (inputs are screened finite, so that arm is dead)."""
    d2 = d * d
    return torch.where(d2 > -1.0, d2, torch.zeros_like(d2))


def num_embedded(L: int, E: int, tau: int) -> int:
    """Number of valid delay-embedding vectors."""
    n = L - (E - 1) * tau
    if n <= 0:
        raise ValueError(f"series too short: L={L}, E={E}, tau={tau}")
    return n


def sqrt_rn(v: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root.

    ``torch.sqrt`` on the CPU is not correctly rounded for float32 (1 ULP
    off on some inputs), while the reference's and the CUDA kernels' are.
    The root of a float32 taken in float64 and rounded once to float32 is
    the correctly rounded float32 root (float64 carries more than
    2·24 + 2 bits, so the double rounding is exact for sqrt).
    """
    return torch.sqrt(v.double()).float()


def _select(vals: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """k smallest per row in (value, index) order → (sqrt dists, int32 idx)."""
    sv, si = torch.sort(vals, dim=-1, stable=True)
    return sqrt_rn(sv[..., :k]), si[..., :k].to(torch.int32)


def sum_last(w: torch.Tensor) -> torch.Tensor:
    """Left-to-right sum over the last axis, one elementwise add per slot.

    The summation order is fixed by the code, not by a reduction kernel's
    launch shape, so each row's sum is the same at any batch size — the
    batch-invariance contract of the matrix engines.
    """
    s = w[..., 0]
    for c in range(1, w.shape[-1]):
        s = s + w[..., c]
    return s


def sum_tree(w: torch.Tensor) -> torch.Tensor:
    """Pairwise-tree sum over the last axis, one elementwise add per level.

    The axis is zero-padded to a power of two and halved until one slot
    is left; the order of every sum is fixed by the code, so a row's sum
    is the same bits at any batch size and on any device (a reduction
    kernel's split of a long axis depends on how many rows it reduces).
    """
    n = w.shape[-1]
    s = torch.nn.functional.pad(w, (0, (1 << max(n - 1, 0).bit_length()) - n))
    while s.shape[-1] > 1:
        h = s.shape[-1] // 2
        s = s[..., :h] + s[..., h:]
    return s[..., 0]


def make_weights(dists: torch.Tensor, eps: float = 1e-30) -> torch.Tensor:
    """Simplex weights from sorted neighbor distances, paper step (3).

    w_i = exp(-d_i / d_min) normalized to sum 1; rows with no valid
    neighbor (all-inf distances) get all-zero weights instead of NaN.
    """
    d_min = torch.clamp(dists[..., :1], min=eps)
    ratio = torch.where(torch.isfinite(d_min), dists / d_min,
                        torch.full_like(dists, _INF))
    w = torch.exp(-ratio)
    s = sum_last(w)[..., None]
    return torch.where(s > 0, w / torch.clamp(s, min=eps),
                       torch.zeros_like(w))


def lookup(Y: torch.Tensor, idx: torch.Tensor, w: torch.Tensor, *,
           offset: int = 0) -> torch.Tensor:
    """Batched simplex lookup, paper Algorithm 3 → (N, rows).

    Yhat[n, j] = sum_k w[j, k] * Y[n, idx[j, k] + offset], the k products
    summed left to right (``sum_last``), so the CUDA kernel can repeat the
    order bit for bit. Indices are clamped into [0, L-1]: invalid slots
    carry idx = -1 with weight 0 (``edm.plan._derive_idx``), so clamping
    leaves finite results as they are while ``torch`` indexing would raise
    on them.
    """
    L = Y.shape[-1]
    cols = torch.clamp(idx.long() + offset, 0, L - 1)
    g = Y[:, cols]  # (N, rows, k)
    return sum_last(g * w.to(Y.dtype))


def pearson_rows(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Row-wise Pearson correlation, two-pass; 0 where a variance is 0."""
    a = a.float()
    b = b.float()
    am = a - a.mean(-1, keepdim=True)
    bm = b - b.mean(-1, keepdim=True)
    cov = (am * bm).sum(-1)
    va = (am * am).sum(-1)
    vb = (bm * bm).sum(-1)
    denom = torch.sqrt(va * vb)
    return torch.where(denom > 0, cov / torch.clamp(denom, min=1e-30),
                       torch.zeros_like(cov))


def pearson_rows_tree(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``pearson_rows`` with every sum a ``sum_tree``: each row's ρ is the
    same bits whatever the other rows of the call (the batch invariance
    of the S-Map engines)."""
    a = a.float()
    b = b.float()
    am = a - (sum_tree(a) / a.shape[-1])[..., None]
    bm = b - (sum_tree(b) / b.shape[-1])[..., None]
    cov = sum_tree(am * bm)
    va = sum_tree(am * am)
    vb = sum_tree(bm * bm)
    denom = torch.sqrt(va * vb)
    return torch.where(denom > 0, cov / torch.clamp(denom, min=1e-30),
                       torch.zeros_like(cov))


def lookup_rho(Y: torch.Tensor, idx: torch.Tensor, w: torch.Tensor, *,
               offset: int = 0) -> torch.Tensor:
    """Fused lookup + Pearson ρ per target → (N,).

    Compares Yhat[n, j] with the aligned truth Y[n, j + offset].
    """
    yhat = lookup(Y, idx, w, offset=offset)
    rows = idx.shape[0]
    return pearson_rows(yhat, Y[:, offset:offset + rows])


def lookup_rho_batch(Y, idx, w, *, offset: int = 0) -> torch.Tensor:
    """B tables against all N targets → (B, N): one ``lookup_rho`` per
    table, so each row sees the shapes of a B = 1 call."""
    return torch.stack([lookup_rho(Y, idx[b], w[b], offset=offset)
                        for b in range(idx.shape[0])])


def lookup_rho_own(X, idx, w, *, offset: int = 0) -> torch.Tensor:
    """Table b against its own series X[b] only → (B,)."""
    return torch.stack([lookup_rho(X[b:b + 1], idx[b], w[b],
                                   offset=offset)[0]
                        for b in range(idx.shape[0])])


# --------------------------------------------------------------------------
# Per-series pipeline: distance matrix, top-k, multi-cap top-k (the
# simplex oracle and the CCM convergence engine).
# --------------------------------------------------------------------------


def delay_embed(x: torch.Tensor, E: int, tau: int) -> torch.Tensor:
    """Materialized time-delay embedding, shape (..., Lp, E)."""
    Lp = num_embedded(x.shape[-1], E, tau)
    return torch.stack([x[..., k * tau:k * tau + Lp] for k in range(E)],
                       dim=-1)


def pairwise_distances(x: torch.Tensor, *, E: int, tau: int) -> torch.Tensor:
    """(Lp, Lp) squared distances of the delay embedding of one series.

    The strict chain from ``acc = 0``: ``acc + fl((x[i+kτ] − x[j+kτ])²)``
    for k = 0..E-1 in order. The series is not mean-centered (the TPU
    kernel's wrapper centers it; the reference ``ref`` does not).
    """
    x = x.float()
    Lp = num_embedded(x.shape[-1], E, tau)
    acc = torch.zeros((Lp, Lp), dtype=torch.float32, device=x.device)
    for k in range(E):
        xk = x[k * tau:k * tau + Lp]
        acc = acc + strict_sq(xk[:, None] - xk[None, :])
    return acc


def _sorted_roots(sv: torch.Tensor) -> torch.Tensor:
    """Euclidean distances of selected squared ones: sqrt(max(v, 0))."""
    return sqrt_rn(torch.clamp(sv, min=0.0))


def topk_select(D: torch.Tensor, *, k: int, exclude_self: bool = True,
                max_idx=None) -> tuple[torch.Tensor, torch.Tensor]:
    """k smallest per row of a square squared-distance matrix → (Lp, k).

    Returns ascending Euclidean distances and int32 column indices.
    Self (``exclude_self``) and columns past ``max_idx`` (inclusive cap)
    enter as +inf with their real index, so a row with fewer than k valid
    candidates fills in with +inf in ascending column order, as
    ``lax.top_k`` fills it in the reference.
    """
    Lp = D.shape[0]
    if k > Lp:
        raise ValueError(f"k={k} exceeds the {Lp} candidates per row")
    dev = D.device
    mask = torch.zeros((Lp, Lp), dtype=torch.bool, device=dev)
    if exclude_self:
        mask |= torch.eye(Lp, dtype=torch.bool, device=dev)
    if max_idx is not None:
        mask |= torch.arange(Lp, device=dev)[None, :] > int(max_idx)
    sv, si = torch.sort(torch.where(mask, _INF, D.float()), dim=-1,
                        stable=True)
    return _sorted_roots(sv[:, :k]), si[:, :k].to(torch.int32)


def all_knn(x: torch.Tensor, *, E: int, tau: int = 1, k: int | None = None,
            exclude_self: bool = True,
            max_idx=None) -> tuple[torch.Tensor, torch.Tensor]:
    """All-kNN over one series, ``pairwise_distances`` then ``topk_select``
    → (Lp, k) each; k defaults to E + 1. The plain version of the fused
    kernel, which must give the same bits without the (Lp, Lp) matrix."""
    k = E + 1 if k is None else int(k)
    return topk_select(pairwise_distances(x, E=E, tau=tau), k=k,
                       exclude_self=exclude_self, max_idx=max_idx)


def all_knn_rows(x: torch.Tensor, rows, *, E: int, tau: int = 1,
                 k: int | None = None, exclude_self: bool = True,
                 max_idx=None) -> tuple[torch.Tensor, torch.Tensor]:
    """``all_knn``'s rows ``rows`` alone → (len(rows), k) each: the strict
    chain of those rows against every column and the same stable
    selection, without the (Lp, Lp) matrix (a check of a long series)."""
    x = x.float()
    Lp = num_embedded(x.shape[-1], E, tau)
    k = E + 1 if k is None else int(k)
    if k > Lp:
        raise ValueError(f"k={k} exceeds the {Lp} candidates per row")
    r = torch.as_tensor(rows, device=x.device).long()
    acc = torch.zeros((r.numel(), Lp), dtype=torch.float32, device=x.device)
    for e in range(E):
        xe = x[e * tau:e * tau + Lp]
        acc = acc + strict_sq(xe[r][:, None] - xe[None, :])
    cols = torch.arange(Lp, device=x.device)[None, :]
    mask = torch.zeros_like(acc, dtype=torch.bool)
    if exclude_self:
        mask |= cols == r[:, None]
    if max_idx is not None:
        mask |= cols > int(max_idx)
    sv, si = torch.sort(torch.where(mask, _INF, acc), dim=-1, stable=True)
    return _sorted_roots(sv[:, :k]), si[:, :k].to(torch.int32)


def check_sizes_caps(max_idxs) -> tuple[int, ...]:
    """Validate a multi-cap tuple (non-empty, >= 0, ascending) → ints."""
    caps = tuple(int(m) for m in max_idxs)
    if not caps:
        raise ValueError("max_idxs must not be empty")
    if any(m < 0 for m in caps):
        raise ValueError(f"max_idxs must be >= 0, got {caps}")
    if any(b < a for a, b in zip(caps, caps[1:])):
        raise ValueError(f"max_idxs must be ascending, got {caps}")
    return caps


def topk_select_sizes(D: torch.Tensor, *, k: int, max_idxs,
                      exclude_self: bool = True
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """k smallest per row under every prefix cap → (S, Lp, k) each.

    Level s is the (value, index) k-best over columns [0, max_idxs[s]]
    (self excluded): the same valid slots as ``topk_select(D, k=k,
    max_idx=max_idxs[s])``. A slot is valid iff its distance is finite;
    the others are dist = inf / idx = ``PAD_IDX``.
    """
    Lp = D.shape[0]
    caps = check_sizes_caps(max_idxs)
    dev = D.device
    rows = torch.arange(Lp, device=dev)[:, None]
    outs_d, outs_i = [], []
    for m in caps:
        hi = min(m + 1, Lp)
        vals = D[:, :hi].float()
        if exclude_self:
            vals = torch.where(torch.arange(hi, device=dev)[None, :] == rows,
                               _INF, vals)
        sv, si = torch.sort(vals, dim=-1, stable=True)
        pad = max(0, k - hi)
        sv = torch.nn.functional.pad(sv[:, :k], (0, pad), value=_INF)
        si = torch.nn.functional.pad(si[:, :k], (0, pad), value=PAD_IDX)
        ok = torch.isfinite(sv)
        outs_d.append(torch.where(ok, _sorted_roots(sv), _INF))
        outs_i.append(torch.where(ok, si.to(torch.int32), PAD_IDX))
    return torch.stack(outs_d), torch.stack(outs_i)


# --------------------------------------------------------------------------
# Library-batched all-kNN (the CCM matrix engine primitive).
# --------------------------------------------------------------------------


def all_knn_batch(X: torch.Tensor, *, E: int, tau: int = 1,
                  k: int | None = None, exclude_self: bool = True,
                  max_idx=None) -> tuple[torch.Tensor, torch.Tensor]:
    """All-kNN tables for B library series → (B, Lp, k) dists + int32 idx.

    Slice b depends on X[b] only (bit-invariant in B). Masked columns
    (past ``max_idx``, and self) enter the selection as +inf with their
    column index.
    """
    if X.ndim != 2:
        raise ValueError(f"X must be (B, L), got shape {tuple(X.shape)}")
    B, L = X.shape
    Lp = num_embedded(L, E, tau)
    k = E + 1 if k is None else int(k)
    if k > Lp:
        raise ValueError(f"k={k} exceeds the {Lp} candidates per row")
    Xf = X.float()
    acc = torch.zeros((B, Lp, Lp), dtype=torch.float32, device=X.device)
    for lag in range(E):
        xk = Xf[:, lag * tau:lag * tau + Lp]
        acc = acc + strict_sq(xk[:, :, None] - xk[:, None, :])
    cols = torch.arange(Lp, device=X.device)
    mask = torch.zeros((Lp, Lp), dtype=torch.bool, device=X.device)
    if exclude_self:
        mask |= torch.eye(Lp, dtype=torch.bool, device=X.device)
    if max_idx is not None:
        mask |= (cols[None, :] > int(max_idx))
    return _select(torch.where(mask[None], _INF, acc), k)


# --------------------------------------------------------------------------
# Incremental multi-E all-kNN (the one-pass optimal-E sweep engine).
#
# D_E = D_{E-1} + (x[i+(E-1)τ] − x[j+(E-1)τ])², so the stack of per-E
# tables costs one O(E_max·L²) accumulation. Outputs are padded to the
# E=1 shape (E_max, L, k_max); padding is dist=inf / idx=PAD_IDX.
# --------------------------------------------------------------------------


def multi_e_ks(E_max: int, k: int | None) -> tuple[int, ...]:
    """Per-level neighbor counts: k_E = E+1 (simplex default) or uniform k."""
    if E_max < 1:
        raise ValueError(f"E_max must be >= 1, got {E_max}")
    if k is None:
        return tuple(e + 2 for e in range(E_max))  # E = e+1 → k = E+1
    return (int(k),) * E_max


def multi_e_max_idx(L: int, E_max: int, tau: int, max_idx) -> tuple[int, ...]:
    """Per-level candidate caps, clamped to the level's last valid index.

    ``max_idx`` may be None, an int, or an (E_max,) sequence of ints.
    """
    base = [L - e * tau - 1 for e in range(E_max)]
    if max_idx is None:
        return tuple(base)
    mx = np.broadcast_to(np.asarray(max_idx, np.int64), (E_max,))
    return tuple(int(min(m, b)) for m, b in zip(mx, base))


def pad_multi_e_tables(dists, idx, *, E_max: int, tau: int,
                       ks: tuple[int, ...]):
    """Force dist=inf / idx=PAD_IDX outside each level's (Lp_E, k_E) block."""
    L = dists.shape[-2]
    dev = dists.device
    lev = torch.arange(E_max, device=dev)[:, None, None]
    rows = torch.arange(L, device=dev)[None, :, None]
    kcol = torch.arange(dists.shape[-1], device=dev)[None, None, :]
    ks_a = torch.tensor(ks, device=dev)[:, None, None]
    valid = (rows < L - lev * tau) & (kcol < ks_a)
    return (torch.where(valid, dists, _INF),
            torch.where(valid, idx, PAD_IDX))


def all_knn_multi_e(x: torch.Tensor, *, E_max: int, tau: int = 1,
                    k: int | None = None, exclude_self: bool = True,
                    max_idx=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Neighbor tables for every E in 1..E_max in one incremental pass.

    Returns (dists, idx), both (E_max, L, k_max): slice
    ``[E-1, :Lp_E, :k_E]`` is the table at dimension E. A (N, L) panel
    gives (N, E_max, L, k_max), one series at a time.
    """
    if x.ndim == 2:
        outs = [all_knn_multi_e(xs, E_max=E_max, tau=tau, k=k,
                                exclude_self=exclude_self, max_idx=max_idx)
                for xs in x]
        return (torch.stack([d for d, _ in outs]),
                torch.stack([i for _, i in outs]))
    L = x.shape[-1]
    num_embedded(L, E_max, tau)  # raises on too-short series
    ks = multi_e_ks(E_max, k)
    mxs = multi_e_max_idx(L, E_max, tau, max_idx)
    k_max = max(ks)
    if k_max > L:
        raise ValueError(f"k={k_max} exceeds the {L} candidates per row")
    dev = x.device
    xpad = torch.cat([x.float(),
                      torch.zeros((E_max - 1) * tau, device=dev)])
    cols = torch.arange(L, device=dev)[None, :]
    rows = torch.arange(L, device=dev)[:, None]
    acc = torch.zeros((L, L), dtype=torch.float32, device=dev)
    outs_d, outs_i = [], []
    for e in range(E_max):  # level e ↔ embedding dim E = e+1
        xk = xpad[e * tau:e * tau + L]
        acc = acc + strict_sq(xk[:, None] - xk[None, :])
        invalid = cols > mxs[e]
        if exclude_self:
            invalid = invalid | (cols == rows)
        d, i = _select(torch.where(invalid, _INF, acc), ks[e])
        pad = k_max - ks[e]
        outs_d.append(torch.nn.functional.pad(d, (0, pad), value=_INF))
        outs_i.append(torch.nn.functional.pad(i, (0, pad), value=PAD_IDX))
    return pad_multi_e_tables(torch.stack(outs_d), torch.stack(outs_i),
                              E_max=E_max, tau=tau, ks=ks)


# --------------------------------------------------------------------------
# S-Map weighted normal equations (the batched S-Map engine substrate).
#
# For query row j and locality θ, S-Map fits ŷ = [1, z_j]·b with
# b = argmin Σ_i w_i (y_i − [1, z_i]·b)²,  w_i = exp(−θ d_ij / d̄_j).
# The engine accumulates the (E+1, E+1) weighted Gram matrix G = AᵀWA and
# the moments M = AᵀWy for every (j, θ, target) and batch-solves the ridge
# normal equations downstream (core/smap_engine.py).
# --------------------------------------------------------------------------

_DBAR_TINY = 1e-30  # d̄ below this ⇒ degenerate (constant) row: ratio d/1


def smap_ratio(x: torch.Tensor, *, E: int, tau: int,
               rows: int) -> torch.Tensor:
    """(rows, rows) S-Map distance ratios d_ij / d̄_j over the library.

    d_ij = sqrt_rn(max(D_ij, 0)) of the strict-chain squared distances
    (bit-equal to the reference's); d̄_j is their mean over the ``rows``
    library columns, self's zero included (cppEDM). A row with d̄ ≤ 1e-30
    (a constant series, where every d_ij is 0) divides by 1, so its
    weights are exp(0) = 1.
    """
    d = _sorted_roots(pairwise_distances(x, E=E, tau=tau)[:rows, :rows])
    dbar = d.mean(dim=1, keepdim=True)
    return d / torch.where(dbar > _DBAR_TINY, dbar, torch.ones_like(dbar))


def _smap_operands(x, Y, *, E, tau, Tp):
    """(rows, A·A (rows, (E+1)²), y·A (rows, N·(E+1))) of one library."""
    if Tp < 0:
        raise ValueError(f"smap_gram needs Tp >= 0, got {Tp}")
    x = x.float()
    Y = Y.float()
    Lp = num_embedded(x.shape[-1], E, tau)
    rows = Lp - Tp
    if rows <= 0:
        raise ValueError(f"no library rows: L={x.shape[-1]}, E={E}, "
                         f"tau={tau}, Tp={Tp}")
    off = (E - 1) * tau + Tp
    E1 = E + 1
    A = torch.cat([torch.ones((rows, 1), dtype=torch.float32,
                              device=x.device),
                   delay_embed(x, E, tau)[:rows]], dim=1)
    yv = Y[:, off:off + rows]  # (N, rows)
    AA = (A[:, :, None] * A[:, None, :]).reshape(rows, E1 * E1)
    yA = (yv.T[:, :, None] * A[:, None, :]).reshape(rows, -1)
    return rows, AA, yA


def _smap_products(x, Y, *, E, tau, Tp, thetas, exclude_self, absolute):
    rows, AA, yA = _smap_operands(x, Y, E=E, tau=tau, Tp=Tp)
    if absolute:
        AA, yA = AA.abs(), yA.abs()
    E1 = E + 1
    ratio = smap_ratio(x.float(), E=E, tau=tau, rows=rows)
    self_mask = torch.eye(rows, dtype=torch.bool, device=x.device)
    Gs, Ms = [], []
    for t in thetas:  # two products per θ; one (rows, rows) W at a time
        W = torch.exp(-float(t) * ratio)
        if exclude_self:
            W = W.masked_fill(self_mask, 0.0)
        Gs.append((W @ AA).reshape(rows, E1, E1))
        Ms.append((W @ yA).reshape(rows, -1, E1))
    return torch.stack(Gs, dim=1), torch.stack(Ms, dim=1)


def smap_gram(x: torch.Tensor, Y: torch.Tensor, *, E: int, tau: int = 1,
              Tp: int = 1, thetas: tuple[float, ...],
              exclude_self: bool = True) -> tuple[torch.Tensor, torch.Tensor]:
    """Weighted Gram/moment accumulation for every (query row, θ, target).

    x: (L,) library series; Y: (N, L) target panel (self-prediction is
    Y = x[None]). With rows = Lp − Tp library points (those whose Tp-ahead
    truth exists) and A = [1 | delay_embed(x)[:rows]] of shape (rows, E+1):

      G[j, t]    = Aᵀ W_{j,θ_t} A            (rows, T, E+1, E+1)
      M[j, t, n] = Aᵀ W_{j,θ_t} y_n          (rows, T, N,   E+1)

    where W_{j,θ} = diag(exp(−θ d_ij / d̄_j)) with the self weight zeroed
    when ``exclude_self`` (leave-one-out) and y_n[i] = Y[n, i + off],
    off = (E−1)τ + Tp. Each θ is two products, W @ (A⊗A) and W @ (y⊗A).
    Tp ≥ 0.
    """
    return _smap_products(x, Y, E=E, tau=tau, Tp=Tp, thetas=thetas,
                          exclude_self=exclude_self, absolute=False)


def smap_gram_abs(x: torch.Tensor, Y: torch.Tensor, *, E: int, tau: int = 1,
                  Tp: int = 1, thetas: tuple[float, ...],
                  exclude_self: bool = True
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Σ_i w_ij·|term_i| for every entry of ``smap_gram``'s (G, M).

    The scale against which two float32 accumulations of G and M in
    different orders are compared: each rounding error of a sum is
    bounded by a multiple of it, whatever the terms' signs.
    """
    return _smap_products(x, Y, E=E, tau=tau, Tp=Tp, thetas=thetas,
                          exclude_self=exclude_self, absolute=True)


# --------------------------------------------------------------------------
# Norm-expansion distances (the matrix-unit variant).
# --------------------------------------------------------------------------


def pairwise_distances_mxu(x: torch.Tensor, *, E: int,
                           tau: int) -> torch.Tensor:
    """(Lp, Lp) squared distances by norm expansion, clamped at ≥ 0.

    ‖zᵢ‖² + ‖zⱼ‖² − 2⟨zᵢ, zⱼ⟩ on the delay embedding of the series centered
    by its float32 mean (the reference's ``variant="mxu"``: centering keeps
    the expansion's cancellation small and leaves the distances as they
    are). Never bit-equal to ``pairwise_distances``: the cross term is a
    sum of products, so results are held to a tolerance relative to
    ‖zᵢ‖² + ‖zⱼ‖².
    """
    x = x.float()
    Z = delay_embed(x - x.mean(), E, tau)
    n = (Z * Z).sum(-1)
    return torch.clamp(n[:, None] + n[None, :] - 2.0 * (Z @ Z.T), min=0.0)


# --------------------------------------------------------------------------
# Incremental master append (the serving tick's stream-in/merge).
#
# A multi-E master is the uncapped top-k_m table of ``all_knn_multi_e``.
# When every series grows by dt points, level e's library grows by exactly
# dt columns (Lp_e = L − e·τ), and the table grows without the O(Lp²)
# rebuild:
#
#   - OLD rows (i < Lp_old_e): their coordinates are unchanged, so an old
#     column that survives into the new top-k_m already sits in the stored
#     top-k_m. Merge the k_m stored candidates with the dt new columns.
#   - NEW rows (Lp_old_e ≤ i < Lp_new_e): one full scan of the grown
#     library, masked as the cold build masks it (columns past Lp_new_e − 1,
#     and self).
#
# The grown table is bit-identical to a cold rebuild. Three rules (the
# reference's, ``repro/kernels/ref.py``'s append section) make it hold:
#
#   1. Every distance is the strict two-rounding chain (``strict_sq``), so
#      a stored candidate's recomputed value, the new-column values and the
#      cold accumulator are the same bits whatever the buffer shapes.
#   2. Candidates are merged as squared distances, before the root (the
#      root is many-to-one in float32), laid out [stored slots, new
#      columns]: stored indices are < Lp_old_e ≤ the new ones, so a stable
#      sort resolves equal values in column order — the cold tie rule.
#   3. A stored garbage slot (dist inf, from k_m > the level's candidate
#      count) carries the old build's index pattern, whose indices collide
#      with now-valid columns. It enters as +inf, and every surviving
#      non-finite slot is rewritten to the cold pattern afterwards
#      (``normalize_garbage``).
#
# The reference's merge works in the negated domain (``lax.top_k`` keeps
# the largest); here it is the squared distance itself, smallest first.
# fl(a − b) = −fl(b − a) and fl(−s) = −fl(s) exactly, so both domains
# carry the same magnitudes.
# --------------------------------------------------------------------------


def check_append_args(X: torch.Tensor, dists: torch.Tensor,
                      idx: torch.Tensor, tau: int) -> int:
    """Validate panel master_append inputs; returns dt (the appended width).

    X (N, L_new); dists/idx (N, E_max, L_old, k_m).
    """
    if X.ndim != 2 or dists.ndim != 4:
        raise ValueError(f"X must be (N, L) and the master (N, E_max, L, k), "
                         f"got {tuple(X.shape)} and {tuple(dists.shape)}")
    if idx.shape != dists.shape:
        raise ValueError(f"dists/idx shape mismatch: {tuple(dists.shape)} vs "
                         f"{tuple(idx.shape)}")
    N, E_max, L_old, _ = dists.shape
    if X.shape[0] != N:
        raise ValueError(f"{X.shape[0]} series but the master has {N}")
    dt = int(X.shape[-1]) - L_old
    if dt < 1:
        raise ValueError(f"append needs at least one new point, got dt={dt}")
    num_embedded(L_old, E_max, tau)  # stored master must already be valid
    return dt


def _lagged(X: torch.Tensor, E_max: int, tau: int) -> list[torch.Tensor]:
    """[x[.., l·τ : l·τ + L]] for l < E_max, over the zero-padded series."""
    L = X.shape[-1]
    xpad = torch.nn.functional.pad(X.float(), (0, (E_max - 1) * tau))
    return [xpad[..., l * tau:l * tau + L] for l in range(E_max)]


def _slab_level(xls, e: int, r0: int, r1: int) -> torch.Tensor:
    """(N, r1 − r0, L) unmasked level-e accumulators of rows [r0, r1)
    against every column."""
    acc = torch.zeros((xls[0].shape[0], r1 - r0, xls[0].shape[-1]),
                      dtype=torch.float32, device=xls[0].device)
    for l in range(e + 1):
        xl = xls[l]
        acc = acc + strict_sq(xl[:, r0:r1, None] - xl[:, None, :])
    return acc


def append_new_row_slab(X: torch.Tensor, *, dt: int, E_max: int,
                        tau: int) -> torch.Tensor:
    """(N, E_max, dt, L_new) squared distances of the dt newest rows of
    each level against every column, unmasked: entry [s, e, r, j] equals
    the cold accumulator at (row Lp_old_e + r, column j) wherever that is
    valid. The reference returns the same values negated."""
    L_new = X.shape[-1]
    xls = _lagged(X, E_max, tau)
    return torch.stack([
        _slab_level(xls, e, L_new - dt - e * tau, L_new - e * tau)
        for e in range(E_max)], dim=1)


def normalize_garbage(vals: torch.Tensor, ik: torch.Tensor,
                      rows: torch.Tensor) -> torch.Tensor:
    """Rewrite the indices of non-finite slots to the cold build's pattern.

    ``vals`` (…, rows, k) merged squared distances in ascending order,
    ``ik`` their indices, ``rows`` (rows,) the row ids. Garbage survives a
    merge only when the finite count equals the row's valid-column count,
    so the cold pattern is self at the first garbage slot, then the slot
    id.
    """
    finite = torch.isfinite(vals)
    nfin = finite.sum(-1, keepdim=True)
    slot = torch.arange(vals.shape[-1], device=vals.device)
    garb = torch.where(slot == nfin, rows[:, None].to(slot.dtype), slot)
    return torch.where(finite, ik, garb.to(ik.dtype))


def append_candidates(X: torch.Tensor, dists: torch.Tensor,
                      idx: torch.Tensor, *, tau: int, e: int):
    """Level e's merge candidates (squared distances, before the root).

    X (N, L_new) grown panel, dists/idx (N, E_max, L_old, k_m) its
    prefix's master. Returns (old, old_idx, new): ``old`` (N, Lp_old,
    k_m + dt) the old rows' stored candidates recomputed (+inf where a
    slot held none) then their dt new columns, ``old_idx`` those columns'
    indices, ``new`` (N, dt, L_new) the new rows against every column,
    masked as the cold build masks them (+inf). The grown level is the
    k_m smallest of each row in (value, position) order.
    """
    N, _, L_old, k_m = dists.shape
    L_new = X.shape[-1]
    dt = L_new - L_old
    dev = X.device
    xls = _lagged(X, e + 1, tau)
    Lp_old, Lp_new = L_old - e * tau, L_new - e * tau
    slab = _slab_level(xls, e, Lp_old, Lp_new)  # (N, dt, L_new)
    i_o = idx[:, e, :Lp_old].long()
    ok = torch.isfinite(dists[:, e, :Lp_old])
    jj = torch.clamp(i_o, min=0).reshape(N, -1)  # garbage/PAD: any column
    acc = torch.zeros((N, Lp_old, k_m), dtype=torch.float32, device=dev)
    for l in range(e + 1):
        xl = xls[l]
        xj = torch.gather(xl, 1, jj).reshape(N, Lp_old, k_m)
        acc = acc + strict_sq(xl[:, :Lp_old, None] - xj)
    old = torch.cat([torch.where(ok, acc, _INF),
                     slab[:, :, :Lp_old].transpose(1, 2)], dim=2)
    new_cols = (Lp_old + torch.arange(dt, device=dev)).expand(N, Lp_old, dt)
    old_idx = torch.cat([i_o, new_cols], dim=2)
    cols = torch.arange(L_new, device=dev)
    rows_n = Lp_old + torch.arange(dt, device=dev)
    inval = (cols[None, :] > Lp_new - 1) | (cols[None, :] == rows_n[:, None])
    return old, old_idx, torch.where(inval, _INF, slab)


def master_append(X: torch.Tensor, dists: torch.Tensor, idx: torch.Tensor,
                  *, tau: int = 1) -> tuple[torch.Tensor, torch.Tensor]:
    """Grow multi-E master tables to cover ``dt`` appended points.

    ``X`` is the grown (N, L_new) panel; ``dists``/``idx`` the stored
    uniform-k ``all_knn_multi_e`` tables of its (N, L_old) prefix,
    (N, E_max, L_old, k_m). Returns the grown (N, E_max, L_new, k_m)
    tables, bit-identical to ``all_knn_multi_e(X, E_max=E_max, tau=tau,
    k=k_m)``, at O(Lp·(k_m + dt)) per row and level instead of O(Lp²).
    """
    dt = check_append_args(X, dists, idx, tau)
    N, E_max, L_old, k_m = dists.shape
    L_new = L_old + dt
    dev = X.device
    out_d = torch.full((N, E_max, L_new, k_m), _INF, dtype=torch.float32,
                       device=dev)
    out_i = torch.full((N, E_max, L_new, k_m), PAD_IDX, dtype=torch.int32,
                       device=dev)
    for e in range(E_max):  # level e ↔ embedding dim E = e+1
        Lp_old, Lp_new = L_old - e * tau, L_new - e * tau
        old, old_idx, new = append_candidates(X, dists, idx, tau=tau, e=e)
        sv, pos = torch.sort(old, dim=-1, stable=True)
        sv = sv[..., :k_m]
        ik = normalize_garbage(sv, torch.gather(old_idx, -1, pos[..., :k_m]),
                               torch.arange(Lp_old, device=dev))
        out_d[:, e, :Lp_old] = _sorted_roots(sv)
        out_i[:, e, :Lp_old] = ik.to(torch.int32)
        d, i = _select(new, k_m)
        out_d[:, e, Lp_old:Lp_new] = d
        out_i[:, e, Lp_old:Lp_new] = i
    return out_d, out_i
