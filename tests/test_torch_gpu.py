"""Each CUDA kernel against its plain version, on the card.

Marked ``gpu``: each test decides inside itself whether a CUDA device is
present and skips with the reason when it is not (the CPU tests cover the
plain versions against the JAX reference). Run them on a GPU machine with
``PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py``.
"""

import numpy as np
import pytest
import torch

from repro_torch.data import timeseries as ts

pytestmark = pytest.mark.gpu


def _cuda_panel(N=12, L=400, seed=0):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.as_tensor(ts.forced_network_panel(N, L, seed=seed)[0],
                           device="cuda")


@pytest.mark.parametrize("kw", [
    dict(E_max=8, tau=1, k=None, max_idx=None),
    dict(E_max=20, tau=1, k=22, max_idx=None),
    dict(E_max=5, tau=2, k=40, max_idx=[300, 50, 280, 9, 120]),
])
def test_knn_multi_e_kernel_equals_plain(kw):
    from repro_torch.kernels import knn_multi_e
    X = _cuda_panel()
    got = knn_multi_e.all_knn_multi_e(X, **kw)
    want = knn_multi_e.plain(X, **kw)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("L,kw,route", [
    (400, dict(E_max=1, tau=1, k=None, max_idx=None), "select"),
    (333, dict(E_max=8, tau=2, k=9, max_idx=None), "select"),
    (400, dict(E_max=20, tau=1, k=32, max_idx=None), "select"),
    (300, dict(E_max=32, tau=1, k=9, max_idx=None), "select"),
    (350, dict(E_max=6, tau=1, k=9, max_idx=[300, 40, 280, 5, 120, 60]),
     "select"),                                   # capped, non-monotone
    (400, dict(E_max=4, tau=1, k=40, max_idx=None), "insert"),   # k > 32
    (300, dict(E_max=32, tau=1, k=None, max_idx=None), "insert"),  # k 33
], ids=["E1", "E8-tau2-k9", "E20-k32", "E32-k9", "capped", "k40", "E32-k33"])
def test_knn_multi_e_both_designs_equal_plain(L, kw, route):
    from repro_torch.kernels import knn_multi_e, ref
    X = _cuda_panel(N=4, L=L)
    k_max = max(ref.multi_e_ks(kw["E_max"], kw["k"]))
    assert knn_multi_e.route(L, kw["E_max"], kw["tau"], k_max) == route
    got = knn_multi_e.all_knn_multi_e(X, **kw)
    want = knn_multi_e.plain(X, **kw)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_knn_multi_e_designs_agree_at_a_selection_shape():
    from repro_torch.kernels import knn_multi_e
    X = _cuda_panel(N=5, L=333)
    kw = dict(E_max=12, tau=1, k=22, max_idx=[300, 40] * 6)
    assert knn_multi_e.route(333, 12, 1, 22) == "select"
    sel = knn_multi_e.all_knn_multi_e(X, **kw)
    ins = knn_multi_e._launch(X, "insert", exclude_self=True, **kw)
    assert torch.equal(sel[0], ins[0]) and torch.equal(sel[1], ins[1])
    # A shape neither kernel takes: k's lists pass a block's shared memory.
    with pytest.raises(ValueError, match="shared memory"):
        knn_multi_e.all_knn_multi_e(_cuda_panel(N=2, L=4000), E_max=1,
                                    k=4000)


@pytest.mark.parametrize("k,E_max", [(None, 8), (9, 8), (32, 20), (None, 32)])
def test_knn_multi_e_equals_plain_on_tied_distances(k, E_max):
    from repro_torch.kernels import knn_multi_e
    x = _ties_series()
    X = torch.stack([x, x.flip(0), torch.round(x * 2) / 2])
    got = knn_multi_e.all_knn_multi_e(X, E_max=E_max, k=k)
    want = knn_multi_e.plain(X, E_max=E_max, k=k)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("kw", [
    dict(E=3, tau=1, k=4, max_idx=None),
    dict(E=2, tau=3, k=70, max_idx=30),
])
def test_knn_batch_kernel_equals_plain(kw):
    from repro_torch.kernels import knn_batch
    X = _cuda_panel()
    got = knn_batch.all_knn_batch(X, **kw)
    want = knn_batch.plain(X, **kw)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("own", [False, True], ids=["all", "own"])
def test_lookup_rho_kernel_matches_plain(own):
    from repro_torch.kernels import knn_batch, lookup, ref
    X = _cuda_panel()
    d, i = knn_batch.all_knn_batch(X, E=3, k=4)
    w = ref.make_weights(d)
    got = lookup.lookup_rho(X, i, w, offset=2, own=own)
    want = (lookup.plain_own if own else lookup.plain)(X, i, w, offset=2)
    assert torch.allclose(got, want, rtol=0, atol=1e-5)


def test_session_on_gpu_matches_plain_session():
    from repro_torch.edm import EDM
    panel = _cuda_panel().cpu().numpy()
    E_k, rho_k = EDM(panel, E_max=8).optimal_E()
    E_p, rho_p = EDM(panel, E_max=8, impl="ref").optimal_E()
    np.testing.assert_array_equal(E_k, E_p)
    np.testing.assert_allclose(rho_k, rho_p, rtol=0, atol=1e-5)


@pytest.mark.parametrize("N,L", [(12, 6_000), (256, 1_200)],
                         ids=["fly-like", "subject6-like"])
@pytest.mark.parametrize("ragged", [False, True])
def test_direct_launch_peak_within_its_batch_byte_model(N, L, ragged):
    """One direct launch of B = N libraries allocates no more than B times
    ``direct_batch_bytes``' kernel-path model plus the call's transposed
    targets (a ragged launch pads a copy of its libraries)."""
    from repro_torch.core.ccm import direct_batch_bytes, make_group_launch
    from repro_torch.kernels.lookup import TARGET_TILE
    X = _cuda_panel(N=N, L=L)
    make_group_launch(X, X, E=3, tau=1, Tp=0, k=4, impl="auto")(0, N, N)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    launch = make_group_launch(X, X, E=3, tau=1, Tp=0, k=4, impl="auto")
    launch(0, N - int(ragged), N)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    yt = 4 * L * -(-N // TARGET_TILE) * TARGET_TILE
    per = direct_batch_bytes(L, N, E=3, tau=1, Tp=0, k=4, kernel=True)
    print(f"N {N} L {L} ragged {ragged}: peak {peak} B, "
          f"{(peak - yt) / N:.0f} a library, model {per}")
    assert 0 < peak <= N * per + yt


def _ties_series(L=400, seed=1):
    """A series with a repeated stretch: exact distance ties."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    x = np.random.default_rng(seed).standard_normal(L).astype(np.float32)
    if L >= 260:
        x[200:260] = x[20:80]
    else:
        x[L - L // 4:] = x[:L // 4]
    x[::7] = 0.25
    return torch.as_tensor(x, device="cuda")


@pytest.mark.parametrize("L,E,tau", [
    (400, 1, 1), (400, 3, 1), (400, 4, 2), (400, 20, 1),
    (401, 3, 1), (403, 3, 1), (404, 1, 1),       # Lp % 4: 3, 1, 0
    (50, 3, 1), (61, 1, 1), (3, 3, 1), (40, 20, 1),  # Lp < 64, Lp = 1
    (1600, 20, 1), (10_000, 20, 1),              # the variants path's
], ids=["E1", "E3", "E4-tau2", "E20", "Lp399", "Lp401", "Lp404", "Lp48",
        "Lp61", "Lp1", "Lp21-E20", "L1600-E20", "L10000-E20"])
def test_pairwise_dist_kernel_equals_plain(L, E, tau):
    from repro_torch.kernels import pairwise_dist
    x = _ties_series(L)
    want = pairwise_dist.plain(x, E=E, tau=tau)
    assert torch.equal(pairwise_dist.pairwise_distances(x, E=E, tau=tau),
                       want)
    for kind in ("vector", "word"):  # both designs at every shape
        assert torch.equal(pairwise_dist._launch(x, kind, E=E, tau=tau),
                           want)


@pytest.mark.parametrize("k,max_idx,exclude_self", [
    (4, None, True), (70, None, True), (70, 30, True), (9, 120, False),
    (1, 0, True),
    (32, None, True), (33, None, True),          # the two designs' boundary
    (32, 20, False), (21, 300, True),
])
def test_topk_select_kernel_equals_plain(k, max_idx, exclude_self):
    from repro_torch.kernels import pairwise_dist, topk
    D = pairwise_dist.plain(_ties_series(), E=3, tau=2)
    got = topk.topk_select(D, k=k, max_idx=max_idx,
                           exclude_self=exclude_self)
    want = topk.plain_select(D, k=k, max_idx=max_idx,
                             exclude_self=exclude_self)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("k,caps,exclude_self", [
    (4, (31, 32, 33, 63, 64, 100, 395), True),   # caps at batch edges
    (70, (2, 40, 40, 200, 10_000), True),        # caps < k, equal, past Lp
    (5, (150,), True),                           # a single cap
    (3, (0, 1, 95, 390), False),
    (32, (10, 31, 200, 395), True),              # the two designs'
    (33, (10, 31, 200, 395), True),              # boundary
    (4, (0,), True),                             # a single cap of 0
    (6, (100, 101, 101, 103), True),             # inside one warp's span
    (21, (0, 3, 20, 21, 600), False),
])
def test_topk_select_sizes_kernel_equals_plain(k, caps, exclude_self):
    from repro_torch.kernels import pairwise_dist, topk
    D = pairwise_dist.plain(_ties_series(), E=3, tau=2)
    got = topk.topk_select_sizes(D, k=k, max_idxs=caps,
                                 exclude_self=exclude_self)
    want = topk.plain_sizes(D, k=k, max_idxs=caps, exclude_self=exclude_self)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("L", [515, 549, 1061])
def test_topk_selection_kernels_equal_plain_across_chunks(L):
    """Rows of one chunk and a few columns (514, 548) and of three chunks:
    the selection kernels against the plain versions and the insertion
    kernels, caps on and beside the chunks' edges, +inf values."""
    from repro_torch.kernels import pairwise_dist, topk
    x = _cuda_panel(N=2, L=L)[0]
    D = pairwise_dist.plain(x, E=2, tau=1)
    Lp = D.shape[0]
    D[5, 40:60] = float("inf")
    for k, mx in ((4, None), (21, 10), (32, Lp - 2)):
        want = topk.plain_select(D, k=k, max_idx=mx)
        for got in (topk.topk_select(D, k=k, max_idx=mx),
                    topk._launch_select(D, "insert", k=k, max_idx=mx)):
            assert torch.equal(got[0], want[0])
            assert torch.equal(got[1], want[1])
    for k, caps in ((4, (0, 7, 49, 511, 512, 513, Lp - 1)),
                    (21, (20, 64, 500, 10_000))):
        want = topk.plain_sizes(D, k=k, max_idxs=caps)
        for got in (topk.topk_select_sizes(D, k=k, max_idxs=caps),
                    topk._launch_sizes(D, "insert", k=k, max_idxs=caps)):
            assert torch.equal(got[0], want[0])
            assert torch.equal(got[1], want[1])


def test_topk_designs_agree_at_the_paths_shapes():
    """cache=False simplex's launch (Lp = 1598, k = 4, cap Lp - 2), the
    convergence sweep's (its seven caps) and the variants path's at
    L = 10,000 (E = 20, k = 21): the selection kernels bit-equal to the
    kept insertion kernels and to the plain versions."""
    from repro_torch.core.ccm import normalize_lib_sizes
    from repro_torch.kernels import pairwise_dist, topk
    X = _cuda_panel(N=2, L=1600)
    D = pairwise_dist.pairwise_distances(X[0], E=3, tau=1)
    Lp = D.shape[0]
    sel = topk.topk_select(D, k=4, max_idx=Lp - 2)
    ins = topk._launch_select(D, "insert", k=4, max_idx=Lp - 2)
    want = topk.plain_select(D, k=4, max_idx=Lp - 2)
    for a, b, c in zip(sel, ins, want):
        assert torch.equal(a, b) and torch.equal(a, c)
    caps, _ = normalize_lib_sizes((50, 100, 200, 400, 800, 1200, 1500),
                                  Lp=Lp)
    assert topk.route(4, len(caps)) == "select"
    sel = topk.topk_select_sizes(D, k=4, max_idxs=caps)
    ins = topk._launch_sizes(D, "insert", k=4, max_idxs=caps)
    want = topk.plain_sizes(D, k=4, max_idxs=caps)
    for a, b, c in zip(sel, ins, want):
        assert torch.equal(a, b) and torch.equal(a, c)
    x = torch.as_tensor(ts.forced_network_panel(4, 10_000, seed=0)[0][3],
                        device="cuda")
    D = pairwise_dist.pairwise_distances(x, E=20, tau=1)
    sel = topk.topk_select(D, k=21)
    ins = topk._launch_select(D, "insert", k=21)
    want = topk.plain_select(D, k=21)
    for a, b, c in zip(sel, ins, want):
        assert torch.equal(a, b) and torch.equal(a, c)


def test_topk_sizes_takes_more_caps_than_go_by_value():
    from repro_torch.kernels import pairwise_dist, topk
    D = pairwise_dist.plain(_ties_series(), E=3, tau=2)
    caps = tuple(range(0, 390, 5))  # 78 caps: the insertion kernel
    assert topk.route(4, len(caps)) == "insert"
    got = topk.topk_select_sizes(D, k=4, max_idxs=caps)
    want = topk.plain_sizes(D, k=4, max_idxs=caps)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("N,L,k", [
    (12, 400, 1), (12, 400, 4), (12, 400, 21), (12, 400, 33), (12, 400, 8),
    (1, 1600, 4),                                # the simplex path's shape
    (2, 13_000, 4),                              # past a 48 KB series
], ids=["k1", "k4", "k21", "k33", "k8", "simplex", "L13000"])
def test_lookup_kernel_equals_plain(N, L, k):
    from repro_torch.kernels import lookup, ref, topk
    X = _cuda_panel(N=max(N, 2), L=L)[:N]  # the panel forces from 2 series
    D = ref.pairwise_distances(X[0], E=3, tau=1)
    Lp = D.shape[0]
    # The simplex path's table (cap Lp - 2, rows Lp - 1), else cap 300.
    cap, rows = (Lp - 2, Lp - 1) if N == 1 else (300, Lp)
    d, i = topk.plain_select(D, k=k, max_idx=cap)
    w = ref.make_weights(d)[:rows]
    i = i[:rows].clone()
    i[::5, -1] = -1  # invalid slots as the master derivation leaves them
    got = lookup.lookup(X, i, w, offset=3)
    assert torch.equal(got, lookup.plain_lookup(X, i, w, offset=3))


def test_lookup_kernel_takes_a_table_off_16_byte_alignment():
    from repro_torch.kernels import lookup, ref, topk
    X = _cuda_panel()
    d, i = topk.plain_select(ref.pairwise_distances(X[0], E=3, tau=1), k=4)
    w = ref.make_weights(d)
    # The same table one word into a buffer: rows 4-byte aligned only.
    ib = torch.empty(i.numel() + 1, dtype=torch.int32, device="cuda")
    wb = torch.empty(w.numel() + 1, dtype=torch.float32, device="cuda")
    ib[1:] = i.reshape(-1)
    wb[1:] = w.reshape(-1)
    got = lookup.lookup(X, ib[1:].view(i.shape), wb[1:].view(w.shape),
                        offset=3)
    assert torch.equal(got, lookup.plain_lookup(X, i, w, offset=3))


def test_session_ccm_and_surrogates_on_gpu_match_plain_session():
    from repro_torch.edm import EDM
    panel = _cuda_panel(N=6, L=500).cpu().numpy()
    runs = []
    for impl in ("auto", "ref"):
        sess = EDM(panel, E_max=6, impl=impl)
        sess.optimal_E()
        runs.append((sess.ccm(0, 1, lib_sizes=(20, 40, 100, 400)),
                     sess.ccm(2, 3),
                     sess.surrogate_test(1, 4, num_surrogates=30,
                                         lib_sizes=(50, 300)).surrogate_rho,
                     EDM(panel, E=3, cache=False, impl=impl).simplex()))
    for got, want in zip(*runs):
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


# ------------------------------------------------------------------ S-Map
# G and M sum ~rows float32 products in the kernel's order and in cuBLAS's:
# held within GRAM_RTOL of Σ|terms| (``ref.smap_gram_abs``). ρ goes
# through an ill-conditioned solve at large θ (tests/test_torch_smap.py).
GRAM_RTOL = 1e-5


def _smap_rho_tol(theta: float) -> float:
    return 1e-4 if theta <= 4.0 else 3e-3


def _gram_close(got, want, scale):
    err = (got - want).abs()
    assert bool((err <= GRAM_RTOL * scale).all()), float(err.max())


@pytest.mark.parametrize("E,tau,Tp,excl,N,L", [
    (1, 1, 0, False, 1, 300),    # E = 1, Tp = 0, self included
    (2, 2, 1, True, 3, 257),     # tau 2, rows not a multiple of 64
    (5, 1, 3, True, 3, 300),
    (3, 1, 1, True, 1, 132),     # rows = 128: tiles end on the last row
    (3, 1, 0, True, 1, 133),     # rows = 131: a tile straddles rows
    (20, 1, 1, True, 2, 300),    # E + 1 = 21: 441 + 42 columns
])
def test_smap_gram_kernel_matches_plain(E, tau, Tp, excl, N, L):
    from repro_torch.kernels import ref, smap_gram
    torch.backends.cuda.matmul.allow_tf32 = False
    X = _cuda_panel(N=N + 1, L=L, seed=E)
    x, Y = X[0], X[1:]
    kw = dict(E=E, tau=tau, Tp=Tp, thetas=(0.0, 0.5, 2.0, 8.0),
              exclude_self=excl)
    G, M = smap_gram.smap_gram(x, Y, **kw)
    Gp, Mp = smap_gram.plain(x, Y, **kw)
    Ga, Ma = ref.smap_gram_abs(x, Y, **kw)
    assert G.shape == Gp.shape and M.shape == Mp.shape
    _gram_close(G, Gp, Ga)
    _gram_close(M, Mp, Ma)


def test_smap_gram_kernel_constant_series_and_batch_axis():
    from repro_torch.kernels import ref, smap_gram
    torch.backends.cuda.matmul.allow_tf32 = False
    X = _cuda_panel(N=4, L=300)
    X[2] = 0.7  # a constant library: d̄ = 0, every weight 1
    kw = dict(E=2, tau=1, Tp=1, thetas=(0.0, 4.0))
    G, M = smap_gram.smap_gram(X, X[:3], **kw)          # shared targets
    Go, Mo = smap_gram.smap_gram(X, X[:, None, :], **kw)  # own targets
    for b in range(4):
        g, m = smap_gram.smap_gram(X[b], X[:3], **kw)
        assert torch.equal(G[b], g) and torch.equal(M[b], m)
        g, m = smap_gram.smap_gram(X[b], X[b][None], **kw)
        assert torch.equal(Go[b], g) and torch.equal(Mo[b], m)
        gp, mp = smap_gram.plain(X[b], X[:3], **kw)
        ga, ma = ref.smap_gram_abs(X[b], X[:3], **kw)
        _gram_close(G[b], gp, ga)
        _gram_close(M[b], mp, ma)
    assert torch.isfinite(G[2]).all() and torch.isfinite(M[2]).all()


@pytest.mark.parametrize("E,N,T,L,const", [
    (1, 1, 8, 301, False),    # narrow (C = 6), rows 299
    (1, 3, 1, 300, False),    # wide, one θ
    (3, 1, 8, 300, False),    # the θ-sweep's shape, rows 297
    (3, 1, 8, 300, True),     # ... on a constant library
    (3, 154, 1, 300, False),  # the S-Map xmap's shape
    (20, 1, 8, 300, False),   # E + 1 = 21: C = 462, wide with 8 θ
    (20, 3, 1, 250, False),
])
def test_smap_gram_tensor_core_kernel_within_gram_rtol(E, N, T, L, const):
    from repro_torch.kernels import ref, smap_gram
    torch.backends.cuda.matmul.allow_tf32 = False
    X = _cuda_panel(N=N + 1, L=L, seed=E)
    x, Y = X[0].clone(), X[1:]
    if const:
        x[:] = 0.7
    thetas = (0.0, 0.5, 1.0, 2.0, 3.0, 4.0, 6.0, 8.0) if T == 8 else (1.0,)
    kw = dict(E=E, tau=1, Tp=1, thetas=thetas)
    G, M = smap_gram.smap_gram(x, Y, **kw)
    Gp, Mp = smap_gram.plain(x, Y, **kw)
    Ga, Ma = ref.smap_gram_abs(x, Y, **kw)
    assert G.shape == Gp.shape and M.shape == Mp.shape
    _gram_close(G, Gp, Ga)
    _gram_close(M, Mp, Ma)


def test_smap_gram_scratch_slices_bit_equal_to_single_launches(monkeypatch):
    from repro_torch.kernels import smap_gram
    X = _cuda_panel(N=5, L=300)
    for Y, kw in ((X, dict(E=3, tau=1, Tp=0, thetas=(1.0,))),
                  (X[:, None, :], dict(E=2, tau=1, Tp=1,
                                       thetas=(0.0, 1.0, 4.0, 8.0, 2.0)))):
        rows = 300 - (kw["E"] - 1) - kw["Tp"]
        C = (kw["E"] + 1) ** 2 + Y.shape[-2] * (kw["E"] + 1)
        monkeypatch.setattr(smap_gram, "SCRATCH_BYTES",
                            2 * 4 * smap_gram.scratch_floats(
                                rows, C, len(kw["thetas"])))
        smap_gram.smap_gram.launches = 0
        G, M = smap_gram.smap_gram(X, Y, **kw)  # slices of 2, 2 and 1
        assert smap_gram.smap_gram.launches == 1
        monkeypatch.undo()
        for b in range(5):
            g, m = smap_gram.smap_gram(X[b], Y if Y.ndim == 2 else Y[b], **kw)
            assert torch.equal(G[b], g) and torch.equal(M[b], m)


@pytest.mark.parametrize("E,N,thetas,steps", [
    (3, 3, (1.0,), 2),                        # wide, one θ
    (20, 1, (0.0, 0.5, 2.0, 8.0, 1.0), 2),    # wide, five θ (C = 462)
    (2, 1, (0.0, 1.0, 4.0, 8.0, 2.0), 2),     # narrow (C = 12)
    (3, 154, (1.0,), 0),                      # no row fits beside R
])
def test_smap_gram_row_slices_bit_equal_to_an_unsliced_launch(
        monkeypatch, E, N, thetas, steps):
    from repro_torch.kernels import ref, smap_gram
    X = _cuda_panel(N=N + 1, L=700, seed=E)
    x, Y = X[0], X[1:]
    kw = dict(E=E, tau=1, Tp=1, thetas=thetas)
    G0, M0 = smap_gram.smap_gram(x, Y, **kw)
    rows, T = G0.shape[0], len(thetas)
    C = (E + 1) ** 2 + N * (E + 1)
    fixed = smap_gram.scratch_floats(rows, C, T, 0)
    step = smap_gram.scratch_floats(rows, C, T, smap_gram.ROW_STEP) - fixed
    # One library over the bound: its query rows go in slices of
    # max(1, steps) · ROW_STEP (697 rows: 256, 256, 185 or 6 of 128).
    monkeypatch.setattr(smap_gram, "SCRATCH_BYTES", 4 * (fixed + steps * step))
    nb, nj = smap_gram.slices(rows, C, T, 1)
    assert (nb, nj) == (1, max(1, steps) * smap_gram.ROW_STEP)
    smap_gram.smap_gram.launches = 0
    G, M = smap_gram.smap_gram(x, Y, **kw)
    assert smap_gram.smap_gram.launches == 1
    assert torch.equal(G, G0) and torch.equal(M, M0)
    Gp, Mp = smap_gram.plain(x, Y, **kw)
    Ga, Ma = ref.smap_gram_abs(x, Y, **kw)
    _gram_close(G, Gp, Ga)
    _gram_close(M, Mp, Ma)


def test_smap_launches_per_call_and_plain_agreement():
    from repro_torch.core import smap_group, smap_theta_sweep
    from repro_torch.kernels import smap_gram
    torch.backends.cuda.matmul.allow_tf32 = False
    X = _cuda_panel(N=6, L=400)
    thetas = (0.0, 1.0, 8.0)
    smap_gram.smap_gram.launches = 0
    got = smap_theta_sweep(X, E=3, thetas=thetas)
    assert smap_gram.smap_gram.launches == 1  # the panel in one launch
    want = smap_theta_sweep(X, E=3, thetas=thetas, impl="ref")
    for t, theta in enumerate(thetas):
        assert float((got[:, t] - want[:, t]).abs().max()) <= \
            _smap_rho_tol(theta)
    smap_gram.smap_gram.launches = 0
    g = smap_group(X, X[1:4], E=2, theta=1.5)
    assert smap_gram.smap_gram.launches == 1  # every library in one launch
    gp = smap_group(X, X[1:4], E=2, theta=1.5, impl="ref")
    assert float((g - gp).abs().max()) <= _smap_rho_tol(1.5)


def test_session_smap_on_gpu_matches_plain_session():
    from repro_torch.edm import EDM
    panel = _cuda_panel(N=6, L=500).cpu().numpy()
    outs = []
    for impl in ("auto", "ref"):
        sess = EDM(panel, E_max=6, impl=impl)
        outs.append((sess.smap(), sess.xmap(method="smap", theta=1.0),
                     EDM(panel, E=3, impl=impl, batch_libs=4).xmap(
                         method="smap")))
    for t, theta in enumerate(EDM(panel, impl="ref").config.thetas):
        np.testing.assert_allclose(outs[0][0][:, t], outs[1][0][:, t],
                                   rtol=0, atol=_smap_rho_tol(theta))
    for a, b in zip(outs[0][1:], outs[1][1:]):
        np.testing.assert_allclose(a, b, rtol=0, atol=_smap_rho_tol(1.0))


@pytest.mark.parametrize("E", [None, 3], ids=["per-series", "fixed"])
def test_xmap_smap_bit_invariant_in_batch_size_on_gpu(E):
    from repro_torch.edm import EDM
    panel = _cuda_panel(N=9, L=400).cpu().numpy()
    outs = [EDM(panel, E=E, E_max=6, batch_libs=B).xmap(method="smap")
            for B in (1, 4, panel.shape[0])]
    for m in outs[1:]:
        np.testing.assert_array_equal(m, outs[0])


# ------------------------------------------- append, mxu and fused kernels


def _append_case(L_new, E_max, tau, dt, k, kind, N=3):
    """(grown panel, stored master of its prefix) on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from repro_torch.kernels import knn_multi_e
    X = np.random.default_rng(L_new + dt).standard_normal(
        (N, L_new)).astype(np.float32)
    if kind == "tie":  # heavy value collisions: the tie order
        X = np.round(X * 2) / 2
    X = torch.as_tensor(X, device="cuda")
    d, i = knn_multi_e.all_knn_multi_e(X[:, :L_new - dt], E_max=E_max,
                                       tau=tau, k=k)
    return X, d, i


@pytest.mark.parametrize("L_new,E_max,tau,dt,k,kind", [
    (100, 3, 1, 1, 20, "tie"),     # Δt = 1
    (211, 6, 1, 64, 20, "tie"),    # Δt > k_m
    (154, 4, 2, 7, 20, "rand"),
    (400, 1, 1, 32, 20, "tie"),    # E = 1
    (300, 20, 1, 16, 22, "rand"),  # E = 20, the session's k_m
    (30, 4, 2, 2, 25, "rand"),     # garbage slots before and after
    (24, 6, 1, 3, 20, "tie"),      # garbage, ties
    (300, 32, 1, 40, 32, "tie"),   # the stream kernel's widest
    (300, 3, 1, 5, 33, "tie"),     # k 33: the insertion kernel
])
def test_knn_append_kernel_equals_plain_and_cold(L_new, E_max, tau, dt, k,
                                                 kind):
    """Both designs (the stream kernel for k ≤ 32, the insertion kernel)
    bit-equal to the plain version and to a cold build."""
    from repro_torch.kernels import knn_append, knn_multi_e
    X, d, i = _append_case(L_new, E_max, tau, dt, k, kind)
    assert knn_append.route(L_new, E_max, tau, k, dt) == (
        "stream" if k <= 32 else "insert")
    got = knn_append.master_append(X, d, i, tau=tau)
    want = knn_append.plain(X, d, i, tau=tau)
    cold = knn_multi_e.all_knn_multi_e(X, E_max=E_max, tau=tau, k=k)
    ins = knn_append._launch(X, d, i, "insert", tau=tau)
    for a, b, c, e in zip(got, want, cold, ins):
        assert torch.equal(a, b) and torch.equal(a, c) and torch.equal(a, e)


def test_knn_append_kernel_takes_an_unordered_master():
    """A stored list out of (value, index) order is sorted first: the same
    selection as the plain version's sort, on both designs."""
    from repro_torch.kernels import knn_append
    X, d, i = _append_case(120, 3, 1, 9, 8, "rand")
    perm = torch.randperm(8, generator=torch.Generator().manual_seed(0))
    d, i = d[..., perm.cuda()].clone(), i[..., perm.cuda()].clone()
    want = knn_append.plain(X, d, i, tau=1)
    for kind in ("stream", "insert"):
        got = knn_append._launch(X, d, i, kind, tau=1)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("E,tau", [(1, 1), (3, 1), (4, 2), (20, 1)])
def test_pairwise_mxu_kernel_within_tolerance_of_plain(E, tau):
    from repro_torch.kernels import pairwise_dist
    torch.backends.cuda.matmul.allow_tf32 = False
    x = _ties_series() * 3.0 + 40.0  # an offset the centering removes
    got = pairwise_dist.pairwise_distances_mxu(x, E=E, tau=tau)
    want = pairwise_dist.plain_mxu(x, E=E, tau=tau)
    scale = pairwise_dist.mxu_scale(x, E=E, tau=tau)
    assert got.shape == want.shape and bool((got >= 0).all())
    assert bool(((got.double() - want.double()).abs()
                 <= pairwise_dist.MXU_RTOL * scale).all())


@pytest.mark.parametrize("E,tau,k,max_idx,exclude_self", [
    (1, 1, 2, None, True), (3, 2, 4, None, True), (20, 1, 21, None, True),
    (4, 1, 70, 30, True), (3, 1, 9, 120, False),
])
def test_knn_fused_kernel_equals_plain_and_two_kernel(E, tau, k, max_idx,
                                                      exclude_self):
    from repro_torch.kernels import knn_fused, pairwise_dist, topk
    x = _ties_series()
    kw = dict(k=k, max_idx=max_idx, exclude_self=exclude_self)
    got = knn_fused.all_knn_fused(x, E=E, tau=tau, **kw)
    want = knn_fused.plain(x, E=E, tau=tau, **kw)
    two = topk.topk_select(pairwise_dist.pairwise_distances(x, E=E, tau=tau),
                           **kw)
    for a, b, c in zip(got, want, two):
        assert torch.equal(a, b) and torch.equal(a, c)


@pytest.mark.parametrize("E,tau,k,max_idx,exclude_self,tile_cols", [
    (1, 1, 1, None, True, 256), (3, 2, 4, None, True, 256),
    (20, 1, 21, None, True, 256), (20, 1, 32, 200, True, 1024),
    (24, 1, 25, None, False, 256), (32, 2, 32, 150, True, 256),
    (4, 3, 9, 5, True, 256), (2, 1, 16, None, False, 1024),
])
def test_knn_fused_designs_equal_plain(E, tau, k, max_idx, exclude_self,
                                       tile_cols):
    """The selection kernel (at its own tile and a small one, so that
    tiles cut the lag windows) and the kept insertion kernel, bit-equal
    to the plain version on a series with exact ties."""
    from repro_torch.kernels import knn_fused
    x = torch.round(_ties_series() * 4) / 4
    kw = dict(E=E, tau=tau, k=k, max_idx=max_idx, exclude_self=exclude_self)
    want = knn_fused.plain(x, **kw)
    sel = knn_fused._launch(x, "select", tile_cols=tile_cols, **kw)
    ins = knn_fused._launch(x, "insert", **kw)
    for a, b, c in zip(sel, ins, want):
        assert torch.equal(a, c) and torch.equal(b, c)


def test_knn_fused_designs_equal_plain_at_the_variants_shape():
    """L = 1600, E = 20, k = 21 (eight column slices a block) and E = 3."""
    from repro_torch.kernels import knn_fused
    x = _cuda_panel(N=3, L=1600)[2]
    for E in (3, 20):
        assert knn_fused.route(1600, E, 1, E + 1) == "select"
        got = knn_fused.all_knn_fused(x, E=E)
        want = knn_fused.plain(x, E=E)
        ins = knn_fused._launch(x, "insert", E=E)
        for a, b, c in zip(got, want, ins):
            assert torch.equal(a, b) and torch.equal(a, c)


def _rho_case(B, Nt, rows, k, off=2, seed=0, extra=0):
    """(Y, idx, w) on the card: tables with (-1, 0) slots, ``extra`` spare
    rows in front (a view that starts off 16-byte alignment)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from repro_torch.kernels import ref
    rng = np.random.default_rng(seed)
    L = rows + off
    Y = rng.standard_normal((Nt, L)).astype(np.float32)
    idx = rng.integers(0, rows, size=(B, rows + extra, k)).astype(np.int32)
    d = np.sort(rng.uniform(0.01, 2.0, size=(B, rows + extra, k)), axis=-1)
    idx[:, ::7, -1] = -1
    d[:, ::7, -1] = np.inf
    w = ref.make_weights(torch.as_tensor(d, dtype=torch.float32))
    return (torch.as_tensor(Y, device="cuda"),
            torch.as_tensor(idx, device="cuda"), w.cuda())


@pytest.mark.parametrize("B,Nt,rows,k,own", [
    (3, 5, 1, 3, False), (3, 5, 31, 4, False), (2, 40, 256, 21, False),
    (4, 33, 700, 5, False), (6, 1, 513, 2, False), (5, 5, 257, 21, True),
    (3, 3, 300, 40, True), (2, 7, 300, 48, False), (2, 64, 1598, 4, False),
])
def test_lookup_rho_kernel_equals_its_emulated_order(B, Nt, rows, k, own):
    """The kernel's ρ bit-equal to ``lookup._emulate`` on the CPU (the order
    the CPU tests hold against the reference): one row, a ragged tile, a
    chunk, a ragged last chunk, one target, k past the staging limit."""
    from repro_torch.kernels import lookup
    Y, idx, w = _rho_case(B, B if own else Nt, rows, k)
    got = lookup.lookup_rho(Y, idx, w, offset=2, own=own)
    want = lookup._emulate(Y.cpu(), idx.cpu(), w.cpu(), offset=2, own=own)
    assert torch.equal(got.cpu(), want)


def test_lookup_rho_kernel_bits_do_not_depend_on_batch_or_layout():
    """(b, n) at B = 1 equals B = all; row-sliced views that start off
    16-byte alignment, tables whose rows are not contiguous, and a
    caller's ``Yt`` give the same bits as contiguous copies."""
    from repro_torch.kernels import lookup
    B, Nt, rows = 4, 37, 600
    Y, idx, w = _rho_case(B, Nt, rows, 5, extra=3)
    iv, wv = idx[:, 3:], w[:, 3:]  # rows 3.. of each table: a view
    full = lookup.lookup_rho(Y, iv, wv, offset=2)
    assert torch.equal(full, lookup.lookup_rho(
        Y, iv.contiguous(), wv.contiguous(), offset=2))
    assert torch.equal(full, lookup.lookup_rho(
        Y, iv, wv, offset=2, Yt=lookup.transpose_targets(Y)))
    for b in range(B):
        assert torch.equal(full[b], lookup.lookup_rho(
            Y, iv[b:b + 1], wv[b:b + 1], offset=2)[0])
    wide_i = torch.cat([iv, iv[..., :1]], dim=-1)[..., :5]  # row stride 6
    wide_w = torch.cat([wv, wv[..., :1]], dim=-1)[..., :5]
    assert wide_i.stride(1) == 6
    assert torch.equal(full, lookup.lookup_rho(Y, wide_i, wide_w, offset=2))
    own = lookup.lookup_rho(Y[:B], iv, wv, offset=2, own=True)
    assert torch.equal(own, torch.diagonal(full[:, :B]))


def test_session_append_on_gpu_equals_cold_session_in_one_launch():
    from repro_torch.edm import EDM
    from repro_torch.kernels import knn_append
    panel = _cuda_panel(N=8, L=460).cpu().numpy()
    warm = EDM(panel[:, :400], E_max=8)
    warm.optimal_E()
    launches = []
    for stop in (401, 417, 460):  # Δt = 1, 16, 43
        knn_append.master_append.launches = 0
        warm.append(panel[:, warm.data.L:stop])
        launches.append(knn_append.master_append.launches)
    assert launches == [1, 1, 1]  # ≤ 2·E_max: one per append of the panel
    cold = EDM(panel, E_max=8)
    E_c, rho_c = cold.optimal_E()
    for a, b in zip(warm._cache["master"][:2], cold._cache["master"][:2]):
        assert torch.equal(a, b)
    E_w, rho_w = warm.optimal_E()
    np.testing.assert_array_equal(E_w, E_c)
    np.testing.assert_array_equal(rho_w, rho_c)
    ref_sess = EDM(panel[:, :400], E_max=8, impl="ref")
    ref_sess.optimal_E()
    ref_sess.append(panel[:, 400:])
    for a, b in zip(warm._cache["master"][:2], ref_sess._cache["master"][:2]):
        assert torch.equal(a, b)


# ------------------------------ knn_batch and knn_append: both designs each


def _tied_panel(N, L, seed=3):
    """Values rounded to 1/8: exact distance ties everywhere."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    X = np.random.default_rng(seed).standard_normal((N, L)).astype(np.float32)
    return torch.as_tensor(np.round(X * 8) / 8, device="cuda")


def _batch_both_routes_equal_plain(X, kind, **kw):
    from repro_torch.kernels import knn_batch
    Lp = X.shape[1] - (kw["E"] - 1) * kw.get("tau", 1)
    k = kw.get("k") or kw["E"] + 1
    assert knn_batch.route(Lp, kw["E"], kw.get("tau", 1), k) == kind
    got = knn_batch.all_knn_batch(X, **kw)
    want = knn_batch.plain(X, **kw)
    ins = knn_batch._launch(X, "insert", **kw)
    for a, b, c in zip(got, want, ins):
        assert torch.equal(a, b) and torch.equal(a, c)


@pytest.mark.parametrize("k", [4, 5, 8, 9, 16, 17, 32, 33])
def test_knn_batch_routes_equal_plain_at_bucket_edges(k):
    _batch_both_routes_equal_plain(_tied_panel(3, 333), "thread" if k <= 32
                                   else "insert", E=3, tau=1, k=k)


@pytest.mark.parametrize("kw", [
    dict(E=1, tau=1, k=2),
    dict(E=4, tau=2, k=9),
    dict(E=3, tau=1, k=6, max_idx=100),
    dict(E=3, tau=1, k=6, max_idx=2),  # fewer valid columns than k
    dict(E=3, tau=1, k=6, exclude_self=False),
    dict(E=20, tau=1, k=21),
    dict(E=32, tau=1, k=32),
], ids=["E1", "tau2", "capped", "cap-below-k", "self", "E20", "E32-k32"])
def test_knn_batch_thread_kernel_edge_cases(kw):
    _batch_both_routes_equal_plain(_tied_panel(4, 257), "thread", **kw)


def test_knn_batch_long_series_in_column_chunks():
    from repro_torch.kernels import knn_batch
    X = _cuda_panel(N=2, L=2 * knn_batch.CHUNK + 700)
    _batch_both_routes_equal_plain(X, "thread", E=3, tau=1, k=4)


def test_knn_batch_insert_kernel_at_one_warp_a_block(monkeypatch):
    """A k the old fixed 8-warp block refused runs at fewer warps a block;
    here the block's room is scaled down so that one warp takes it."""
    from repro_torch.kernels import knn_batch
    assert knn_batch.insert_warps(3632) == 8
    assert knn_batch.insert_warps(3633) == 7
    assert knn_batch.insert_warps(knn_batch.K_LIMIT) == 1
    X = _tied_panel(2, 200)
    kw = dict(E=2, tau=1, k=40)
    want = knn_batch.plain(X, **kw)
    monkeypatch.setattr(knn_batch, "SMEM_MAX", 8 * 40)
    assert knn_batch.insert_warps(40) == 1
    got = knn_batch.all_knn_batch(X, **kw)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    with pytest.raises(ValueError, match="limit"):
        knn_batch.insert_warps(41)


def test_knn_batch_raises_past_its_k_limit():
    from repro_torch.kernels import knn_batch
    k = knn_batch.K_LIMIT + 1
    X = _cuda_panel(N=2, L=k + 10)[:1]
    with pytest.raises(ValueError, match=f"limit of {knn_batch.K_LIMIT}"):
        knn_batch.all_knn_batch(X, E=1, k=k)


def test_knn_append_root_collision_panel():
    """New columns whose squared distance is one ulp from a stored
    neighbour's under the same root: the stream kernel recomputes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from repro_torch.kernels import knn_append, knn_multi_e
    L_old, dt = 120, 3
    X = torch.as_tensor(ts.root_collision_panel(8, L_old, dt, seed=2),
                        device="cuda")
    d, i = knn_multi_e.all_knn_multi_e(X[:, :L_old], E_max=3, k=6)
    got = knn_append.master_append(X, d, i)
    want = knn_append.plain(X, d, i)
    cold = knn_multi_e.all_knn_multi_e(X, E_max=3, k=6)
    ins = knn_append._launch(X, d, i, "insert")
    for a, b, c, e in zip(got, want, cold, ins):
        assert torch.equal(a, b) and torch.equal(a, c) and torch.equal(a, e)


def test_knn_append_insert_kernel_at_one_warp_a_block(monkeypatch):
    from repro_torch.kernels import knn_append
    assert knn_append.insert_warps(3633) == 7
    assert knn_append.insert_warps(knn_append.K_LIMIT) == 1
    X, d, i = _append_case(150, 3, 1, 5, 40, "tie")
    want = knn_append.plain(X, d, i, tau=1)
    monkeypatch.setattr(knn_append, "SMEM_MAX", 8 * 40)
    got = knn_append.master_append(X, d, i, tau=1)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_knn_append_raises_past_its_k_limit():
    from repro_torch.kernels import knn_append
    X = _cuda_panel(N=2, L=30)[:1]
    k = knn_append.K_LIMIT + 1
    d = torch.zeros((1, 1, 20, k), device="cuda")
    i = torch.zeros((1, 1, 20, k), dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match=f"limit of {knn_append.K_LIMIT}"):
        knn_append.master_append(X, d, i)


# ------------------------------------ the other kernels' shape ceilings


def test_knn_fused_raises_past_its_shared_memory():
    """The old ceiling (L + 32·k ≤ 58,112 floats) is gone: L = 2000 with
    k = 1800 runs on the insertion kernel, reading the series from global
    memory; a series of 60,000 runs on the selection kernel (256 sampled
    rows held against the plain rows). Only a k whose one list passes a
    block's shared memory still raises."""
    from repro_torch.kernels import knn_fused, ref
    x = _cuda_panel(N=2, L=2000)[0]
    assert knn_fused.route(2000, 1, 1, 1800) == "insert"
    got = knn_fused.all_knn_fused(x, E=1, k=1800)
    want = knn_fused.plain(x, E=1, k=1800)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    rng = np.random.default_rng(0)
    xl = torch.as_tensor(np.round(rng.standard_normal(60_000) * 8) / 8,
                         dtype=torch.float32, device="cuda")
    d, i = knn_fused.all_knn_fused(xl, E=3, k=9)
    rows = np.sort(rng.choice(d.shape[0], 256, replace=False))
    dr, ir = ref.all_knn_rows(xl, rows, E=3, k=9)
    assert torch.equal(d[rows], dr) and torch.equal(i[rows], ir)
    k = knn_fused.K_LIMIT + 1
    with pytest.raises(ValueError, match="shared memory"):
        knn_fused.all_knn_fused(torch.zeros(k + 1, device="cuda"), E=1, k=k)


def test_knn_multi_e_raises_past_its_levels():
    from repro_torch.kernels import knn_multi_e
    X = _cuda_panel(N=2, L=200)
    with pytest.raises(ValueError, match="exceeds the kernel's 64"):
        knn_multi_e.all_knn_multi_e(X, E_max=65)


def test_smap_gram_raises_past_its_thetas():
    from repro_torch.kernels import smap_gram
    X = _cuda_panel(N=2, L=100)
    with pytest.raises(ValueError, match="1 to 64 thetas"):
        smap_gram.smap_gram(X[0], X, E=2, thetas=[0.5] * 65)


def test_topk_raises_past_its_k_limit():
    from repro_torch.kernels import topk
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    k = topk.SMEM_MAX // 8 + 1  # 29,057: one warp's list passes a block
    D = torch.zeros((k, k), device="cuda")
    with pytest.raises(ValueError, match="shared memory"):
        topk.topk_select(D, k=k)


@pytest.mark.parametrize("route", ["master", "direct", "smap"])
def test_journaled_xmap_equals_plain_on_the_card(tmp_path, route):
    """``xmap(run_dir=)`` on the card: the plain xmap's bits, the journal
    complete, and a second call launches no kernel."""
    import json

    from repro_torch.edm import EDM
    from repro_torch.kernels import knn_batch, knn_multi_e, lookup, smap_gram
    X = _cuda_panel(N=16, L=500)
    if route == "master":
        sess = EDM(X, E_max=6)
        sess.optimal_E()
        call = {}
    else:
        sess = EDM(X, E=3, batch_libs=5)
        call = {"method": "smap"} if route == "smap" else {}
    plain = EDM(X, E_max=6) if route == "master" else EDM(X, E=3)
    if route == "master":
        plain.optimal_E()
    want = plain.xmap(**call)
    got = sess.xmap(run_dir=str(tmp_path / "run"), **call)
    assert np.array_equal(got, want)
    report = json.loads((tmp_path / "run" / "report.json").read_text())
    assert report["status"] == "complete"
    wrappers = (knn_batch.all_knn_batch, knn_multi_e.all_knn_multi_e,
                lookup.lookup_rho, smap_gram.smap_gram)
    before = [fn.launches for fn in wrappers]
    again = EDM(X, E_max=6) if route == "master" else EDM(X, E=3)
    if route == "master":
        again._cache = sess._cache
    assert np.array_equal(again.xmap(run_dir=str(tmp_path / "run"), **call),
                          want)
    assert [fn.launches for fn in wrappers] == before
    assert again.stats["runs_short_circuited"] == 1


def test_real_cuda_oom_halves_the_batch_bit_identically(tmp_path):
    """A memory cap the S-Map route's first batch cannot be held under: the
    allocator's ``torch.cuda.OutOfMemoryError`` halves B (a ``halve``
    entry, never ``unclassified``) and the matrix keeps its bits."""
    import json

    from repro_torch.edm import EDM
    X = _cuda_panel(N=64, L=1600)
    want = EDM(X, E=3).xmap(method="smap")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    EDM(X, E=3).xmap(method="smap")
    peak = torch.cuda.max_memory_allocated()
    total = torch.cuda.get_device_properties(0).total_memory
    torch.cuda.empty_cache()
    torch.cuda.set_per_process_memory_fraction(
        (base + 0.7 * (peak - base)) / total)
    try:
        got = EDM(X, E=3).xmap(method="smap", run_dir=str(tmp_path / "run"))
    finally:
        torch.cuda.set_per_process_memory_fraction(1.0)
    trail = json.loads(
        (tmp_path / "run" / "report.json").read_text())["oom_backoff"]
    actions = [t["action"] for t in trail]
    assert "halve" in actions and "unclassified" not in actions, trail
    assert trail[0]["B"] == 64
    assert np.array_equal(got, want)


def _serve_panel():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    full = ts.forced_network_panel(8, 420, seed=3)[0]
    return full[:, :400], full


SERVE_PAIRS = [(0, 1), (1, 2), (2, 3), (3, 4), (4, 5), (5, 6), (6, 7),
               (7, 0)]


def test_served_ccm_equals_direct_sessions_on_the_card():
    """Coalesced answers equal singleton ``ccm_batch`` calls, an append
    equals a cold session, and an evicted master's lazy rebuild answers
    the same bits; the eviction frees what it reports."""
    from repro_torch.edm import EDM
    from repro_torch.serving import EDMServer
    panel, full = _serve_panel()
    grown = full[:, :403]

    def oracle(x):
        d = EDM(x, E_max=6)
        d.optimal_E()
        return [np.float32(d.ccm_batch([p], E=3)[0]) for p in SERVE_PAIRS]

    with EDMServer(autostart=False) as srv:
        srv.register_panel("p", panel, E_max=6, cache=True)
        srv.submit("optimal_E", "p")
        srv.scheduler.drain_once()
        futs = [srv.submit("ccm", "p", lib=l, target=t, E=3)
                for l, t in SERVE_PAIRS]
        assert srv.scheduler.drain_once() == len(SERVE_PAIRS)
        assert [np.float32(f.result()) for f in futs] == oracle(panel)
        srv.submit("append", "p", delta=full[:, 400:403])
        srv.scheduler.drain_once()
        futs = [srv.submit("ccm", "p", lib=l, target=t, E=3)
                for l, t in SERVE_PAIRS]
        srv.scheduler.drain_once()
        want = oracle(grown)
        assert [np.float32(f.result()) for f in futs] == want
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        freed = srv.evict_panel("p")
        torch.cuda.synchronize()
        assert freed > 0 and before - torch.cuda.memory_allocated() >= freed
        futs = [srv.submit("ccm", "p", lib=l, target=t, E=3)
                for l, t in SERVE_PAIRS]
        srv.scheduler.drain_once()
        assert [np.float32(f.result()) for f in futs] == want


def test_recovered_server_equals_the_uninterrupted_one_on_the_card(
        tmp_path):
    import json
    import os

    from repro_torch.edm import EDM
    from repro_torch.serving import EDMServer, WalError
    panel, full = _serve_panel()
    sd = str(tmp_path / "state")
    with EDMServer(state_dir=sd, autostart=False) as srv:
        srv.register_panel("p", panel, E_max=6, cache=True)
        for k in range(3):
            srv.submit("append", "p", delta=full[:, 400 + k:401 + k])
            srv.scheduler.drain_once()
        meta_path = os.path.join(srv.registry.get("p").wal.pdir,
                                 "meta.json")

    def set_device(device):
        with open(meta_path) as f:
            meta = json.load(f)
        meta["config"]["device"] = device
        with open(meta_path, "w") as f:
            json.dump(meta, f)

    set_device("cpu")
    with pytest.raises(WalError, match="device type"):
        EDMServer.recover(sd, autostart=False)
    set_device("cuda")
    rec = EDMServer.recover(sd, autostart=False)
    try:
        assert rec.recovery_report["p"]["version"] == 3
        assert rec.registry.get("p").sess.data.panel.is_cuda
        futs = rec.submit_many("ccm", "p", [{"lib": l, "target": t, "E": 3}
                                            for l, t in SERVE_PAIRS])
        while rec.scheduler.drain_once():
            pass
        d = EDM(full[:, :403], E_max=6)
        want = [np.float32(v) for v in d.ccm_batch(SERVE_PAIRS, E=3)]
        assert [np.float32(f.result()) for f in futs] == want
    finally:
        rec.close()



def test_world_of_one_cuda_mesh_session_equals_the_local_session():
    """``EDMConfig(mesh=...)`` on a CUDA world of one (NCCL, started by
    ``make_ccm_mesh``): the sharded engines run the same kernels on the
    same blocks as a ``cache=False`` local session, so the bits agree."""
    import torch.distributed as dist
    from repro_torch.distributed import make_ccm_mesh
    from repro_torch.edm import EDM
    panel = _cuda_panel(N=7, L=300).cpu().numpy()
    mesh = make_ccm_mesh((1, 1), ("data", "model"))
    try:
        sess = EDM(panel, E_max=6, mesh=mesh)
        local = EDM(panel, E_max=6, cache=False)
        for got, want in zip(sess.optimal_E(), local.optimal_E()):
            np.testing.assert_array_equal(got, want)
        for method in ("simplex", "smap"):
            np.testing.assert_array_equal(sess.xmap(method=method),
                                          local.xmap(method=method))
        np.testing.assert_array_equal(sess.smap(), local.smap())
    finally:
        dist.destroy_process_group()


def test_mesh_of_two_without_a_process_group_raises():
    import torch.distributed as dist
    from repro_torch.distributed import make_ccm_mesh
    _cuda_panel(N=2, L=50)  # skips without CUDA
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="torchrun"):
        make_ccm_mesh((2,), ("data",))


# ------------------------------------------------- the LM substrate


LM_SMOKE_TOL = 1e-4   # float32 smoke models, TF32 off, card vs CPU


def _lm_pair(arch, **replace):
    """(cfg, CPU model, the same weights on the card) of a smoke arch."""
    import dataclasses
    from repro_torch import models as pm
    from repro_torch.configs import get_config
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the card-against-CPU checks")
    assert not torch.backends.cuda.matmul.allow_tf32
    cfg = dataclasses.replace(get_config(arch, smoke=True), **replace)
    cpu = pm.init_params(cfg, device="cpu",
                         generator=torch.Generator().manual_seed(0))
    card = pm.abstract_params(cfg).to_empty(device="cuda")
    card.load_state_dict(cpu.state_dict())
    return cfg, cpu, card


def _lm_batch(cfg, device, B=2, S=16):
    rng = np.random.default_rng(4)
    out = {"labels": rng.integers(0, cfg.vocab_size, (B, S))}
    if cfg.embed_inputs:
        out["embeds"] = rng.normal(size=(B, S, cfg.d_model)).astype(
            np.float32)
    else:
        out["tokens"] = rng.integers(0, cfg.vocab_size, (B, S))
    return {k: torch.as_tensor(v, device=device) for k, v in out.items()}


LM_ARCHS = ("qwen1.5-4b", "llama3-8b", "yi-6b", "nemotron-4-15b",
            "jamba-v0.1-52b", "hubert-xlarge", "llava-next-mistral-7b",
            "xlstm-125m", "llama4-maverick-400b-a17b", "deepseek-v2-lite-16b")


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_forward_loss_and_grads_on_the_card(arch):
    from repro_torch import models as pm
    cfg, cpu, card = _lm_pair(arch)
    with torch.no_grad():
        lc, ac = pm.forward_train(cpu, cfg, _lm_batch(cfg, "cpu"))
        loss_c, _ = pm.loss_fn(cpu, cfg, _lm_batch(cfg, "cpu"))
        lg, ag = pm.forward_train(card, cfg, _lm_batch(cfg, "cuda"))
    torch.testing.assert_close(lg.cpu(), lc, rtol=LM_SMOKE_TOL,
                               atol=LM_SMOKE_TOL)
    torch.testing.assert_close(ag.cpu(), ac, rtol=LM_SMOKE_TOL,
                               atol=LM_SMOKE_TOL)
    loss, _ = pm.loss_fn(card, cfg, _lm_batch(cfg, "cuda"))
    loss.backward()
    torch.testing.assert_close(loss.detach().cpu(), loss_c,
                               rtol=LM_SMOKE_TOL, atol=LM_SMOKE_TOL)
    grads = [p.grad for p in card.parameters() if p.grad is not None]
    norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads))
    assert torch.isfinite(norm) and norm > 0


@pytest.mark.parametrize("arch", [a for a in LM_ARCHS
                                  if a != "hubert-xlarge"])
def test_lm_decode_steps_on_the_card(arch):
    from repro_torch import models as pm
    cfg, cpu, card = _lm_pair(arch)
    toks = np.random.default_rng(5).integers(0, cfg.vocab_size, (2, 5))
    caches = {d: pm.init_cache(cfg, 2, 8, device=d) for d in ("cpu", "cuda")}
    with torch.no_grad():
        for t in range(5):
            out = {}
            for d, m in (("cpu", cpu), ("cuda", card)):
                out[d], caches[d] = pm.decode_step(
                    m, cfg, torch.as_tensor(toks[:, t:t + 1], device=d),
                    caches[d], t)
            torch.testing.assert_close(out["cuda"].cpu(), out["cpu"],
                                       rtol=LM_SMOKE_TOL, atol=LM_SMOKE_TOL)


@pytest.mark.parametrize("arch", ["llama3-8b", "deepseek-v2-lite-16b",
                                  "jamba-v0.1-52b", "xlstm-125m"])
def test_lm_serve_engine_on_the_card_equals_the_cpu(arch):
    from repro_torch.serving import ServeEngine
    cfg, cpu, card = _lm_pair(arch)
    prompts = [[1, 2, 3, 4], [7, 8], [5, 5, 5, 5, 5, 5]]
    want = ServeEngine(cfg, cpu, s_max=32).generate(prompts, max_new=8)
    got = ServeEngine(cfg, card, s_max=32).generate(prompts, max_new=8)
    assert got.tokens == want.tokens and got.steps == want.steps
    hot = dict(max_new=8, temperature=0.8, seed=0)
    assert ServeEngine(cfg, card, s_max=32).generate(prompts, **hot).tokens \
        == ServeEngine(cfg, cpu, s_max=32).generate(prompts, **hot).tokens


def test_lm_chunked_prefill_on_the_card():
    from repro_torch import models as pm
    cfg, cpu, card = _lm_pair("deepseek-v2-lite-16b", attn_full_max=8,
                              attn_chunk_q=8)
    toks = np.random.default_rng(6).integers(0, cfg.vocab_size, (1, 32))
    with torch.no_grad():
        lc, cc = pm.prefill(cpu, cfg, {"tokens": torch.as_tensor(toks)},
                            s_max=40)
        lg, cg = pm.prefill(card, cfg, {"tokens": torch.as_tensor(
            toks, device="cuda")}, s_max=40)
    torch.testing.assert_close(lg.cpu(), lc, rtol=LM_SMOKE_TOL,
                               atol=LM_SMOKE_TOL)
    for name in cc:
        for k in cc[name]:
            torch.testing.assert_close(cg[name][k].cpu(), cc[name][k],
                                       rtol=LM_SMOKE_TOL, atol=LM_SMOKE_TOL)
