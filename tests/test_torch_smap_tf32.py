"""The 3×TF32 split of the S-Map Gram kernel, emulated on the CPU.

``csrc/smap_gram.cu`` forms W·R on the tensor cores from TF32 operands:
each float32 operand v becomes hi, v rounded to TF32 as
``cvt.rna.tf32.f32`` rounds (to nearest, ties away from zero, on the 13
low mantissa bits), and lo = v − hi (exact) truncated to TF32; the
product is hi·hi + hi·lo + lo·hi. This file emulates that split in torch
(here only, never on the port's path),
forms the three products exactly (float64 sums of products of TF32
values) from the port's plain W and R, and holds the result within
``GRAM_RTOL`` of Σ|terms| of the JAX reference's G and M — the bound the
kernel is held to on the card. Plain TF32 (hi·hi alone) falls outside it:
the reason for the split.
"""

import numpy as np
import pytest
import torch

from repro.data import timeseries as ts
from repro.kernels import ref as jref
from repro_torch.kernels import ref as tref

GRAM_RTOL = 1e-5


def tf32_rna(v: torch.Tensor) -> torch.Tensor:
    """float32 → the nearest TF32 value (10 mantissa bits), ties away
    from zero, as ``cvt.rna.tf32.f32``: add half of the dropped unit to
    the magnitude's bits and clear the 13 low bits."""
    bits = v.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_trunc(v: torch.Tensor) -> torch.Tensor:
    """float32 → TF32 by clearing the 13 low mantissa bits (toward zero)."""
    bits = v.float().contiguous().view(torch.int32)
    return (bits & ~0x1FFF).view(torch.float32)


def _split(v: torch.Tensor):
    hi = tf32_rna(v)
    return hi, tf32_trunc(v - hi)


def _gram_products(x, Y, *, E, theta, three):
    """(G, M) of one θ from TF32 operands (float64 sums), leave-one-out."""
    rows, AA, yA = tref._smap_operands(x, Y, E=E, tau=1, Tp=1)
    ratio = tref.smap_ratio(x, E=E, tau=1, rows=rows)
    W = torch.exp(-theta * ratio).masked_fill(
        torch.eye(rows, dtype=torch.bool), 0.0)
    R = torch.cat([AA, yA], dim=1)
    (wh, wl), (rh, rl) = _split(W), _split(R)
    wh, wl, rh, rl = (t.double() for t in (wh, wl, rh, rl))
    C = wh @ rh
    if three:
        C = C + wh @ rl + wl @ rh
    E1 = E + 1
    return (C[:, :E1 * E1].reshape(rows, E1, E1),
            C[:, E1 * E1:].reshape(rows, -1, E1))


def _rel_err(x, Y, *, E, theta, three):
    """max over G and M of |emulated − reference| / Σ|terms|."""
    G, M = _gram_products(torch.from_numpy(x), torch.from_numpy(Y), E=E,
                          theta=theta, three=three)
    Gj, Mj = jref.smap_gram(x, Y, E=E, tau=1, Tp=1, thetas=(theta,))
    Ga, Ma = tref.smap_gram_abs(torch.from_numpy(x), torch.from_numpy(Y),
                                E=E, tau=1, Tp=1, thetas=(theta,))
    worst = 0.0
    for got, want, scale in ((G, Gj, Ga), (M, Mj, Ma)):
        want = torch.from_numpy(np.array(want)[:, 0]).double()
        scale = scale[:, 0].double()
        pos = scale > 0
        worst = max(worst, float(((got - want).abs()[pos] / scale[pos]).max()))
    return worst


def _panel(N, L, seed):
    return np.asarray(ts.forced_network_panel(N, L, seed=seed)[0], np.float32)


def test_tf32_rounding_and_split():
    one = 1.0
    ulp = 2.0 ** -10  # TF32's unit in the last place at 1
    v = torch.tensor([one + ulp / 2, -(one + ulp / 2), one + ulp / 2 - 2 ** -23,
                      one + 3 * ulp / 2, 3.0, 0.0], dtype=torch.float32)
    want = torch.tensor([one + ulp, -(one + ulp), one, one + 2 * ulp, 3.0,
                         0.0], dtype=torch.float32)
    assert torch.equal(tf32_rna(v), want)
    r = torch.from_numpy(np.random.default_rng(0).standard_normal(
        1000).astype(np.float32))
    assert torch.equal(tf32_trunc(v), torch.tensor(
        [one, -one, one, one + ulp, 3.0, 0.0], dtype=torch.float32))
    hi, lo = _split(r)
    assert bool((tf32_rna(hi) == hi).all() and (tf32_trunc(lo) == lo).all())
    assert float(((hi + lo - r).abs() / r.abs()).max()) <= 2.0 ** -21


@pytest.mark.parametrize("theta", [0.5, 2.0, 8.0])
@pytest.mark.parametrize("E,N", [(3, 4), (1, 2)])
def test_three_tf32_gram_within_gram_rtol_of_reference(theta, E, N):
    P = _panel(N + 1, 300, seed=E)
    err = _rel_err(P[0], P[1:], E=E, theta=theta, three=True)
    assert err <= GRAM_RTOL, err


@pytest.mark.parametrize("theta", [0.5, 2.0, 8.0])
def test_plain_tf32_gram_misses_gram_rtol(theta):
    P = _panel(5, 300, seed=3)
    err = _rel_err(P[0], P[1:], E=3, theta=theta, three=False)
    assert err > GRAM_RTOL, err
