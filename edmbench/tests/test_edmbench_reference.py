"""The plain reference against hand-worked cases, its tie rule, and its
agreement with the port on a small panel with a periodic series."""

import math

import numpy as np
import torch

from edmbench.reference import common, edim, simplex_xmap


def test_simplex_cross_map_by_hand():
    # E = 1, k = 2, Tp = 0: each point's two nearest others.
    x = [0.0, 1.0, 3.0, 4.0, 8.0]
    y = [1.0, 2.0, 0.0, 5.0, 3.0]
    e = math.exp
    # (neighbour indices, their distances) worked out by hand
    nb = [((1, 2), (1, 3)), ((0, 2), (1, 2)), ((3, 1), (1, 2)),
          ((2, 1), (1, 3)), ((3, 2), (4, 5))]
    pred = []
    for (i1, i2), (d1, d2) in nb:
        w1, w2 = e(-d1 / d1), e(-d2 / d1)
        pred.append((w1 * y[i1] + w2 * y[i2]) / (w1 + w2))
    want = np.corrcoef(pred, y)[0, 1]
    panel = np.array([x, y], np.float32)
    got = simplex_xmap.expected(panel, [0], {"E": 1, "tau": 1,
                                             "Tp_cross": 0},
                                device="cpu", precision="float64")
    assert abs(got[0, 1] - want) < 1e-12


def test_equal_distances_go_to_the_lower_index():
    D = torch.tensor([[math.inf, 0.0, 0.0, 0.0, 5.0],
                      [2.0, math.inf, 1.0, 2.0, 2.0]], dtype=torch.float64)
    d2, idx = common.select(D, 2)
    assert idx.tolist() == [[1, 2], [2, 0]]
    assert d2.tolist() == [[0.0, 0.0], [1.0, 2.0]]


def test_optimal_e_curve_of_a_self_forecast_by_hand():
    # E = 1, Tp = 1, k = 2 over x[:-1], forecasts one step ahead.
    x = [0.0, 2.0, 3.0, 7.0, 4.0, 1.0]
    e = math.exp
    cand = [0, 1, 2, 3, 4]  # points whose next value exists
    pred = []
    for i in cand:
        ds = sorted((abs(x[i] - x[j]), j) for j in cand if j != i)
        (d1, j1), (d2, j2) = ds[:2]
        w1, w2 = e(-d1 / d1), e(-d2 / d1)
        pred.append((w1 * x[j1 + 1] + w2 * x[j2 + 1]) / (w1 + w2))
    want = np.corrcoef(pred, x[1:])[0, 1]
    _, rho = edim.expected(np.array([x], np.float32), [0],
                           {"E_max": 1, "tau": 1, "Tp": 1}, device="cpu",
                           precision="float64")
    assert abs(rho[0, 0] - want) < 1e-12


def test_readings_flag_a_changed_or_missing_answer():
    ref = np.zeros((2, 3))
    assert common.worst_gap([ref + 1e-7], ref) < 2e-7
    assert common.worst_gap([ref, ref + 0.25], ref) == 0.25
    assert common.worst_gap([np.full((2, 3), np.nan)], ref) == math.inf
    assert common.worst_gap([ref[:1]], ref) == math.inf
    assert common.worst_gap([], ref) == math.inf
    r = edim.readings([(np.array([2, 1]), ref[:, :2])],
                      (None, np.array([[0.1, 0.5], [0.3, 0.2]])))
    assert r["e_opt_regret"] == 0.0
    r = edim.readings([(np.array([1, 1]), ref[:, :2])],
                      (None, np.array([[0.1, 0.5], [0.3, 0.2]])))
    assert abs(r["e_opt_regret"] - 0.4) < 1e-12
