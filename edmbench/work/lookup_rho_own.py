"""Fused lookups and ρ of the own-target form over the optimal-E sweep:
at each E = 1..E_max, each of ``N`` series' table against that series
alone. The series' own sums are counted here, once a table."""


def work(*, N, L, E_max, tau, Tp, **_):
    tot = {"fp32": 0, "tf32": 0, "bytes": 0, "io_bytes": N * E_max * 4}
    for E in range(1, E_max + 1):
        k = E + 1
        rows = L - (E - 1) * tau - Tp
        tot["fp32"] += N * rows * (2 * k + 4 + 3)
        tot["bytes"] += N * (L * 4 + rows * k * 8 + 4)
    return tot
