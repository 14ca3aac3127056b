"""Simplex weights of the optimal-E sweep: each of ``N`` series' table
at every E = 1..E_max (``Lp_E − Tp`` rows, E + 1 neighbours)."""

from edmbench.work.weights import rows_work


def work(*, N, L, E_max, tau, Tp, **_):
    tot = {"fp32": 0, "tf32": 0, "bytes": 0, "io_bytes": 0}
    for E in range(1, E_max + 1):
        w = rows_work(N, L - (E - 1) * tau - Tp, E + 1)
        for key in tot:
            tot[key] += w[key]
    return tot
