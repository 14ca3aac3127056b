"""Fused lookups and Pearson ρ of the all-targets form: each of the
``N`` libraries' tables (``Lp − Tp`` rows × E + 1) against each of the
``N`` targets.

A prediction is k products and k − 1 sums; ρ needs, a row, the running
sums of ŷ, ŷ² and ŷ·y (5 operations); a target's own sums are the
target's, not a pair's. Each of the call's ``launches`` reads the target
panel once and its tables, and writes its block of ρ.
"""


def work(*, N, L, E, tau, Tp, launches, **_):
    k = E + 1
    rows = L - (E - 1) * tau - Tp
    return {"fp32": N * N * rows * (2 * k + 4), "tf32": 0,
            "bytes": launches * N * L * 4 + N * rows * k * 8 + N * N * 4,
            "io_bytes": N * N * 4}
