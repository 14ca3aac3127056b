"""Simplex weights exp(−d/d_min), normalised, of the ``N`` libraries'
tables (``Lp − Tp`` rows, E + 1 neighbours)."""


def rows_work(n_tables, rows, k):
    per_row = 4 * k - 1   # k ratios, k exponentials, k − 1 adds, k divisions
    return {"fp32": n_tables * rows * per_row, "tf32": 0,
            "bytes": n_tables * rows * k * 8, "io_bytes": 0}


def work(*, N, L, E, tau, Tp, **_):
    return rows_work(N, L - (E - 1) * tau - Tp, E + 1)
