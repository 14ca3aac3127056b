"""kNN distances and selection of the direct engine: for each of the
``N`` library series, the E + 1 nearest of the ``Lp − Tp`` candidates of
each prediction row, over the delay embedding (E lags)."""


def work(*, N, L, E, tau, Tp, **_):
    k = E + 1
    Lp = L - (E - 1) * tau
    rows = cand = Lp - Tp
    pairs = cand * (cand - 1) // 2           # each unordered pair once
    per_lib = (pairs * (3 * E - 1)           # E subs, E squares, E − 1 adds
               + rows * (cand - 1)           # one comparison a candidate
               + rows * k)                   # a root a kept neighbour
    return {"fp32": N * per_lib, "tf32": 0,
            "bytes": N * (L * 4 + rows * k * 8),
            "io_bytes": N * L * 4}
