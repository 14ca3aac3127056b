"""kNN tables of the optimal-E sweep: for each of ``N`` series and each
E = 1..E_max, the E + 1 nearest of the level's ``Lp_E − Tp`` candidates
to each of its ``Lp_E − Tp`` prediction rows, self excluded. The squared
distance at E is that at E − 1 plus one lag's square (a subtraction, a
square and a sum; two at E = 1). The tables the sweep needs are counted
as output, whatever slack a master keeps beside them."""


def work(*, N, L, E_max, tau, Tp, **_):
    ops = out = 0
    for E in range(1, E_max + 1):
        rows = cand = L - (E - 1) * tau - Tp
        k = E + 1
        ops += (cand * (cand - 1) // 2 * (2 if E == 1 else 3)
                + rows * (cand - 1)          # one comparison a candidate
                + rows * k)                  # a root a kept neighbour
        out += rows * k * 8
    return {"fp32": N * ops, "tf32": 0, "bytes": N * (L * 4 + out),
            "io_bytes": N * L * 4}
