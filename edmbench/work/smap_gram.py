"""S-Map weighted normal equations of the xmap: for each of the ``N``
library series and each of its ``rows = Lp − Tp`` query rows j, the
weights w_ij = exp(−θ·d_ij/d̄_j) over the library's rows, the Gram
G_j = AᵀW_jA and the moments M_j = AᵀW_jy of every one of the ``N``
targets (one θ).

The weighted products are counted once a unique entry — (E+1)(E+2)/2 of
the symmetric G and N·(E+1) of M — a multiply-add (two operations) a
row i, as three TF32 products each (``tf32``): the least of a float32
product on the tensor cores, so the share stays under 100 % whichever
route computes them, the CUDA cores included. The distances (once an
unordered pair: E subtractions, E squares, E − 1 adds and a root), d̄
(an add a pair, a division a row) and the weights (a division, a
multiplication and an exponential an entry) are float32. Each launch
reads the target panel and its libraries once and writes G and M.
"""


def work(*, N, L, E, tau, Tp, launches, **_):
    E1 = E + 1
    rows = L - (E - 1) * tau - Tp
    cols = E1 * (E1 + 1) // 2 + N * E1        # unique G and M entries
    pairs = rows * (rows - 1) // 2
    per_lib = (pairs * (3 * E - 1 + 1)         # distances and their roots
               + rows * rows + rows            # d̄
               + 3 * rows * rows)              # the weights
    return {"fp32": N * per_lib,
            "tf32": 3 * 2 * N * rows * rows * cols,
            "bytes": (launches * N * L * 4 + N * L * 4
                      + N * rows * (E1 * E1 + N * E1) * 4),
            "io_bytes": N * L * 4}
