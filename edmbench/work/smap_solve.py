"""The batched ridge solve and the ρ of the S-Map xmap: for each of the
``N`` libraries' ``rows = Lp − Tp`` systems (G + εI) b = m with the
``N`` targets' moments as right-hand sides, then each target's forecast
ŷ_j = [1, z_j]·b and its ρ.

A system (n = E + 1): ε from the trace (n − 1 adds, a multiplication, a
division and an add) and n adds on the diagonal; the Cholesky, Σ_j (2j
operations and a root on the diagonal, (n − 1 − j)(2j + 1) below it);
a target, two triangular solves of n² operations each and the forecast,
n multiplications and n − 1 adds; ρ, the running sums of ŷ, ŷ² and ŷ·y
(5 operations a row and target). The bytes: G and M read, the library
and the target panel read for the forecast's rows and truth, ρ written.
"""


def work(*, N, L, E, tau, Tp, **_):
    n = E + 1
    rows = L - (E - 1) * tau - Tp
    chol = sum(2 * j + 1 + (n - 1 - j) * (2 * j + 1) for j in range(n))
    per_system = (n + 3) + n + chol + N * (2 * n * n + 2 * n - 1 + 5)
    return {"fp32": N * rows * per_system, "tf32": 0,
            "bytes": (N * rows * (n * n + N * n) * 4 + 2 * N * L * 4
                      + N * N * 4),
            "io_bytes": N * N * 4}
