"""Work counts at the shapes of PERF.md's kernel table (154 × 1,600),
beside its "bound ms" column (67 TFLOP/s float32, 495 TF32, 3.35 TB/s).

The counts here are the algorithm's least: a distance once a pair (the
table counts both orders and 3E operations a pair), a selection one
comparison a candidate, ρ's target sums once a target (the table: 16
operations a slot). So each least time sits below the table's by the
factor its row names."""

import pytest

from edmbench import spec

PEAKS = spec.load_json(spec.HERE / "peaks.json")


def least_ms(w):
    ops = (w["fp32"] / PEAKS["fp32_flops_per_s"]
           + w["tf32"] / PEAKS["tf32_flops_per_s"])
    return 1e3 * max(ops, w["bytes"] / PEAKS["hbm_bytes_per_s"])


# stage, shape, the table's bound ms, the expected ratio (ours / table's)
ROWS = [
    # knn_batch: Lp(Lp−1)/2·8 + Lp(Lp−1) + 4Lp against 9·Lp² a series
    ("knn_batch", dict(N=154, L=1600, E=3, tau=1, Tp=0), 0.0528, 0.5555),
    # knn_multi_e: Σ_E of 3 operations a pair once and a comparison a
    # candidate over Lp_E − 1 points, against 3·E_max·L² a series
    ("knn_multi_e", dict(N=154, L=1600, E_max=20, tau=1, Tp=1), 0.353,
     0.8161),
    # lookup_rho, the direct xmap (6 launches of 26): 12 against 16 a slot
    ("lookup_rho", dict(N=154, L=1600, E=3, tau=1, Tp=0, launches=6),
     0.00905, 0.7500),
]


@pytest.mark.parametrize("stage,shape,table_ms,ratio", ROWS,
                         ids=[r[0] for r in ROWS])
def test_least_time_beside_the_kernel_table(stage, shape, table_ms, ratio):
    w = spec.work_stage(stage).work(**shape)
    assert w["fp32"] > 0 and w["bytes"] > 0
    assert least_ms(w) / table_ms == pytest.approx(ratio, rel=0.01)


def test_every_stage_counts_its_call_boundary_within_its_bytes():
    shape = dict(N=82, L=10608, E=3, E_max=20, tau=1, Tp=0, launches=82)
    for p in sorted((spec.HERE / "work").glob("*.py")):
        if p.stem == "__init__":
            continue
        w = spec.work_stage(p.stem).work(**shape)
        assert set(w) == {"fp32", "tf32", "bytes", "io_bytes"}
        assert 0 <= w["io_bytes"] <= w["bytes"] and w["fp32"] > 0
