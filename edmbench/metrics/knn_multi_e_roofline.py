"""Kernels (``csrc/knn_multi_e.cu``): % of the optimal-E sweep's kNN
stage's least time (``work/knn_multi_e.py``) in the device time of the
multi-E kNN kernels."""

STAGE = "knn_multi_e"
PATTERN = r"knn_multi_e(_select)?_kernel"


def read(ctx):
    return ctx.kernel_roofline(STAGE, PATTERN)
