"""Kernels (``csrc/knn_batch.cu``): % of the batched kNN stage's least
time (``work/knn_batch.py``) in the device time of the kNN kernels."""

STAGE = "knn_batch"
PATTERN = r"knn_batch(_thread)?_kernel"


def read(ctx):
    return ctx.kernel_roofline(STAGE, PATTERN)
