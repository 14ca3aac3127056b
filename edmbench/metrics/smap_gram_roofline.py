"""Kernels (``csrc/smap_gram.cu``): % of the S-Map Gram stage's least time
(``work/smap_gram.py``) in the device time of the ``smap_gram`` kernels
(distances, d̄, weights, the right-hand sides and the weighted product)."""

STAGE = "smap_gram"
PATTERN = r"smap_\w+_kernel"


def read(ctx):
    return ctx.kernel_roofline(STAGE, PATTERN)
