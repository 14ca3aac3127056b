"""Kernels (``csrc/lookup_rho.cu``): % of the lookup-ρ stage's least time
(``work/lookup_rho.py``) in the device time of the lookup-ρ kernels."""

STAGE = "lookup_rho"
PATTERN = r"rho_(all|finish)_kernel"


def read(ctx):
    return ctx.kernel_roofline(STAGE, PATTERN)
