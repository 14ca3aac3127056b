"""Kernels, all of a call: % of an S-Map xmap call's wall that the least
time of its whole algorithmic work takes (as ``work_roofline.xmap``)."""


def read(ctx):
    return ctx.call_share()
