"""Kernels, all of a call: % of an xmap call's wall that the least time of
its whole algorithmic work takes — every stage's operations at the peaks
against the panel read and ρ written once, whichever kernels do it."""


def read(ctx):
    return ctx.call_share()
