"""Device (H100): 1 − the union of device intervals over the wall of the
profiled ``optimal_E`` calls."""


def read(ctx):
    return ctx.idle_share()
