"""Device (H100): 1 − the union of device intervals over the wall of the
profiled S-Map xmap calls."""


def read(ctx):
    return ctx.idle_share()
