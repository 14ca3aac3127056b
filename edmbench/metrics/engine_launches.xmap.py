"""Engine layer (``core/ccm.py::drive_batched``): library-batch launches
an xmap call makes (the ``edm_launches`` counter's rise; a count that
repeats exactly)."""


def read(ctx):
    if not ctx.calls:
        return None
    per = ctx.per_call("edm_launches")
    return sum(per) / len(per)
