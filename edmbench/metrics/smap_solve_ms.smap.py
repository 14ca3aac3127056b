"""Solve layer (``core/smap_engine.py::_ridge_solve``): the mean device
time of the batched ridge solve, the ``dev_s`` of the ``smap.solve``
span (the Cholesky, both triangular solves and any re-solve of failed
systems), in ms. None where the span is absent or has no device time (an
older program, or a CPU run)."""


def read(ctx):
    devs = [s["dev_s"] for s in ctx.spans
            if s["name"] == "smap.solve" and "dev_s" in s]
    if not devs:
        return None
    return 1e3 * sum(devs) / len(devs)
