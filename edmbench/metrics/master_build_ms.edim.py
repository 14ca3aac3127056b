"""Plan layer (``edm/session.py::_master``, ``panel_master``): the mean
device time of the multi-E kNN master build, the ``dev_s`` of the
``session.master_build`` span, in ms. None where the span has no device
time (an older program, or a CPU run)."""


def read(ctx):
    devs = [s["dev_s"] for s in ctx.spans
            if s["name"] == "session.master_build" and "dev_s" in s]
    if not devs:
        return None
    return 1e3 * sum(devs) / len(devs)
