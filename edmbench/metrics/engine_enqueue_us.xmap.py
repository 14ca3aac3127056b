"""Engine layer (``core/ccm.py::drive_batched``): the mean host time of one
launch's enqueue, the ``engine.launch`` span (the launch closure's eager
ops and kernel wrappers), in µs. None where the program has no such
span."""


def read(ctx):
    durs = [s["dur_s"] for s in ctx.spans if s["name"] == "engine.launch"
            and s["path"].startswith("session.xmap/")]
    if not durs:
        return None
    return 1e6 * sum(durs) / len(durs)
