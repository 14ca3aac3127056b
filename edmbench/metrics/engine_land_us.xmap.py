"""Engine layer (``core/ccm.py::drive_batched``): the mean host time of one
landing, the ``engine.land`` span (the device-to-host copy, which waits
for the launch, and the copy into the result), in µs. None where the
program has no such span."""


def read(ctx):
    durs = [s["dur_s"] for s in ctx.spans if s["name"] == "engine.land"
            and s["path"].startswith("session.xmap/")]
    if not durs:
        return None
    return 1e6 * sum(durs) / len(durs)
