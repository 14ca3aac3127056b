"""Plan layer (``edm/plan.py::rho_curves_from_master``): the mean device
time of the per-E derive loop (the derive sorts, gathers, weights and
own-target lookups), the ``dev_s`` of the ``plan.derive`` span, in ms.
None where the span is absent or has no device time (a CPU run)."""


def read(ctx):
    devs = [s["dev_s"] for s in ctx.spans
            if s["name"] == "plan.derive" and "dev_s" in s]
    if not devs:
        return None
    return 1e3 * sum(devs) / len(devs)
