"""Session layer (``edm/session.py``): the share of each ``session.xmap``
span spent in its ``session.assemble`` spans — the write of each E-group's
block into the (N, N) host result. None where the program has no such
span."""


def read(ctx):
    parts = [s["dur_s"] for s in ctx.spans if s["name"] == "session.assemble"
             and s["path"].startswith("session.xmap/")]
    total = sum(s["dur_s"] for s in ctx.spans if s["name"] == "session.xmap")
    if not parts or total <= 0:
        return None
    return sum(parts) / total
