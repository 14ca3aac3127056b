"""Session layer (``edm/session.py``): the share of each ``session.xmap``
span not covered by the ``engine.drive`` spans inside it — the E
grouping, target gathers, launch closures and result assembly the
session does around the engine."""


def read(ctx):
    outer = [s for s in ctx.spans if s["name"] == "session.xmap"]
    total = sum(s["dur_s"] for s in outer)
    if total <= 0:
        return None
    inner = sum(s["dur_s"] for s in ctx.spans
                if s["name"] == "engine.drive"
                and s["path"].startswith("session.xmap/"))
    return (total - inner) / total
