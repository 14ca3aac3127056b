"""Solve layer (``core/smap_engine.py::_ridge_solve``): the share of the
window's ridge systems whose float32 Cholesky failed on a Gram that
rounding made indefinite and that were solved again in float64 (the
``edm_smap_ridge_fallbacks`` counter's rise over ``edm_smap_systems``'s).
None where the program has no such counters."""


def read(ctx):
    systems = sum(ctx.per_call("edm_smap_systems"))
    if systems <= 0:
        return None
    return sum(ctx.per_call("edm_smap_ridge_fallbacks")) / systems
