"""Activation-sharding context of the LM substrate (the port of
``repro.models.meshctx``).

The reference pins activation shardings at block boundaries when a
launcher has set a mesh, and turns on sequence-parallel decode attention
by a toggle. Placing the LM substrate on a ``torch.distributed`` mesh is
ROADMAP item 11c, not ported yet: ``set_mesh`` with a mesh raises, no mesh
is ever set, so ``constrain`` is the identity and ``seqpar_decode()`` is
always False.
"""

from __future__ import annotations

import contextlib

_MESH = None
_SEQPAR_DECODE = False


def set_mesh(mesh):
    if mesh is not None:
        raise NotImplementedError(
            "repro_torch.models: placing the LM substrate on a mesh is "
            "ROADMAP item 11c (launch/mesh.py, launch/sharding.py, "
            "sequence-parallel decode, expert-parallel MoE), not ported yet")


def get_mesh():
    return _MESH


@contextlib.contextmanager
def use_mesh(mesh):
    set_mesh(mesh)
    yield


def constrain(x, *logical):
    """The reference's sharding constraint by logical dims; the identity
    without a mesh, which is always the case here."""
    return x


def set_seqpar_decode(on: bool):
    """Record the sequence-parallel decode toggle; it takes effect only on
    a mesh (ROADMAP item 11c)."""
    global _SEQPAR_DECODE
    _SEQPAR_DECODE = bool(on)


def seqpar_decode() -> bool:
    return _SEQPAR_DECODE and _MESH is not None
