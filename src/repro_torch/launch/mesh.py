"""Meshes of the LM substrate (the port of ``repro.launch.mesh`` and of
``repro.compat.make_mesh``).

A mesh is a ``torch.distributed`` ``DeviceMesh`` with named dims, one
process a rank. ``axis_size`` and ``dp_axes`` read only a mesh's dim names
and sizes, so the sharding rules also run on a stand-in that has no world
behind it: anything with ``shape`` (a tuple, or a dict by name) and
``mesh_dim_names`` (``abstract_mesh``) or ``axis_names`` (what the
reference's rules read of a JAX mesh).
"""

from __future__ import annotations

import dataclasses


def make_mesh(shape, names, *, device_type: str = "cuda"):
    """A ``DeviceMesh`` of ``shape`` over the whole world, dims named
    ``names``. The world must hold exactly ``prod(shape)`` ranks, or a mesh
    of one starts a world of one itself (NCCL on the card, gloo on the
    CPU); a mesh of another size raises. See
    ``repro_torch.distributed.make_ccm_mesh``, which builds it."""
    from repro_torch.distributed.sharded_ccm import make_ccm_mesh

    return make_ccm_mesh(shape, names, device_type=device_type)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """One pod: (16, 16) over ("data", "model"), 256 ranks. Several pods:
    (2, 16, 16) over ("pod", "data", "model"), 512 ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device_type=device_type)


def make_test_mesh(shape=(2, 2), axes=("data", "model"), *,
                   device_type: str = "cuda"):
    """A small mesh for multi-rank tests (gloo ranks on the CPU with
    ``device_type="cpu"``)."""
    return make_mesh(shape, axes, device_type=device_type)


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """A mesh's dim names and sizes with no world behind it."""

    shape: tuple
    mesh_dim_names: tuple


def abstract_mesh(shape, names) -> AbstractMesh:
    return AbstractMesh(tuple(int(s) for s in shape), tuple(names))


def mesh_sizes(mesh) -> dict:
    """{dim name: size} of a mesh or a stand-in."""
    names = getattr(mesh, "mesh_dim_names", None) or mesh.axis_names
    shape = mesh.shape
    if isinstance(shape, dict):
        return {n: int(shape[n]) for n in names}
    return dict(zip(names, (int(s) for s in shape)))


def dp_axes(mesh) -> tuple:
    """The data-parallel axes ("pod" folds into data on multi-pod
    meshes)."""
    return ("pod", "data") if "pod" in mesh_sizes(mesh) else ("data",)


def axis_size(mesh, axes) -> int:
    if isinstance(axes, str):
        axes = (axes,)
    sizes = mesh_sizes(mesh)
    n = 1
    for a in axes:
        n *= sizes[a]
    return n
