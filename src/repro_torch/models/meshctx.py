"""Activation-sharding context of the LM substrate (the port of
``repro.models.meshctx``), and the collectives that the model's mesh path
writes out.

A launcher (or a test) calls ``set_mesh(mesh)`` with a ``DeviceMesh`` whose
dims carry the reference's names ("pod", "data", "model"); without a mesh
every constraint is the identity and every single-device path is as it
was. ``set_seqpar_decode(True)`` turns on sequence-parallel decode
attention, which takes effect only on a mesh.

How the reference's GSPMD program maps onto ``torch.distributed``, one
process a rank:

* Parameters and decode caches are ``DTensor``s placed by the rules of
  ``repro_torch.launch.sharding`` (``carry.place_params``,
  ``transformer.init_cache(..., mesh=)``).
* Activations are ``DTensor``s between units: batch over the
  data-parallel axes where they divide it, replicated over "model";
  ``constrain`` redistributes them to the reference's spec. Inside a unit
  the layers' code runs on the rank's local rows (``to_local()``), and
  each op that meets a placed parameter or cache runs on its local shard
  with its collective written out (``dense``: a column-parallel weight
  all-gathers its output over "model", a row-parallel one all-reduces
  its partial sums; ``embed``: a masked local lookup and an all-reduce;
  ``unembed``: an all-gather of the vocab shards; the MoE and the
  sequence-parallel decode attention are the reference's own shard_map
  islands). Weight dims sharded over the data axes (FSDP) are all-gathered
  at use.
* DTensor's own sharding propagation is not on this path: its implicit
  Shard → Replicate redistribution goes through the functional
  all-gather, which crashes a gloo world on CUDA tensors (torch 2.11 on
  the H100 machine; ``tools/gloo_cuda_probe.py``), and four ranks on one
  card can only be gloo (NCCL refuses two ranks on one GPU). The
  redistributions are shaped to use what gloo serves on CUDA there:
  all-reduce (sum and max) and the c10d all-gather; a Partial → Shard
  goes through an all-reduce and a local slice, a Replicate → Shard is a
  local slice. Gloo on that machine refuses the list all-to-all, and the
  path uses none.

``collective_counts()`` counts the collectives this module issued, by
kind, since ``reset_collective_counts()``; ``collective_seconds()`` sums
the host's seconds inside them (a gloo or NCCL call returns when this
rank's part is done, so this includes waiting for the other ranks).
"""

from __future__ import annotations

import collections
import contextlib
import time

import torch

_MESH = None
_SEQPAR_DECODE = False
_COUNTS: collections.Counter = collections.Counter()
_SECONDS: collections.Counter = collections.Counter()


def set_mesh(mesh):
    """Set (or, with None, clear) the mesh of the LM substrate: a
    ``torch.distributed`` ``DeviceMesh`` with named dims."""
    global _MESH
    if mesh is not None and getattr(mesh, "mesh_dim_names", None) is None:
        raise TypeError("set_mesh takes a DeviceMesh with named dims "
                        "(repro_torch.launch.mesh.make_mesh), or None")
    _MESH = mesh


def get_mesh():
    return _MESH


@contextlib.contextmanager
def use_mesh(mesh):
    prev = _MESH
    set_mesh(mesh)
    try:
        yield
    finally:
        set_mesh(prev)


# --------------------------------------------------------- collectives


def reset_collective_counts():
    _COUNTS.clear()
    _SECONDS.clear()


def collective_counts() -> dict:
    return dict(_COUNTS)


def collective_seconds() -> dict:
    return dict(_SECONDS)


def _group(mesh, axis):
    return mesh.get_group(axis)


def axis_len(axis, mesh=None) -> int:
    mesh = mesh or _MESH
    if mesh is None or axis not in mesh.mesh_dim_names:
        return 1
    return mesh.size(mesh.mesh_dim_names.index(axis))


def coordinate(axis, mesh=None) -> int:
    """This rank's index along the mesh dim ``axis`` (0 when absent)."""
    mesh = mesh or _MESH
    if mesh is None or axis not in mesh.mesh_dim_names:
        return 0
    return mesh.get_local_rank(axis)


def all_reduce(t: torch.Tensor, axes, op: str = "sum", mesh=None):
    """``t`` reduced (sum or max) over the mesh dims ``axes``, in place."""
    import torch.distributed as dist

    mesh = mesh or _MESH
    red = dist.ReduceOp.MAX if op == "max" else dist.ReduceOp.SUM
    for axis in ((axes,) if isinstance(axes, str) else axes):
        if axis_len(axis, mesh) > 1:
            t0 = time.perf_counter()
            dist.all_reduce(t, op=red, group=_group(mesh, axis))
            _SECONDS[f"all_reduce_{op}"] += time.perf_counter() - t0
            _COUNTS[f"all_reduce_{op}"] += 1
    return t


def all_gather(t: torch.Tensor, axis, dim: int, mesh=None) -> torch.Tensor:
    """The shards of ``t`` along the mesh dim ``axis`` put together along
    tensor dim ``dim``, in the axis' order."""
    import torch.distributed as dist

    mesh = mesh or _MESH
    n = axis_len(axis, mesh)
    if n == 1:
        return t
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(n)]
    t0 = time.perf_counter()
    dist.all_gather(parts, t, group=_group(mesh, axis))
    _SECONDS["all_gather"] += time.perf_counter() - t0
    _COUNTS["all_gather"] += 1
    return torch.cat(parts, dim=dim)


# ------------------------------------------------------------ DTensors


_DTENSOR = None


def is_dtensor(t) -> bool:
    global _DTENSOR
    if _DTENSOR is None:
        from torch.distributed.tensor import DTensor

        _DTENSOR = DTensor
    return isinstance(t, _DTENSOR)


def sharded_dims(dt) -> dict:
    """{mesh dim name: tensor dim} of the dims a DTensor is sharded on."""
    names = dt.device_mesh.mesh_dim_names
    return {names[i]: p.dim for i, p in enumerate(dt.placements)
            if p.is_shard()}


def gather(t, axes=None):
    """A DTensor's local block gathered over the mesh dims ``axes`` (all
    when None) as a plain tensor; a plain tensor as it is. Several mesh
    dims on one tensor dim (first major) are gathered minor first."""
    if not is_dtensor(t):
        return t
    mesh = t.device_mesh
    local = t.to_local()
    for i in reversed(range(mesh.ndim)):
        name = mesh.mesh_dim_names[i]
        p = t.placements[i]
        if p.is_partial():
            raise ValueError("gather of a Partial DTensor; constrain it")
        if p.is_shard() and (axes is None or name in axes):
            local = all_gather(local, name, p.dim, mesh)
    return local


def full(t):
    """A placed parameter as the whole tensor on every rank."""
    return gather(t)


def block(t: torch.Tensor, axis, dim: int, mesh=None) -> torch.Tensor:
    """This rank's block of a whole tensor along ``dim``, cut in equal
    blocks over the mesh dim ``axis``."""
    n = axis_len(axis, mesh)
    if n == 1:
        return t
    w = t.shape[dim] // n
    return t.narrow(dim, coordinate(axis, mesh) * w, w)


def local_slice(whole: torch.Tensor, mesh, placements,
                axes=None) -> torch.Tensor:
    """The block of ``whole`` that this rank holds under ``placements``,
    cutting only over the mesh dims ``axes`` (all when None)."""
    out = whole
    for i, p in enumerate(placements):
        if p.is_shard() and (axes is None
                             or mesh.mesh_dim_names[i] in axes):
            w = out.shape[p.dim] // mesh.size(i)
            out = out.narrow(p.dim, mesh.get_local_rank(i) * w, w)
    return out


# ----------------------------------------------------------------- caches
#
# A decode cache placed on a mesh holds the rank's batch rows (the data-
# parallel axes, as the activations) and, over "model", a block of the
# sequence (attention, MLA) or of an inner dim (recurrent states).

DP_AXES = ("pod", "data")


def _model_axes(dt) -> tuple:
    return tuple(a for a in dt.device_mesh.mesh_dim_names
                 if a not in DP_AXES)


def cache_read(leaf):
    """A cache leaf over the rank's batch rows, whole in its other dims."""
    return gather(leaf, _model_axes(leaf)) if is_dtensor(leaf) else leaf


def cache_read_many(leaves) -> list:
    """``cache_read`` of leaves of one layout (the same placements and
    leading dims): one all-gather of their blocks joined on the last
    dim."""
    if not all(is_dtensor(t) for t in leaves) or len(leaves) == 1 or any(
            list(t.placements) != list(leaves[0].placements)
            for t in leaves):
        return [cache_read(t) for t in leaves]
    widths = [t.shape[-1] for t in leaves]
    mesh = leaves[0].device_mesh
    joined = torch.cat([t.to_local() for t in leaves], -1)
    for i in reversed(range(mesh.ndim)):
        p = leaves[0].placements[i]
        name = mesh.mesh_dim_names[i]
        if p.is_shard() and name not in DP_AXES:
            joined = all_gather(joined, name, p.dim, mesh)
    return list(torch.split(joined, widths, dim=-1))


def cache_store(leaf, new: torch.Tensor):
    """Write ``new`` (the rank's batch rows, whole in the other dims) into
    a cache leaf in place: a placed leaf keeps its own block."""
    if is_dtensor(leaf):
        new = local_slice(new, leaf.device_mesh, leaf.placements,
                          _model_axes(leaf))
        leaf = leaf.to_local()
    leaf.copy_(new)


def cache_write_row(leaf, pos: int, row: torch.Tensor):
    """Write sequence position ``pos`` of a (B, S, ...) cache leaf in
    place; on a mesh only the rank whose sequence block holds ``pos``
    writes (the reference's masked update of the owning shard)."""
    if not is_dtensor(leaf):
        leaf[:, pos] = row.to(leaf.dtype)
        return
    local = leaf.to_local()
    start = 0
    mesh = leaf.device_mesh
    for i, p in enumerate(leaf.placements):
        if p.is_shard() and p.dim == 1:
            start = start * mesh.size(i) + mesh.get_local_rank(i)
    start *= local.shape[1]
    if start <= pos < start + local.shape[1]:
        local[:, pos - start] = row.to(local.dtype)


def place(t: torch.Tensor, mesh, placements):
    """A whole tensor (the same on every rank) as a DTensor of
    ``placements``: each rank keeps its block, no communication."""
    from torch.distributed.tensor import DTensor

    local = local_slice(t, mesh, placements)
    # a block keeps no reference to the whole tensor's storage
    local = (local.clone(memory_format=torch.contiguous_format)
             if local.numel() != t.numel() else t.contiguous())
    return DTensor.from_local(local, mesh, list(placements),
                              run_check=False, shape=t.shape,
                              stride=_contiguous_stride(t.shape))


def _contiguous_stride(shape) -> tuple:
    stride, acc = [], 1
    for s in reversed(tuple(shape)):
        stride.append(acc)
        acc *= s
    return tuple(reversed(stride))


def redistribute(dt, placements):
    """``dt`` in ``placements``, by the collectives that gloo serves on
    CUDA: Partial → all-reduce; Shard → Replicate or another dim's Shard
    → all-gather, then a local slice; Replicate → Shard a local slice."""
    from torch.distributed.tensor import DTensor, Replicate

    placements = list(placements)
    if list(dt.placements) == placements:
        return dt
    mesh = dt.device_mesh
    local = dt.to_local()
    for i, p in enumerate(dt.placements):
        if p.is_partial():
            local = all_reduce(local.clone(), mesh.mesh_dim_names[i],
                               mesh=mesh)
    cur = [Replicate() if p.is_partial() else p for p in dt.placements]
    for i in reversed(range(mesh.ndim)):
        if cur[i].is_shard() and cur[i] != placements[i]:
            local = all_gather(local, mesh.mesh_dim_names[i], cur[i].dim,
                               mesh)
            cur[i] = Replicate()
    for i, p in enumerate(placements):
        if p.is_shard() and not cur[i].is_shard():
            w = local.shape[p.dim] // mesh.size(i)
            local = local.narrow(p.dim, mesh.get_local_rank(i) * w, w)
    return DTensor.from_local(local.contiguous(), mesh, placements,
                              run_check=False, shape=dt.shape,
                              stride=_contiguous_stride(dt.shape))


def _axes(logical, mesh):
    names = mesh.mesh_dim_names
    if logical == "dp":
        return tuple(a for a in ("pod", "data") if a in names) or None
    if logical == "model":
        return ("model",) if "model" in names else None
    return None


def logical_spec(shape, *logical, mesh=None):
    """The reference's spec of an activation of ``shape`` by logical dims
    ('dp' | 'model' | None each), non-divisible dims replicated."""
    from repro_torch.launch.sharding import P

    mesh = mesh or _MESH
    spec = []
    for size, name in zip(shape, logical):
        axes = _axes(name, mesh)
        n = 1
        for a in axes or ():
            n *= axis_len(a, mesh)
        spec.append(axes if axes is not None and size % n == 0 else None)
    return P(*spec)


def constrain(x, *logical):
    """The reference's sharding constraint by logical dims ('dp' | 'model'
    | None per tensor dim): a DTensor is redistributed to that spec
    (non-divisible dims replicated); a plain tensor, or any tensor when no
    mesh is set, is returned as it is."""
    if (_MESH is None or not is_dtensor(x) or x.ndim != len(logical)):
        return x
    from repro_torch.launch.sharding import to_placements

    spec = logical_spec(x.shape, *logical)
    return redistribute(x, to_placements(x.device_mesh, spec))


_BATCH_SHARDED = False


def batch_sharded() -> bool:
    """Whether the activations now on the mesh path hold a block of the
    batch (the data-parallel axes divide it) or the whole batch."""
    return _BATCH_SHARDED


def _dp_axes(mesh) -> tuple:
    return tuple(a for a in DP_AXES if a in mesh.mesh_dim_names)


def batch_all(x: torch.Tensor) -> torch.Tensor:
    """The whole batch of an activation whose rows this rank holds (an
    all-gather over the data-parallel axes, minor first)."""
    if _MESH is None or not _BATCH_SHARDED:
        return x
    for a in reversed(_dp_axes(_MESH)):
        x = all_gather(x, a, 0)
    return x


def batch_rows(x: torch.Tensor) -> torch.Tensor:
    """This rank's rows of a whole-batch tensor (the inverse of
    ``batch_all``)."""
    if _MESH is None or not _BATCH_SHARDED:
        return x
    for a in _dp_axes(_MESH):
        x = block(x, a, 0)
    return x


def activation(x: torch.Tensor):
    """A whole input (the same on every rank) entering the mesh path: a
    replicated DTensor, then batch over the data-parallel axes where they
    divide it."""
    from torch.distributed.tensor import Replicate

    global _BATCH_SHARDED
    dt = constrain(place(x, _MESH, [Replicate()] * _MESH.ndim),
                   "dp", *([None] * (x.ndim - 1)))
    _BATCH_SHARDED = any(p.is_shard() for p in dt.placements)
    return dt


def wrap_like(rows: torch.Tensor, like):
    """A layer's local result as a DTensor of ``like``'s placements (its
    batch rows are ``like``'s; other dims replicated); ``rows`` as it is
    when ``like`` is a plain tensor."""
    if not is_dtensor(like):
        return rows
    from torch.distributed.tensor import DTensor

    shape = (like.shape[0],) + tuple(rows.shape[1:])
    return DTensor.from_local(rows, like.device_mesh, like.placements,
                              run_check=False, shape=torch.Size(shape),
                              stride=_contiguous_stride(shape))


def local(x):
    """A DTensor's local block; a plain tensor as it is."""
    return x.to_local() if is_dtensor(x) else x


def full_tree(module) -> dict:
    """A parameter module's tree as nested dicts of whole tensors."""
    out: dict = {}
    for name, t in module.named_parameters():
        node = out
        *path, leaf = name.split(".")
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = full(t)
    return out


# --- serving toggles (set by launchers; default off) -------------------


def set_seqpar_decode(on: bool):
    """Enable sequence-parallel KV decode attention (the flash-style
    combine over the cache's model-sharded sequence axis)."""
    global _SEQPAR_DECODE
    _SEQPAR_DECODE = bool(on)


def seqpar_decode() -> bool:
    return _SEQPAR_DECODE and _MESH is not None
