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
  all-reduce (sum and max), the c10d all-gather and reduce-scatter; a
  Partial → Shard goes through an all-reduce and a local slice, a
  Replicate → Shard is a local slice. Gloo on that machine refuses the
  list all-to-all, and the path uses none.

Gradients. The collectives are autograd Functions returning new tensors
(under ``no_grad`` they issue the same c10d calls as without autograd).
Their backward depends on what the ranks along the axis compute:

* along "model" every rank holds the same activations and computes the
  same downstream function: a sum's backward is the identity, an
  all-gather's the rank's slice of the gradient, a ``block`` (this rank's
  slice of a tensor they all hold) all-gathers the gradients; the input
  of a computation each rank does a part of (a column-parallel product,
  the rank's experts) takes ``sum_grad``, whose backward sums its partial
  gradient over "model" (Megatron's f/g pairs);
* along the data-parallel axes the ranks hold different rows and each
  computes its own rows' share of the loss (the step's loss is their
  sum): a sum's backward sums the ranks' gradients, an all-gather's (an
  FSDP weight gathered at use) is a reduce-scatter, a slice of the batch
  (``batch_rows``) is a plain slice; a leaf replicated over them has its
  gradient all-reduced once a step (``optim.grad_utils.take_grads``).

A max all-reduce carries no gradient. A rematerialized unit issues its
forward collectives again in the backward, in the same order on every
rank.

``collective_counts()`` counts the collectives this module issued, by
kind (forward and backward), since ``reset_collective_counts()``;
``collective_bytes()`` sums the bytes of their results on this rank (an
all-reduce's tensor, an all-gather's whole, a reduce-scatter's block), by
the same kinds; ``collective_seconds()`` sums the host's seconds inside
them (a gloo or NCCL call returns when this rank's part is done, so this
includes waiting for the other ranks).
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
_BYTES: collections.Counter = collections.Counter()


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
    _BYTES.clear()


def collective_counts() -> dict:
    return dict(_COUNTS)


def collective_seconds() -> dict:
    return dict(_SECONDS)


def collective_bytes() -> dict:
    """{kind: bytes of the collectives' results on this rank} since
    ``reset_collective_counts()``."""
    return dict(_BYTES)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


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


def _axes_of(axes) -> tuple:
    return (axes,) if isinstance(axes, str) else tuple(axes)


def _c10d_all_reduce(t: torch.Tensor, axes, op: str, mesh) -> torch.Tensor:
    """``t`` reduced over the mesh dims ``axes`` by c10d, in place."""
    import torch.distributed as dist

    red = dist.ReduceOp.MAX if op == "max" else dist.ReduceOp.SUM
    for axis in _axes_of(axes):
        if axis_len(axis, mesh) > 1:
            t0 = time.perf_counter()
            dist.all_reduce(t, op=red, group=_group(mesh, axis))
            _SECONDS[f"all_reduce_{op}"] += time.perf_counter() - t0
            _COUNTS[f"all_reduce_{op}"] += 1
            _BYTES[f"all_reduce_{op}"] += _nbytes(t)
    return t


def _c10d_all_gather(t: torch.Tensor, axis, dim: int, mesh) -> torch.Tensor:
    import torch.distributed as dist

    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(axis_len(axis, mesh))]
    t0 = time.perf_counter()
    dist.all_gather(parts, t, group=_group(mesh, axis))
    _SECONDS["all_gather"] += time.perf_counter() - t0
    _COUNTS["all_gather"] += 1
    _BYTES["all_gather"] += _nbytes(t) * len(parts)
    return torch.cat(parts, dim=dim)


def _c10d_reduce_scatter(t: torch.Tensor, axis, dim: int, mesh):
    """This rank's block (along ``dim``) of ``t`` summed over ``axis``."""
    import torch.distributed as dist

    parts = [c.contiguous() for c in t.chunk(axis_len(axis, mesh), dim)]
    out = torch.empty_like(parts[0])
    t0 = time.perf_counter()
    dist.reduce_scatter(out, parts, group=_group(mesh, axis))
    _SECONDS["reduce_scatter"] += time.perf_counter() - t0
    _COUNTS["reduce_scatter"] += 1
    _BYTES["reduce_scatter"] += _nbytes(out)
    return out


def _replicated(axis) -> bool:
    """Whether the ranks along ``axis`` compute one downstream function
    (the module docstring's two cases: "model" yes, the data-parallel axes
    no)."""
    return axis not in DP_AXES


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, axes, mesh):
        ctx.axes = tuple(a for a in axes if not _replicated(a))
        ctx.mesh = mesh
        return _c10d_all_reduce(t.clone(), axes, "sum", mesh)

    @staticmethod
    def backward(ctx, g):
        if ctx.axes:
            g = _c10d_all_reduce(g.clone(), ctx.axes, "sum", ctx.mesh)
        return g, None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, axis, dim, mesh):
        ctx.axis, ctx.dim, ctx.mesh = axis, dim, mesh
        return _c10d_all_gather(t, axis, dim, mesh)

    @staticmethod
    def backward(ctx, g):
        if _replicated(ctx.axis):
            g = g.chunk(axis_len(ctx.axis, ctx.mesh), ctx.dim)[
                coordinate(ctx.axis, ctx.mesh)]
        else:
            g = _c10d_reduce_scatter(g, ctx.axis, ctx.dim, ctx.mesh)
        return g, None, None, None


class _Split(torch.autograd.Function):
    """This rank's block of a tensor replicated along a "model"-like axis;
    the backward all-gathers the blocks' gradients (Megatron's split)."""

    @staticmethod
    def forward(ctx, t, axis, dim, mesh):
        ctx.axis, ctx.dim, ctx.mesh = axis, dim, mesh
        n = axis_len(axis, mesh)
        return t.chunk(n, dim)[coordinate(axis, mesh)]

    @staticmethod
    def backward(ctx, g):
        return _c10d_all_gather(g, ctx.axis, ctx.dim, ctx.mesh), None, \
            None, None


class _SumGrad(torch.autograd.Function):
    """The identity, whose backward sums the gradient over ``axis`` (the
    input of a computation each rank along it does a part of)."""

    @staticmethod
    def forward(ctx, t, axis, mesh):
        ctx.axis, ctx.mesh = axis, mesh
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return _c10d_all_reduce(g.clone(), ctx.axis, "sum", ctx.mesh), \
            None, None


def _grad_needed(t: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and t.requires_grad


def all_reduce(t: torch.Tensor, axes, op: str = "sum", mesh=None):
    """``t`` reduced (sum or max) over the mesh dims ``axes``, as a new
    tensor (``t`` is not written). A sum is differentiable: along "model"
    its backward is the identity, along the data-parallel axes a sum of
    the ranks' gradients. A max carries no gradient (it is taken of
    ``t`` detached; the callers use it as a stabilizer)."""
    mesh = mesh or _MESH
    axes = _axes_of(axes)
    if op == "max" or not _grad_needed(t):
        return _c10d_all_reduce(t.detach().clone(), axes, op, mesh)
    if all(axis_len(a, mesh) == 1 for a in axes):
        return t
    return _AllReduce.apply(t, axes, mesh)


def all_gather(t: torch.Tensor, axis, dim: int, mesh=None) -> torch.Tensor:
    """The shards of ``t`` along the mesh dim ``axis`` put together along
    tensor dim ``dim``, in the axis' order. Differentiable: along "model"
    the backward takes this rank's slice of the gradient, along a
    data-parallel axis it reduce-scatters it."""
    mesh = mesh or _MESH
    if axis_len(axis, mesh) == 1:
        return t
    if not _grad_needed(t):
        return _c10d_all_gather(t, axis, dim, mesh)
    return _AllGather.apply(t, axis, dim % t.ndim, mesh)


def all_reduce_(t: torch.Tensor, axes, op: str = "sum", mesh=None):
    """``t`` reduced over the mesh dims ``axes`` IN PLACE, outside
    autograd (the optimizer's reductions of gradients and statistics)."""
    with torch.no_grad():
        return _c10d_all_reduce(t, _axes_of(axes), op, mesh or _MESH)


def sum_grad(t: torch.Tensor, axis="model", mesh=None) -> torch.Tensor:
    """``t`` as it is; in the backward its gradient is summed over
    ``axis``. Put on the input of a computation that each rank along
    ``axis`` does a block of (a column-parallel product, this rank's
    experts), whose gradient is then a partial sum."""
    mesh = mesh or _MESH
    if axis_len(axis, mesh) == 1 or not _grad_needed(t):
        return t
    return _SumGrad.apply(t, axis, mesh)


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
    return gather_block(t.to_local(), t.device_mesh, t.placements, axes)


def gather_block(local: torch.Tensor, mesh, placements, axes=None):
    """``gather`` of a local block held under ``placements``."""
    for i in reversed(range(mesh.ndim)):
        name = mesh.mesh_dim_names[i]
        p = placements[i]
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
    blocks over the mesh dim ``axis``. Along "model" (a tensor every rank
    along it holds) the backward all-gathers the blocks' gradients; along
    a data-parallel axis it is a plain slice."""
    n = axis_len(axis, mesh)
    if n == 1:
        return t
    if _replicated(axis) and _grad_needed(t):
        return _Split.apply(t, axis, dim % t.ndim, mesh or _MESH)
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

    # the block keeps no reference to the whole tensor's storage (a
    # replicated one is a copy too: a train state is updated in place)
    local = local_slice(t, mesh, placements).clone(
        memory_format=torch.contiguous_format)
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
            local = all_reduce(local, mesh.mesh_dim_names[i],
                               mesh=mesh)
    cur = [Replicate() if p.is_partial() else p for p in dt.placements]
    for i in reversed(range(mesh.ndim)):
        if cur[i].is_shard() and cur[i] != placements[i]:
            local = all_gather(local, mesh.mesh_dim_names[i], cur[i].dim,
                               mesh)
            cur[i] = Replicate()
    for i, p in enumerate(placements):
        if p.is_shard() and not cur[i].is_shard():
            local = block(local, mesh.mesh_dim_names[i], p.dim, mesh)
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


def batch_local(t) -> tuple:
    """(this rank's rows of a batch leaf, whether they are a block of the
    batch). A DTensor gives its local rows (gathered whole over the other
    mesh dims); a whole tensor (the same on every rank) its block over the
    data-parallel axes where they divide its batch, else all of it."""
    if is_dtensor(t):
        mesh = t.device_mesh
        rows = gather(t, tuple(a for a in mesh.mesh_dim_names
                               if a not in DP_AXES))
        return rows, any(p.is_shard() and p.dim == 0 and
                         mesh.mesh_dim_names[i] in DP_AXES
                         for i, p in enumerate(t.placements))
    if t.shape[0] % dp_size():
        return t, False
    for a in _dp_axes(_MESH):
        t = block(t, a, 0)
    return t, True


def rows_activation(rows: torch.Tensor, batch: int, sharded: bool):
    """A layer input made of this rank's rows (``batch_local``) as the
    activation DTensor of a ``batch``-row batch: Shard(0) over the
    data-parallel axes when ``sharded``, replicated otherwise."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    global _BATCH_SHARDED
    _BATCH_SHARDED = sharded
    pl = [Shard(0) if sharded and a in DP_AXES else Replicate()
          for a in _MESH.mesh_dim_names]
    shape = (batch,) + tuple(rows.shape[1:])
    return DTensor.from_local(rows, _MESH, pl, run_check=False,
                              shape=torch.Size(shape),
                              stride=_contiguous_stride(shape))


def dp_size(mesh=None) -> int:
    """The product of the data-parallel axes' sizes."""
    mesh = mesh or _MESH
    n = 1
    for a in _dp_axes(mesh):
        n *= axis_len(a, mesh)
    return n


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
