"""Pairwise CCM on a device mesh: the reference's zero-collective layout on
``torch.distributed``.

The port of ``repro.distributed.sharded_ccm``. The (library × target) skill
matrix is cut in two dimensions over a named ``DeviceMesh``: library series
over ``lib_axes`` (default "data", plus "pod" on multi-pod meshes), target
series over ``tgt_axes`` (default "model"). Several named axes flatten in
the order given, first axis major, as ``P(("pod", "data"))`` does.

JAX's ``shard_map`` is one controller driving every device; here there is
one process a rank. Every rank calls the same function with the full,
replicated inputs (the reference's initial placement) and computes only its
own (library shard × target shard) block from its mesh coordinates, through
the same library-batched engine as a local run (``ops.all_knn_batch`` B
libraries a launch, then the fused lookup-ρ). No collective runs in the
inner loop. Where the reference returns a sharded ``jax.Array`` (the
fixed-E modes, ``sharded_optimal_E``, ``sharded_smap_theta``) this returns
a ``DTensor`` made by ``DTensor.from_local`` with no communication:
``Shard`` on the decomposed dims, ``Replicate`` on the others; its
``full_tensor()`` is the caller's one collective (or ``gather_host``, which
also runs on a gloo world of CUDA tensors). Where the reference returns a
host array (the per-target ``E_opt`` modes) the ranks first agree that
every block was computed, then gather the blocks once, and each rank
returns the same array, in the original target order.

Two embedding-dimension modes, as in the reference: a fixed E, or a
per-target ``E_opt`` table whose targets are laid out so that every shard
owns the same segment structure of E-groups (``_egroup_layout``).
"""

from __future__ import annotations

import atexit
import math
import os
import shutil
import tempfile

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import telemetry
from repro_torch.core.ccm import (ccm_convergence_caps, direct_batch_libs,
                                  normalize_lib_sizes, pad_batch,
                                  post_lookup_rho)
from repro_torch.core.embedding import embed_offset, num_embedded, pred_rows
from repro_torch.core.simplex import optimal_E_batch
from repro_torch.core.smap_engine import (DEFAULT_THETAS, smap_group,
                                          smap_theta_sweep)
from repro_torch.kernels import ops

#: Mesh device types and the collective backends that can deliver their
#: results: NCCL gathers CUDA tensors on the device, gloo gathers on the host.
_BACKENDS = {"cuda": ("nccl", "gloo"), "cpu": ("gloo",)}
#: The backend that only counts (``torch.distributed``'s fake process
#: group, the dry run's world of 256 or 512 ranks in one process): it
#: exchanges nothing, so a mesh over it takes meta tensors alone.
COUNTING_BACKEND = "fake"


def make_ccm_mesh(shape, names, *, device_type: str = "cuda"):
    """A ``DeviceMesh`` of ``shape`` with named dims over the whole world.

    One process a rank: under ``torchrun`` (or after
    ``torch.distributed.init_process_group``) the process group must hold
    exactly ``prod(shape)`` ranks, and the mesh is never shrunk to fit the
    processes found. With no process group and ``prod(shape) == 1`` this
    starts a world of one itself, on a ``FileStore`` in a new temporary
    directory (no environment variables, no TCP port; the directory goes
    at exit): NCCL for "cuda", gloo for "cpu". That world is the caller's:
    it ends with ``torch.distributed.destroy_process_group()`` or with the
    process. A CUDA mesh raises without CUDA.
    """
    from torch.distributed.device_mesh import init_device_mesh

    shape = tuple(int(s) for s in shape)
    names = tuple(names)
    if len(shape) != len(names):
        raise ValueError(f"mesh shape {shape} and names {names} differ in "
                         f"length")
    if device_type not in _BACKENDS:
        raise ValueError(f"unknown mesh device type {device_type!r}; "
                         f"expected one of {tuple(_BACKENDS)}")
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("a CUDA mesh but CUDA is not available; the port "
                           "does not fall back to the CPU — pass "
                           "device_type='cpu' for a gloo mesh there")
    size = math.prod(shape)
    if not dist.is_initialized():
        if size != 1:
            raise RuntimeError(
                f"a {shape} mesh needs {size} processes, one a rank, and "
                f"none is running: start them with torchrun, or call "
                f"torch.distributed.init_process_group(world_size={size}, "
                f"...) in each before building the mesh")
        store_dir = tempfile.mkdtemp(prefix="ccm_mesh_")
        atexit.register(shutil.rmtree, store_dir, True)
        store = dist.FileStore(os.path.join(store_dir, "store"), 1)
        dist.init_process_group(
            "nccl" if device_type == "cuda" else "gloo", store=store,
            rank=0, world_size=1)
    _comm_device(device_type)  # raises on a backend that cannot serve it
    if dist.get_world_size() != size:
        raise RuntimeError(
            f"a {shape} mesh needs a world of {size} ranks, this one has "
            f"{dist.get_world_size()}: start exactly {size} processes")
    return init_device_mesh(device_type, shape, mesh_dim_names=names)


def pad_to_multiple(x: torch.Tensor, multiple: int,
                    axis: int = 0) -> torch.Tensor:
    """Zero-pad ``axis`` up to a multiple (shards need equal blocks)."""
    n = x.shape[axis]
    pad = (-n) % multiple
    if pad == 0:
        return x
    shape = list(x.shape)
    shape[axis] = pad
    return torch.cat([x, x.new_zeros(shape)], dim=axis)


def mesh_axes_size(mesh, axes) -> int:
    """Total rank count across the named mesh axes."""
    shape = dict(zip(mesh.mesh_dim_names, mesh.shape))
    size = 1
    for ax in axes:
        size *= int(shape[ax])
    return size


def pad_members(members: np.ndarray, multiple: int) -> np.ndarray:
    """Pad an index list to a multiple by repeating its last entry
    (real data — padded slots' results are discarded by the caller)."""
    pad = (-len(members)) % multiple
    if pad == 0:
        return members
    return np.concatenate([members, np.repeat(members[-1:], pad)])


def _egroup_layout(E_opt, S: int):
    """Target layout giving every one of ``S`` target shards the same
    E-groups.

    As in the reference: each group's member list is padded to a multiple
    of S (repeating its last member — real data, results discarded) and cut
    into S equal chunks; shard d's block is its chunk of every group in
    order, so every shard runs one segment structure ``segs = ((E, width),
    ...)``. The group order is a stable argsort on the table's device
    (ascending E, then index); only the per-E histogram crosses to the host
    before compute.

    Returns (perm, keep, segs): the permuted target order as a tensor on
    ``E_opt``'s device (delivered with the results), the per-slot "not a
    pad" mask (host bool), and the per-shard segments.
    """
    E_opt = torch.as_tensor(E_opt).to(torch.int64)
    hist = torch.bincount(E_opt).tolist()
    order = torch.argsort(E_opt, stable=True)
    seg_gather, seg_keep, segs = [], [], []
    o = 0
    for E, cnt in enumerate(hist):
        if cnt == 0:
            continue
        padded = cnt + (-cnt) % S
        gi = o + np.minimum(np.arange(padded), cnt - 1)  # repeat last member
        keep = np.arange(padded) < cnt
        w = padded // S
        segs.append((int(E), w))
        seg_gather.append(gi.reshape(S, w))
        seg_keep.append(keep.reshape(S, w))
        o += cnt
    gather = np.concatenate(seg_gather, axis=1).reshape(-1)
    keep = np.concatenate(seg_keep, axis=1).reshape(-1)
    perm = order[torch.as_tensor(gather, device=order.device)]
    return perm, keep, tuple(segs)


# ------------------------------------------------------------ placement


def _comm_device(device_type: str) -> torch.device:
    """Where the world's backend exchanges a ``device_type`` mesh's
    tensors: the card on NCCL, the host on gloo, the meta device on the
    counting backend (which delivers nothing: ``_on`` refuses any other
    input there). Raises on a pair no backend of the group serves (never
    moving work elsewhere)."""
    backend = str(dist.get_backend())
    if ":" in backend:  # per-device backends, "cpu:gloo,cuda:nccl"
        backend = dict(p.split(":") for p in backend.split(",")).get(
            device_type, "none")
    if backend == COUNTING_BACKEND:
        return torch.device("meta")
    if backend not in _BACKENDS[device_type]:
        raise ValueError(
            f"backend {backend!r} cannot deliver a {device_type} mesh's "
            f"results; use one of {_BACKENDS[device_type]}")
    if backend == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _mesh_device(mesh) -> torch.device:
    """Check ``mesh`` spans the initialized world; its ranks' device."""
    if not dist.is_initialized():
        raise RuntimeError("a mesh run needs an initialized process group")
    if mesh.size() != dist.get_world_size():
        raise ValueError(
            f"the mesh holds {mesh.size()} ranks, the world "
            f"{dist.get_world_size()}: a mesh here spans the whole world")
    if _comm_device(mesh.device_type).type == "meta":
        return torch.device("meta")
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _on(x, dev: torch.device) -> torch.Tensor:
    """An input on the mesh's device: arrays are copied there, a tensor
    on another device type raises. On the counting backend's meta device
    only a meta tensor is taken: anything holding values raises."""
    if dev.type == "meta" and not (isinstance(x, torch.Tensor)
                                   and x.is_meta):
        raise ValueError(
            f"the {COUNTING_BACKEND!r} process group only counts: it takes "
            f"meta tensors, not a {type(x).__name__}"
            + (f" on {x.device}" if isinstance(x, torch.Tensor) else ""))
    if isinstance(x, torch.Tensor):
        if x.device.type != dev.type:
            raise ValueError(f"a {x.device.type} tensor on a "
                             f"{dev.type} mesh")
        return x
    return torch.as_tensor(np.asarray(x, np.float32), device=dev)


def _shard(mesh, axes) -> tuple[int, int]:
    """(this rank's block, block count) along the flattened ``axes``."""
    names = mesh.mesh_dim_names
    idx = 0
    for ax in axes:
        idx = idx * mesh.size(names.index(ax)) + mesh.get_local_rank(ax)
    return idx, mesh_axes_size(mesh, axes)


def _block(x: torch.Tensor, mesh, axes, what: str) -> torch.Tensor:
    """This rank's rows of ``x`` over ``axes`` (rows must divide evenly)."""
    i, S = _shard(mesh, axes)
    n = x.shape[0]
    if n % S:
        raise ValueError(f"{what}: {n} series do not divide over mesh axes "
                         f"{tuple(axes)} ({S} shards); use pad_to_multiple")
    w = n // S
    return x[i * w:(i + 1) * w]


def _dtensor(local: torch.Tensor, mesh, dim_axes: dict):
    """``local`` as a DTensor, no communication: ``Shard(d)`` on every mesh
    dim named in ``dim_axes[d]``, ``Replicate()`` on the rest. DTensor
    splits a tensor dim over its mesh dims in the mesh's order, so the
    axes of a dim must be given in that order."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    names = mesh.mesh_dim_names
    placements = [Replicate()] * mesh.ndim
    shape = list(local.shape)
    for d, axes in dim_axes.items():
        pos = [names.index(ax) for ax in axes]
        if pos != sorted(pos):
            raise ValueError(f"mesh axes {tuple(axes)} out of the mesh's "
                             f"order {names}: a DTensor result needs them "
                             f"in that order")
        for p in pos:
            if placements[p] != Replicate():
                raise ValueError(f"mesh axis {names[p]!r} shards two dims")
            placements[p] = Shard(d)
        shape[d] *= mesh_axes_size(mesh, axes)
    shape = torch.Size(shape)
    stride = tuple(int(s) for s in torch.empty(shape, device="meta").stride())
    return DTensor.from_local(local, mesh, placements, run_check=False,
                              shape=shape, stride=stride)


def _agree(flags) -> list[int]:
    """The world's element-wise maximum of small int ``flags``: one
    all-reduce of a few integers."""
    t = torch.tensor([int(f) for f in flags], dtype=torch.int64,
                     device=_comm_device(_world_device_type()))
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return t.tolist()


def _from_rank0(*arrays) -> list[np.ndarray]:
    """Rank 0's ``arrays`` on every rank (host arrays; one broadcast each,
    on whatever the world's backend carries)."""
    dev = _comm_device(_world_device_type())
    out = []
    for a in arrays:
        t = torch.from_numpy(np.ascontiguousarray(a)).to(dev)
        dist.broadcast(t, src=0)
        out.append(t.cpu().numpy())
    return out


def _world_device_type() -> str:
    """The device type the world's collectives carry best."""
    backend = str(dist.get_backend())
    return "cuda" if "nccl" in backend else "cpu"


def _agreed(fn):
    """``fn()`` on every rank, then agreement before any delivery gather.

    A rank whose ``fn`` raised re-raises its own error after the others
    have heard of it, so no rank waits in a collective another has left.
    The others raise too: a ``MemoryError`` when a rank ran out of memory
    (an out-of-memory error to ``edm.runner.is_oom_error``, so a journaled
    run's ladder halves B on every rank alike), else a ``RuntimeError``.
    """
    from repro_torch.edm.runner import is_oom_error

    out, err = None, None
    try:
        out = fn()
    except Exception as e:  # noqa: BLE001 — re-raised below, after agreeing
        err = e
    oom = err is not None and is_oom_error(err)
    any_oom, any_err = _agree([oom, err is not None and not oom])
    if err is not None:
        raise err
    if any_err:
        raise RuntimeError("another rank of the mesh failed in this call")
    if any_oom:
        raise MemoryError("another rank of the mesh ran out of memory in "
                          "this call")
    return out


def _assemble(local: torch.Tensor, mesh, dim_axes: dict) -> np.ndarray:
    """Every rank's block put together on the host, the same array on
    every rank: one all-gather over the world (on the device with NCCL,
    on the host with gloo). Rank r's block lands at its mesh coordinate,
    flattened over ``dim_axes[d]`` in the order given for each dim d."""
    dev = _comm_device(mesh.device_type)
    t = local.contiguous().to(dev)
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, t)
    names = mesh.mesh_dim_names
    sizes = dict(zip(names, mesh.shape))
    shape = list(local.shape)
    for d, axes in dim_axes.items():
        shape[d] *= mesh_axes_size(mesh, axes)
    out = np.empty(shape, torch.empty(0, dtype=local.dtype).numpy().dtype)
    ranks = mesh.mesh.cpu().numpy()
    for coord in np.ndindex(ranks.shape):
        at = dict(zip(names, coord))
        index = [slice(None)] * local.ndim
        for d, axes in dim_axes.items():
            i = 0
            for ax in axes:
                i = i * sizes[ax] + at[ax]
            w = local.shape[d]
            index[d] = slice(i * w, (i + 1) * w)
        out[tuple(index)] = parts[int(ranks[coord])].cpu().numpy()
    return out


def gather_host(dt) -> np.ndarray:
    """A DTensor of this module's engines on the host, the same array on
    every rank: one all-gather on whatever the world's backend carries
    (unlike ``full_tensor()``, it also runs a CUDA mesh over gloo)."""
    mesh = dt.device_mesh
    dim_axes: dict[int, tuple] = {}
    for name, p in zip(mesh.mesh_dim_names, dt.placements):
        if p.is_shard():
            dim_axes[p.dim] = dim_axes.get(p.dim, ()) + (name,)
    return _assemble(dt.to_local(), mesh, dim_axes)


# -------------------------------------------------------------- engines


def _local_block(libs, tgts, *, E, tau, Tp, rows, off, hard_max, impl,
                 batch_libs=None, budget_mb=None):
    """ρ tile for (local libraries × local targets): (nl, nt).

    The local engine on the rank's block: libraries B at a time through
    ``ops.all_knn_batch`` (B from ``core.ccm.direct_batch_libs``' memory
    rule), then the fused lookup-ρ of each batch. Rows are bit-invariant
    in B; nothing leaves the rank.
    """
    nl = libs.shape[0]
    B = direct_batch_libs(nl, libs.shape[-1], tgts.shape[0], E=E, tau=tau,
                          Tp=Tp, k=E + 1, impl=impl, device=libs.device,
                          batch_libs=batch_libs, budget_mb=budget_mb)
    nb = -(-nl // B)
    # ragged final batch: repeat real series, drop their rows below
    libs = pad_batch(libs, nb * B)
    Yt = ops.lookup_targets(tgts, impl=impl)
    out = []
    for b in range(nb):
        d, ix = ops.all_knn_batch(libs[b * B:(b + 1) * B], E=E, tau=tau,
                                  k=E + 1, exclude_self=True,
                                  max_idx=hard_max, impl=impl)
        out.append(post_lookup_rho(tgts, d, ix, rows=rows, off=off,
                                   impl=impl, Yt=Yt))
    return torch.cat(out)[:nl]


def _check_pair(X_lib, X_tgt, E, E_opt) -> None:
    if X_tgt.shape[-1] != X_lib.shape[-1]:
        raise ValueError("library/target series length mismatch")
    if (E is None) == (E_opt is None):
        raise ValueError("pass exactly one of E= or E_opt=")


def sharded_ccm_matrix(X_lib, X_tgt, *, E: int | None = None, tau: int = 1,
                       Tp: int = 0, mesh, lib_axes=("data",),
                       tgt_axes=("model",), impl: str = "auto", E_opt=None,
                       batch_libs: int | None = None,
                       batch_budget_mb: float | None = None, layout=None):
    """All-pairs CCM skill matrix on a device mesh.

    X_lib: (N_lib, L) — N_lib must divide evenly over ``lib_axes``.
    X_tgt: (N_tgt, L) — likewise over ``tgt_axes`` (use pad_to_multiple).

    Fixed-E mode (``E=``): returns the (N_lib, N_tgt) ρ as a DTensor
    sharded ``Shard(0)`` over ``lib_axes`` and ``Shard(1)`` over
    ``tgt_axes``, never leaving the ranks. Per-target optimal-E mode
    (``E_opt=`` (N_tgt,) table): targets laid out per ``_egroup_layout``
    so each shard runs the same E-segments (libraries auto-pad over
    ``lib_axes``); returns a host (N_lib, N_tgt) ndarray in the original
    target order, the same on every rank. ``batch_libs`` /
    ``batch_budget_mb`` size the per-shard engine (``_local_block``);
    ``layout`` is a precomputed ``_egroup_layout(E_opt, S_t)``.
    """
    dev = _mesh_device(mesh)
    X_lib, X_tgt = _on(X_lib, dev), _on(X_tgt, dev)
    _check_pair(X_lib, X_tgt, E, E_opt)
    L = X_lib.shape[-1]

    def block_fn(Eb):
        def block(libs, tgts):
            return _local_block(
                libs, tgts, E=Eb, tau=tau, Tp=Tp,
                rows=pred_rows(L, Eb, tau, Tp), off=embed_offset(Eb, tau, Tp),
                hard_max=num_embedded(L, Eb, tau) - 1 - max(Tp, 0),
                impl=impl, batch_libs=batch_libs, budget_mb=batch_budget_mb)
        return block

    telemetry.counter("edm_sharded_launches").inc()
    with telemetry.span("sharded.ccm_matrix", N_lib=int(X_lib.shape[0]),
                        N_tgt=int(X_tgt.shape[0]), fixed_E=E is not None):
        if E_opt is None:
            local = block_fn(E)(_block(X_lib, mesh, lib_axes, "X_lib"),
                                _block(X_tgt, mesh, tgt_axes, "X_tgt"))
            return _dtensor(local, mesh, {0: lib_axes, 1: tgt_axes})
        return _egrouped_matrix(X_lib, X_tgt, block_fn, E_opt=E_opt,
                                mesh=mesh, lib_axes=lib_axes,
                                tgt_axes=tgt_axes, layout=layout)


def _egrouped_matrix(X_lib, X_tgt, block_fn, *, E_opt, mesh, lib_axes,
                     tgt_axes, curves: bool = False,
                     layout=None) -> np.ndarray:
    """Shared E-grouped driver: per-shard E-segments, no collective while
    computing; one gather and the host unpermute at delivery.

    ``block_fn(E)`` maps (local libs, local target segment) to a (nl, w)
    ρ tile — or, with ``curves=True``, to an (S, nl, w) convergence tile
    whose leading size axis is replicated; targets stay the minor axis.
    ``layout``: a precomputed ``_egroup_layout(E_opt, S_t)``, for callers
    that cut the library axis into many calls over the same targets (the
    journaled mesh run of ``EDM.xmap``).
    """
    N_lib, N_tgt = X_lib.shape[0], X_tgt.shape[0]
    S_t = mesh_axes_size(mesh, tgt_axes)
    S_l = mesh_axes_size(mesh, lib_axes)
    if layout is None:
        E_opt = torch.as_tensor(E_opt, device=X_tgt.device).broadcast_to(
            (N_tgt,))
        layout = _egroup_layout(E_opt, S_t)
    perm, keep, segs = layout
    libs = _block(pad_to_multiple(X_lib, S_l), mesh, lib_axes, "X_lib")
    tgts = _block(X_tgt[perm.to(X_tgt.device)], mesh, tgt_axes, "X_tgt")

    def local():
        outs, o = [], 0
        for Eg, w in segs:
            outs.append(block_fn(Eg)(libs, tgts[o:o + w]))
            o += w
        return torch.cat(outs, dim=-1)

    lib_dim = 1 if curves else 0
    R = _assemble(_agreed(local), mesh,
                  {lib_dim: lib_axes, lib_dim + 1: tgt_axes})
    perm = perm.cpu().numpy()  # delivered WITH the results, not before
    if curves:
        rho = np.zeros((R.shape[0], N_lib, N_tgt), np.float32)
        rho[:, :, perm[keep]] = R[:, :N_lib, keep]
    else:
        rho = np.zeros((N_lib, N_tgt), np.float32)
        rho[:, perm[keep]] = R[:N_lib, keep]
    return rho


def sharded_ccm_convergence(X_lib, X_tgt, *, lib_sizes, E: int | None = None,
                            tau: int = 1, Tp: int = 0, mesh,
                            lib_axes=("data",), tgt_axes=("model",),
                            impl: str = "auto", E_opt=None):
    """All-pairs CCM convergence grids on a device mesh.

    The sharded counterpart of ``core.ccm.ccm_convergence``: every
    (library, target) pair's library-size curve, shape (num_sizes, N_lib,
    N_tgt), with the 2-D decomposition of ``sharded_ccm_matrix``. Each
    rank runs one pairwise and one multi-cap top-k launch per local
    library (``core.ccm.ccm_convergence_caps``), never a per-size
    re-scan; the size axis is replicated.

    Fixed-E mode (``E=``): a DTensor sharded ``Shard(1)`` over
    ``lib_axes`` and ``Shard(2)`` over ``tgt_axes``. Per-target optimal-E
    mode (``E_opt=``): a host ndarray in the original target order, sizes
    re-clamped per segment E. ``lib_sizes`` follows the caller's
    order (validated, deduplicated and clamped as in
    ``core.ccm.normalize_lib_sizes``).
    """
    dev = _mesh_device(mesh)
    X_lib, X_tgt = _on(X_lib, dev), _on(X_tgt, dev)
    _check_pair(X_lib, X_tgt, E, E_opt)
    L = X_lib.shape[-1]

    def block_fn(Eb):
        caps, inv = normalize_lib_sizes(
            lib_sizes, Lp=num_embedded(L, Eb, tau), Tp=Tp)
        inv = torch.as_tensor(inv, device=dev).long()

        def block(libs, tgts):
            cur = torch.stack([ccm_convergence_caps(
                x, tgts, E=Eb, tau=tau, Tp=Tp, caps=caps, exclude_self=True,
                impl=impl) for x in libs])  # (nl, |caps|, nt)
            return cur.transpose(0, 1)[inv]

        return block

    telemetry.counter("edm_sharded_launches").inc()
    with telemetry.span("sharded.ccm_convergence",
                        N_lib=int(X_lib.shape[0]),
                        N_tgt=int(X_tgt.shape[0])):
        if E_opt is None:
            local = block_fn(E)(_block(X_lib, mesh, lib_axes, "X_lib"),
                                _block(X_tgt, mesh, tgt_axes, "X_tgt"))
            return _dtensor(local, mesh, {1: lib_axes, 2: tgt_axes})
        return _egrouped_matrix(X_lib, X_tgt, block_fn, E_opt=E_opt,
                                mesh=mesh, lib_axes=lib_axes,
                                tgt_axes=tgt_axes, curves=True)


def sharded_optimal_E(X, *, E_max: int = 20, tau: int = 1, Tp: int = 1,
                      mesh, axes=("data",), impl: str = "auto"):
    """Per-series optimal E on a device mesh → (E_opt (N,), ρ (N, E_max)),
    both DTensors sharded ``Shard(0)`` over ``axes``.

    Each rank runs the local multi-E driver (``core.simplex.
    optimal_E_batch``: one multi-E kNN launch per series) on its shard,
    with no collective. N must divide evenly over ``axes`` (use
    pad_to_multiple).
    """
    X = _on(X, _mesh_device(mesh))
    telemetry.counter("edm_sharded_launches").inc()
    with telemetry.span("sharded.optimal_E", N=int(X.shape[0]),
                        E_max=E_max):
        E_opt, rho = optimal_E_batch(_block(X, mesh, axes, "X"),
                                     E_max=E_max, tau=tau, Tp=Tp, impl=impl)
        return (_dtensor(E_opt, mesh, {0: axes}),
                _dtensor(rho, mesh, {0: axes}))


def sharded_smap_theta(X, *, E: int, tau: int = 1, Tp: int = 1,
                       thetas: tuple[float, ...] | None = None,
                       ridge: float = 1e-6, mesh, axes=("data",),
                       impl: str = "auto"):
    """Per-series S-Map θ-sweeps on a device mesh → ρ (N, |θ|), a DTensor
    sharded ``Shard(0)`` over ``axes``.

    Each rank runs the batched S-Map engine (``core.smap_engine.
    smap_theta_sweep``: one Gram launch and one batched solve for every θ)
    on its shard, with no collective. N must divide evenly over ``axes``.
    """
    thetas = DEFAULT_THETAS if thetas is None else tuple(
        float(t) for t in thetas)
    X = _on(X, _mesh_device(mesh))
    telemetry.counter("edm_sharded_launches").inc()
    with telemetry.span("sharded.smap_theta", N=int(X.shape[0]), E=E,
                        thetas=len(thetas)):
        rho = smap_theta_sweep(_block(X, mesh, axes, "X"), E=E, tau=tau,
                               Tp=Tp, thetas=thetas, ridge=ridge, impl=impl)
        return _dtensor(rho, mesh, {0: axes})


def sharded_smap_matrix(X_lib, X_tgt, *, E: int | None = None, tau: int = 1,
                        Tp: int = 0, theta: float = 1.0, ridge: float = 1e-6,
                        mesh, lib_axes=("data",), tgt_axes=("model",),
                        impl: str = "auto", E_opt=None, layout=None):
    """All-pairs S-Map cross-map skill matrix on a device mesh.

    The decomposition and modes of ``sharded_ccm_matrix``, with the
    simplex lookup replaced by the batched S-Map engine
    (``core.smap_engine.smap_group``: fit on each local library's
    manifold, predict the local targets). Fixed E: a DTensor; ``E_opt=``:
    a host ndarray in the original target order. Exposed as
    ``EDM.xmap(method="smap")`` on mesh sessions.
    """
    dev = _mesh_device(mesh)
    X_lib, X_tgt = _on(X_lib, dev), _on(X_tgt, dev)
    _check_pair(X_lib, X_tgt, E, E_opt)

    def block_fn(Eb):
        def block(libs, tgts):
            return smap_group(libs, tgts, E=Eb, tau=tau, Tp=Tp,
                              theta=float(theta), ridge=ridge, impl=impl)
        return block

    telemetry.counter("edm_sharded_launches").inc()
    with telemetry.span("sharded.smap_matrix", N_lib=int(X_lib.shape[0]),
                        N_tgt=int(X_tgt.shape[0]), fixed_E=E is not None):
        if E_opt is None:
            local = block_fn(E)(_block(X_lib, mesh, lib_axes, "X_lib"),
                                _block(X_tgt, mesh, tgt_axes, "X_tgt"))
            return _dtensor(local, mesh, {0: lib_axes, 1: tgt_axes})
        return _egrouped_matrix(X_lib, X_tgt, block_fn, E_opt=E_opt,
                                mesh=mesh, lib_axes=lib_axes,
                                tgt_axes=tgt_axes, layout=layout)


def ccm_step(X, *, E: int, tau: int, mesh, lib_axes=("data",),
             tgt_axes=("model",), impl: str = "auto"):
    """Dry-run entry point: all-pairs CCM of one (N, L) panel (lib == tgt)."""
    return sharded_ccm_matrix(X, X, E=E, tau=tau, mesh=mesh,
                              lib_axes=lib_axes, tgt_axes=tgt_axes,
                              impl=impl)
