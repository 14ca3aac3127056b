"""Dry run of the production meshes (the port of ``repro.launch.dryrun``).

Counts every (architecture × input-shape × mesh) cell, plus the EDM cell
``edm_ccm``, on the production mesh of 256 ranks (one pod: (16, 16) over
("data", "model")) or 512 (two pods: (2, 16, 16) over ("pod", "data",
"model")), and records one rank's cost, memory and collectives. No array
is allocated: parameters, train states, batches and caches are meta
tensors, placed as DTensors by ``launch.sharding``.

The reference lowers and compiles each cell on 512 emulated devices and
reads XLA's analyses. Here the world is ``torch.distributed``'s fake
process group, set up in this process (it stands for rank 0 of 256 or
512; its collectives exchange nothing, and ``distributed.sharded_ccm``
takes only meta tensors over it), and the cell's function runs eagerly on
rank 0's blocks under counting modes (``analyze``):

* ``cost["flops"]``: ``torch.utils.flop_counter``'s formulas, those
  ``FlopCounterMode`` counts with (the matrix products;
  ``cost["flops_by_op"]`` splits them by op);
* ``cost["bytes accessed"]``: every dispatched op's input and output
  bytes (views count none, nor do the inputs of ops that read only a
  shape, ``empty_like`` and the like; collectives are counted apart);
* ``memory``: ``argument_size_in_bytes`` (the rank's blocks of the state
  or parameters, the batch and the cache), ``output_size_in_bytes``,
  ``temp_size_in_bytes`` (the peak of the bytes made during the call and
  live at once: each storage from the op that made it until it is freed)
  and ``alias_size_in_bytes`` (outputs in the arguments' storages: the
  state or cache updated in place, the reference's donation);
* ``collectives``: the reference's kinds (``all-reduce`` = sum + max,
  ``all-gather``, ``reduce-scatter``, ``all-to-all``,
  ``collective-permute``) with ``counts``, ``bytes_by_kind`` (the bytes of
  each result on this rank, ``meshctx.collective_bytes``) and ``total``;
  the port's own kinds beside them (``by_port_kind``), and the c10d ops
  the dispatcher saw (``dispatched``), which equal them when every
  collective went through ``models.meshctx``.

An eager count costs time per op, not per element, so a cell at the
reference's depth, microbatches and sequence would take minutes. A cell
is therefore counted through probes whose counts give the cell's: at 1
and 2 units (``probe``; every count is linear in units), a train cell of
several microbatches at 2 and 3 microbatches of the cell's size (linear
in microbatches from two on), a long sequence at 3, 4 and 5 of its chunks
(``probe_seq``; quadratic in chunks), the EDM cell at 1 and 2 library
batches (``probe_edm``). FLOPs, bytes accessed and collectives come out
exact; the one count that could step between the probes and a cell is
the bucketed all-reduce of small gradients replicated over the
data-parallel axes (``optim.grad_utils.BUCKET_BYTES``). The peak of live
bytes is extrapolated along the same lines (along the longest probes'
line in the sequence) and is an estimate: the tests hold it within a
stated bound of a direct count. The probes keep the cell's layouts
(``scan_layers``) and code each unit's optimizer moments as the whole
model does (``make_train_step(stack=)``). ``count_cell(...,
direct=True)`` counts the cell itself.

The record keeps the reference's keys (``arch``, ``shape``, ``mesh``,
``devices``, ``status``, ``opt``, ``total_s``, ``cost``, ``memory``,
``collectives``; ``error`` and ``traceback`` on failure) but for the
compiler's: ``lower_s`` and ``compile_s`` become one ``count_s`` (the
probes' counting seconds), and ``hlo_chars`` is dropped (there is no HLO).
``probe`` holds the points counted and their seconds.

Usage:
  python -m repro_torch.launch.dryrun --arch llama3-8b --shape train_4k \\
      --mesh single --out experiments/dryrun [--device cpu]
  python -m repro_torch.launch.dryrun --all --mesh both \\
      --out experiments/dryrun
  python -m repro_torch.launch.dryrun --arch qwen1.5-4b ...  # its cells
  python -m repro_torch.launch.dryrun --arch edm_ccm --shape ccm_pairwise

``--device`` is the production mesh's device type (``cuda`` by default;
the tests and the CPU pass ``cpu``). Nothing is placed on that device.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import os
import time
import traceback
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import ARCHS, SHAPES, TrainConfig, cells, get_config
from repro_torch.launch import sharding as shd
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import meshctx
from repro_torch.models import transformer as tf

EDM_ARCH = "edm_ccm"
EDM_SHAPES = {
    # the paper's largest synthetic workload: 10^5 series × 10^4 steps
    "ccm_pairwise": dict(n_series=102_400, length=10_000, E=20, tau=1),
    # Subject6-shaped real-world cell (Table 1)
    "ccm_subject6": dict(n_series=92_160, length=3_780, E=10, tau=1),
}

MESH_RANKS = {"single": 256, "multi": 512}


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


# ------------------------------------------------------------ input specs


def _model_inputs(cfg, kind: str, B: int, S: int, mesh=None) -> dict:
    i32 = torch.int32
    if kind == "train":
        if cfg.embed_inputs:
            return {"embeds": _meta((B, S, cfg.d_model), torch.bfloat16),
                    "labels": _meta((B, S), i32)}
        return {"tokens": _meta((B, S), i32), "labels": _meta((B, S), i32)}
    if kind == "prefill":
        if cfg.embed_inputs:
            return {"embeds": _meta((B, S, cfg.d_model), torch.bfloat16)}
        return {"tokens": _meta((B, S), i32)}
    # decode: one new token against an S-long cache
    return {"tokens": _meta((B, 1), i32),
            "cache": tf.init_cache(cfg, B, S, dtype=cfg.dtype, abstract=True,
                                   mesh=mesh),
            "pos": _meta((), i32)}


def input_specs(arch: str, shape_name: str, *, mesh=None) -> dict:
    """Meta stand-ins for every model input of a cell, of the reference's
    shapes and dtypes. A decode cell's cache is ``init_cache(...,
    abstract=True, mesh=)``: placed on ``mesh`` when one is given."""
    if arch == EDM_ARCH:
        p = EDM_SHAPES[shape_name]
        return {"X": _meta((p["n_series"], p["length"]), torch.float32)}
    sc = SHAPES[shape_name]
    return _model_inputs(get_config(arch), sc.kind, sc.global_batch,
                         sc.seq_len, mesh)


# ------------------------------------------------------------------ world


def fake_world(size: int) -> None:
    """This process as rank 0 of a fake process group of ``size`` ranks
    (``torch.distributed``'s counting backend: its collectives exchange
    nothing). A fake world of another size is replaced; a real one
    raises."""
    import torch.distributed as dist
    # registers the "fake" backend
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if str(dist.get_backend()) != "fake":
            raise RuntimeError(
                f"a {dist.get_backend()!r} world is running in this process; "
                f"the dry run counts in a fake world of its own")
        if dist.get_world_size() == size:
            return
        dist.destroy_process_group()
        _forget_meshes()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=size)


def _forget_meshes() -> None:
    """Clear DTensor's sharding-propagation caches (its Python cache and,
    where torch has one, the C++ fast path's). They key on values, meshes
    included, and a mesh equals any mesh of the same shape and names: a
    mesh of a new world would get back one of an ended world, holding that
    world's groups."""
    from torch.distributed.tensor import DTensor, debug

    clear = getattr(debug, "_clear_sharding_prop_cache", None)
    if clear is not None:
        clear()
        return
    prop = DTensor._op_dispatcher.sharding_propagator
    for name in ("propagate_op_sharding", "_propagate_tensor_meta_cached"):
        cache = getattr(prop, name, None)
        if hasattr(cache, "cache_clear"):
            cache.cache_clear()


def production_mesh(mesh_kind: str, *, device_type: str = "cuda"):
    """The production mesh of ``mesh_kind`` ("single": (16, 16), "multi":
    (2, 16, 16)) over a fake world of its 256 or 512 ranks."""
    fake_world(MESH_RANKS[mesh_kind])
    return make_production_mesh(multi_pod=mesh_kind == "multi",
                                device_type=device_type)


# ----------------------------------------------------------- cell builder


def _strip_dp(spec):
    """Remove data-parallel axes from a spec (serving params are TP-only:
    FSDP weight shards force per-step all-gathers at inference)."""

    def clean(d):
        if d is None or isinstance(d, str):
            return None if d in ("data", "pod") else d
        t = tuple(a for a in d if a not in ("data", "pod"))
        return t if t else None

    return shd.P(*(clean(d) for d in spec))


def serving_spec(cfg, mesh, opt: int = 0):
    """The rule placing a serving cell's parameters at level ``opt``:
    ``(name, shape) → spec``. ``param_spec``; from ``opt`` 1 without the
    data-parallel axes (``_strip_dp``); from ``opt`` 3 the small K/V
    projections (``wk``, ``wv``) replicated, so every model shard computes
    full K/V locally (GQA kv heads fewer than the model shards cannot be
    head-sharded)."""

    def spec(name, shape):
        s = shd.param_spec(name, shape, cfg, mesh)
        if opt >= 1:
            s = _strip_dp(s)
        names = shd._names(name)
        if opt >= 3 and len(names) >= 2 and names[-2] in ("wk", "wv"):
            s = shd.P(*([None] * len(s)))
        return s

    return spec


def _on_mesh(step, mesh, *, grad: bool, seqpar: bool = False):
    """``step`` run under ``meshctx.use_mesh(mesh)``, with autograd on for
    a train step and off for serving, sequence-parallel decode as given."""

    def fn(*args):
        with meshctx.use_mesh(mesh), torch.set_grad_enabled(grad):
            meshctx.set_seqpar_decode(seqpar)
            try:
                return step(*args)
            finally:
                meshctx.set_seqpar_decode(False)

    return fn


def _placed_batch(cfg, mesh, batch: dict) -> dict:
    specs = shd.batch_specs(cfg, mesh, batch)
    return {k: meshctx.place(v, mesh, shd.to_placements(mesh, specs[k]))
            for k, v in batch.items()}


def train_cell(cfg, tcfg, mesh, B: int, S: int, *, constraints=True,
               stack=None):
    """``(fn, args)`` of one train step of ``cfg`` under ``tcfg`` on a
    B × S batch: ``make_train_step`` on a meta train state placed on
    ``mesh`` (``training.carry.place_state``; no mesh: the plain meta
    state). ``constraints``: the dry run's, the batch placed over the
    data-parallel axes and ``launch.sharding``'s batch and gradient
    constraints; else a whole batch and none, as a launcher's step.
    ``stack`` as ``make_train_step``'s."""
    from repro_torch.training import make_train_step
    from repro_torch.training.carry import place_state

    batch = _model_inputs(cfg, "train", B, S)
    kw = {}
    if constraints and mesh is not None:
        kw = dict(batch_constraint=shd.dp_batch_constraint(mesh),
                  grad_constraint=shd.expert_grad_constraint(cfg, mesh))
        batch = _placed_batch(cfg, mesh, batch)
    _, train_step, abstract_state = make_train_step(cfg, tcfg, stack=stack,
                                                    **kw)
    state = abstract_state()
    if mesh is not None:
        state = place_state(cfg, mesh, state)
    return _on_mesh(train_step, mesh, grad=True), (state, batch)


def serve_cell(cfg, kind: str, mesh, B: int, S: int, *, opt: int = 0,
               seqpar=None):
    """``(fn, args)`` of one serving step of ``cfg`` (``kind`` "prefill":
    the encoder's forward or ``prefill`` of B × S tokens; "decode": one
    token a row against an S-long cache, ``init_cache(..., abstract=True,
    mesh=)``), its meta parameters placed by ``serving_spec(opt)``; a
    decode sequence-parallel from ``opt`` 2 (or as ``seqpar`` says)."""
    from repro_torch.models.carry import place_params

    params = tf.abstract_params(cfg)
    if mesh is not None:
        params = place_params(cfg, mesh, params,
                              spec=serving_spec(cfg, mesh, opt))
    specs = _model_inputs(cfg, kind, B, S, mesh)
    if kind == "prefill":
        if cfg.family == "audio":  # encoder: "prefill" = full forward
            def prefill_step(params, batch):
                logits, _ = tf.forward_train(params, cfg, batch)
                return logits
        else:
            def prefill_step(params, batch):
                return tf.prefill(params, cfg, batch)
        return _on_mesh(prefill_step, mesh, grad=False), (params, specs)

    def decode_step(params, tokens, cache, pos):
        return tf.decode_step(params, cfg, tokens, cache, pos)

    # The cache row written is rank 0's (position 0); the counts do not
    # depend on the position.
    seqpar = opt >= 2 if seqpar is None else bool(seqpar)
    return (_on_mesh(decode_step, mesh, grad=False, seqpar=seqpar),
            (params, specs["tokens"], specs["cache"], 0))


def _lib_axes(mesh) -> tuple:
    return ("pod", "data") if "pod" in mesh.mesh_dim_names else ("data",)


def edm_batches(shape_name: str, mesh) -> tuple:
    """(B, batches): the library batch of the EDM cell's local engine on
    ``mesh`` (``core.ccm.auto_batch_libs`` on the rank's libraries, as
    ``sharded_ccm._local_block`` picks it on a device) and how many
    batches its libraries take."""
    from repro_torch.core.ccm import auto_batch_libs
    from repro_torch.core.embedding import num_embedded

    p = EDM_SHAPES[shape_name]
    nl = p["n_series"] // meshctx.dp_size(mesh)
    Lp = num_embedded(p["length"], p["E"], p["tau"])
    B = max(1, min(auto_batch_libs(Lp, nl, device="meta"), nl))
    return B, -(-nl // B)


def edm_cell(shape_name: str, mesh, *, n_batches=None):
    """``(fn, args)`` of the EDM cell: ``sharded_ccm.ccm_step`` of the
    (N, L) panel on ``mesh`` (libraries over the data-parallel axes,
    targets over "model", the plain versions: ``impl="ref"``), or, with
    ``n_batches``, the same engine on the first ``n_batches`` library
    batches of each rank (its probes)."""
    from repro_torch.distributed.sharded_ccm import ccm_step, \
        sharded_ccm_matrix

    p = EDM_SHAPES[shape_name]
    X = input_specs(EDM_ARCH, shape_name)["X"]
    kw = dict(E=p["E"], tau=p["tau"], mesh=mesh, lib_axes=_lib_axes(mesh),
              tgt_axes=("model",), impl="ref")
    if n_batches is None:
        return _on_mesh(lambda X: ccm_step(X, **kw), mesh, grad=False), (X,)
    B, _ = edm_batches(shape_name, mesh)
    libs = _meta((n_batches * B * meshctx.dp_size(mesh), p["length"]),
                 torch.float32)
    return (_on_mesh(lambda libs, X: sharded_ccm_matrix(
        libs, X, batch_libs=B, **kw), mesh, grad=False), (libs, X))


def build_cell(arch: str, shape_name: str, mesh, *, n_layers=None,
               microbatch=None, scan_layers=None, opt: int = 0,
               global_batch=None, seq_len=None, config=None, shape=None):
    """Returns ``(fn, args)``: ``fn(*args)`` runs the cell's step once on
    this rank's blocks (meta tensors).

    ``n_layers``/``microbatch`` override the config, ``global_batch`` and
    ``seq_len`` the shape's batch and length: the probes count a cut
    depth at the cell's microbatch size (``global_batch = microbatch × B /
    M``), and a prefill at a few chunks of its sequence.
    ``scan_layers`` overrides the layouts (stacked leaves and caches).
    ``config``/``shape`` stand in for the arch's ``ModelConfig`` and the
    shape's ``ShapeConfig`` (the tests' smoke configs).
    """
    if arch == EDM_ARCH:
        return edm_cell(shape_name, mesh)

    full = config if config is not None else get_config(arch)
    cfg = dataclasses.replace(
        full, n_layers=full.n_layers if n_layers is None else n_layers,
        scan_layers=(full.scan_layers if scan_layers is None
                     else scan_layers))
    sc = shape if shape is not None else SHAPES[shape_name]
    B = sc.global_batch if global_batch is None else int(global_batch)
    S = sc.seq_len if seq_len is None else int(seq_len)
    if sc.kind == "train":
        # Gradient accumulation (microbatch 8) is the production baseline.
        tcfg = TrainConfig(
            microbatch=(microbatch if microbatch is not None else
                        int(os.environ.get("DRYRUN_MICROBATCH", "8"))),
            optimizer=("adamw8bit"
                       if arch == "llama4-maverick-400b-a17b" else "adamw"))
        return train_cell(cfg, tcfg, mesh, B, S,
                          stack=full.n_units if cfg.scan_layers else 1)
    return serve_cell(cfg, sc.kind, mesh, B, S, opt=opt)


# -------------------------------------------------------------- counting

_COLL_OPS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
             "collective-permute")
_PORT_KIND = {"all_reduce_sum": "all-reduce", "all_reduce_max": "all-reduce",
              "all_gather": "all-gather", "reduce_scatter": "reduce-scatter"}
# Ops that read only their inputs' shapes.
_SHAPE_ONLY = ("empty", "empty_like", "empty_strided", "new_empty",
               "new_empty_strided", "zeros_like", "ones_like", "full_like",
               "new_zeros", "new_ones", "new_full", "detach")


def _tensors(tree):
    """The local tensors of a tree of dicts, lists, tuples, modules and
    (D)Tensors."""
    if isinstance(tree, torch.nn.Module):
        for p in tree.parameters():
            yield meshctx.local(p)
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)
    elif isinstance(tree, torch.Tensor):
        yield tree._local_tensor if meshctx.is_dtensor(tree) else tree


def _storages(tree) -> dict:
    """{storage key: (storage, bytes)} of a tree's local tensors."""
    out = {}
    for t in _tensors(tree):
        st = t.untyped_storage()
        out[st._cdata] = (st, st.nbytes())
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class _Counter(TorchDispatchMode):
    """FLOPs, bytes accessed, the live bytes' peak and the c10d ops of
    every op dispatched while it is on. FLOPs by
    ``torch.utils.flop_counter``'s formulas (``flop_registry``, what
    ``FlopCounterMode`` counts with; its own mode would double the count's
    time). Storages in ``held`` (the arguments') are not counted as
    made."""

    def __init__(self, held):
        from torch.utils.flop_counter import flop_registry

        super().__init__()
        self.formulas = flop_registry
        self.held = set(held)
        self.live: dict = {}
        self.cur = self.peak = 0
        self.bytes = 0
        self.ops = 0
        self.flops: collections.Counter = collections.Counter()
        self.c10d: collections.Counter = collections.Counter()

    def _free(self, key):
        self.cur -= self.live.pop(key, (0, None))[0]

    def _made(self, t):
        st = t.untyped_storage()
        key = st._cdata
        if key in self.live or key in self.held:
            return
        n = st.nbytes()
        self.live[key] = (n, weakref.ref(st, lambda _, k=key: self._free(k)))
        self.cur += n
        self.peak = max(self.peak, self.cur)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.ops += 1
        if func.namespace == "c10d":
            self.c10d[func.__name__.split(".")[0]] += 1
            return out
        formula = self.formulas.get(func._overloadpacket)
        if formula is not None:
            self.flops[str(func._overloadpacket)] += int(
                formula(*args, **kwargs, out_val=out))
        outs = list(_tensors(out))
        if not func.is_view:
            if func.__name__.split(".")[0] not in _SHAPE_ONLY:
                self.bytes += sum(_nbytes(t) for t in _tensors(
                    (args, kwargs)))
            self.bytes += sum(_nbytes(t) for t in outs)
        for t in outs:
            self._made(t)
        return out


def _counts_now(counter) -> dict:
    """{key: value} of the additive counts so far: FLOPs (total and by
    op), bytes accessed, ops, collectives by kind (the reference's and the
    port's: counts and result bytes) and the c10d ops dispatched."""
    out = {"flops": sum(counter.flops.values()),
           "bytes accessed": int(counter.bytes), "ops": counter.ops}
    for k, v in counter.flops.items():
        out[f"flops:{k}"] = v
    counts = meshctx.collective_counts()
    nbytes = meshctx.collective_bytes()
    for kind in _COLL_OPS:
        out[f"count:{kind}"] = out[f"bytes:{kind}"] = 0
    for k, n in counts.items():
        out[f"count:{_PORT_KIND[k]}"] += n
        out[f"bytes:{_PORT_KIND[k]}"] += nbytes.get(k, 0)
        out[f"port_count:{k}"] = n
        out[f"port_bytes:{k}"] = nbytes.get(k, 0)
    for k, n in counter.c10d.items():
        out[f"dispatched:{k}"] = n
    return out


def analyze(fn, args) -> dict:
    """One run of ``fn(*args)`` on this rank, counted: ``cost``,
    ``memory``, ``collectives`` (the module docstring) and ``count_s``."""
    held = _storages(args)
    meshctx.reset_collective_counts()
    counter = _Counter(held)
    t0 = time.perf_counter()
    with counter:
        out = fn(*args)
    count_s = time.perf_counter() - t0
    got = _storages(out)
    flat = _counts_now(counter)
    flat.update({
        "argument_size_in_bytes": sum(n for _, n in held.values()),
        "output_size_in_bytes": sum(n for _, n in got.values()),
        "temp_size_in_bytes": int(counter.peak),
        "alias_size_in_bytes": sum(n for k, (_, n) in got.items()
                                   if k in held)})
    del out, got
    rec = _record_of(flat)
    rec["count_s"] = count_s
    return rec


# ----------------------------------------------------------------- probes

_MEM_KEYS = ("argument_size_in_bytes", "output_size_in_bytes",
             "temp_size_in_bytes", "alias_size_in_bytes")


def _prefixed(flat, prefix) -> dict:
    return {k[len(prefix):]: v for k, v in flat.items()
            if k.startswith(prefix)}


def _record_of(flat: dict) -> dict:
    """The record's ``cost``, ``memory`` and ``collectives`` from
    ``{key: value}`` (``_counts_now``'s keys and the memory's)."""
    col = {"bytes_by_kind": {k: flat.get(f"bytes:{k}", 0)
                             for k in _COLL_OPS},
           "counts": {k: flat.get(f"count:{k}", 0) for k in _COLL_OPS}}
    col["total"] = sum(col["bytes_by_kind"].values())
    col["by_port_kind"] = {"counts": _prefixed(flat, "port_count:"),
                           "bytes": _prefixed(flat, "port_bytes:")}
    col["dispatched"] = _prefixed(flat, "dispatched:")
    return {"cost": {"flops": flat["flops"],
                     "bytes accessed": flat["bytes accessed"],
                     "flops_by_op": _prefixed(flat, "flops:"),
                     "ops": flat.get("ops", 0)},
            "memory": {k: flat[k] for k in _MEM_KEYS if k in flat},
            "collectives": col}


def _flat(rec) -> dict:
    """``_record_of``'s inverse: ``{key: value}`` of a record."""
    col = rec["collectives"]
    out = {"flops": rec["cost"]["flops"],
           "bytes accessed": rec["cost"]["bytes accessed"],
           "ops": rec["cost"].get("ops", 0), **rec["memory"]}
    for kind in _COLL_OPS:
        out[f"count:{kind}"] = col["counts"][kind]
        out[f"bytes:{kind}"] = col["bytes_by_kind"][kind]
    for pre, d in (("port_count:", col["by_port_kind"]["counts"]),
                   ("port_bytes:", col["by_port_kind"]["bytes"]),
                   ("dispatched:", col["dispatched"]),
                   ("flops:", rec["cost"]["flops_by_op"])):
        out.update({pre + k: v for k, v in d.items()})
    return out


def probe_points(units: int, micro) -> tuple:
    """(unit counts, microbatch counts or None) a cell of ``units`` units
    and ``micro`` microbatches (None: not a train cell) is counted at."""
    us = (1, 2) if units > 1 else (1,)
    if micro is None:
        return us, None
    return us, (micro,) if micro <= 3 else (2, 3)


def _extend(lo: dict, hi: dict, steps: int) -> dict:
    """``lo + steps·(hi − lo)`` key by key (a key missing counts 0): the
    line through two probes one step apart, ``steps`` past the first."""
    return {k: lo.get(k, 0) + steps * (hi.get(k, 0) - lo.get(k, 0))
            for k in set(lo) | set(hi)}


def probe(build, units: int, micro, plen: int, batch=None) -> dict:
    """Count ``build(n_layers=, microbatch=, global_batch=) → (fn, args)``
    at the probe points and extrapolate to ``units`` units and ``micro``
    microbatches (None: not a train cell) of a ``batch``-row global batch.

    Every count is ``C0 + U·Cu + M·(Cm + U·Cmu)``, an integer. One unit
    and two units give the units' line. A train cell of M ≥ 4
    microbatches is counted at two and three microbatches of the cell's
    size (``global_batch = m·batch/M``), which give the microbatches'
    line: from two on, each microbatch adds the same ops (the first
    differs: its gradients land on none, and one microbatch alone takes no
    constraints), and the gather of the placed batch grows with the global
    batch. Arguments, outputs and the peak of live bytes follow the same
    lines. Returns ``analyze``'s record layout plus ``probe``: the points'
    counts (``points``: each unit count at the cell's microbatches;
    ``microbatch_points``: as counted) and seconds."""
    us, ms = probe_points(units, micro)
    counted, secs = {}, {}
    for u in us:
        for m in ms or (None,):
            over = {"n_layers": u * plen}
            if m is not None:
                over.update(microbatch=m, global_batch=m * batch // micro)
            fn, args = build(**over)
            rec = analyze(fn, args)
            del fn, args
            key = str(u) if m is None else f"{u}x{m}"
            counted[key], secs[key] = _flat(rec), rec["count_s"]
    if ms is None:
        points = counted
    else:
        points = {str(u): _extend(counted[f"{u}x{ms[0]}"],
                                  counted[f"{u}x{ms[-1]}"], micro - ms[0])
                  for u in us}
    out = points["1"]
    if len(us) > 1:
        out = _extend(points["1"], points["2"], units - 1)
    rec = _record_of(out)
    rec["probe"] = {"units": units, "microbatches": micro,
                    "unit_counts": list(us),
                    "microbatch_counts": None if ms is None else list(ms),
                    "points": points, "count_s": secs}
    if ms is not None:
        rec["probe"]["microbatch_points"] = counted
    rec["count_s"] = sum(secs.values())
    return rec


def probe_edm(shape_name: str, mesh) -> dict:
    """The EDM cell's counts through probes: its engine runs the rank's
    libraries in batches of one size (a ragged last batch padded), so
    every count is ``C0 + n·Cb`` in the batch count n, from counts at one
    and two batches. The argument is the panel alone."""
    B, nb = edm_batches(shape_name, mesh)
    points, secs = {}, {}
    for n in (1, 2) if nb > 1 else (1,):
        fn, args = edm_cell(shape_name, mesh, n_batches=n)
        rec = analyze(fn, args)
        del fn, args
        points[n], secs[str(n)] = _flat(rec), rec["count_s"]
    out = points[1] if nb == 1 else _extend(points[1], points[2], nb - 1)
    X = input_specs(EDM_ARCH, shape_name)["X"]
    out["argument_size_in_bytes"] = _nbytes(X)
    rec = _record_of(out)
    rec["probe"] = {"library_batch": B, "batches": nb,
                    "points": {str(n): p for n, p in points.items()},
                    "count_s": secs}
    rec["count_s"] = sum(secs.values())
    return rec


def cell_size(cfg, sc, *, microbatch=None) -> tuple:
    """(units, microbatches or None, pattern length) of a model cell of
    config ``cfg`` and shape ``sc``."""
    if sc.kind != "train":
        return cfg.n_units, None, len(cfg.pattern)
    m = (microbatch if microbatch is not None else
         int(os.environ.get("DRYRUN_MICROBATCH", "8")))
    return cfg.n_units, max(m, 1), len(cfg.pattern)


def count_cell(arch: str, shape_name: str, mesh, *, opt: int = 0,
               direct: bool = False, config=None, shape=None) -> dict:
    """A cell's counts on ``mesh``: through the probes, or (``direct``)
    one count of the cell itself. ``config``, ``shape``: as
    ``build_cell``'s."""
    over = dict(opt=opt, config=config, shape=shape)
    if arch == EDM_ARCH and not direct:
        rec = probe_edm(shape_name, mesh)
        rec["counted"] = "probes"
        return rec
    if direct:
        fn, args = build_cell(arch, shape_name, mesh, **over)
        rec = analyze(fn, args)
        del fn, args
        rec["counted"] = "direct"
        return rec
    cfg = config if config is not None else get_config(arch)
    sc = shape if shape is not None else SHAPES[shape_name]
    units, micro, plen = cell_size(cfg, sc)
    chunks = seq_chunks(cfg, sc)
    if chunks is None:
        rec = probe(lambda **o: build_cell(arch, shape_name, mesh, **over,
                                           **o),
                    units, micro, plen, sc.global_batch)
    else:
        cq, n_cell = chunks
        rec = probe_seq(lambda n: probe(
            lambda **o: build_cell(arch, shape_name, mesh, **over,
                                   seq_len=n * cq, **o),
            units, micro, plen, sc.global_batch), n_cell)
    rec["counted"] = "probes"
    return rec


SEQ_PROBES = (3, 4, 5)


def seq_chunks(cfg, sc):
    """(chunk length, the sequence's count of chunks) when a cell is
    counted through sequence probes, else None. The chunk is the
    attention's (``attn_chunk_q``; every probe must take the chunked
    attention: longer than ``attn_full_max``) or, in a model without
    attention, its recurrent layers' (``xlstm.chunk``, ``mamba.chunk``).
    A prefill is probed when it is longer than ``SEQ_PROBES`` chunks; a
    train step when the probes' 3 + 4 + 5 chunks are fewer than its own
    (each is counted at two and three microbatches and two depths) and it
    has no attention: the bytes a chunked attention's backward accesses
    are not quadratic in its chunks (no production train cell is long
    enough to be probed so)."""
    from repro_torch.models.transformer import ATTN_KINDS

    if any(k in ATTN_KINDS for k in cfg.pattern):
        if sc.kind == "train":
            return None
        cq = cfg.attn_chunk_q
        if SEQ_PROBES[0] * cq <= cfg.attn_full_max:
            return None
    elif cfg.xlstm is not None or cfg.mamba is not None:
        cq = (cfg.xlstm or cfg.mamba).chunk
    else:
        return None
    n = sc.seq_len // cq
    least = {"prefill": SEQ_PROBES[-1], "train": sum(SEQ_PROBES)}
    if sc.kind not in least or sc.seq_len % cq or n <= least[sc.kind]:
        return None
    return cq, n


def fit_seq(flats, chunks: int) -> dict:
    """``{key: value}`` at ``chunks`` chunks from the flat counts at 3, 4
    and 5 (``probe_seq``'s model)."""
    f3, f4, f5 = flats
    a, b = chunks - 3, (chunks - 3) * (chunks - 4) // 2
    out = {k: f3.get(k, 0) + a * (f4.get(k, 0) - f3.get(k, 0))
           + b * (f5.get(k, 0) - 2 * f4.get(k, 0) + f3.get(k, 0))
           for k in set(f3) | set(f4) | set(f5)}
    k = "temp_size_in_bytes"
    if k in f5:
        out[k] = f5[k] + (chunks - 5) * (f5[k] - f4[k])
    return out


def probe_seq(count, chunks: int) -> dict:
    """A cell's counts at ``chunks`` chunks of its sequence from
    ``count(n)`` (a probed record at n chunks) at n = 3, 4, 5. Each count
    is a polynomial of degree two in n: the chunked attention visits every
    (query, key) chunk pair, and the rest grows with the tokens (the
    recurrent layers' loops over time steps too; the MoE's capacity where
    the tokens a rank routes, times top-k and the capacity factor, divide
    by the experts, as they do at every probe of every production cell).
    The peak of live bytes grows with the tokens where it is held (a
    forward's activations and caches) but steps where the op holding it
    changes: it takes the line through the two longest probes, an
    estimate (short where a steeper holder takes over past the probes)."""
    recs = {n: count(n) for n in SEQ_PROBES}
    rec = _record_of(fit_seq([_flat(recs[n]) for n in SEQ_PROBES], chunks))
    rec["probe"] = dict(recs[SEQ_PROBES[0]]["probe"], seq_chunks=chunks,
                        seq_probe_chunks=list(SEQ_PROBES),
                        seq_points={str(n): r["probe"]
                                    for n, r in recs.items()})
    rec["count_s"] = sum(r["count_s"] for r in recs.values())
    return rec


# ------------------------------------------------------------------- CLI


def run_cell(arch: str, shape_name: str, mesh_kind: str, opt: int = 0, *,
             device_type: str = "cuda", mesh=None, config=None,
             shape=None) -> dict:
    """The record of one cell on the production mesh of ``mesh_kind`` (or
    on ``mesh``, a mesh of the caller's world); a cell that raises is
    recorded with ``status: error``."""
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
           "devices": (MESH_RANKS[mesh_kind] if mesh is None
                       else mesh.size()),
           "status": "ok", "opt": opt}
    t0 = time.time()
    try:
        if mesh is None:
            mesh = production_mesh(mesh_kind, device_type=device_type)
        rec["device_type"] = mesh.device_type
        rec.update(count_cell(arch, shape_name, mesh, opt=opt,
                              config=config, shape=shape))
    except Exception as e:
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-3000:]
    rec["total_s"] = round(time.time() - t0, 2)
    return rec


def all_cells() -> list:
    todo = [(a, s) for a in ARCHS for s in cells(a)]
    return todo + [(EDM_ARCH, s) for s in EDM_SHAPES]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single", choices=["single", "multi",
                                                         "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="experiments/dryrun")
    ap.add_argument("--opt", type=int, default=0,
                    help="perf-iteration level (1: TP-only serving params, "
                         "2: + sequence-parallel KV decode, 3: + replicated "
                         "K/V projections)")
    ap.add_argument("--device", default="cuda",
                    help="the production mesh's device type (cuda or cpu)")
    args = ap.parse_args(argv)

    os.makedirs(args.out, exist_ok=True)
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    if args.all:
        todo = all_cells()
    elif args.arch and args.shape:
        todo = [(args.arch, args.shape)]
    elif args.arch:  # every cell of one arch
        todo = [(a, s) for a, s in all_cells() if a == args.arch]
    else:
        ap.error("--arch [--shape] or --all")

    n_bad = 0
    for mesh_kind in meshes:  # one world switch at most
        for arch, shape_name in todo:
            suffix = f"__opt{args.opt}" if args.opt else ""
            name = f"{arch}__{shape_name}__{mesh_kind}{suffix}"
            path = os.path.join(args.out, name + ".json")
            rec = run_cell(arch, shape_name, mesh_kind, opt=args.opt,
                           device_type=args.device)
            with open(path, "w") as f:
                json.dump(rec, f, indent=1)
            cost = rec.get("cost", {})
            print(f"[dryrun] {name}: {rec['status']} "
                  f"count={rec.get('count_s', 0):.2f}s "
                  f"flops={cost.get('flops', 0):.3e} "
                  f"coll={rec.get('collectives', {}).get('total', 0):.3e}B",
                  flush=True)
            if rec["status"] != "ok":
                n_bad += 1
                print(rec["error"], flush=True)
    return n_bad


if __name__ == "__main__":
    main()
