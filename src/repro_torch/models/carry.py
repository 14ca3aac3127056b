"""Carry a reference model's weights and caches into the port.

The reference's parameter tree (``repro.models.init_params``) as numpy
arrays — ``jax.tree.map(np.asarray, params)`` — becomes the port's
parameter module: under ``cfg.scan_layers`` the leading (n_units,) axis of
``units`` is unstacked into ``units.<u>``; a list of units maps one to
one. A cache tree (``init_cache``, ``decode_step``) keeps the reference's
layout in the port, so it is only checked and moved to the device.

``place_params`` puts a parameter tree on a mesh by
``launch.sharding.param_spec``: a carried module is cut leaf by leaf, and
a generated one is drawn leaf by leaf, each rank keeping its block.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.models import transformer as tf


def flatten_tree(tree, prefix=()):
    """[(path, leaf)] of a tree of dicts and lists, in key order."""
    if isinstance(tree, dict):
        return [item for k in tree for item in flatten_tree(tree[k],
                                                            prefix + (k,))]
    if isinstance(tree, (list, tuple)):
        return [item for i, v in enumerate(tree)
                for item in flatten_tree(v, prefix + (i,))]
    return [(prefix, tree)]


def _tensor(a, path, want: torch.Tensor, device) -> torch.Tensor:
    """``a`` as a tensor of ``want``'s shape and dtype on ``device``; raises
    naming the reference path when either differs."""
    a = np.asarray(a)
    name = "/".join(map(str, path))
    if tuple(a.shape) != tuple(want.shape):
        raise ValueError(f"{name}: shape {tuple(a.shape)}, the port wants "
                         f"{tuple(want.shape)}")
    if a.dtype.name != str(want.dtype).removeprefix("torch."):
        raise ValueError(f"{name}: dtype {a.dtype.name}, the port wants "
                         f"{want.dtype}")
    if a.dtype.name == "bfloat16":  # numpy has no bfloat16: go by float32
        return torch.from_numpy(a.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(device)


def port_names(cfg, path):
    """The port's parameter name(s) of one reference leaf path, each with
    the index into the leaf that it takes."""
    if path[0] != "units":
        return [(".".join(path), ())]
    if cfg.scan_layers:
        return [(".".join(("units", str(u)) + path[1:]), (u,))
                for u in range(cfg.n_units)]
    return [(".".join(("units",) + tuple(map(str, path[1:]))), ())]


def params_from_numpy(cfg, tree, *, device):
    """The port's parameter module on ``device`` holding the reference's
    weights ``tree`` (nested dicts of numpy arrays); loaded with
    ``strict=True`` after every shape and dtype is checked."""
    model = tf.abstract_params(cfg)
    want = dict(model.named_parameters())
    state = {}
    for path, leaf in flatten_tree(tree):
        leaf = np.asarray(leaf)
        for name, idx in port_names(cfg, path):
            if name not in want:
                raise ValueError(f"{'/'.join(map(str, path))}: the port has "
                                 f"no parameter {name}")
            state[name] = _tensor(leaf[idx] if idx else leaf,
                                  path + idx, want[name], device)
    model = model.to_empty(device=device)
    model.load_state_dict(state, strict=True)
    return model


def cache_from_numpy(cfg, tree, *, device):
    """The reference's cache ``tree`` (numpy leaves; ``init_cache``'s
    layout) as the port's cache on ``device``, every leaf checked against
    ``init_cache``'s shape and dtype for the tree's batch and S_max."""
    leaves = flatten_tree(tree)
    lead = 1 if cfg.scan_layers else 0
    batch = np.asarray(leaves[0][1]).shape[lead]
    s_max = next((np.asarray(a).shape[lead + 1]
                  for p, a in leaves if p[-1] in ("k", "c_kv")), 1)
    out = tf.init_cache(cfg, batch, s_max, abstract=True)
    want = dict(flatten_tree(out))
    if set(want) != {p for p, _ in leaves}:
        raise ValueError(
            f"cache tree has leaves {sorted(map(str, (p for p, _ in leaves)))}"
            f"; the port's init_cache has {sorted(map(str, want))}")
    for path, leaf in leaves:
        node = out
        for k in path[:-1]:
            node = node[k]
        node[path[-1]] = _tensor(leaf, path, want[path], device)
    return out


def place_params(cfg, mesh, params=None, *, generator=None, device=None,
                 spec=None):
    """The parameter module of ``cfg`` with every leaf a DTensor on
    ``mesh``, placed by ``param_spec`` (or by ``spec(name, shape)``, a rule
    of the same signature: the dry run's serving specs).

    ``params``: a whole module (e.g. ``params_from_numpy``), each leaf cut
    to this rank's block. Without it the weights are drawn as
    ``init_params(cfg, device=, generator=)`` draws them (a generator
    seeded 0 on the mesh's device when None), one leaf at a time: each
    whole leaf is made, its block kept and the rest freed, so no rank
    holds the whole model and every block is bit-equal to that slice of
    the world of one's weights.
    """
    from repro_torch.launch.sharding import param_spec, to_placements
    from repro_torch.models import meshctx
    from repro_torch.models.layers import Params

    if spec is None:
        def spec(name, shape):
            return param_spec(name, shape, cfg, mesh)

    def placed(name, t):
        pl = to_placements(mesh, spec(name, t.shape))
        return meshctx.place(t.detach(), mesh, pl)

    if params is not None:
        tree: dict = {}
        for name, t in params.named_parameters():
            node = tree
            *path, leaf = name.split(".")
            for k in path:
                node = node.setdefault(k, {})
            node[leaf] = placed(name, t)
        return Params(_lists(tree))

    # The draw order's names, from a pass on the meta device.
    drawn: list = []
    meta = tf.param_tree(cfg, tf.init_rng("meta", keep=lambda t: (
        drawn.append(t), t)[1]))
    order = {id(t): i for i, t in enumerate(drawn)}
    names = [None] * len(drawn)
    for path, t in flatten_tree(meta):
        if id(t) in order:
            names[order[id(t)]] = ".".join(map(str, path))
    kept = iter(range(len(names)))

    def keep(t):
        return placed(names[next(kept)], t)

    dev = device if device is not None else mesh.device_type
    tree = tf.param_tree(cfg, tf.init_rng(dev, generator, keep))
    return Params(_lists(_place_rest(tree, placed)))


def _place_rest(tree, placed, prefix=()):
    """Place the leaves not drawn through ``keep`` (zeros, ones, computed
    vectors); drawn leaves are DTensors already."""
    from repro_torch.models import meshctx

    if isinstance(tree, dict):
        return {k: _place_rest(v, placed, prefix + (k,))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_place_rest(v, placed, prefix + (str(i),))
                for i, v in enumerate(tree)]
    if meshctx.is_dtensor(tree):
        return tree
    return placed(".".join(prefix), tree)


def _lists(tree):
    """Nested dicts keyed by unit index ("0", "1", ...) as lists."""
    if not isinstance(tree, dict):
        return tree
    if tree and all(k.isdigit() for k in tree):
        return [_lists(tree[str(i)]) for i in range(len(tree))]
    return {k: _lists(v) for k, v in tree.items()}
