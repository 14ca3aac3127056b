"""Carry a reference train state into the port, and back.

The reference's state (``repro.training.make_train_step``'s
``init_state``, or one taken mid-run), its leaves as numpy arrays —
``{"params", "opt": {"step", "m", "v"}, "ebuf"}`` — becomes the port's:
the weights through ``repro_torch.models.carry.params_from_numpy``, and
the moments (float32, or 8-bit ``{"q", "scale"}``) and error buffers by
the port's parameter names, the leading (n_units,) axis of a scanned
model's ``units`` leaves unstacked into ``units.<u>``. Every leaf is
checked against the port's own layout (``abstract_state``), and a shape,
dtype or codec that differs raises, naming the reference path.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.models import carry as mcarry
from repro_torch.models import meshctx
from repro_torch.training.step import make_train_step


def _node(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _moments(cfg, params_tree, tree, want, where, device):
    """{port name: moment} of the reference's moment ``tree``."""
    out = {}
    paths = [p for p, _ in mcarry.flatten_tree(params_tree)]
    n_leaves = len(mcarry.flatten_tree(tree))
    seen = 0
    for path in paths:
        try:
            node = _node(tree, path)
        except (KeyError, IndexError, TypeError):
            raise ValueError(f"{'/'.join(map(str, where + path))}: missing "
                             f"from the reference state") from None
        for name, idx in mcarry.port_names(cfg, path):
            w = want[name]
            if isinstance(w, dict) != isinstance(node, dict):
                raise ValueError(
                    f"{'/'.join(map(str, where + path))}: "
                    f"{'8-bit codes' if isinstance(node, dict) else 'float32'}"
                    f" in the reference state, the port keeps "
                    f"{'8-bit codes' if isinstance(w, dict) else 'float32'}")
            if isinstance(w, dict):
                out[name] = {k: mcarry._tensor(
                    np.asarray(node[k])[idx] if idx else node[k],
                    where + path + (k,) + idx, w[k], device) for k in w}
            else:
                out[name] = mcarry._tensor(
                    np.asarray(node)[idx] if idx else node,
                    where + path + idx, w, device)
        seen += len(mcarry.flatten_tree(node))
    if seen != n_leaves:
        raise ValueError(f"{'/'.join(where)}: {n_leaves} leaves in the "
                         f"reference state, {seen} matched to parameters")
    return out


def state_from_numpy(cfg, tcfg, tree, *, device, mesh=None):
    """The port's train state on ``device`` holding the reference's state
    ``tree`` (numpy leaves), for ``make_train_step(cfg, tcfg)``; with
    ``mesh``, placed on it (``place_state``)."""
    if mesh is not None:
        return place_state(cfg, mesh, state_from_numpy(cfg, tcfg, tree,
                                                       device=device))
    want = make_train_step(cfg, tcfg)[2]()
    if ("ebuf" in want) != ("ebuf" in tree):
        raise ValueError(
            f"ebuf: the reference state {'has' if 'ebuf' in tree else 'lacks'}"
            f" error buffers, grad_compression={tcfg.grad_compression!r}")
    state = {"params": mcarry.params_from_numpy(cfg, tree["params"],
                                                device=device)}
    opt = tree["opt"]
    state["opt"] = {"step": mcarry._tensor(
        np.asarray(opt["step"]), ("opt", "step"), want["opt"]["step"],
        device)}
    for key in ("m", "v"):
        state["opt"][key] = _moments(cfg, tree["params"], opt[key],
                                     want["opt"][key], ("opt", key), device)
    if "ebuf" in want:
        state["ebuf"] = _moments(cfg, tree["params"], tree["ebuf"],
                                 want["ebuf"], ("ebuf",), device)
    return state


def _host(t: torch.Tensor) -> np.ndarray:
    t = meshctx.full(t.detach()).cpu()
    # a copy: the state is updated in place by the next step
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy().copy()


def _insert(tree: dict, path, value):
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def _listify(tree):
    """Dicts keyed 0..n−1 (the reference's unit lists) as lists."""
    if not isinstance(tree, dict):
        return tree
    out = {k: _listify(v) for k, v in tree.items()}
    if out and all(isinstance(k, int) for k in out):
        return [out[i] for i in range(len(out))]
    return out


def _tree_of(cfg, named: dict) -> dict:
    """{port name: numpy leaf or codes} as the reference's nested tree,
    ``units.<u>`` stacked along a leading axis under ``scan_layers``."""
    groups: dict[tuple, list] = {}
    for name, leaf in named.items():
        parts = tuple(int(p) if p.isdigit() else p for p in name.split("."))
        if cfg.scan_layers and parts[0] == "units":
            groups.setdefault(("units",) + parts[2:], []).append(
                (parts[1], leaf))
        else:
            groups[parts] = [(None, leaf)]
    tree: dict = {}
    for path, items in groups.items():
        if items[0][0] is None:
            value = items[0][1]
        else:
            items.sort(key=lambda it: it[0])
            first = items[0][1]
            value = ({k: np.stack([it[1][k] for it in items]) for k in first}
                     if isinstance(first, dict)
                     else np.stack([it[1] for it in items]))
        _insert(tree, path, value)
    return _listify(tree)


def state_to_numpy(cfg, state) -> dict:
    """The port's train state as the reference's tree of numpy arrays
    (bf16 leaves as float32: numpy has no bfloat16). A placed state is
    gathered whole (every rank of its mesh calls this)."""
    def leaves(d):
        return {n: ({k: _host(x) for k, x in v.items()}
                    if isinstance(v, dict) else _host(v))
                for n, v in d.items()}

    out = {"params": _tree_of(cfg, leaves(dict(
        state["params"].named_parameters()))),
        "opt": {"step": _host(state["opt"]["step"]),
                "m": _tree_of(cfg, leaves(state["opt"]["m"])),
                "v": _tree_of(cfg, leaves(state["opt"]["v"]))}}
    if "ebuf" in state:
        out["ebuf"] = _tree_of(cfg, leaves(state["ebuf"]))
    return out


# ------------------------------------------------------- placed states


def _placements(mesh, spec):
    from repro_torch.launch.sharding import to_placements

    return to_placements(mesh, spec)


def _map_state(state, specs, fn):
    """``fn(leaf, spec)`` over the non-parameter leaves of a train state
    (step, moments or their codes, error buffers)."""
    out = {"opt": {"step": fn(state["opt"]["step"], specs["opt"]["step"])}}
    for key in ("m", "v"):
        out["opt"][key] = {
            n: ({k: fn(x, specs["opt"][key][n][k]) for k, x in m.items()}
                if isinstance(m, dict) else fn(m, specs["opt"][key][n]))
            for n, m in state["opt"][key].items()}
    if "ebuf" in state:
        out["ebuf"] = {n: fn(x, specs["ebuf"][n])
                       for n, x in state["ebuf"].items()}
    return out


def place_state(cfg, mesh, state):
    """A whole train state (``init_state`` without a mesh, or
    ``state_from_numpy``) placed on ``mesh`` by
    ``launch.sharding.state_specs``: every leaf a DTensor holding this
    rank's block (the parameters by ``models.carry.place_params``)."""
    from repro_torch.launch.sharding import state_specs
    specs = state_specs(cfg, mesh, state)
    rest = _map_state(state, specs, lambda t, spec: meshctx.place(
        t, mesh, _placements(mesh, spec)))
    return {"params": mcarry.place_params(cfg, mesh, state["params"]),
            **rest}


def init_placed_state(cfg, tcfg, mesh, *, generator=None, device=None):
    """``make_train_step(cfg, tcfg)``'s initial state placed on ``mesh``
    by ``state_specs`` with no rank holding the whole: the weights drawn
    leaf by leaf as ``models.carry.place_params`` draws them (each block
    bit-equal to that slice of the world of one's draw), the moments and
    error buffers made as zeros of each rank's block."""
    from torch.distributed.tensor import DTensor

    from repro_torch.launch.sharding import state_specs

    abstract = make_train_step(cfg, tcfg)[2]()
    specs = state_specs(cfg, mesh, abstract)
    dev = torch.device(device if device is not None else mesh.device_type)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())

    def zeros(t, spec):
        pl = _placements(mesh, spec)
        shape = list(t.shape)
        for i, p in enumerate(pl):
            if p.is_shard():
                shape[p.dim] //= mesh.size(i)
        return DTensor.from_local(
            torch.zeros(shape, dtype=t.dtype, device=dev), mesh, pl,
            run_check=False, shape=t.shape, stride=t.stride())

    params = mcarry.place_params(cfg, mesh, generator=generator, device=dev)
    return {"params": params, **_map_state(abstract, specs, zeros)}
