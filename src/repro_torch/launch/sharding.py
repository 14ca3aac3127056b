"""Sharding rules: parameter, optimizer, batch and cache specs (the port of
``repro.launch.sharding``), and their placements on a ``DeviceMesh``.

Strategy, as the reference's:
  * tensor parallel over "model": attention head projections (flattened
    head dim), MLP hidden, vocab, MoE experts, SSM inner dims;
  * FSDP over "data" (+ "pod"): the d_model axis of weight matrices, the
    optimizer state sharded with its parameter;
  * activations: batch over ("pod", "data"); decode KV caches shard the
    *sequence* axis over "model" (sequence-parallel KV decode);
  * a dim the axes do not divide is replicated (qwen's 20 heads, hubert's
    504-class head).

A spec (``P``) has one entry per tensor dim: None, a mesh axis name, or a
tuple of names (a dim sharded over several axes, first axis major). A
one-name tuple is written as the name, as JAX writes it. The rules key on
the reference's tree path: the port's parameter names are those paths
with a unit's index in place of the stacked axis (``units.3.l0.mix.wq.w``
for the stacked ``units/l0/mix/wq/w``), and a port leaf's spec is the
reference's spec of the stacked leaf without its leading None.
``to_placements`` turns a spec into one ``Placement`` per mesh dim.
"""

from __future__ import annotations

import dataclasses

from repro_torch.launch.mesh import axis_size, dp_axes, mesh_sizes


class P(tuple):
    """A partition spec: one entry per tensor dim (None, an axis name, or a
    tuple of axis names)."""

    def __new__(cls, *dims):
        return super().__new__(cls, tuple(
            d[0] if isinstance(d, tuple) and len(d) == 1 else d
            for d in dims))

    def __repr__(self):
        return "P(" + ", ".join(map(repr, self)) + ")"


def _div(n: int, mesh, axes) -> bool:
    return axes is not None and n % axis_size(mesh, axes) == 0


def _maybe(n, mesh, axes):
    """axes if they divide n evenly, else None (replicate)."""
    if axes is None:
        return None
    return axes if _div(n, mesh, axes) else None


def _names(name) -> list:
    """A parameter's path keys without list indices (a unit's number)."""
    parts = name.split(".") if isinstance(name, str) else list(name)
    return [str(p) for p in parts if not str(p).isdigit()]


def param_spec(name, shape, cfg, mesh) -> P:
    """The spec of one parameter: ``name`` its port name (or path),
    ``shape`` the port leaf's shape (or a tensor)."""
    names = _names(name)
    core = tuple(getattr(shape, "shape", shape))
    dp = dp_axes(mesh)
    leaf = names[-1] if names else ""
    parent = names[-2] if len(names) >= 2 else ""

    # ---- 1-D leaves: biases, norms, per-channel vectors
    if len(core) == 0:
        return P()
    if len(core) == 1:
        if leaf in ("b", "conv_b", "D_skip"):
            return P(_maybe(core[0], mesh, "model"))
        return P(None)

    # ---- embeddings / lm head: (vocab, d_model), d_model not FSDP-sharded
    if leaf == "table":
        return P(_maybe(core[0], mesh, "model"), None)

    # ---- MoE expert banks: (E, D, F) / (E, F, D), experts over model
    if parent == "mlp" and len(core) == 3:
        return P(_maybe(core[0], mesh, "model"), _maybe(core[1], mesh, dp),
                 None)
    if leaf == "router":
        return P(_maybe(core[0], mesh, dp), None)

    # ---- sLSTM recurrent blocks: (H, dh, dh)
    if leaf == "r" and len(core) == 3:
        return P(None, None, _maybe(core[2], mesh, "model"))

    # ---- projections INTO the sharded inner dim: (d_model, X)
    if parent in ("wq", "wk", "wv", "w_gate", "w_up", "up", "in_proj",
                  "w_dkv", "w_kr", "wq_full", "ffn_gate", "ffn_up") or (
            leaf == "w" and parent in ("wi", "wf")):
        return P(_maybe(core[0], mesh, dp), _maybe(core[1], mesh, "model"))

    # ---- projections OUT of the sharded inner dim: (X, d_model)
    if parent in ("wo", "w_down", "down", "out_proj", "ffn_down",
                  "w_uk", "w_uv", "dt_proj"):
        return P(_maybe(core[0], mesh, "model"), _maybe(core[1], mesh, dp))

    # ---- mamba: conv (K, d_in), x_proj (d_in, R+2N), A_log (d_in, N)
    if parent == "mix" and leaf == "conv_w":
        return P(None, _maybe(core[1], mesh, "model"))
    if parent == "x_proj":
        return P(_maybe(core[0], mesh, "model"), None)
    if leaf == "A_log":
        return P(_maybe(core[0], mesh, "model"), None)

    # ---- generic: model on the last divisible dim, dp on another
    dims = [None] * len(core)
    for i in reversed(range(len(core))):
        if _div(core[i], mesh, "model"):
            dims[i] = "model"
            break
    for i in range(len(core)):
        if dims[i] is None and _div(core[i], mesh, dp):
            dims[i] = dp
            break
    return P(*dims)


def param_specs(cfg, mesh, params) -> dict:
    """{name: spec} of a parameter module (or a {name: tensor} dict)."""
    items = (params.named_parameters() if hasattr(params, "named_parameters")
             else params.items())
    return {n: param_spec(n, t.shape, cfg, mesh) for n, t in items}


def state_specs(cfg, mesh, state) -> dict:
    """Specs of a train state of ``repro_torch.training.make_train_step``:
    ``{"params", "opt": {"step", "m", "v"}, "ebuf"}``. A moment shares its
    parameter's rule; an 8-bit moment's ``q`` and ``scale`` each take the
    rule of their parameter's name at their own shape, as the reference's
    last-axis codec does."""

    def moment(name, m):
        if isinstance(m, dict):
            return {k: param_spec(name, v.shape, cfg, mesh)
                    for k, v in m.items()}
        return param_spec(name, m.shape, cfg, mesh)

    specs = {"params": param_specs(cfg, mesh, state["params"]),
             "opt": {"step": P()}}
    for key in ("m", "v"):
        specs["opt"][key] = {n: moment(n, m)
                             for n, m in state["opt"][key].items()}
    if "ebuf" in state:
        specs["ebuf"] = param_specs(cfg, mesh, state["ebuf"])
    return specs


def batch_specs(cfg, mesh, batch) -> dict:
    """Every batch leaf: batch over dp where divisible."""
    dp = dp_axes(mesh)
    return {k: P(_maybe(x.shape[0], mesh, dp), *([None] * (x.ndim - 1)))
            for k, x in batch.items()}


def cache_specs(cfg, mesh, cache):
    """Decode caches (``init_cache``'s tree, the reference's layout): batch
    over dp where divisible; the attention and MLA caches' sequence axis
    over "model"; recurrent states' inner dims over "model"."""
    dp = dp_axes(mesh)

    def leaf(name, x, stacked):
        o = 1 if stacked else 0
        dims = [None] * x.ndim
        if x.ndim >= o + 1:
            dims[o] = _maybe(x.shape[o], mesh, dp)  # batch
        if name in ("k", "v", "c_kv", "k_rope") and x.ndim >= o + 2:
            dims[o + 1] = _maybe(x.shape[o + 1], mesh, "model")  # sequence
        elif name == "ssm" and x.ndim >= o + 2:
            dims[o + 1] = _maybe(x.shape[o + 1], mesh, "model")  # d_inner
        elif name == "conv" and x.ndim >= o + 3:
            dims[o + 2] = _maybe(x.shape[o + 2], mesh, "model")
        elif name == "C" and x.ndim >= o + 3:
            dims[o + 2] = _maybe(x.shape[o + 2], mesh, "model")  # mLSTM dk
        elif name in ("h", "c", "n", "m") and x.ndim == o + 2:
            dims[o + 1] = _maybe(x.shape[o + 1], mesh, "model")  # sLSTM D
        return P(*dims)

    def walk(t, name, stacked):
        if isinstance(t, dict):
            return {k: walk(v, k, stacked) for k, v in t.items()}
        if isinstance(t, list):
            return [walk(v, name, False) for v in t]
        return leaf(name, t, stacked)

    # stacked (n_units, B, ...) under scan_layers; per-unit lists otherwise
    return walk(cache, "", True)


def to_placements(mesh, spec) -> list:
    """One ``Placement`` per mesh dim: ``Shard(d)`` on every mesh dim that
    names tensor dim d in ``spec``, ``Replicate()`` on the others."""
    from torch.distributed.tensor import Replicate, Shard

    out = []
    for axis in mesh_sizes(mesh):
        dim = next((d for d, s in enumerate(spec)
                    if s == axis or (isinstance(s, tuple) and axis in s)),
                   None)
        out.append(Replicate() if dim is None else Shard(dim))
    return out


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (the reference's ``NamedSharding``)."""

    mesh: object
    spec: P

    @property
    def placements(self) -> list:
        return to_placements(self.mesh, self.spec)



def to_shardings(mesh, specs):
    """A tree of specs (dicts and lists) as the same tree of
    ``NamedSharding``s on ``mesh`` (``CheckpointManager.restore``'s
    ``shardings``)."""
    if isinstance(specs, P):
        return NamedSharding(mesh, specs)
    if isinstance(specs, dict):
        return {k: to_shardings(mesh, v) for k, v in specs.items()}
    if isinstance(specs, list):
        return [to_shardings(mesh, v) for v in specs]
    raise TypeError(f"not a spec tree: {type(specs)}")


def dp_batch_constraint(mesh):
    """The dry run's per-microbatch constraint (the reference's
    ``launch/dryrun.py``): each leaf of a whole microbatch (the same on
    every rank) placed with its batch over the data-parallel axes where
    they divide it, as DTensors of this rank's rows."""
    from repro_torch.models import meshctx

    def constrain(mb: dict) -> dict:
        return {k: meshctx.place(v, mesh, to_placements(
            mesh, batch_specs(None, mesh, {k: v})[k]))
            for k, v in mb.items()}

    return constrain


def expert_grad_constraint(cfg, mesh):
    """The dry run's gradient constraint: the MoE expert banks' gradients
    (3-d ``mlp.w_*`` leaves) pinned to their parameter's spec, every other
    gradient left as it is. The port's gradients come back with their
    parameter's placement (``optim.take_grads``), so this places nothing
    anew: it checks the layout and redistributes a bank that differs."""
    from repro_torch.models import meshctx

    def constrain(grads: dict) -> dict:
        out = {}
        for n, g in grads.items():
            names = _names(n)
            if (meshctx.is_dtensor(g) and g.ndim == 3 and "mlp" in names
                    and names[-1].startswith("w_")):
                g = meshctx.redistribute(g, to_placements(
                    mesh, param_spec(n, g.shape, cfg, mesh)))
            out[n] = g
        return out

    return constrain
