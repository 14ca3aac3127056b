"""Shared neural layers: norms, rotary embeddings, MLPs, init helpers.

The port of ``repro.models.layers``. Parameters live in ``nn.Module``
trees (``Params``); every layer is a plain
function ``f(p, x, ...)`` of tensors that reads its parameters as
``p["w"]`` and tests ``"b" in p``, as the reference reads its dicts, so a
dict of tensors works too. Initializers return dicts of tensors drawn
from one ``Init`` (device and generator); on the ``meta`` device they
allocate nothing and draw nothing.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models import meshctx


@dataclasses.dataclass(frozen=True)
class Init:
    """Where initial parameters are made: ``device``, and the generator
    every draw takes in turn (None on the meta device). ``keep``, when
    given, receives each drawn leaf and returns what the tree holds
    instead (``carry.place_params`` keeps a rank's shard)."""

    device: torch.device
    generator: torch.Generator | None
    keep: object = None

    @property
    def abstract(self) -> bool:
        return self.device.type == "meta"


class Params(nn.Module):
    """A node of a parameter tree built from the reference's nested dicts:
    a tensor becomes a parameter, a dict a child ``Params``, a list an
    ``nn.ModuleList`` of them, under the reference's keys (so the state
    dict names are its paths: ``units.0.l0.mix.wq.w``). ``p["w"]`` and
    ``"b" in p`` read it as the reference reads a dict."""

    def __init__(self, tree: dict):
        super().__init__()
        for name, v in tree.items():
            if isinstance(v, dict):
                self.add_module(name, Params(v))
            elif isinstance(v, list):
                self.add_module(name, nn.ModuleList(Params(u) for u in v))
            else:
                self.register_parameter(name, nn.Parameter(
                    v, requires_grad=v.is_floating_point()))

    def __getitem__(self, name):
        return getattr(self, name)

    def __contains__(self, name) -> bool:
        return name in self._parameters or name in self._modules


def torch_dtype(name) -> torch.dtype:
    """A config's dtype string ("bfloat16", "float32") as a torch dtype."""
    return name if isinstance(name, torch.dtype) else getattr(torch, name)


def _init(rng: Init, shape, scale, dtype):
    """``scale`` × a standard normal truncated to ±2, drawn in float32 and
    cast to ``dtype`` (the reference's ``jax.random.truncated_normal``)."""
    dtype = torch_dtype(dtype)
    if rng.abstract:
        t = torch.empty(shape, dtype=dtype, device=rng.device)
    else:
        t = torch.empty(shape, dtype=torch.float32, device=rng.device)
        torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0,
                                    generator=rng.generator)
        t = t.mul_(scale).to(dtype)
    return rng.keep(t) if rng.keep is not None else t


def abstract(shape, dtype) -> torch.Tensor:
    """A shape and dtype without storage (the reference's
    ``jax.ShapeDtypeStruct``): a tensor on the meta device."""
    return torch.empty(shape, dtype=torch_dtype(dtype), device="meta")


def zeros(rng: Init, shape, dtype):
    return torch.zeros(shape, dtype=torch_dtype(dtype), device=rng.device)


def ones(rng: Init, shape, dtype):
    return torch.ones(shape, dtype=torch_dtype(dtype), device=rng.device)


def dense_init(rng: Init, d_in, d_out, dtype, *, bias=False, scale=None):
    scale = (1.0 / math.sqrt(d_in)) if scale is None else scale
    p = {"w": _init(rng, (d_in, d_out), scale, dtype)}
    if bias:
        p["b"] = zeros(rng, (d_out,), dtype)
    return p


def dense(p, x, *, gather_out=True, x_sharded=False, grad_summed=False):
    """``x @ w`` with the reference's (d_in, d_out) layout, the weight cast
    to ``x.dtype`` at use.

    A weight placed on a mesh (a DTensor) runs on its local shard: its
    data-parallel (FSDP) dims are all-gathered; sharded over "model" on
    d_out (column-parallel) the local columns' output is all-gathered over
    "model" (kept local with ``gather_out=False``); sharded on d_in
    (row-parallel) the local rows of ``x`` (or ``x`` itself, already those
    rows, with ``x_sharded``) give partial sums all-reduced over "model".

    Gradients: a column-parallel product gives each rank a partial sum of
    ``x``'s gradient, summed over "model" in the backward
    (``meshctx.sum_grad``; ``grad_summed``: the caller did it once for
    several products of one input); the FSDP gather's backward is a
    reduce-scatter over the data-parallel axes.
    """
    w = p["w"]
    if meshctx.is_dtensor(w):
        return _dense_placed(p, x, gather_out, x_sharded, grad_summed)
    y = x @ w.to(x.dtype)
    if "b" in p:
        y = y + p["b"].to(x.dtype)
    return y


def dense_many(ps, x) -> list:
    """``dense`` of several weights on one input. Placed column-parallel
    (d_out over "model") they share one all-gather of their local columns
    (each rank's block of every output, then split), not one each."""
    ws = [p["w"] for p in ps]
    if not (all(meshctx.is_dtensor(w) and _model_dim(w) == 1 for w in ws)
            and meshctx.axis_len("model", ws[0].device_mesh) > 1):
        return [dense(p, x) for p in ps]
    mesh = ws[0].device_mesh
    x = meshctx.sum_grad(x, "model", mesh)
    locs = [dense(p, x, gather_out=False, grad_summed=True) for p in ps]
    widths = [t.shape[-1] for t in locs]
    g = meshctx.all_gather(torch.cat(locs, -1), "model", -1, mesh)
    g = g.reshape(*g.shape[:-1], -1, sum(widths))
    return [o.reshape(*o.shape[:-2], -1)
            for o in torch.split(g, widths, dim=-1)]


def _model_dim(w):
    """The tensor dim a placed weight shards over "model", or None."""
    return meshctx.sharded_dims(w).get("model")


def _dense_placed(p, x, gather_out, x_sharded, grad_summed):
    w = p["w"]
    mesh = w.device_mesh
    dim = _model_dim(w)
    fsdp = tuple(a for a in mesh.mesh_dim_names if a != "model")
    wl = meshctx.gather(w, fsdp).to(x.dtype)
    b = meshctx.gather(p["b"], fsdp).to(x.dtype) if "b" in p else None
    if dim == 1:
        if not grad_summed:
            x = meshctx.sum_grad(x, "model", mesh)
        y = x @ wl
        if b is not None:
            y = y + (b if b.shape[-1] == y.shape[-1] else meshctx.block(
                b, "model", 0, mesh))
        return meshctx.all_gather(y, "model", -1, mesh) if gather_out else y
    if dim == 0:
        xs = x if x_sharded else meshctx.block(x, "model", x.ndim - 1, mesh)
        y = meshctx.all_reduce(xs @ wl, "model", mesh=mesh)
    else:
        y = x @ wl
    if b is not None:
        y = y + meshctx.gather(b).to(x.dtype)
    return y


def rmsnorm_init(rng: Init, d, dtype):
    return {"g": ones(rng, (d,), dtype)}


def rmsnorm(p, x, eps=1e-5):
    """Normalized in float32, cast back, then scaled by ``g`` in x.dtype."""
    x32 = x.float()
    rms = torch.rsqrt((x32 * x32).mean(-1, keepdim=True) + eps)
    return (x32 * rms).to(x.dtype) * meshctx.full(p["g"]).to(x.dtype)


def rope_frequencies(d_head: int, theta: float, device=None) -> torch.Tensor:
    """Inverse frequencies for rotary embeddings, shape (d_head//2,)."""
    return 1.0 / (theta ** (torch.arange(0, d_head, 2, dtype=torch.float32,
                                         device=device) / d_head))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """Rotary position embedding on the two halves of the head dimension
    (not interleaved pairs), as the reference.

    x: (..., S, n_heads, d_head); positions: broadcastable to (..., S).
    """
    d = x.shape[-1]
    inv = rope_frequencies(d, theta, x.device)  # (d/2,)
    ang = positions[..., None].float() * inv  # (..., S, d/2)
    sin = torch.sin(ang)[..., None, :]  # (..., S, 1, d/2)
    cos = torch.cos(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def mlp_init(rng: Init, d_model, d_ff, kind, dtype):
    if kind == "swiglu":
        return {
            "w_gate": dense_init(rng, d_model, d_ff, dtype),
            "w_up": dense_init(rng, d_model, d_ff, dtype),
            "w_down": dense_init(rng, d_ff, d_model, dtype),
        }
    if kind in ("relu2", "gelu"):  # Nemotron-4 squared-ReLU / HuBERT GELU
        return {
            "w_up": dense_init(rng, d_model, d_ff, dtype),
            "w_down": dense_init(rng, d_ff, d_model, dtype),
        }
    raise ValueError(f"unknown mlp kind {kind!r}")


def mlp(p, x, kind):
    """The MLP. Placed on a mesh with its hidden dim over "model" (the
    up-projections column-parallel, the down-projection row-parallel), the
    hidden activations stay local and one all-reduce combines the output
    (Megatron's MLP)."""
    local = (meshctx.is_dtensor(p["w_down"]["w"])
             and _model_dim(p["w_down"]["w"]) == 0
             and all(_model_dim(p[n]["w"]) == 1
                     for n in ("w_gate", "w_up") if n in p))
    if local:  # one backward sum for both up-projections' partials
        x = meshctx.sum_grad(x, "model", p["w_down"]["w"].device_mesh)
    up = functools.partial(dense, gather_out=not local, grad_summed=local)
    if kind == "swiglu":
        h = F.silu(up(p["w_gate"], x)) * up(p["w_up"], x)
    elif kind == "relu2":
        h = torch.square(F.relu(up(p["w_up"], x)))
    elif kind == "gelu":
        # jax.nn.gelu's default is the tanh approximation.
        h = F.gelu(up(p["w_up"], x), approximate="tanh")
    else:
        raise ValueError(kind)
    return dense(p["w_down"], h, x_sharded=local)


def embedding_init(rng: Init, vocab, d_model, dtype, scale: float = 1.0):
    return {"table": _init(rng, (vocab, d_model), scale, dtype)}


def embed(p, tokens, dtype=None):
    """Token embedding gather. The reference casts the whole table to the
    compute dtype and then gathers, so its backward sums a row's
    gradients in the compute dtype and rounds the table's gradient to the
    table's dtype once; under autograd the port does the same. Without
    gradients, gathering the rows first and casting them gives the same
    bits (a cast is elementwise) without copying a (vocab, d_model) table
    every step."""
    table = p["table"]
    if meshctx.is_dtensor(table):
        return _embed_placed(table, tokens, dtype)
    if dtype is None or torch_dtype(dtype) == table.dtype:
        return table[tokens]
    if torch.is_grad_enabled() and table.requires_grad:
        return table.to(torch_dtype(dtype))[tokens]
    return table[tokens].to(torch_dtype(dtype))


def _embed_placed(table, tokens, dtype):
    """A vocab-parallel lookup: each rank gathers the rows its shard holds
    (zeros for the others) and an all-reduce over "model" sums them, which
    gives every row exactly. Under autograd the rank's block is cast to
    ``dtype`` before the gather, as ``embed`` casts the whole table."""
    tl = meshctx.gather(table, tuple(
        a for a in table.device_mesh.mesh_dim_names if a != "model"))
    if dtype is not None and torch.is_grad_enabled() and tl.requires_grad:
        tl = tl.to(torch_dtype(dtype))
    if _model_dim(table) == 0:
        lo = meshctx.coordinate("model", table.device_mesh) * tl.shape[0]
        hit = (tokens >= lo) & (tokens < lo + tl.shape[0])
        rows = tl[(tokens - lo).clamp(0, tl.shape[0] - 1)]
        rows = meshctx.all_reduce(rows * hit[..., None].to(rows.dtype),
                                  "model", mesh=table.device_mesh)
    else:
        rows = tl[tokens]
    return rows if dtype is None else rows.to(torch_dtype(dtype))


def unembed(p, x):
    """Project to vocab logits in float32 (loss numerics). A table placed
    with its vocab over "model" gives each rank its vocab columns, then an
    all-gather over "model"."""
    table = p["table"]
    if meshctx.is_dtensor(table):
        tl = meshctx.gather(table, tuple(
            a for a in table.device_mesh.mesh_dim_names if a != "model"))
        if _model_dim(table) == 0:
            x = meshctx.sum_grad(x, "model", table.device_mesh)
        y = x.float() @ tl.T.float()
        if _model_dim(table) == 0:
            y = meshctx.all_gather(y, "model", -1, table.device_mesh)
        return y
    return x.float() @ table.T.float()


def unembed_ce(p, x, labels):
    """(cross-entropy of each position, its log-sum-exp) of the float32
    logits ``x @ tableᵀ`` against ``labels``, as ``log_softmax`` and a
    gather of the label's entry give it. A table placed with its vocab
    over "model" takes it vocab-parallel: each rank's logits are its
    vocab columns only, and one max and one sum (the exponentials' sum and
    the label's logit, joined) all-reduced over "model" give every rank
    the whole-vocab values; no rank holds the whole logits."""
    table = p["table"]
    if not (meshctx.is_dtensor(table) and _model_dim(table) == 0
            and meshctx.axis_len("model", table.device_mesh) > 1):
        z = unembed(p, x)
        ce = -torch.gather(torch.log_softmax(z, dim=-1), -1,
                           labels[..., None].long())[..., 0]
        return ce, torch.logsumexp(z, dim=-1)
    mesh = table.device_mesh
    tl = meshctx.gather(table, tuple(
        a for a in mesh.mesh_dim_names if a != "model"))
    x = meshctx.sum_grad(x, "model", mesh)
    z = x.float() @ tl.T.float()  # (..., V / model)
    n = tl.shape[0]
    lo = meshctx.coordinate("model", mesh) * n
    m = meshctx.all_reduce(z.amax(-1), "model", "max", mesh)
    hit = (labels >= lo) & (labels < lo + n)
    zt = torch.gather(z, -1, (labels - lo).clamp(0, n - 1)[..., None].long()
                      )[..., 0] * hit
    se = torch.exp(z - m[..., None]).sum(-1)
    red = meshctx.all_reduce(torch.stack([se, zt]), "model", mesh=mesh)
    lse = m + torch.log(red[0])
    return lse - red[1], lse
