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
import math

import torch
import torch.nn.functional as F
from torch import nn


@dataclasses.dataclass(frozen=True)
class Init:
    """Where initial parameters are made: ``device``, and the generator
    every draw takes in turn (None on the meta device)."""

    device: torch.device
    generator: torch.Generator | None

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
        return torch.empty(shape, dtype=dtype, device=rng.device)
    t = torch.empty(shape, dtype=torch.float32, device=rng.device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0,
                                generator=rng.generator)
    return t.mul_(scale).to(dtype)


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


def dense(p, x):
    """``x @ w`` with the reference's (d_in, d_out) layout, the weight cast
    to ``x.dtype`` at use."""
    y = x @ p["w"].to(x.dtype)
    if "b" in p:
        y = y + p["b"].to(x.dtype)
    return y


def rmsnorm_init(rng: Init, d, dtype):
    return {"g": ones(rng, (d,), dtype)}


def rmsnorm(p, x, eps=1e-5):
    """Normalized in float32, cast back, then scaled by ``g`` in x.dtype."""
    x32 = x.float()
    rms = torch.rsqrt((x32 * x32).mean(-1, keepdim=True) + eps)
    return (x32 * rms).to(x.dtype) * p["g"].to(x.dtype)


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
    if kind == "swiglu":
        h = F.silu(dense(p["w_gate"], x)) * dense(p["w_up"], x)
    elif kind == "relu2":
        h = torch.square(F.relu(dense(p["w_up"], x)))
    elif kind == "gelu":
        # jax.nn.gelu's default is the tanh approximation.
        h = F.gelu(dense(p["w_up"], x), approximate="tanh")
    else:
        raise ValueError(kind)
    return dense(p["w_down"], h)


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
    if dtype is None or torch_dtype(dtype) == table.dtype:
        return table[tokens]
    if torch.is_grad_enabled() and table.requires_grad:
        return table.to(torch_dtype(dtype))[tokens]
    return table[tokens].to(torch_dtype(dtype))


def unembed(p, x):
    """Project to vocab logits in float32 (loss numerics)."""
    return x.float() @ p["table"].T.float()
