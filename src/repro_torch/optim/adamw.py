"""AdamW from scratch, plus an 8-bit block-quantized variant (the port of
``repro.optim.adamw``).

The 8-bit optimizer keeps per-256-block absmax int8 moments with a
float32 scale: (4 + 1 + 1 + ε) bytes of state a float32 parameter beside
its gradient, instead of (4 + 4 + 4). Moments are dequantized, updated
and requantized each step; the quantization error is bounded by the
blockwise absmax.

Nonlinear codes: signed-sqrt for m (resolution near 0) and a quartic map
for v (positive, wide dynamic range); linear codes would round v's small
entries to zero and blow up 1/√v. The optimizer's codec runs along the
LAST axis only: ``q`` keeps the parameter's shape (int8) and ``scale``
has shape (..., last/256). Leaves whose last dim does not block (biases,
norms) keep float32 moments. The flat (blocks, 256) codec below is for
the gradient wire compression, whose payload is transient.

State layout: ``{"step": int32 0-d, "m": {name: moment}, "v": {...}}``,
a moment being a float32 tensor or ``{"q": int8, "scale": float32}``.
Eligibility is judged on the REFERENCE's leaf: it stacks the units of a
scanned model into one leaf (``stack`` units), so a unit's leaf of
32,768 elements stacked over two units is eligible there, and here too.
The codes then match unit by unit, as blocks run along the last axis.

Eager and in place: leaves update one after another (each leaf's
temporaries are freed before the next), and the parameters and float32
moments are written in place under ``no_grad`` — a functional copy of a
full model's weights would not fit beside its train state. The values
are the reference's.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from repro_torch.models import meshctx
from repro_torch.optim.grad_utils import stacked

BLOCK = 256


# ------------------------------------------------------- int8 block codec


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded square root. ``torch.sqrt`` is on CUDA, as the
    reference's is; on the CPU it is not (1 ULP off on some float32
    inputs), so there the root is taken in float64 and rounded once.
    ``tests/test_torch_optim.py::test_adamw_step_matches_the_reference``
    (its float32 cases) needs this: with the CPU's own root the weights
    land 1.19e-7 from the reference's (one ULP at |w| ≈ 1), beyond its
    bound of ``ADAM_ULPS`` ULPs of the update (3.7e-9)."""
    if x.device.type == "cpu":
        return torch.sqrt(x.double()).to(x.dtype)
    return torch.sqrt(x)


def _encode(y, kind):
    """Codes of ``y`` ∈ [−1, 1] (float, not yet int8). "sq" takes
    copysign(127·√|y|, y), the same bits as the reference's
    127·sign(y)·√|y| (a product with ±1 is exact), with fewer temporaries;
    the codes are rounded half to even, as ``jnp.round``."""
    if kind == "lin":
        return torch.round(127.0 * y)
    if kind == "sq":  # signed sqrt: fine resolution near zero
        return _sqrt(torch.abs(y)).mul_(127.0).copysign_(y).round_()
    if kind == "q4":  # quartic: positive values, wide dynamic range
        return (torch.abs(y) ** 0.25).mul_(127.0).round_()
    raise ValueError(kind)


def _decode_(y, kind):
    """Decodes ``y`` = code/127 in place: "sq" |y|·y (the reference's
    sign(y)·y·y), "q4" (y·y)·(y·y) (``lax.integer_pow``)."""
    if kind == "sq":
        return y.mul_(y.abs())
    if kind == "q4":
        return y.mul_(y).mul_(y)
    return y


def q8_eligible(p, stack: int = 1) -> bool:
    """The reference's rule (last dim % 256 == 0 and ≥ 65,536 elements) on
    its leaf: ``p`` stacked ``stack`` times along a new leading axis."""
    return (p.ndim >= 1 and p.shape[-1] % BLOCK == 0
            and p.numel() * stack >= 65536)


def _const(x: float, dtype) -> float:
    """``x`` rounded to ``dtype``, as JAX rounds a weakly typed Python
    scalar to the array's dtype before the operation."""
    return float(torch.tensor(x, dtype=dtype))


def _quantize(x: torch.Tensor, kind: str = "lin", cut=None) -> dict:
    """Last-axis block codec (optimizer moments). Math runs in x.dtype.
    ``cut``: ``x`` is a rank's block of a leaf whose blocks straddle the
    ranks along its last dim (``Cut``)."""
    if cut is not None:
        return _quantize_cut(x, kind, cut)
    *lead, last = x.shape
    b = x.reshape(*lead, last // BLOCK, BLOCK)
    amax = torch.linalg.vector_norm(b, float("inf"), dim=-1, keepdim=True)
    y = b / torch.clamp(amax, min=_const(1e-30, x.dtype))
    q = _encode(y, kind).to(torch.int8).reshape(x.shape)
    return {"q": q, "scale": amax[..., 0].float()}


def _dequantize(enc: dict, shape, size=None, kind: str = "lin",
                dtype=torch.float32, cut=None) -> torch.Tensor:
    if cut is not None:
        y = _decode_(enc["q"].to(dtype).div_(127.0), kind)
        scale = enc["scale"]
        if cut.scale_placements is not None:
            scale = cut.my_rows(cut.scale_whole(scale), y)
        return y.mul_(scale.to(dtype)[..., cut.block_of(y)])
    *lead, last = shape
    y = enc["q"].to(dtype).reshape(*lead, last // BLOCK, BLOCK).div_(127.0)
    y = _decode_(y, kind).mul_(enc["scale"][..., None].to(dtype))
    return y.reshape(shape)


@dataclasses.dataclass(frozen=True)
class Cut:
    """A rank's block of a placed leaf whose 256-blocks (along the last dim,
    ``size`` whole) straddle the ranks along the mesh dims ``axes``: the
    block starts at column ``offset``. The codec keeps the reference's
    blocks of the whole leaf: a block's absmax is the max over ``axes`` of
    the ranks' partial maxima, and each rank codes its own elements.

    Where the ``scale`` leaf is placed as the codes but replicated over
    ``axes`` (its blocks' count is not divisible there), its local block is
    every block of this rank's rows. Otherwise (``scale_placements``: the
    sharding rule put the scale's dims elsewhere) the absmax of the whole
    leaf, (``lead`` rows, blocks), is assembled from the ranks' rows
    (``rows``: where this rank's rows start on each leading dim; ``axes``
    then every dim the codes are sharded on) and each rank keeps the
    scale's block by its own placement."""

    offset: int
    size: int
    axes: tuple
    mesh: object
    rows: tuple = ()
    lead: tuple = ()
    scale_placements: tuple = None

    def block_of(self, x: torch.Tensor) -> torch.Tensor:
        """The block index of each of ``x``'s last-dim columns."""
        cols = torch.arange(x.shape[-1], device=x.device) + self.offset
        return cols // BLOCK

    def my_rows(self, whole: torch.Tensor, like: torch.Tensor):
        """This rank's rows (those of ``like``, a local block) of a tensor
        over the whole leaf's leading dims."""
        for d, (o, n) in enumerate(zip(self.rows, like.shape[:-1])):
            whole = whole.narrow(d, o, n)
        return whole

    def scale_whole(self, scale: torch.Tensor) -> torch.Tensor:
        """The whole leaf's (lead, blocks) scale from this rank's block."""
        return meshctx.gather_block(scale, self.mesh, self.scale_placements)


def _quantize_cut(x, kind, cut: Cut) -> dict:
    bid = cut.block_of(x)
    amax = torch.zeros(x.shape[:-1] + (cut.size // BLOCK,), dtype=x.dtype,
                       device=x.device)
    amax.scatter_reduce_(-1, bid.expand(x.shape), x.abs(), "amax")
    if cut.scale_placements is not None:
        whole = torch.zeros(cut.lead + amax.shape[-1:], dtype=x.dtype,
                            device=x.device)
        cut.my_rows(whole, x).copy_(amax)
        whole = meshctx.all_reduce_(whole, cut.axes, "max", cut.mesh)
        amax = cut.my_rows(whole, x)
        scale = meshctx.local_slice(whole, cut.mesh, cut.scale_placements)
    else:
        amax = meshctx.all_reduce_(amax, cut.axes, "max", cut.mesh)
        scale = amax
    y = x / torch.clamp(amax[..., bid], min=_const(1e-30, x.dtype))
    return {"q": _encode(y, kind).to(torch.int8),
            "scale": scale.float().contiguous()}


def _offset(dt, dim: int) -> int:
    """Where a DTensor's local block starts along tensor dim ``dim``."""
    mesh, off, width = dt.device_mesh, 0, dt.shape[dim]
    for i, p in enumerate(dt.placements):
        if p.is_shard() and p.dim == dim:
            width //= mesh.size(i)
            off += mesh.get_local_rank(i) * width
    return off


def codec_cut(q, scale):
    """The ``Cut`` of a placed 8-bit moment (its codes ``q`` and
    ``scale``), or None where the codec runs on the local blocks alone (a
    plain leaf, or a last dim whose local width is a multiple of 256:
    then ``scale`` is placed as ``q``)."""
    if not meshctx.is_dtensor(q):
        return None
    last = q.ndim - 1
    names = q.device_mesh.mesh_dim_names
    axes = tuple(names[i] for i, p in enumerate(q.placements)
                 if p.is_shard() and p.dim == last)
    local = not axes or q.to_local().shape[-1] % BLOCK == 0
    if local and list(q.placements) == list(scale.placements):
        return None
    if not local and not any(
            sp.is_shard() if names[i] in axes else sp != q.placements[i]
            for i, sp in enumerate(scale.placements)):
        return Cut(_offset(q, last), q.shape[-1], axes, q.device_mesh)
    return Cut(_offset(q, last), q.shape[-1],
               tuple(names[i] for i, p in enumerate(q.placements)
                     if p.is_shard()), q.device_mesh,
               rows=tuple(_offset(q, d) for d in range(last)),
               lead=tuple(q.shape[:-1]),
               scale_placements=tuple(scale.placements))


def _quantize_flat(x: torch.Tensor, kind: str = "lin") -> dict:
    """Flat (blocks, 256) codec — wire compression only (transient)."""
    flat = x.reshape(-1)
    pad = (-flat.numel()) % BLOCK
    blocks = torch.nn.functional.pad(flat, (0, pad)).reshape(-1, BLOCK)
    amax = torch.linalg.vector_norm(blocks, float("inf"), dim=1,
                                    keepdim=True)
    y = blocks / torch.clamp(amax, min=1e-30)
    return {"q": _encode(y, kind).to(torch.int8), "scale": amax.float()}


def _dequantize_flat(enc: dict, shape, size, kind: str = "lin"):
    y = _decode_(enc["q"].float().div_(127.0), kind).mul_(enc["scale"])
    return y.reshape(-1)[:size].reshape(shape)


# --------------------------------------------------------------- AdamW


def named(params) -> dict:
    """{name: tensor} of a parameter module or of a dict of tensors."""
    if isinstance(params, torch.nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def adamw_init(params, *, bits8: bool = False, stack: int = 1):
    """Zero moments: float32 tensors, or int8 codes with float32 scales
    for a codec-eligible leaf under ``bits8`` (the reference's
    ``_quantize`` of zeros, made directly). ``stack``: the units the
    reference stacks into the leaf of each ``units.<u>.…`` name
    (``cfg.n_units`` under ``cfg.scan_layers``, else 1)."""
    leaves = named(params)

    def zero(name, p):
        if bits8 and q8_eligible(p, stack if stacked(name, stack) else 1):
            return {"q": torch.zeros(p.shape, dtype=torch.int8,
                                     device=p.device),
                    "scale": torch.zeros(p.shape[:-1] + (
                        p.shape[-1] // BLOCK,), dtype=torch.float32,
                        device=p.device)}
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    m = {name: zero(name, p) for name, p in leaves.items()}
    v = {name: zero(name, p) for name, p in leaves.items()}
    device = next(iter(leaves.values())).device
    return {"step": torch.zeros((), dtype=torch.int32, device=device),
            "m": m, "v": v}


@torch.no_grad()
def _leaf(p, g, m, v, *, lr, c1, c2, b1, b2, eps, weight_decay, bits8,
          cut=None):
    """One leaf's update: writes ``p`` (and float32 ``m``, ``v``) in place;
    returns its new (m, v). ``cut``: the 8-bit codec's ``Cut`` of a
    placed leaf (tensors here are its local blocks)."""
    leaf8 = bits8 and isinstance(m, dict)
    # bf16-param leaves do the moment math in bf16 when the moments are
    # 8-bit (they round-trip through int8 codes anyway); float32 masters
    # keep float32 moment math.
    ct = torch.bfloat16 if (leaf8 and p.dtype == torch.bfloat16) \
        else torch.float32
    k = functools.partial(_const, dtype=ct)
    g32 = g.to(ct)
    if leaf8:
        m_f = _dequantize(m, g.shape, kind="sq", dtype=ct, cut=cut)
        v_f = _dequantize(v, g.shape, kind="q4", dtype=ct, cut=cut)
    else:
        m_f, v_f = m, v
    m_f.mul_(k(b1)).add_(k(1 - b1) * g32)
    v_f.mul_(k(b2)).add_(k(1 - b2) * g32 * g32)
    del g32
    upd = m_f / c1.to(ct)
    upd.div_(_sqrt(v_f / c2.to(ct)).add_(k(eps)))
    p32 = p.to(ct)
    upd.add_(k(weight_decay) * p32)
    upd.mul_(lr.to(ct))
    if p32 is p:
        p.sub_(upd)
    else:
        p.copy_((p32 - upd).to(p.dtype))
    del upd, p32
    if leaf8:
        return _quantize(m_f, "sq", cut), _quantize(v_f, "q4", cut)
    return m_f, v_f


def _local(t):
    if isinstance(t, dict):
        return {k: _local(x) for k, x in t.items()}
    return meshctx.local(t)


def _placed_as(new, like):
    """``new`` (local blocks) placed as ``like`` (a DTensor, or a dict of
    them); as it is when ``like`` is plain."""
    if isinstance(like, dict):
        return {k: _placed_as(new[k], like[k]) for k in like}
    if not meshctx.is_dtensor(like):
        return new
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(new, like.device_mesh, like.placements,
                              run_check=False, shape=like.shape,
                              stride=like.stride())


def adamw_update(
    grads,
    state,
    params,
    *,
    lr,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.1,
    bits8: bool = False,
):
    """One AdamW step: writes the parameters (a module or a dict of
    tensors) and the float32 moments in place and returns (params, new
    state). ``grads``: {name: gradient}. ``lr`` may be a 0-d tensor (a
    schedule's); it and the bias corrections 1 − b^step are float32, as
    the reference's.

    Placed leaves (DTensors: parameters, gradients and moments placed by
    ``launch.sharding.state_specs``) update their local blocks; the 8-bit
    codec keeps the reference's 256-blocks of the whole leaf along its
    last dim (``codec_cut``). The step counter and ``lr`` are replicated
    (a DTensor step is read and returned placed)."""
    step_in = state["step"]
    step = _local(step_in) + 1
    stepf = step.to(torch.float32)
    c1 = 1.0 - torch.pow(b1, stepf)
    c2 = 1.0 - torch.pow(b2, stepf)
    lr = torch.as_tensor(lr, dtype=torch.float32, device=step.device)
    m_out, v_out = {}, {}
    for name, p in named(params).items():
        m, v = state["m"][name], state["v"][name]
        cut = (codec_cut(m["q"], m["scale"])
               if bits8 and isinstance(m, dict) else None)
        mo, vo = _leaf(
            _local(p), _local(grads[name]), _local(m), _local(v), lr=lr,
            c1=c1, c2=c2, b1=b1, b2=b2, eps=eps,
            weight_decay=weight_decay, bits8=bits8, cut=cut)
        m_out[name], v_out[name] = _placed_as(mo, m), _placed_as(vo, v)
    return params, {"step": _placed_as(step, step_in), "m": m_out,
                    "v": v_out}


def make_optimizer(train_cfg, *, stack: int = 1):
    """(init_fn, update_fn) pair from a TrainConfig; ``stack`` as in
    ``adamw_init``."""
    bits8 = train_cfg.optimizer == "adamw8bit"
    init = functools.partial(adamw_init, bits8=bits8, stack=stack)
    update = functools.partial(
        adamw_update, b1=train_cfg.b1, b2=train_cfg.b2, eps=train_cfg.eps,
        weight_decay=train_cfg.weight_decay, bits8=bits8,
    )
    return init, update
