"""Gradient compression with error feedback (the port of
``repro.distributed.compression``).

Wire-format compression for data-parallel gradient exchange: bf16
truncation or blockwise-int8 quantization, with an error-feedback buffer
(the residual is added back before the next compression, preserving
convergence — Seide et al. / EF-SGD). ``allreduce_compressed`` is the
``torch.distributed`` building block: it all-gathers the quantized
payload over a process group and dequantize-reduces locally, so the wire
carries 1 byte + 4/256 an element instead of 4.

Gradient trees are dicts {parameter name: tensor}. The flat int8 codec
runs over the reference's leaf: the units a scanned model stacks into one
leaf (``stack``, see ``repro_torch.optim.grad_utils.reference_leaves``)
are concatenated in unit order before blocking, since a block of 256 may
straddle two units there.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.models import meshctx
from repro_torch.optim.adamw import BLOCK, _placed_as
from repro_torch.optim.adamw import _dequantize_flat as _dequantize
from repro_torch.optim.adamw import _quantize_flat as _quantize
from repro_torch.optim.adamw import named
from repro_torch.optim.grad_utils import local, reference_leaves, sharded_axes


def compress(g: torch.Tensor, kind: str):
    if kind == "bf16":
        return g.to(torch.bfloat16)
    if kind == "int8":
        return _quantize(g.float())
    raise ValueError(kind)


def decompress(payload, kind: str, shape, size):
    if kind == "bf16":
        return payload.float()
    return _dequantize(payload, shape, size)


def ef_compress_tree(grads, error_buf, kind: str, *, stack: int = 1):
    """Error-feedback compression of a gradient tree.

    Returns (compressed-and-decompressed grads — what the wire delivers,
    float32 — and the new error buffer). kind="none" passes through.
    """
    if kind == "none":
        return grads, error_buf
    if any(meshctx.is_dtensor(g) for g in grads.values()):
        return _ef_placed(grads, error_buf, kind, stack)
    wire, err = {}, {}
    for names in reference_leaves(grads, stack):
        g32 = torch.cat([(grads[n].float() + error_buf[n]).reshape(-1)
                         for n in names])
        got = decompress(compress(g32, kind), kind, g32.shape, g32.numel())
        off = 0
        for n in names:
            size = grads[n].numel()
            wire[n] = got[off:off + size].reshape(grads[n].shape)
            err[n] = g32[off:off + size].reshape(grads[n].shape) - wire[n]
            off += size
    return ({n: wire[n] for n in grads}, {n: err[n] for n in grads})


def _flat_index(t) -> torch.Tensor:
    """Each element of a DTensor's local block: its index in the whole
    leaf flattened row-major (int64, the block's shape)."""
    from repro_torch.optim.adamw import _offset

    idx = torch.zeros((), dtype=torch.int64, device=t.device)
    stride = 1
    for d in reversed(range(t.ndim)):
        n = t.to_local().shape[d]
        pos = torch.arange(n, device=t.device) + _offset(t, d)
        idx = idx + (pos * stride).reshape((n,) + (1,) * (t.ndim - 1 - d))
        stride *= t.shape[d]
    return idx


def _ef_placed(grads, error_buf, kind, stack):
    """``ef_compress_tree`` of placed gradients and error buffers: each
    rank compresses its local blocks. The int8 wire keeps the reference's
    flat 256-blocks over the whole (unit-stacked) leaf: each element's
    block is found from its index in that leaf, a block's absmax is the
    max over the mesh dims the leaf is sharded on of the ranks' partial
    maxima (blocks wholly inside a rank's block read only its own), and
    each rank codes its own elements against it."""
    wire, err = {}, {}
    for names in reference_leaves(grads, stack):
        g32 = [(local(grads[n]).float() + local(error_buf[n])) for n in names]
        if kind == "bf16":
            got = [g.to(torch.bfloat16).float() for g in g32]
        else:
            t = grads[names[0]]
            unit = t.numel()
            nblocks = -(-unit * len(names) // BLOCK)
            bids = [(_flat_index(t) + u * unit) // BLOCK
                    for u in range(len(names))]
            amax = torch.zeros(nblocks, dtype=torch.float32,
                               device=g32[0].device)
            for g, b in zip(g32, bids):
                amax.scatter_reduce_(0, b.reshape(-1), g.abs().reshape(-1),
                                     "amax")
            axes = sharded_axes(t)
            if axes:
                meshctx.all_reduce_(amax, axes, "max", t.device_mesh)
            got = []
            for g, b in zip(g32, bids):
                a = amax[b]
                q = torch.round(127.0 * (g / torch.clamp(a, min=1e-30)))
                got.append(q.to(torch.int8).float().div_(127.0).mul_(a))
        for n, g, w in zip(names, g32, got):
            wire[n], err[n] = w, g - w
    out_w, out_e = {}, {}
    for n in grads:
        like = grads[n]
        out_w[n] = _placed_as(wire[n], like)
        out_e[n] = _placed_as(err[n], error_buf[n])
    return out_w, out_e


def init_error_buf(params):
    """A float32 zero buffer a parameter (a module or a dict of tensors)."""
    return {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for n, p in named(params).items()}


def allreduce_compressed(g: torch.Tensor, kind: str, group=None):
    """Mean all-reduce over a ``torch.distributed`` process group (the
    world when None) with a compressed wire format: the reference's over a
    ``shard_map`` axis.

    int8: all-gather the (q, scale) payload and dequantize-sum locally.
    bf16: sum in bf16, divide in bf16. none: float32 sum.
    """
    n = dist.get_world_size(group)
    if kind == "none":
        t = g.clone()
        dist.all_reduce(t, group=group)
        return t / n
    if kind == "bf16":
        t = g.to(torch.bfloat16)
        dist.all_reduce(t, group=group)
        return (t / n).to(g.dtype)
    enc = compress(g.float(), "int8")
    qs = [torch.empty_like(enc["q"]) for _ in range(n)]
    ss = [torch.empty_like(enc["scale"]) for _ in range(n)]
    dist.all_gather(qs, enc["q"], group=group)        # n × (blocks, 256)
    dist.all_gather(ss, enc["scale"], group=group)    # n × (blocks, 1)
    total = torch.sum(torch.stack(qs).float() / 127.0 * torch.stack(ss),
                      dim=0)
    return (total.reshape(-1)[: g.numel()].reshape(g.shape) / n).to(g.dtype)
