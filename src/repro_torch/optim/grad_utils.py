"""Gradient utilities: global-norm clipping, microbatch accumulation (the
port of ``repro.optim.grad_utils``).

A gradient tree here is a dict {parameter name: tensor}. The reference
stacks the units of a scanned model along a leading axis, one leaf for
all units; the port holds one tensor a unit (``units.<u>.…``). Where
the reference's leaf decides a result (8-bit eligibility, the
compression's blocks), ``stack`` says how many units it stacks into one
leaf (``cfg.n_units`` under ``cfg.scan_layers``, else 1), and
``reference_leaves`` regroups the port's names into the reference's
leaves, in its order (dict keys sorted, list items in turn).
"""

from __future__ import annotations

import torch

from repro_torch.models import meshctx


def _part(p: str):
    return (0, int(p)) if p.isdigit() else (1, p)


def stacked(name: str, stack: int) -> bool:
    """Whether the reference stacks ``name`` (``units.<u>.<rest>``) with
    the other units' into one leaf of ``stack`` units."""
    parts = name.split(".", 2)
    return (stack > 1 and len(parts) == 3 and parts[0] == "units"
            and parts[1].isdigit())


def reference_leaves(names, stack: int = 1) -> list[list[str]]:
    """The port's parameter ``names`` grouped into the reference's leaves,
    in the reference's leaf order: under ``stack`` > 1 the names
    ``units.<u>.<rest>`` of one ``<rest>`` form one group, in unit order;
    every other name is a group of its own."""
    groups: dict[tuple, list[tuple[int, str]]] = {}
    for name in names:
        parts = name.split(".")
        if stacked(name, stack):
            key, unit = ("units",) + tuple(parts[2:]), int(parts[1])
        else:
            key, unit = tuple(parts), 0
        groups.setdefault(key, []).append((unit, name))
    order = sorted(groups, key=lambda k: tuple(map(_part, k)))
    return [[n for _, n in sorted(groups[k])] for k in order]


def sharded_axes(t) -> tuple:
    """The mesh dims a placed leaf is sharded on (none for a plain one)."""
    if not meshctx.is_dtensor(t):
        return ()
    names = t.device_mesh.mesh_dim_names
    return tuple(names[i] for i, p in enumerate(t.placements)
                 if p.is_shard())


def local(t):
    """A placed leaf's local block; a plain tensor as it is."""
    return t.to_local() if meshctx.is_dtensor(t) else t


def global_norm(tree) -> torch.Tensor:
    """√(Σ g²) over every leaf, in float32. The reference sums its stacked
    leaves, the port one leaf a unit: the same terms in another order, so
    the two agree to a tolerance, not to bits.

    Placed leaves (DTensors): each leaf's local sum of squares is summed
    over exactly the mesh dims the leaf is sharded on (the leaves of one
    set of dims summed locally first, then one all-reduce a set)."""
    if not any(meshctx.is_dtensor(g) for g in tree.values()):
        return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                              for g in tree.values()))
    sums: dict = {}
    for g in tree.values():
        key = (sharded_axes(g),
               g.device_mesh if meshctx.is_dtensor(g) else None)
        s = torch.sum(torch.square(local(g).float()))
        sums[key] = sums[key] + s if key in sums else s
    total = None
    for (axes, mesh), s in sums.items():
        if axes:
            s = meshctx.all_reduce_(s, axes, mesh=mesh)
        total = s if total is None else total + s
    return torch.sqrt(total)


def clip_by_global_norm(tree, max_norm: float):
    """Scale every leaf by min(1, max_norm / max(norm, 1e-9)), IN PLACE (a
    second copy of a full model's gradients would not fit beside the
    train state); returns (tree, norm). The product is taken in float32
    and rounded to the leaf's dtype, as the reference's."""
    norm = global_norm(tree)
    scale = torch.clamp(
        torch.full_like(norm, max_norm) / torch.clamp(norm, min=1e-9),
        max=1.0)
    for g in tree.values():
        g = local(g)
        if g.dtype == torch.float32:
            g.mul_(scale)
        else:
            g.copy_(g.float() * scale)
    return tree, norm


def take_grads(params) -> dict:
    """{name: gradient} of a parameter module, taken off the module (its
    ``.grad`` set to None); a parameter the loss never read gets zeros,
    as the reference's ``jax.grad`` gives it.

    A placed parameter's gradient is a DTensor of its placement. Each
    data-parallel rank's backward gives its own rows' share of it: the
    FSDP gathers' backward (a reduce-scatter) has summed the shares of the
    leaves sharded over those axes, and here the leaves replicated over a
    data-parallel axis are all-reduced over it (``sum_over_dp``)."""
    out = {}
    for name, p in params.named_parameters():
        out[name] = torch.zeros_like(p) if p.grad is None else p.grad
        p.grad = None
    sum_over_dp(out)
    return out


BUCKET_BYTES = 32 << 20


def sum_over_dp(grads: dict):
    """All-reduce (sum, in place) every placed gradient over the
    data-parallel axes it is replicated on. Leaves of one set of axes and
    dtype are joined into buckets of up to ``BUCKET_BYTES`` (one
    all-reduce a bucket); a larger leaf is reduced alone."""
    buckets: dict = {}

    def flush(key):
        ts = buckets.pop(key)
        flat = meshctx.all_reduce_(torch.cat([t.reshape(-1) for t in ts]),
                                   key[0], mesh=key[2])
        off = 0
        for t in ts:
            t.copy_(flat[off:off + t.numel()].view_as(t))
            off += t.numel()

    for g in grads.values():
        if not meshctx.is_dtensor(g):
            continue
        mesh = g.device_mesh
        sharded = sharded_axes(g)
        axes = tuple(a for a in meshctx.DP_AXES
                     if a in mesh.mesh_dim_names and a not in sharded
                     and meshctx.axis_len(a, mesh) > 1)
        if not axes:
            continue
        t = g.to_local()
        if t.numel() * t.element_size() >= BUCKET_BYTES:
            meshctx.all_reduce_(t, axes, mesh=mesh)
            continue
        key = (axes, t.dtype, mesh)
        buckets.setdefault(key, []).append(t)
        if sum(x.numel() * x.element_size()
               for x in buckets[key]) >= BUCKET_BYTES:
            flush(key)
    for key in list(buckets):
        flush(key)


def _detach(aux):
    return {k: v.detach() for k, v in aux.items()}


def accumulate_microbatches(loss_fn, params, batch, n_micro: int,
                            constrain=None, constrain_grads=None):
    """Mean loss and gradients over ``n_micro`` sequential microbatches.

    ``loss_fn(params, batch) → (loss, aux)``; ``params`` is a parameter
    module, ``batch`` a dict of tensors whose leading (global batch) axis
    ``n_micro`` divides. Returns ((mean loss, the LAST microbatch's aux),
    {name: gradient}), as the reference's scan.

    ``constrain``: applied to each microbatch (the global rows
    [i·B/n, (i+1)·B/n)) before ``loss_fn``, e.g. to place it over the
    data-parallel axes; ``constrain_grads``: applied to the accumulated
    gradients. As in the reference, neither is applied when ``n_micro``
    ≤ 1. On a mesh the gradients come back with their parameters'
    placements (``take_grads``).

    Each microbatch runs ``(loss / n_micro).backward()`` into ``.grad``:
    the backward is linear in its seed, so for ``n_micro`` a power of two
    (an exact scale by 2⁻ᵏ) each microbatch adds exactly the reference's
    ``g / n_micro`` to the accumulator, the first onto zeros; for other
    counts 1/n_micro is rounded once more. This keeps one gradient buffer,
    not a gradient plus an accumulator. The accumulator's dtype is the
    parameter's, as the reference's.
    """
    for p in params.parameters():
        p.grad = None
    if n_micro <= 1:
        loss, aux = loss_fn(params, batch)
        loss.backward()
        return (loss.detach(), _detach(aux)), take_grads(params)
    micro = {k: v.reshape((n_micro, v.shape[0] // n_micro) + v.shape[1:])
             for k, v in batch.items()}
    total = torch.zeros((), dtype=torch.float32,
                        device=next(iter(batch.values())).device)
    for i in range(n_micro):
        mb = {k: v[i] for k, v in micro.items()}
        loss, aux = loss_fn(params, mb if constrain is None
                            else constrain(mb))
        (loss / n_micro).backward()
        total = total + loss.detach() / n_micro
        del loss
    grads = take_grads(params)
    if constrain_grads is not None:
        grads = constrain_grads(grads)
    return (total, _detach(aux)), grads
