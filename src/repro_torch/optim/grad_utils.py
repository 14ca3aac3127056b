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


def global_norm(tree) -> torch.Tensor:
    """√(Σ g²) over every leaf, in float32. The reference sums its stacked
    leaves, the port one leaf a unit: the same terms in another order, so
    the two agree to a tolerance, not to bits."""
    return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                          for g in tree.values()))


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
        if g.dtype == torch.float32:
            g.mul_(scale)
        else:
            g.copy_(g.float() * scale)
    return tree, norm


def take_grads(params) -> dict:
    """{name: gradient} of a parameter module, taken off the module (its
    ``.grad`` set to None); a parameter the loss never read gets zeros,
    as the reference's ``jax.grad`` gives it."""
    out = {}
    for name, p in params.named_parameters():
        out[name] = torch.zeros_like(p) if p.grad is None else p.grad
        p.grad = None
    return out


def _detach(aux):
    return {k: v.detach() for k, v in aux.items()}


def accumulate_microbatches(loss_fn, params, batch, n_micro: int):
    """Mean loss and gradients over ``n_micro`` sequential microbatches.

    ``loss_fn(params, batch) → (loss, aux)``; ``params`` is a parameter
    module, ``batch`` a dict of tensors whose leading (global batch) axis
    ``n_micro`` divides. Returns ((mean loss, the LAST microbatch's aux),
    {name: gradient}), as the reference's scan.

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
        loss, aux = loss_fn(params, {k: v[i] for k, v in micro.items()})
        (loss / n_micro).backward()
        total = total + loss.detach() / n_micro
        del loss
    return (total, _detach(aux)), take_grads(params)
