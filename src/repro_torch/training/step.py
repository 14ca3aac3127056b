"""train_step construction (the port of ``repro.training.step``): loss →
(microbatched) grads → error-feedback compression → clip → schedule →
AdamW, in eager PyTorch.

The state is ``{"params": the parameter module, "opt": {"step", "m",
"v"}, "ebuf": {name: float32}}`` (``ebuf`` only with gradient
compression); ``train_step`` updates it in place where it can (weights,
float32 moments) and returns the new state dict and the metrics.
"""

from __future__ import annotations

import functools

import torch

from repro_torch.distributed.compression import (ef_compress_tree,
                                                 init_error_buf)
from repro_torch.models import meshctx
from repro_torch.models import transformer as tf
from repro_torch.optim import (
    accumulate_microbatches,
    clip_by_global_norm,
    make_optimizer,
    warmup_cosine,
)


def stacked_units(cfg) -> int:
    """How many units the reference stacks into one ``units`` leaf."""
    return cfg.n_units if cfg.scan_layers else 1


def make_train_step(cfg, tcfg, batch_constraint=None,
                    grad_constraint=None, *, stack=None):
    """Returns (init_state(generator) → state, train_step(state, batch) →
    (state, metrics), abstract_state() → the state on the meta device).

    ``init_state`` draws the weights from ``generator`` (a seeded
    ``torch.Generator`` on the state's device). ``batch``: a dict of
    tensors on that device. The metrics are the reference's: ``ce`` and
    ``aux`` of the last microbatch, ``loss`` (the accumulated mean),
    ``grad_norm`` (before clipping) and ``lr``, each a 0-d tensor.

    On a mesh (``meshctx.set_mesh``; one process a rank, every rank
    calling the same functions): ``init_state`` draws a state placed by
    ``launch.sharding.state_specs`` (``training.carry.init_placed_state``),
    ``train_step`` takes such a state (``carry.place_state``) and a batch
    of whole tensors (the same on every rank) or of DTensors placed over
    the data-parallel axes, and every rank returns the step's metrics.
    ``batch_constraint`` and ``grad_constraint`` are the reference's:
    applied to each microbatch and to the accumulated gradients
    (``accumulate_microbatches``' ``constrain``/``constrain_grads``;
    ``launch.sharding.dp_batch_constraint`` and
    ``expert_grad_constraint`` build the dry run's).

    ``stack``: the units the reference stacks into one leaf (by default
    ``stacked_units(cfg)``); the dry run's probes, which cut the depth,
    pass the whole model's, so that each unit's leaves are coded as there.
    """
    stack = stacked_units(cfg) if stack is None else int(stack)
    opt_init, opt_update = make_optimizer(tcfg, stack=stack)
    sched = functools.partial(
        warmup_cosine, peak_lr=tcfg.learning_rate,
        warmup_steps=tcfg.warmup_steps, total_steps=tcfg.total_steps)

    def state_of(params):
        state = {"params": params, "opt": opt_init(params)}
        if tcfg.grad_compression != "none":
            state["ebuf"] = init_error_buf(params)
        return state

    def init_state(generator: torch.Generator):
        mesh = meshctx.get_mesh()
        if mesh is not None:
            from repro_torch.training.carry import init_placed_state
            return init_placed_state(cfg, tcfg, mesh, generator=generator)
        return state_of(tf.init_params(cfg, device=generator.device,
                                       generator=generator))

    def abstract_state():
        return state_of(tf.abstract_params(cfg))

    def loss_fn(params, batch):
        return tf.loss_fn(params, cfg, batch, zloss=tcfg.zloss)

    def train_step(state, batch):
        if meshctx.get_mesh() is not None:
            batch = {k: meshctx.full(v) for k, v in batch.items()}
        (loss, metrics), grads = accumulate_microbatches(
            loss_fn, state["params"], batch, max(tcfg.microbatch, 1),
            constrain=batch_constraint, constrain_grads=grad_constraint)
        new_state = dict(state)
        if tcfg.grad_compression != "none":
            grads, new_state["ebuf"] = ef_compress_tree(
                grads, state["ebuf"], tcfg.grad_compression, stack=stack)
        grads, gnorm = clip_by_global_norm(grads, tcfg.grad_clip)
        lr = sched(meshctx.local(state["opt"]["step"]))
        params, opt = opt_update(grads, state["opt"], state["params"], lr=lr)
        del grads
        new_state["params"] = params
        new_state["opt"] = opt
        metrics = dict(metrics)
        metrics["loss"] = loss  # accumulated mean, not last-microbatch
        metrics["grad_norm"] = gnorm
        metrics["lr"] = lr
        return new_state, metrics

    return init_state, train_step, abstract_state
