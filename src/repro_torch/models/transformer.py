"""Model assembly: pattern-based block stacks (the port of
``repro.models.transformer``).

A config's ``pattern`` (e.g. ``("attn",)``, ``("attn_moe", "attn")``,
Jamba's 8-layer hybrid unit) is instantiated ``n_units = n_layers /
len(pattern)`` times. The reference stacks the units' parameters along a
leading axis and scans over them; here each unit is its own child of
``units`` (``units.<u>.l<i>...``), run in a loop, so the parameter names
are the reference's paths with the unit's index in place of the stacked
axis. With ``cfg.remat`` and grad on, each layer is recomputed in the
backward (``torch.utils.checkpoint``); the values are the same.

Entry points:
  * ``init_params`` / ``abstract_params`` — the parameter module on a
    device (the card by default) or on the meta device (no allocation).
  * ``forward_train`` / ``loss_fn`` — logits; next-token (causal) or
    framewise (encoder) CE + MoE aux (+ z-loss).
  * ``prefill`` — forward returning the attention layers' KV caches padded
    to S_max.
  * ``init_cache`` / ``decode_step`` — one token against the cache.

On a mesh (``meshctx.set_mesh``; parameters placed by
``carry.place_params``, the cache by ``init_cache(..., mesh=)``) the
entry points take whole inputs and return whole logits on every rank, as
the reference returns replicated results. Between units the activations
are DTensors (batch over the data-parallel axes, ``constrain`` at each
unit boundary); a unit's layers run on the rank's local rows. Decode
attention dispatches to ``gqa_decode_seqpar`` when
``meshctx.seqpar_decode()`` is on. A recurrent layer (Mamba, xLSTM) on a
mesh gathers its mixer's parameters and its state whole for the step and
keeps its own block of the new state. ``loss_fn`` on a mesh takes each
rank's rows and its vocab block (``_mesh_loss``): the train step's
gradients flow back through the collectives by ``meshctx``'s rules.
"""

from __future__ import annotations

import functools

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.edm.dataset import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import meshctx
from repro_torch.models import mamba as mb
from repro_torch.models import moe as moe_mod
from repro_torch.models import xlstm as xl
from repro_torch.models.layers import (
    Init,
    Params,
    embed,
    embedding_init,
    mlp,
    mlp_init,
    rmsnorm,
    rmsnorm_init,
    torch_dtype,
    unembed,
    unembed_ce,
)
from repro_torch.models.meshctx import constrain

ATTN_KINDS = ("attn", "attn_moe")


def _dtype(cfg):
    return torch_dtype(cfg.dtype)


# ------------------------------------------------------------------ init


def _layer_init(kind, rng, cfg, dtype):
    p = {"norm1": rmsnorm_init(rng, cfg.d_model, dtype)}
    if kind in ATTN_KINDS:
        init = attn.mla_init if cfg.attention == "mla" else attn.gqa_init
        p["mix"] = init(rng, cfg, dtype)
    elif kind in ("mamba", "mamba_moe"):
        p["mix"] = mb.mamba_init(rng, cfg, dtype)
    elif kind == "mlstm":
        p["mix"] = xl.mlstm_init(rng, cfg, dtype)
        return p  # single-residual block
    elif kind == "slstm":
        p["mix"] = xl.slstm_init(rng, cfg, dtype)
        return p
    else:
        raise ValueError(f"unknown block kind {kind!r}")
    p["norm2"] = rmsnorm_init(rng, cfg.d_model, dtype)
    if kind.endswith("_moe"):
        p["mlp"] = moe_mod.moe_init(rng, cfg, dtype)
    else:
        p["mlp"] = mlp_init(rng, cfg.d_model, cfg.d_ff, cfg.mlp, dtype)
    return p


def _unit_init(rng, cfg, dtype):
    return {f"l{i}": _layer_init(kind, rng, cfg, dtype)
            for i, kind in enumerate(cfg.pattern)}


def init_params(cfg, *, device="cuda", generator=None) -> Params:
    """The parameter module of ``cfg`` on ``device`` (the card by default;
    raises without CUDA), every initial value drawn from ``generator`` (on
    that device; a new one seeded 0 when None). The tree is the
    reference's: ``embed`` (token-input archs and VLMs), ``units``,
    ``final_norm``, and ``lm_head`` unless the embeddings are tied. On the
    ``meta`` device it allocates and draws nothing."""
    return Params(param_tree(cfg, init_rng(device, generator)))


def init_rng(device, generator=None, keep=None) -> Init:
    """The ``Init`` of ``init_params``: a seeded generator on the device
    when none is given, none on the meta device."""
    dev = torch.device(device)
    if dev.type != "meta":
        dev = resolve_device(dev, "init_params")
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
    return Init(dev, None if dev.type == "meta" else generator, keep)


def param_tree(cfg, rng: Init) -> dict:
    """The parameter tree of ``cfg`` as nested dicts of tensors, drawn in
    ``init_params``' order from ``rng``."""
    dtype = cfg.param_dtype
    tree = {}
    if not cfg.embed_inputs or cfg.family == "vlm":
        tree["embed"] = embedding_init(rng, cfg.vocab_size, cfg.d_model,
                                       dtype)
    tree["units"] = [_unit_init(rng, cfg, dtype) for _ in range(cfg.n_units)]
    tree["final_norm"] = rmsnorm_init(rng, cfg.d_model, dtype)
    if not (cfg.tie_embeddings and "embed" in tree):
        # 1/√d head init keeps init CE ≈ log V (logits O(1))
        tree["lm_head"] = embedding_init(rng, cfg.vocab_size, cfg.d_model,
                                         dtype, scale=cfg.d_model ** -0.5)
    return tree


def abstract_params(cfg) -> Params:
    """The parameter module on the meta device — no allocation."""
    return init_params(cfg, device="meta")


# --------------------------------------------------------------- forward


def _mixer(kind, p):
    """A layer's mixer parameters: a recurrent mixer on a mesh gathered
    whole (its scans read its parameters directly)."""
    mix = p["mix"]
    if (kind in ATTN_KINDS or not isinstance(mix, torch.nn.Module)
            or not meshctx.is_dtensor(next(mix.parameters()))):
        return mix
    return meshctx.full_tree(mix)


def _apply_layer_train(kind, p, x, positions, *, cfg, mode):
    """mode: 'train' (full attention) or 'prefill' (cache out)."""
    cache = None
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    h = rmsnorm(p["norm1"], x, cfg.norm_eps)
    if kind in ATTN_KINDS:
        if cfg.attention == "mla":
            if mode == "prefill":
                y, cache = attn.mla_full(p["mix"], cfg, h, positions,
                                         return_cache=True)
            else:
                y = attn.mla_full(p["mix"], cfg, h, positions)
        else:
            if mode == "prefill":
                y, cache = attn.gqa_prefill(p["mix"], cfg, h, positions)
            else:
                y = attn.gqa_full(p["mix"], cfg, h, positions)
    elif kind in ("mamba", "mamba_moe"):
        y = mb.mamba_train(_mixer(kind, p), cfg, h)
    elif kind == "mlstm":
        return x + xl.mlstm_train(_mixer(kind, p), cfg, h), aux, None
    elif kind == "slstm":
        return x + xl.slstm_train(_mixer(kind, p), cfg, h), aux, None
    x = x + y
    h2 = rmsnorm(p["norm2"], x, cfg.norm_eps)
    if kind.endswith("_moe"):
        y2, aux = moe_mod.moe_apply(p["mlp"], cfg, h2)
    else:
        y2 = mlp(p["mlp"], h2, cfg.mlp)
    return x + y2, aux, cache


def _unit_apply_train(uparams, cfg, x, positions, mode):
    aux_total = 0.0
    caches = {}
    x = constrain(x, "dp", None, None)  # pin batch over data (FSDP contract)
    dt, x = x, meshctx.local(x)
    positions = positions[:x.shape[0]]
    for i, kind in enumerate(cfg.pattern):
        layer = functools.partial(_apply_layer_train, kind, cfg=cfg,
                                  mode=mode)
        if cfg.remat and torch.is_grad_enabled():
            x, aux, cache = checkpoint(layer, uparams[f"l{i}"], x, positions,
                                       use_reentrant=False)
        else:
            x, aux, cache = layer(uparams[f"l{i}"], x, positions)
        aux_total = aux_total + aux
        if cache is not None:
            caches[f"l{i}"] = cache
    return meshctx.wrap_like(x, dt), aux_total, caches


def _stack_forward(params, cfg, x, positions, mode):
    """Run the units in turn. Returns (x, aux, caches): the caches stacked
    along a leading (units,) axis under ``cfg.scan_layers`` (the reference's
    scan output), a list of per-unit dicts otherwise."""
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    caches = []
    for uparams in params["units"]:
        x, aux, c = _unit_apply_train(uparams, cfg, x, positions, mode)
        aux_total = aux_total + aux
        caches.append(c)
    if cfg.scan_layers:
        caches = {name: {k: torch.stack([c[name][k] for c in caches])
                         for k in caches[0][name]}
                  for name in caches[0]}
    return meshctx.local(x), aux_total, caches


def _inputs_to_h(params, cfg, batch):
    if cfg.embed_inputs:
        x = batch["embeds"].to(_dtype(cfg))
    else:
        x = embed(params["embed"], batch["tokens"], _dtype(cfg))
    B, S = x.shape[0], x.shape[1]
    positions = torch.arange(S, dtype=torch.int32,
                             device=x.device)[None].expand(B, S)
    if meshctx.get_mesh() is not None:
        x = meshctx.activation(x)
    return x, positions


def _head(params, cfg, x):
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    table = params["embed"] if (cfg.tie_embeddings and "embed" in params) \
        else params["lm_head"]
    return unembed(table, x)  # (B, S, V) f32


def forward_train(params, cfg, batch):
    """batch: {"tokens": (B, S) int} or {"embeds": (B, S, D)} → (logits
    (B, S, V) float32, MoE aux scalar)."""
    x, positions = _inputs_to_h(params, cfg, batch)
    x, aux, _ = _stack_forward(params, cfg, x, positions, mode="train")
    return meshctx.batch_all(_head(params, cfg, x)), aux


def loss_fn(params, cfg, batch, *, aux_weight: float = 0.01,
            zloss: float = 0.0):
    """Mean CE (+ MoE aux, + optional z-loss). Returns (loss, metrics).
    On a mesh: ``_mesh_loss``."""
    if meshctx.get_mesh() is not None:
        return _mesh_loss(params, cfg, batch, aux_weight, zloss)
    logits, aux = forward_train(params, cfg, batch)
    labels = batch["labels"] if "labels" in batch else batch["tokens"]
    if cfg.causal:
        logits = logits[:, :-1]
        labels = labels[:, 1:]
    logp = torch.log_softmax(logits, dim=-1)
    ce = -torch.gather(logp, -1, labels[..., None].long())[..., 0]
    loss = ce.mean()
    metrics = {"ce": loss, "aux": aux}
    if any(k.endswith("_moe") for k in cfg.pattern):
        loss = loss + aux_weight * aux
    if zloss:
        lse = torch.logsumexp(logits, dim=-1)
        loss = loss + zloss * torch.mean(lse ** 2)
    metrics["loss"] = loss
    return loss, metrics


def _mesh_loss(params, cfg, batch, aux_weight, zloss):
    """``loss_fn`` on a mesh. ``batch``: whole tensors (the same on every
    rank) or DTensors placed by ``batch_specs``; each rank embeds and runs
    its own rows only (its block over the data-parallel axes where they
    divide the batch). The cross-entropy is taken over the rank's rows,
    vocab-parallel over "model" (``layers.unembed_ce``: no logits are
    gathered), as Σ CE / the global token count; the MoE ``aux`` (the dp
    mean of the groups' aux) and the z-loss keep the reference's meaning.
    The loss each rank differentiates is its share of the step's loss (the
    shares sum to it over the data-parallel axes, so each rank's
    gradients are its share too, summed by the collectives' backward and
    ``take_grads``); the returned loss and metrics hold the whole step's
    values (one all-reduce over the data-parallel axes)."""
    mesh = meshctx.get_mesh()
    key = "embeds" if cfg.embed_inputs else "tokens"
    B = batch[key].shape[0]
    local, sharded = {}, False
    for k, v in batch.items():
        local[k], sharded = meshctx.batch_local(v)
    if cfg.embed_inputs:
        x = local["embeds"].to(_dtype(cfg))
    else:
        x = embed(params["embed"], local["tokens"], _dtype(cfg))
    S = x.shape[1]
    positions = torch.arange(S, dtype=torch.int32,
                             device=x.device)[None].expand(x.shape[0], S)
    x = meshctx.rows_activation(x, B, sharded)
    x, aux, _ = _stack_forward(params, cfg, x, positions, mode="train")
    labels = local["labels"] if "labels" in local else local["tokens"]
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    if cfg.causal:
        x, labels = x[:, :-1], labels[:, 1:]
    table = params["embed"] if (cfg.tie_embeddings and "embed" in params) \
        else params["lm_head"]
    ce, lse = unembed_ce(table, x, labels)
    n_dp = meshctx.dp_size(mesh)
    # rows replicated over dp: every dp rank holds the whole batch's loss
    share = 1.0 if sharded else 1.0 / n_dp
    n_tok = B * ce.shape[1]
    ce_part = ce.sum() / n_tok * share
    loss = ce_part
    if any(k.endswith("_moe") for k in cfg.pattern):
        loss = loss + aux_weight * aux / n_dp
    if zloss:
        loss = loss + zloss * torch.sum(lse ** 2) / n_tok * share
    whole = meshctx.all_reduce(torch.stack([ce_part, loss]).detach(),
                               meshctx.DP_AXES, mesh=mesh)
    return whole[1] + (loss - loss.detach()), {
        "ce": whole[0], "aux": aux, "loss": whole[1]}


# --------------------------------------------------------------- serving


def prefill(params, cfg, batch, *, s_max: int | None = None):
    """Forward pass that also returns the attention layers' caches (padded
    to s_max along the sequence axis): (last-position logits (B, 1, V),
    caches). Recurrent layers' states are not returned, as in the
    reference. On a mesh the caches are the rank's batch rows, whole in
    the sequence (unplaced)."""
    x, positions = _inputs_to_h(params, cfg, batch)
    x, _, caches = _stack_forward(params, cfg, x, positions, mode="prefill")
    logits = meshctx.batch_all(_head(params, cfg, x[:, -1:, :]))
    S = positions.shape[1]
    s_max = s_max or S
    caches = _pad_attn_caches(caches, cfg, s_max,
                              axis=2 if cfg.scan_layers else 1)
    return logits, caches


def _map_leaves(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_leaves(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_leaves(fn, v) for v in tree]
    return fn(tree)


def _pad_attn_caches(caches, cfg, s_max, *, axis):
    def pad(leaf):
        if leaf.ndim > axis and leaf.shape[axis] != s_max:
            shape = list(leaf.shape)
            shape[axis] = s_max - leaf.shape[axis]
            return torch.cat([leaf, leaf.new_zeros(shape)], dim=axis)
        return leaf

    return _map_leaves(pad, caches)


def init_cache(cfg, batch: int, s_max: int, dtype=None, abstract=False, *,
               device="cuda", mesh=None):
    """The decode cache tree: ``{"l<i>": {...}}`` with a leading
    (n_units,) axis under ``cfg.scan_layers``, a list of per-unit trees
    otherwise; zeros (xLSTM stabilizers ``m`` at -1e30) on ``device`` (the
    card by default), or meta tensors when ``abstract``. With ``mesh``
    each leaf is a DTensor placed by ``launch.sharding.cache_specs``,
    each rank allocating only its block."""
    dtype = dtype or cfg.dtype
    unit = {}
    for i, kind in enumerate(cfg.pattern):
        if kind in ATTN_KINDS:
            shape_fn = (attn.mla_cache_shape if cfg.attention == "mla"
                        else attn.gqa_cache_shape)
            unit[f"l{i}"] = shape_fn(cfg, batch, s_max, dtype)
        elif kind in ("mamba", "mamba_moe"):
            unit[f"l{i}"] = mb.mamba_cache_shape(cfg, batch, dtype)
        elif kind == "mlstm":
            unit[f"l{i}"] = xl.mlstm_cache_shape(cfg, batch, dtype)
        elif kind == "slstm":
            unit[f"l{i}"] = xl.slstm_cache_shape(cfg, batch, dtype)
    n = cfg.n_units
    dev = torch.device("meta") if abstract else resolve_device(
        device, "init_cache")

    def make(name, sds, lead=()):
        shape = lead + tuple(sds.shape)
        if abstract:
            return torch.empty(shape, dtype=sds.dtype, device=dev)
        fill = xl.M_INIT if name == "m" else 0.0
        return torch.full(shape, fill, dtype=sds.dtype, device=dev)

    def unit_tree(lead):
        return {l: {k: make(k, sds, lead) for k, sds in leaves.items()}
                for l, leaves in unit.items()}

    if mesh is not None:
        return _placed_cache(init_cache(cfg, batch, s_max, dtype, True),
                             mesh, dev, abstract)
    if cfg.scan_layers:
        return unit_tree((n,))
    return [unit_tree(()) for _ in range(n)]


def _placed_cache(abstract_cache, mesh, dev, abstract=False):
    """Zeros (``m`` at -1e30) placed by ``cache_specs``: each rank makes
    only its block (a meta block when ``abstract``)."""
    from torch.distributed.tensor import DTensor

    from repro_torch.launch.sharding import cache_specs, to_placements

    specs = cache_specs(None, mesh, abstract_cache)

    def make(name, t, spec):
        pl = to_placements(mesh, spec)
        shape = list(t.shape)
        for i, p in enumerate(pl):
            if p.is_shard():
                shape[p.dim] //= mesh.size(i)
        fill = xl.M_INIT if name == "m" else 0.0
        local = (torch.empty(shape, dtype=t.dtype, device=dev) if abstract
                 else torch.full(shape, fill, dtype=t.dtype, device=dev))
        return DTensor.from_local(local, mesh, pl, run_check=False,
                                  shape=t.shape, stride=t.stride())

    def walk(t, spec, name=""):
        if isinstance(t, dict):
            return {k: walk(t[k], spec[k], k) for k in t}
        if isinstance(t, list):
            return [walk(a, b, name) for a, b in zip(t, spec)]
        return make(name, t, spec)

    return walk(abstract_cache, specs)


def _apply_layer_decode(kind, p, cfg, x, cache, pos):
    """One layer's decode step; writes the layer's new state into
    ``cache`` in place."""
    h = rmsnorm(p["norm1"], x, cfg.norm_eps)
    if kind in ATTN_KINDS:
        if cfg.attention == "mla":
            fn = attn.mla_decode
        elif meshctx.seqpar_decode():
            fn = attn.gqa_decode_seqpar
        else:
            fn = attn.gqa_decode
        y, _ = fn(p["mix"], cfg, h, cache, pos)
    else:
        state = {k: meshctx.cache_read(v) for k, v in cache.items()}
        if kind in ("mamba", "mamba_moe"):
            y, new = mb.mamba_decode(_mixer(kind, p), cfg, h, state)
        elif kind == "mlstm":
            y, new = xl.mlstm_decode(_mixer(kind, p), cfg, h, state)
        else:
            y, new = xl.slstm_decode(_mixer(kind, p), cfg, h, state)
        for k, v in new.items():
            meshctx.cache_store(cache[k], v)
        if kind in ("mlstm", "slstm"):
            return x + y
    x = x + y
    h2 = rmsnorm(p["norm2"], x, cfg.norm_eps)
    if kind.endswith("_moe"):
        y2, _ = moe_mod.moe_apply(p["mlp"], cfg, h2)
    else:
        y2 = mlp(p["mlp"], h2, cfg.mlp)
    return x + y2


def decode_step(params, cfg, tokens, cache, pos: int):
    """One-token serve step.

    tokens: (B, 1) int (or {"embeds": (B, 1, D)} for pure-embedding archs);
    cache: tree from init_cache (or a prefill's attention caches in the
    same layout); pos: int write position. Writes the step's KV row and
    recurrent states INTO ``cache`` (in place) and returns
    (logits (B, 1, V) float32, that same cache tree). On a mesh, the
    whole batch's tokens go in and its whole logits come out on every
    rank; the cache is placed (``init_cache(..., mesh=)``).
    """
    if isinstance(tokens, dict):
        x = tokens["embeds"].to(_dtype(cfg))
    else:
        x = embed(params["embed"], tokens, _dtype(cfg))
    if meshctx.get_mesh() is not None:
        x = meshctx.activation(x)
    for u, uparams in enumerate(params["units"]):
        # Unit u's slice of a stacked cache is a view: writes reach it.
        ucache = ({name: {k: v[u] for k, v in leaves.items()}
                   for name, leaves in cache.items()}
                  if cfg.scan_layers else cache[u])
        x = constrain(x, "dp", None, None)
        dt, x = x, meshctx.local(x)
        for i, kind in enumerate(cfg.pattern):
            x = _apply_layer_decode(kind, uparams[f"l{i}"], cfg, x,
                                    ucache[f"l{i}"], pos)
        x = meshctx.wrap_like(x, dt)
    return meshctx.batch_all(_head(params, cfg, meshctx.local(x))), cache
