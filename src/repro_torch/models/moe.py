"""Capacity-based Mixture-of-Experts (the port of ``repro.models.moe``).

Dispatch is data movement (sort + capacity scatter/gather), not one-hot
matmuls. Routing takes each token's top-k experts by probability (ties to
the lower expert index, as ``lax.top_k``: a stable descending sort), sorts
the (token, expert) rows by expert (stable), and gives each row its
position in its expert's run; rows at positions ≥ capacity drop (GShard
semantics, capacity_factor 1.25) and read zero back. Shared experts
(DeepSeek) are an always-on fused MLP.

Expert parallelism: with a mesh whose "model" axis (> 1) divides E, the
layer is the reference's fully manual shard_map island on local tensors.
Routing runs per data-parallel shard over its local tokens (the rank's
batch rows: capacity per dp group, so with dp > 1 the result differs from
the no-mesh path by design), each model rank owns E/n experts (its block
of the placed expert banks) and takes its rows by shifting the sorted
expert ids into local range (rows out of range drop), the partial outputs
are summed over "model" by one all-reduce, and ``aux`` is averaged over
the dp axes. Sort, the expert counts and the scatters run on local tensors: no
DTensor strategy is asked for them. Without a mesh the same block runs
with E_loc = E. ``index_add_`` on CUDA sums a token's expert outputs in
no fixed order, so the card is held to a tolerance.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models import meshctx
from repro_torch.models.layers import _init, mlp, mlp_init
from repro_torch.models.meshctx import constrain


def moe_init(rng, cfg, dtype):
    m = cfg.moe
    D, F_, E = cfg.d_model, m.d_ff_expert, m.num_experts
    scale = 1.0 / math.sqrt(D)
    p = {
        "router": _init(rng, (D, E), scale, "float32"),
        "w_gate": _init(rng, (E, D, F_), scale, dtype),
        "w_up": _init(rng, (E, D, F_), scale, dtype),
        "w_down": _init(rng, (E, F_, D), 1.0 / math.sqrt(F_), dtype),
    }
    if m.num_shared:
        p["shared"] = mlp_init(rng, D, F_ * m.num_shared, "swiglu", dtype)
    return p


def _route(xf, router, k, E, cf):
    """Local routing: returns (se, st, pos, wts, counts, probs)."""
    T = xf.shape[0]
    logits = xf.float() @ router  # (T, E)
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_e = top_p[:, :k], top_e[:, :k]
    top_p = top_p / torch.clamp_min(top_p.sum(-1, keepdim=True), 1e-9)
    flat_e = top_e.reshape(T * k)
    flat_p = top_p.reshape(T * k)
    flat_t = torch.arange(T, device=xf.device).repeat_interleave(k)
    order = torch.sort(flat_e, stable=True).indices
    se = flat_e[order]
    st = flat_t[order]
    # The experts' counts by a static-shape scatter (bit-equal to
    # ``bincount(minlength=E)``, and it runs on meta tensors).
    counts = torch.zeros(E, dtype=torch.int64, device=xf.device).scatter_add_(
        0, flat_e, torch.ones_like(flat_e))
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(T * k, device=xf.device) - starts[se]
    return se, st, pos, flat_p[order][:, None], counts, probs


def _capacity(T, k, E, cf):
    return max(4, int(math.ceil(T * k * cf / E)))


def _expert_block(wg, wu, wd, xf, se_loc, st, pos, C):
    """Capacity dispatch + expert FFN + gather back for a LOCAL expert
    bank. Rows with se_loc outside [0, E_loc) or pos ≥ C drop from the
    dispatch and read zero back (the reference's out-of-bounds scatter
    and fill gather).

    Every shape is static (no row selection by value, so it also runs on
    meta tensors): a dropped row is dispatched to a scratch slot past the
    bank (expert E_loc, position 0), which no expert reads, and gathers
    back from a zero slot there."""
    E_loc, D, _ = wg.shape
    keep = (se_loc >= 0) & (se_loc < E_loc) & (pos < C)
    e_k = torch.where(keep, se_loc, E_loc)
    p_k = torch.where(keep, pos, 0)
    h = torch.zeros((E_loc + 1, C, D), dtype=xf.dtype, device=xf.device)
    h[e_k, p_k] = xf[st]
    h = h[:E_loc]
    gate = torch.bmm(h, wg)
    up = torch.bmm(h, wu)
    out = torch.bmm(F.silu(gate) * up, wd)
    out = torch.cat([out, out.new_zeros((1, C, D))])
    return out[e_k, p_k]  # (T·k, D)


def _moe_local(x, router, wg, wu, wd, shard_id=0, *, k, E, cf, mesh=None,
               dp_names=()):
    """The body shared by the expert-parallel island (local shapes; the
    bank holds E_loc experts from ``shard_id`` · E_loc) and the no-mesh
    path."""
    B, S, D = x.shape
    T = B * S
    xf = x.reshape(T, D)
    se, st, pos, wts, counts, probs = _route(xf, router, k, E, cf)
    C = _capacity(T, k, E, cf)
    E_loc = wg.shape[0]
    if E_loc != E:
        # Expert-parallel: this rank computes its experts' rows only, so
        # the gradients of the tokens it dispatches and of their routing
        # weights are partial sums over "model" (the routing itself runs
        # whole on every model rank).
        xf_e = meshctx.sum_grad(xf, "model", mesh)
        wts = meshctx.sum_grad(wts, "model", mesh)
    else:
        xf_e = xf
    gathered = _expert_block(wg, wu, wd, xf_e, se - shard_id * E_loc, st,
                             pos, C)
    y = torch.zeros((T, D), dtype=x.dtype, device=x.device).index_add_(
        0, st, wts.to(x.dtype) * gathered)
    if E_loc != E:  # expert-parallel: combine partial outputs
        y = meshctx.all_reduce(y, "model", mesh=mesh)
    aux = E * torch.sum((counts.float() / (T * k)) * probs.mean(0))
    if dp_names:
        n = 1
        for a in dp_names:
            n *= meshctx.axis_len(a, mesh)
        aux = meshctx.all_reduce(aux, dp_names, mesh=mesh) / n
    return y.reshape(B, S, D), aux


def moe_apply(p, cfg, x):
    """x: (B, S, D) → (y (B, S, D), aux load-balance loss scalar). On a
    mesh ``x`` is the rank's batch rows (replicated over "model")."""
    m = cfg.moe
    E = m.num_experts
    dtype = x.dtype
    mesh = meshctx.get_mesh()
    n_model = meshctx.axis_len("model", mesh)
    kw = dict(k=m.top_k, E=E, cf=m.capacity_factor)
    if mesh is not None and n_model > 1 and E % n_model == 0:
        dp = tuple(a for a in meshctx.DP_AXES if a in mesh.mesh_dim_names)
        # routing per dp group when the activations' batch is over dp
        dp_names = dp if meshctx.batch_sharded() else ()
        banks = [_expert_bank(p[n], mesh, dtype)
                 for n in ("w_gate", "w_up", "w_down")]
        y, aux = _moe_local(x, meshctx.full(p["router"]), *banks,
                            meshctx.coordinate("model", mesh), mesh=mesh,
                            dp_names=dp_names, **kw)
    else:  # routing over the whole batch, as without a mesh
        y, aux = _moe_local(meshctx.batch_all(x), meshctx.full(p["router"]),
                            *(meshctx.full(p[n]).to(dtype)
                              for n in ("w_gate", "w_up", "w_down")), **kw)
        y = meshctx.batch_rows(y)
    y = constrain(y, "dp", None, None)
    if m.num_shared:
        y = y + mlp(p["shared"], x, "swiglu")
    return y, aux


def _expert_bank(w, mesh, dtype):
    """This model rank's E/n experts of a bank, whole in their other dims
    (a placed bank's FSDP dims all-gathered; a whole one cut)."""
    if meshctx.is_dtensor(w) and meshctx.sharded_dims(w).get("model") == 0:
        local = meshctx.gather(w, tuple(
            a for a in w.device_mesh.mesh_dim_names if a != "model"))
    else:
        local = meshctx.block(meshctx.full(w), "model", 0, mesh)
    return local.to(dtype)
