"""Attention: GQA (full / chunked-prefill / decode) and MLA (DeepSeek).

The port of ``repro.models.attention``, op for op in eager PyTorch (no
``scaled_dot_product_attention``, no fused kernel). Forms:
  * ``full``   — S×S masked attention, used for train (S ≤ attn_full_max).
  * ``chunked``— online softmax over square KV chunks for long prefill;
    memory is O(chunk_q × S) instead of O(S²). Out-of-range chunks are
    masked, not skipped, as in the reference.
  * ``decode`` — one new token against a (B, S, Hkv, dh) cache written at
    position ``pos``; the cache is written in place.

The reference's ``einsum(..., preferred_element_type=float32)`` gives
float32 scores from low-precision operands; here q and k are cast to
float32 before the product, and the softmax is cast back to ``v.dtype``
where the reference casts it.

MLA (Multi-head Latent Attention) caches only the latent + shared rope
key; decode uses the *absorbed* form (W_uk folded into the query, W_uv
deferred past the probability average).

On a mesh (``meshctx``) a decode cache's sequence axis is sharded over
"model": ``gqa_decode`` and ``mla_decode`` write the new row on its owning
rank and all-gather the sequence for the attention (the reference's GSPMD
program re-gathers the cache the same way), while ``gqa_decode_seqpar``
is the reference's shard_map island: each rank attends over its own
positions and one max and two sums (in one all-reduce) over "model"
recombine the softmax.
"""

from __future__ import annotations

import functools
import math

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import meshctx
from repro_torch.models.layers import (abstract, apply_rope, dense,
                                      dense_init, dense_many)

NEG_INF = -1e30


def _promote(a, b):
    """Cast both operands of a product to their common dtype (JAX promotes
    mixed bf16/f32 products; ``torch.einsum`` refuses them)."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt), b.to(dt)


# ----------------------------------------------------------------- GQA


def gqa_init(rng, cfg, dtype):
    D, Hq, Hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    return {
        "wq": dense_init(rng, D, Hq * dh, dtype, bias=cfg.qkv_bias),
        "wk": dense_init(rng, D, Hkv * dh, dtype, bias=cfg.qkv_bias),
        "wv": dense_init(rng, D, Hkv * dh, dtype, bias=cfg.qkv_bias),
        "wo": dense_init(rng, Hq * dh, D, dtype),
    }


def _heads(cfg, p, x, positions):
    B, S, _ = x.shape
    Hq, Hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    G = Hq // Hkv
    q, k, v = dense_many([p["wq"], p["wk"], p["wv"]], x)
    q = q.reshape(B, S, Hq, dh)
    k = k.reshape(B, S, Hkv, dh)
    v = v.reshape(B, S, Hkv, dh)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q.reshape(B, S, Hkv, G, dh), k, v


def _sdpa(q, k, v, mask, scale):
    """q (B,Sq,H,G,d), k/v (B,Sk,H,d), mask (Sq,Sk) or None → (B,Sq,H,G,d)."""
    s = torch.einsum("bqhgd,bkhd->bhgqk", q.float(), k.float()) * scale
    if mask is not None:
        s = torch.where(mask, s, NEG_INF)
    a = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.einsum("bhgqk,bkhd->bqhgd", a, v)


def _causal_mask(S, device):
    return torch.ones((S, S), dtype=torch.bool, device=device).tril()


def gqa_full(p, cfg, x, positions):
    """Training attention: full masked S×S for short sequences, chunked
    online softmax (recomputed in the backward when grad is on) beyond
    attn_full_max."""
    B, S, D = x.shape
    q, k, v = _heads(cfg, p, x, positions)
    cq = min(cfg.attn_chunk_q, S)
    if S <= cfg.attn_full_max or S % cq != 0:
        mask = _causal_mask(S, x.device) if cfg.causal else None
        out = _sdpa(q, k, v, mask, 1.0 / math.sqrt(cfg.d_head))
    else:
        out = _checkpointed_chunks(q, k, v, cq=cq,
                                   scale=1.0 / math.sqrt(cfg.d_head),
                                   causal=cfg.causal)
    return dense(p["wo"], out.reshape(B, S, -1).to(x.dtype))


def gqa_prefill(p, cfg, x, positions):
    """Chunked prefill. Returns (out, cache {k, v})."""
    B, S, D = x.shape
    q, k, v = _heads(cfg, p, x, positions)
    cq = min(cfg.attn_chunk_q, S)
    if S <= cfg.attn_full_max or S % cq != 0:
        mask = _causal_mask(S, x.device) if cfg.causal else None
        out = _sdpa(q, k, v, mask, 1.0 / math.sqrt(cfg.d_head))
    else:
        out = _chunked_causal(q, k, v, cq=cq,
                              scale=1.0 / math.sqrt(cfg.d_head),
                              causal=cfg.causal)
    out = dense(p["wo"], out.reshape(B, S, -1).to(x.dtype))
    return out, {"k": k, "v": v}


def _checkpointed_chunks(q, k, v, **kw):
    """``_chunked_causal``, recomputed in the backward when grad is on (the
    reference's ``jax.checkpoint``): the values are the same."""
    fn = functools.partial(_chunked_causal, **kw)
    if torch.is_grad_enabled():
        return checkpoint(fn, q, k, v, use_reentrant=False)
    return fn(q, k, v)


def _chunked_causal(q, k, v, *, cq, scale, causal=True):
    """Online softmax over KV chunks; the masked variant (every query chunk
    visits every key chunk, the ones past it fully masked).

    q: (B, S, H, G, d) in S/cq query chunks; each accumulates (m, l, o)
    across the S/cq key chunks, float32, with causal masking if asked.
    """
    B, S, H, G, d = q.shape
    dv = v.shape[-1]  # may differ from the QK dim (MLA)
    nq = S // cq
    ck = cq  # square chunks keep the mask logic trivial
    qc = q.reshape(B, nq, cq, H, G, d)
    kc = k.reshape(B, nq, ck, H, d)
    vc = v.reshape(B, nq, ck, H, dv)
    base = torch.ones((cq, ck), dtype=torch.bool, device=q.device).tril()
    full = torch.ones_like(base)
    empty = torch.zeros_like(base)
    outs = []
    for i in range(nq):
        qi = qc[:, i].float()
        m = torch.full((B, H, G, cq), NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros((B, H, G, cq), dtype=torch.float32, device=q.device)
        o = torch.zeros((B, H, G, cq, dv), dtype=torch.float32,
                        device=q.device)
        for j in range(nq):
            s = torch.einsum("bqhgd,bkhd->bhgqk", qi, kc[:, j].float()) * scale
            if causal:
                # j < i: fully visible; j == i: diagonal; j > i: masked.
                mask = full if j < i else (base if j == i else empty)
                s = torch.where(mask, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(-1))
            pr = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + pr.sum(-1)
            o = o * corr[..., None] + torch.einsum(
                "bhgqk,bkhd->bhgqd", pr, vc[:, j].float())
            m = m_new
        out = o / torch.clamp_min(l, 1e-30)[..., None]
        outs.append(out.permute(0, 3, 1, 2, 4))  # (B, cq, H, G, dv)
    return torch.cat(outs, dim=1)


def gqa_decode(p, cfg, x, cache, pos: int):
    """One-token decode against a seq-major cache, its row ``pos`` written
    in place.

    x: (B, 1, D); cache: {k, v} of (B, S_max, Hkv, dh); pos: int.
    """
    B, _, D = x.shape
    dh = cfg.d_head
    S_max = cache["k"].shape[1]
    positions = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    q, k, v = _heads(cfg, p, x, positions)
    meshctx.cache_write_row(cache["k"], pos, k[:, 0])
    meshctx.cache_write_row(cache["v"], pos, v[:, 0])
    ck, cv = meshctx.cache_read_many([cache["k"], cache["v"]])
    mask = (torch.arange(S_max, device=x.device) <= pos)[None, :]
    out = _sdpa(q, ck, cv, mask, 1.0 / math.sqrt(dh))
    out = dense(p["wo"], out.reshape(B, 1, -1).to(x.dtype))
    return out, cache


def gqa_cache_shape(cfg, batch, s_max, dtype):
    shp = (batch, s_max, cfg.n_kv_heads, cfg.d_head)
    return {"k": abstract(shp, dtype), "v": abstract(shp, dtype)}


# ----------------------------------------------------------------- MLA


def mla_init(rng, cfg, dtype):
    D, H = cfg.d_model, cfg.n_heads
    r, dn, dr, dv = (cfg.kv_lora_rank, cfg.qk_nope_dim, cfg.qk_rope_dim,
                     cfg.v_head_dim)
    return {
        "wq": dense_init(rng, D, H * (dn + dr), dtype),
        "w_dkv": dense_init(rng, D, r, dtype),
        "w_kr": dense_init(rng, D, dr, dtype),
        "w_uk": dense_init(rng, r, H * dn, dtype),
        "w_uv": dense_init(rng, r, H * dv, dtype),
        "wo": dense_init(rng, H * dv, D, dtype),
    }


def _mla_q(p, cfg, x, positions, q=None):
    """(q_nope, q_rope) of x, or of its query projection ``q``."""
    B, S, _ = x.shape
    H, dn, dr = cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim
    q = (dense(p["wq"], x) if q is None else q).reshape(B, S, H, dn + dr)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    return q_nope, q_rope


def mla_full(p, cfg, x, positions, *, return_cache=False):
    """Standard (non-absorbed) MLA — train/prefill path."""
    B, S, _ = x.shape
    H, dn, dr, dv = (cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim,
                     cfg.v_head_dim)
    q_nope, q_rope = _mla_q(p, cfg, x, positions)
    c_kv = dense(p["w_dkv"], x)  # (B, S, r) — this is the whole KV cache
    k_rope = apply_rope(dense(p["w_kr"], x)[:, :, None, :], positions,
                        cfg.rope_theta)  # (B, S, 1, dr) shared
    k_nope = dense(p["w_uk"], c_kv).reshape(B, S, H, dn)
    v = dense(p["w_uv"], c_kv).reshape(B, S, H, dv)
    scale = 1.0 / math.sqrt(dn + dr)
    cq = min(cfg.attn_chunk_q, S)
    if S > cfg.attn_full_max and S % cq == 0:
        q_full = torch.cat([q_nope, q_rope], dim=-1)[:, :, :, None, :]
        k_full = torch.cat([k_nope, k_rope.expand(B, S, H, dr)], dim=-1)
        out = _checkpointed_chunks(q_full, k_full, v, cq=cq, scale=scale,
                                   causal=cfg.causal).reshape(B, S, H * dv)
    else:
        s = (
            torch.einsum("bqhd,bkhd->bhqk", q_nope.float(), k_nope.float())
            + torch.einsum("bqhd,bkxd->bhqk", q_rope.float(), k_rope.float())
        ) * scale
        if cfg.causal:
            s = torch.where(_causal_mask(S, x.device), s, NEG_INF)
        a = torch.softmax(s, dim=-1).to(v.dtype)
        out = torch.einsum("bhqk,bkhd->bqhd", a, v).reshape(B, S, H * dv)
    out = dense(p["wo"], out.to(x.dtype))
    if return_cache:
        return out, {"c_kv": c_kv, "k_rope": k_rope[:, :, 0, :]}
    return out


def _latent_block(w):
    """(this rank's rows of a latent-side weight placed with r over
    "model", their offset in r), or None when it is not so placed."""
    if not (meshctx.is_dtensor(w) and meshctx.sharded_dims(w).get("model")
            == 0):
        return None
    local = meshctx.gather(w, tuple(
        a for a in w.device_mesh.mesh_dim_names if a != "model"))
    return local, meshctx.coordinate("model", w.device_mesh) * local.shape[0]


def mla_decode(p, cfg, x, cache, pos: int):
    """Absorbed-form decode: scores/values live in the r-dim latent space.
    The cache's row ``pos`` is written in place. With W_uk and W_uv placed
    with r over "model", each rank contracts its block of r: the latent
    scores' and the output's partial sums are all-reduced (kilobytes, where
    gathering the two weights would move megabytes a layer)."""
    B, _, _ = x.shape
    H, dn, dr, dv = (cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim,
                     cfg.v_head_dim)
    S_max = cache["c_kv"].shape[1]
    positions = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    q, c_new, kr = dense_many([p["wq"], p["w_dkv"], p["w_kr"]], x)
    q_nope, q_rope = _mla_q(p, cfg, x, positions, q)  # (B,1,H,dn),(B,1,H,dr)
    kr_new = apply_rope(kr[:, :, None, :], positions,
                        cfg.rope_theta)[:, :, 0, :]  # c_new: (B, 1, r)
    meshctx.cache_write_row(cache["c_kv"], pos, c_new[:, 0])
    meshctx.cache_write_row(cache["k_rope"], pos, kr_new[:, 0])
    c_kv, k_rope = meshctx.cache_read_many([cache["c_kv"], cache["k_rope"]])
    w_uk, w_uv = p["w_uk"]["w"], p["w_uv"]["w"]
    blocks = (_latent_block(w_uk), _latent_block(w_uv))
    mesh = None
    if None not in blocks and blocks[0][1] == blocks[1][1]:
        (w_uk, lo), (w_uv, _) = blocks
        mesh = p["w_uk"]["w"].device_mesh
        c_kv = c_kv[..., lo:lo + w_uk.shape[0]]
    else:
        w_uk, w_uv = meshctx.full(w_uk), meshctx.full(w_uv)
    r = w_uk.shape[0]
    # absorb W_uk into the query: q̃ (B,1,H,r)
    q_lat = torch.einsum("bqhd,rhd->bqhr",
                         *_promote(q_nope, w_uk.reshape(r, H, dn)))
    s = torch.einsum("bqhr,bkr->bhqk", q_lat.float(), c_kv.float())
    if mesh is not None:
        s = meshctx.all_reduce(s, "model", mesh=mesh)
    s = (s + torch.einsum("bqhd,bkd->bhqk", q_rope.float(), k_rope.float())
         ) / math.sqrt(dn + dr)
    mask = (torch.arange(S_max, device=x.device) <= pos)[None, :]
    s = torch.where(mask, s, NEG_INF)
    a = torch.softmax(s, dim=-1)
    o_lat = torch.einsum("bhqk,bkr->bqhr", a, c_kv.float())
    out = torch.einsum("bqhr,rhd->bqhd",
                       *_promote(o_lat, w_uv.reshape(r, H, dv)))
    if mesh is not None:
        out = meshctx.all_reduce(out, "model", mesh=mesh)
    out = dense(p["wo"], out.reshape(B, 1, H * dv).to(x.dtype))
    return out, cache


def mla_cache_shape(cfg, batch, s_max, dtype):
    return {
        "c_kv": abstract((batch, s_max, cfg.kv_lora_rank), dtype),
        "k_rope": abstract((batch, s_max, cfg.qk_rope_dim), dtype),
    }


# ------------------------------------------- sequence-parallel decode


def gqa_decode_seqpar(p, cfg, x, cache, pos: int):
    """Decode attention with the KV cache's sequence axis sharded over the
    "model" mesh axis (the reference's fully manual shard_map island, with
    its flash-style combine).

    Each model rank owns S_max/n cache positions: the new KV row is written
    only by the owning rank, every rank computes a partial (m, l, o) over
    its local positions, and the exact softmax recombines with one max and
    two sums over "model" of (B, H, G[, d]), the sums joined in one
    all-reduce. q, k and v enter replicated
    over "model" (``dense`` gathers them), x and the cache hold the rank's
    batch rows. Falls back to ``gqa_decode`` when n does not divide S_max.
    """
    mesh = meshctx.get_mesh()
    n_model = meshctx.axis_len("model", mesh)
    S_max = cache["k"].shape[1]
    if S_max % n_model:
        return gqa_decode(p, cfg, x, cache, pos)
    B, _, D = x.shape
    Hq, dh = cfg.n_heads, cfg.d_head
    S_loc = S_max // n_model
    sid = meshctx.coordinate("model", mesh)
    positions = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    q, k, v = _heads(cfg, p, x, positions)  # (B,1,Hkv,G,dh),(B,1,Hkv,dh)×2
    scale = 1.0 / math.sqrt(dh)
    meshctx.cache_write_row(cache["k"], pos, k[:, 0])
    meshctx.cache_write_row(cache["v"], pos, v[:, 0])
    ck, cv = (c.to_local() if meshctx.is_dtensor(c) else c
              for c in (cache["k"], cache["v"]))
    if ck.shape[1] != S_loc:  # a cache not sharded over "model"
        ck = meshctx.block(ck, "model", 1, mesh)
        cv = meshctx.block(cv, "model", 1, mesh)
    s = torch.einsum("bqhgd,bkhd->bhgqk", q.float(), ck.float()) * scale
    gidx = sid * S_loc + torch.arange(S_loc, device=x.device)
    s = torch.where(gidx <= pos, s, NEG_INF)
    m = s.amax(-1)  # (B,H,G,1)
    pexp = torch.exp(s - m[..., None])
    l = pexp.sum(-1)
    o = torch.einsum("bhgqk,bkhd->bhgqd", pexp, cv.float())
    m_g = meshctx.all_reduce(m, "model", "max", mesh)
    corr = torch.exp(m - m_g)
    # the two sums in one all-reduce: l beside o's last dim
    lo = meshctx.all_reduce(torch.cat([o * corr[..., None],
                                       (l * corr)[..., None]], -1),
                            "model", mesh=mesh)
    o_g, l_g = lo[..., :-1], lo[..., -1]
    out = o_g / torch.clamp_min(l_g, 1e-30)[..., None]
    out = out.permute(0, 3, 1, 2, 4).reshape(B, 1, Hq * dh)
    out = dense(p["wo"], out.to(x.dtype))
    return out, cache
