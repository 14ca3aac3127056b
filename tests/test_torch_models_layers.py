"""The port's LM layers and attention (``repro_torch.models.layers``,
``.attention``) against the reference's on the same numpy inputs and the
reference's initial weights, float32 on the CPU (``torch_lm`` tolerances),
and the port's own initializers against the reference's shapes, dtypes
and distributions."""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as ra
from repro.models import layers as rl
from repro_torch.models import attention as pa
from repro_torch.models import layers as pl
from torch_lm import close, close_trees, configs, to_torch

B, S = 2, 16


def _x(seed, *shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _rng(device="cpu", seed=0):
    return pl.Init(torch.device(device),
                   torch.Generator(device=device).manual_seed(seed))


# ----------------------------------------------------------------- layers


@pytest.mark.parametrize("bias", [False, True])
def test_dense(bias):
    p = rl.dense_init(jax.random.key(1), 24, 40, jnp.float32, bias=bias)
    if bias:
        p["b"] = jnp.asarray(_x(2, 40))
    x = _x(3, B, S, 24)
    close(pl.dense(to_torch(p), torch.from_numpy(x)), rl.dense(p, x))


def test_dense_casts_the_weight_to_the_input_dtype():
    p = {"w": torch.randn(8, 4)}
    x = torch.randn(3, 8, dtype=torch.bfloat16)
    y = pl.dense(p, x)
    assert y.dtype == torch.bfloat16
    assert torch.equal(y, x @ p["w"].to(torch.bfloat16))


def test_rmsnorm():
    g = jnp.asarray(1.0 + 0.1 * _x(4, 32))
    x = 3.0 * _x(5, B, S, 32)
    close(pl.rmsnorm({"g": torch.from_numpy(np.array(g))},
                     torch.from_numpy(x), 1e-5),
          rl.rmsnorm({"g": g}, x, 1e-5))


def test_rmsnorm_round_trips_through_float32_in_bf16():
    x = torch.randn(4, 64).to(torch.bfloat16)
    g = torch.randn(64)
    y = pl.rmsnorm({"g": g}, x)
    x32 = x.float()
    want = (x32 * torch.rsqrt((x32 * x32).mean(-1, keepdim=True) + 1e-5)
            ).to(torch.bfloat16) * g.to(torch.bfloat16)
    assert y.dtype == torch.bfloat16 and torch.equal(y, want)


@pytest.mark.parametrize("theta", [10_000.0, 500_000.0])
def test_apply_rope_splits_halves(theta):
    x = _x(6, B, S, 4, 16)
    pos = np.random.default_rng(7).integers(0, 4000, (B, S)).astype(np.int32)
    close(pl.rope_frequencies(16, theta), rl.rope_frequencies(16, theta))
    close(pl.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta),
          rl.apply_rope(x, pos, theta), atol=1e-4)


@pytest.mark.parametrize("kind", ["swiglu", "relu2", "gelu"])
def test_mlp(kind):
    p = rl.mlp_init(jax.random.key(8), 32, 48, kind, jnp.float32)
    x = _x(9, B, S, 32)
    close(pl.mlp(to_torch(p), torch.from_numpy(x), kind), rl.mlp(p, x, kind))


def test_mlp_rejects_an_unknown_kind():
    with pytest.raises(ValueError, match="unknown mlp kind"):
        pl.mlp_init(_rng(), 8, 8, "tanh", "float32")


def test_embed_gathers_then_casts_bit_equal_to_cast_then_gather():
    p = rl.embedding_init(jax.random.key(10), 50, 16, jnp.float32)
    tok = np.random.default_rng(11).integers(0, 50, (B, S)).astype(np.int32)
    pt = to_torch(p)
    got = pl.embed(pt, torch.from_numpy(tok))
    close(got, rl.embed(p, tok), rtol=0, atol=0)
    bf = pl.embed(pt, torch.from_numpy(tok), "bfloat16")
    assert torch.equal(bf, pt["table"].to(torch.bfloat16)[tok])


def test_unembed_in_float32():
    p = rl.embedding_init(jax.random.key(12), 50, 16, jnp.float32)
    x = _x(13, B, S, 16)
    got = pl.unembed(to_torch(p), torch.from_numpy(x).to(torch.bfloat16))
    assert got.dtype == torch.float32
    close(pl.unembed(to_torch(p), torch.from_numpy(x)), rl.unembed(p, x))


def test_init_draws_a_truncated_normal():
    t = pl._init(_rng(), (200, 300), 0.5, "float32")
    assert t.dtype == torch.float32 and t.abs().max() <= 1.0
    # N(0, 1) truncated to ±2 has std 0.8796.
    assert abs(float(t.std()) / 0.5 - 0.8796) < 0.01
    r = rl._init(jax.random.key(0), (200, 300), 0.5, jnp.float32)
    assert abs(float(jnp.std(r)) - float(t.std())) < 0.01
    bf = pl._init(_rng(), (4, 4), 1.0, "bfloat16")
    assert bf.dtype == torch.bfloat16
    meta = pl._init(pl.Init(torch.device("meta"), None), (10**6, 10**6), 1.0,
                    "float32")
    assert meta.is_meta and meta.shape == (10**6, 10**6)


def test_init_is_reproducible_from_the_generator():
    a = pl.dense_init(_rng(seed=3), 8, 8, "float32")["w"]
    b = pl.dense_init(_rng(seed=3), 8, 8, "float32")["w"]
    c = pl.dense_init(_rng(seed=4), 8, 8, "float32")["w"]
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_params_reads_like_the_reference_dicts():
    p = pl.Params({"w": torch.ones(2, 2), "sub": {"g": torch.zeros(2)},
                   "units": [{"b": torch.ones(1)}, {"b": torch.zeros(1)}]})
    assert "w" in p and "sub" in p and "b" not in p
    assert torch.equal(p["sub"]["g"], torch.zeros(2))
    assert sorted(n for n, _ in p.named_parameters()) == [
        "sub.g", "units.0.b", "units.1.b", "w"]


# -------------------------------------------------------------- attention


def _positions(B, S):
    return np.broadcast_to(np.arange(S, dtype=np.int32)[None], (B, S)).copy()


@pytest.mark.parametrize("arch,replace", [
    ("llama3-8b", {}),                     # GQA, G = 2
    ("qwen1.5-4b", {}),                    # qkv bias, G = 1
    ("hubert-xlarge", {}),                 # bidirectional
    ("llama3-8b", dict(attn_full_max=8, attn_chunk_q=8)),     # chunked
    ("hubert-xlarge", dict(attn_full_max=8, attn_chunk_q=4)),  # chunked
])
def test_gqa_full_and_prefill(arch, replace):
    rcfg, pcfg = configs(arch, **replace)
    p = ra.gqa_init(jax.random.key(20), rcfg, jnp.float32)
    if rcfg.qkv_bias:
        for n, s in (("wq", 21), ("wk", 22), ("wv", 23)):
            p[n]["b"] = jnp.asarray(_x(s, p[n]["w"].shape[1]))
    x, pos = _x(24, B, S, rcfg.d_model), _positions(B, S)
    pt, xt, post = to_torch(p), torch.from_numpy(x), torch.from_numpy(pos)
    close(pa.gqa_full(pt, pcfg, xt, post), ra.gqa_full(p, rcfg, x, pos))
    out, cache = pa.gqa_prefill(pt, pcfg, xt, post)
    r_out, r_cache = ra.gqa_prefill(p, rcfg, x, pos)
    close(out, r_out)
    close_trees(cache, r_cache)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("cq,G", [(4, 1), (8, 2), (16, 3)])
def test_chunked_causal(causal, cq, G):
    q, k, v = _x(30, B, 32, 2, G, 8), _x(31, B, 32, 2, 8), _x(32, B, 32, 2, 6)
    got = pa._chunked_causal(*map(torch.from_numpy, (q, k, v)), cq=cq,
                             scale=0.3, causal=causal)
    close(got, ra._chunked_causal(q, k, v, cq=cq, scale=0.3, causal=causal))


def test_chunked_gqa_equals_the_full_path():
    rcfg, pcfg = configs("llama3-8b")
    p = to_torch(ra.gqa_init(jax.random.key(33), rcfg, jnp.float32))
    x = torch.from_numpy(_x(34, B, 32, rcfg.d_model))
    pos = torch.from_numpy(_positions(B, 32))
    full = pa.gqa_full(p, pcfg, x, pos)
    chunked = pa.gqa_full(
        p, dataclasses.replace(pcfg, attn_full_max=8, attn_chunk_q=8), x, pos)
    close(chunked, full.detach().numpy())


def test_gqa_decode_writes_the_cache_in_place():
    rcfg, pcfg = configs("yi-6b")   # G = 4
    p = ra.gqa_init(jax.random.key(40), rcfg, jnp.float32)
    pt = to_torch(p)
    S_max = 12
    shp = (B, S_max, rcfg.n_kv_heads, rcfg.d_head)
    r_cache = {"k": jnp.zeros(shp), "v": jnp.zeros(shp)}
    cache = {"k": torch.zeros(shp), "v": torch.zeros(shp)}
    want = pa.gqa_cache_shape(pcfg, B, S_max, "float32")
    assert all(cache[n].shape == want[n].shape for n in cache)
    xs = _x(41, B, 6, rcfg.d_model)
    for t in range(6):
        x = xs[:, t:t + 1]
        r_out, r_cache = ra.gqa_decode(p, rcfg, x, r_cache, jnp.int32(t))
        out, c = pa.gqa_decode(pt, pcfg, torch.from_numpy(x), cache, t)
        assert c is cache
        close(out, r_out)
        close_trees(cache, r_cache)
    # Decoding position by position equals the full causal pass.
    full = pa.gqa_full(pt, pcfg, torch.from_numpy(xs),
                       torch.from_numpy(_positions(B, 6)))
    close(out[:, 0], full[:, -1].detach().numpy())


def _mla():
    rcfg, pcfg = configs("deepseek-v2-lite-16b")
    p = ra.mla_init(jax.random.key(50), rcfg, jnp.float32)
    return rcfg, pcfg, p, to_torch(p)


@pytest.mark.parametrize("replace", [{}, dict(attn_full_max=8,
                                              attn_chunk_q=8)])
def test_mla_full(replace):
    rcfg, pcfg, p, pt = _mla()
    rcfg, pcfg = (dataclasses.replace(c, **replace) for c in (rcfg, pcfg))
    x, pos = _x(51, B, S, rcfg.d_model), _positions(B, S)
    xt, post = torch.from_numpy(x), torch.from_numpy(pos)
    close(pa.mla_full(pt, pcfg, xt, post), ra.mla_full(p, rcfg, x, pos))
    out, cache = pa.mla_full(pt, pcfg, xt, post, return_cache=True)
    r_out, r_cache = ra.mla_full(p, rcfg, x, pos, return_cache=True)
    close(out, r_out)
    close_trees(cache, r_cache)


def test_mla_decode_absorbed_form():
    rcfg, pcfg, p, pt = _mla()
    S_max, T = 10, 7
    shapes = pa.mla_cache_shape(pcfg, B, S_max, "float32")
    cache = {n: torch.zeros(s.shape) for n, s in shapes.items()}
    r_cache = {n: jnp.zeros(s.shape) for n, s in shapes.items()}
    xs = _x(52, B, T, rcfg.d_model)
    outs = []
    for t in range(T):
        x = xs[:, t:t + 1]
        r_out, r_cache = ra.mla_decode(p, rcfg, x, r_cache, jnp.int32(t))
        out, c = pa.mla_decode(pt, pcfg, torch.from_numpy(x), cache, t)
        assert c is cache
        close(out, r_out)
        close_trees(cache, r_cache)
        outs.append(out[:, 0])
    # The absorbed decode equals the non-absorbed full pass at every
    # position, and its cache the full pass's latents.
    full, fc = pa.mla_full(pt, pcfg, torch.from_numpy(xs),
                           torch.from_numpy(_positions(B, T)),
                           return_cache=True)
    close(torch.stack(outs, 1), full.detach().numpy())
    close(cache["c_kv"][:, :T], fc["c_kv"].detach().numpy())
    close(cache["k_rope"][:, :T], fc["k_rope"].detach().numpy())


def test_mla_decode_promotes_bf16_activations_against_f32_weights():
    _, pcfg, _, pt = _mla()
    pcfg = dataclasses.replace(pcfg, dtype="bfloat16")
    shapes = pa.mla_cache_shape(pcfg, 1, 4, "bfloat16")
    cache = {n: torch.zeros(s.shape, dtype=s.dtype) for n, s in
             shapes.items()}
    x = torch.randn(1, 1, pcfg.d_model).to(torch.bfloat16)
    out, _ = pa.mla_decode(pt, pcfg, x, cache, 0)
    assert out.dtype == torch.bfloat16 and torch.isfinite(out).all()


def test_cache_shapes_match_the_reference():
    for arch, fn in (("llama3-8b", "gqa_cache_shape"),
                     ("deepseek-v2-lite-16b", "mla_cache_shape")):
        rcfg, pcfg = configs(arch)
        want = getattr(ra, fn)(rcfg, 3, 7, jnp.bfloat16)
        got = getattr(pa, fn)(pcfg, 3, 7, "bfloat16")
        assert set(got) == set(want)
        for n in got:
            assert got[n].is_meta and tuple(got[n].shape) == want[n].shape
            assert got[n].dtype == torch.bfloat16


def test_sdpa_takes_float32_scores_from_bf16_operands():
    """Scores come out float32 from bf16 q and k, as the reference's
    ``preferred_element_type``."""
    q = torch.randn(1, 3, 2, 2, 8).to(torch.bfloat16)
    k = torch.randn(1, 5, 2, 8).to(torch.bfloat16)
    v = torch.randn(1, 5, 2, 8).to(torch.bfloat16)
    out = pa._sdpa(q, k, v, None, 1 / math.sqrt(8))
    s = torch.einsum("bqhgd,bkhd->bhgqk", q.float(), k.float()) / math.sqrt(8)
    want = torch.einsum("bhgqk,bkhd->bqhgd",
                        torch.softmax(s, -1).to(torch.bfloat16), v)
    assert out.dtype == torch.bfloat16 and torch.equal(out, want)
