"""Serving entry points of the port's models against the reference:
``init_cache``, ``decode_step`` (logits and every cache leaf, position by
position), ``prefill`` (last-position logits and the padded attention
caches, on the full and the chunked attention paths), caches carried
mid-decode (``repro_torch.models.carry.cache_from_numpy``), and the
port's own decode against its parallel forward. Float32 smoke configs on
the CPU (``torch_lm`` tolerances)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import models as rm
from repro_torch import models as pm
from repro_torch.models import carry
from torch_lm import (DECODABLE, carried, close, close_trees, configs,
                      to_numpy)

B = 2


def _tokens(cfg, seed, B, T):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, T)).astype(np.int32)


def _ref_step(rcfg):
    return jax.jit(lambda p, t, c, pos: rm.decode_step(p, rcfg, t, c, pos))


def _decode_both(rcfg, pcfg, params, model, toks, r_cache, cache, start=0):
    step = _ref_step(rcfg)
    with torch.no_grad():
        for t in range(toks.shape[1]):
            r_logits, r_cache = step(params, jnp.asarray(toks[:, t:t + 1]),
                                     r_cache, jnp.int32(start + t))
            logits, out = pm.decode_step(model, pcfg, torch.from_numpy(
                toks[:, t:t + 1]), cache, start + t)
            assert out is cache   # written in place, as documented
            assert logits.shape == (toks.shape[0], 1, pcfg.vocab_size)
            close(logits, r_logits, what=f"logits at {start + t}")
            close_trees(cache, to_numpy(r_cache))
    return r_cache, cache


@pytest.mark.parametrize("arch", DECODABLE)
def test_decode_steps_match_the_reference(arch):
    rcfg, pcfg = configs(arch)
    params, model = carried(rcfg, pcfg, seed=1)
    r_cache = rm.init_cache(rcfg, B, 8)
    cache = pm.init_cache(pcfg, B, 8, device="cpu")
    close_trees(cache, to_numpy(r_cache), rtol=0, atol=0)
    _decode_both(rcfg, pcfg, params, model, _tokens(rcfg, 2, B, 5),
                 r_cache, cache)


def test_unscanned_layers_keep_a_list_of_unit_caches():
    rcfg, pcfg = configs("jamba-v0.1-52b", scan_layers=False)
    params, model = carried(rcfg, pcfg, seed=1)
    r_cache = rm.init_cache(rcfg, B, 6)
    cache = pm.init_cache(pcfg, B, 6, device="cpu")
    assert isinstance(cache, list) and len(cache) == pcfg.n_units
    _decode_both(rcfg, pcfg, params, model, _tokens(rcfg, 3, B, 4),
                 r_cache, cache)


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "xlstm-125m"])
def test_a_carried_cache_decodes_on(arch):
    """A reference cache taken mid-decode, carried into the port, decodes
    on to the reference's logits and caches."""
    rcfg, pcfg = configs(arch)
    params, model = carried(rcfg, pcfg, seed=4)
    toks = _tokens(rcfg, 5, B, 6)
    step = _ref_step(rcfg)
    r_cache = rm.init_cache(rcfg, B, 8)
    for t in range(3):
        _, r_cache = step(params, jnp.asarray(toks[:, t:t + 1]), r_cache,
                          jnp.int32(t))
    cache = carry.cache_from_numpy(pcfg, to_numpy(r_cache), device="cpu")
    _decode_both(rcfg, pcfg, params, model, toks[:, 3:], r_cache, cache,
                 start=3)


def test_carry_names_the_reference_path_on_a_mismatch():
    rcfg, pcfg = configs("llama3-8b")
    tree = to_numpy(rm.init_params(rcfg, jax.random.key(0)))
    tree["units"]["l0"]["mix"]["wq"]["w"] = np.zeros((2, 3, 3), np.float32)
    with pytest.raises(ValueError, match="units/l0/mix/wq/w"):
        carry.params_from_numpy(pcfg, tree, device="cpu")
    tree = to_numpy(rm.init_params(rcfg, jax.random.key(0)))
    tree["final_norm"]["g"] = tree["final_norm"]["g"].astype(np.float64)
    with pytest.raises(ValueError, match="final_norm/g: dtype float64"):
        carry.params_from_numpy(pcfg, tree, device="cpu")
    cache = to_numpy(rm.init_cache(rcfg, B, 4))
    cache["l0"]["v"] = cache["l0"]["v"][..., :1]
    with pytest.raises(ValueError, match="l0/v: shape"):
        carry.cache_from_numpy(pcfg, cache, device="cpu")


@pytest.mark.parametrize("arch,replace", [
    ("llama3-8b", {}),
    ("qwen1.5-4b", {}),
    ("deepseek-v2-lite-16b", {}),
    ("jamba-v0.1-52b", {}),
    ("llama3-8b", dict(attn_full_max=8, attn_chunk_q=8)),
    ("deepseek-v2-lite-16b", dict(attn_full_max=8, attn_chunk_q=8)),
    ("llama3-8b", dict(scan_layers=False)),
])
def test_prefill_matches_the_reference(arch, replace):
    rcfg, pcfg = configs(arch, **replace)
    params, model = carried(rcfg, pcfg, seed=2)
    toks = _tokens(rcfg, 6, 1, 16)
    r_logits, r_caches = rm.prefill(params, rcfg, {"tokens": jnp.asarray(
        toks)}, s_max=20)
    with torch.no_grad():
        logits, caches = pm.prefill(model, pcfg, {"tokens": torch.from_numpy(
            toks)}, s_max=20)
    assert logits.shape == (1, 1, pcfg.vocab_size)
    close(logits, r_logits)
    close_trees(caches, to_numpy(r_caches))
    k = carry.flatten_tree(caches)[0][1]
    assert k.shape[2 if pcfg.scan_layers else 1] == 20   # padded seq axis


def test_prefill_cache_matches_decode_attn():
    """The port's counterpart of the reference's check: a prefill's KV
    rows are the ones decode writes, padded to s_max."""
    _, pcfg = configs("llama3-8b")
    model = pm.init_params(pcfg, device="cpu",
                           generator=torch.Generator().manual_seed(2))
    toks = torch.from_numpy(_tokens(pcfg, 7, 1, 8))
    with torch.no_grad():
        logits, caches = pm.prefill(model, pcfg, {"tokens": toks}, s_max=12)
        cache = pm.init_cache(pcfg, 1, 12, device="cpu")
        for t in range(8):
            step_logits, cache = pm.decode_step(model, pcfg, toks[:, t:t + 1],
                                                cache, t)
    assert logits.shape == (1, 1, pcfg.vocab_size)
    assert caches["l0"]["k"].shape[2] == 12
    close(caches["l0"]["k"], cache["l0"]["k"].numpy())
    close(caches["l0"]["v"], cache["l0"]["v"].numpy())
    close(logits, step_logits.numpy())


@pytest.mark.parametrize("arch", ["llama3-8b", "deepseek-v2-lite-16b",
                                  "jamba-v0.1-52b", "xlstm-125m"])
def test_decode_matches_forward(arch):
    """The port's greedy decode over a prompt equals its parallel forward
    at every position (dropless MoE, as the reference's test: capacity
    drops are a batch effect absent from single-token decode)."""
    _, pcfg = configs(arch)
    if pcfg.moe is not None:
        pcfg = dataclasses.replace(pcfg, moe=dataclasses.replace(
            pcfg.moe, capacity_factor=float(pcfg.moe.num_experts)))
    model = pm.init_params(pcfg, device="cpu",
                           generator=torch.Generator().manual_seed(1))
    T = 8
    toks = torch.from_numpy(_tokens(pcfg, 8, 1, T))
    with torch.no_grad():
        full, _ = pm.forward_train(model, pcfg, {"tokens": toks})
        cache = pm.init_cache(pcfg, 1, T, device="cpu")
        for t in range(T):
            logits, cache = pm.decode_step(model, pcfg, toks[:, t:t + 1],
                                           cache, t)
            close(logits[0, 0], full[0, t].numpy(), what=f"position {t}")


def test_init_cache_defaults_to_the_card():
    _, pcfg = configs("llama3-8b")
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(RuntimeError, match="not available"):
        pm.init_cache(pcfg, 1, 4)
    abstract = pm.init_cache(pcfg, 1, 4, abstract=True)
    assert abstract["l0"]["k"].is_meta
