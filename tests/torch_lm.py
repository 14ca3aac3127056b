"""Shared helpers of the LM substrate's parity tests: the reference's
weights and inputs made from a seed with numpy and JAX, and carried into
the port as numpy arrays.

Tolerances: float32 smoke models, the reference under XLA's fused
reductions against eager PyTorch. ``parity_report`` prints the observed
maxima per arch (``PYTHONPATH=src:tests JAX_PLATFORMS=cpu python
tests/torch_lm.py``): logits ≤ 2.2e-6, losses ≤ 9.6e-7, decode logits
≤ 2.0e-6, cache leaves ≤ 1.9e-6.
"""

import jax
import numpy as np
import torch

from repro import models as rm
from repro.configs import get_config as ref_config
from repro_torch.configs import get_config as port_config
from repro_torch.models import carry

# Logits, losses, layer outputs and caches: |Δ| ≤ ATOL + RTOL·|ref|.
RTOL = ATOL = 2e-5
# Gradients: |Δ| ≤ GRAD_RTOL × the leaf's largest |ref|, that floored at
# GRAD_FLOOR × the model's largest gradient: a leaf whose gradient is zero
# in exact arithmetic (xLSTM input-gate biases, whose effect the log-space
# stabilizer divides out) carries only rounding noise. Observed: ≤ 4.5e-6
# on every other leaf, 4.2e-5 on those.
GRAD_RTOL = 2e-4
GRAD_FLOOR = 1e-3

DECODABLE = ("qwen1.5-4b", "llama3-8b", "yi-6b", "nemotron-4-15b",
             "jamba-v0.1-52b", "llava-next-mistral-7b", "xlstm-125m",
             "llama4-maverick-400b-a17b", "deepseek-v2-lite-16b")


def configs(arch, **replace):
    """(reference config, port config) of an arch's smoke config, the same
    ``dataclasses.replace`` fields given to both."""
    import dataclasses
    r, p = ref_config(arch, smoke=True), port_config(arch, smoke=True)
    if replace:
        r, p = dataclasses.replace(r, **replace), dataclasses.replace(
            p, **replace)
    return r, p


def ref_params(rcfg, seed=0):
    return rm.init_params(rcfg, jax.random.key(seed))


def to_numpy(tree):
    return jax.tree.map(np.asarray, tree)


def carried(rcfg, pcfg, seed=0):
    """(reference params, the port's module holding the same weights)."""
    params = ref_params(rcfg, seed)
    return params, carry.params_from_numpy(pcfg, to_numpy(params),
                                           device="cpu")


def to_torch(tree):
    """A tree of numpy/JAX arrays as the same tree of CPU tensors."""
    if isinstance(tree, dict):
        return {k: to_torch(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_torch(v) for v in tree)
    return torch.from_numpy(np.array(tree))


def batch(cfg, seed, B, S):
    """numpy inputs of one batch: tokens (or embeds) and labels."""
    rng = np.random.default_rng(seed)
    out = {}
    if cfg.embed_inputs:
        out["embeds"] = rng.normal(size=(B, S, cfg.d_model)).astype(
            np.float32)
    else:
        out["tokens"] = rng.integers(0, cfg.vocab_size, (B, S)).astype(
            np.int32)
    out["labels"] = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    return out


def close(got, want, rtol=RTOL, atol=ATOL, what=""):
    """Assert |got − want| ≤ atol + rtol·|want|; returns max |Δ|."""
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else \
        np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=what)
    return float(np.abs(got.astype(np.float64) - want).max()) \
        if got.size else 0.0


def close_trees(got, want, **kw):
    """``close`` on every leaf of two trees of one layout."""
    g = dict(carry.flatten_tree(got))
    w = carry.flatten_tree(want)
    assert set(g) == {p for p, _ in w}
    return max([close(g[p], v, what=str(p), **kw) for p, v in w] or [0.0])


def grad_errors(pcfg, model, ref_grads):
    """{port parameter name: max |Δ| of its gradient against the
    reference's (unstacked), over the leaf's scale as GRAD_RTOL holds it}.
    A parameter the forward never reads (a VLM's token table under embed
    inputs) has no gradient in the port, a zero one in the reference."""
    leaves = carry.flatten_tree(to_numpy(ref_grads))
    top = max(float(np.abs(g).max()) for _, g in leaves)
    port = dict(model.named_parameters())
    out = {}
    for path, g in leaves:
        for name, idx in carry.port_names(pcfg, path):
            want = g[idx] if idx else g
            got = port[name].grad
            got = np.zeros_like(want) if got is None else got.numpy()
            scale = max(float(np.abs(want).max()), GRAD_FLOOR * top)
            out[name] = float(np.abs(got - want).max()) / scale
    return out


def parity_report(archs=None, B=2, S=16, steps=5):
    """Per arch, the largest |Δ| of the port against the reference on one
    batch with carried weights: logits, loss, each gradient leaf relative
    to its scale (as the tests hold it), decode logits and cache leaves
    over ``steps`` positions. Prints one line an arch."""
    import jax.numpy as jnp

    from repro.configs import ARCHS, SKIP_CELLS
    from repro_torch import models as pm

    for arch in archs or ARCHS:
        rcfg, pcfg = configs(arch)
        params, model = carried(rcfg, pcfg, seed=0)
        inp = batch(rcfg, 1, B, S)
        jb = {k: jnp.asarray(v) for k, v in inp.items()}
        tb = {k: torch.from_numpy(v) for k, v in inp.items()}
        r_logits, _ = rm.forward_train(params, rcfg, jb)
        (r_loss, _), r_grads = jax.value_and_grad(
            lambda p: rm.loss_fn(p, rcfg, jb), has_aux=True)(params)
        logits, _ = pm.forward_train(model, pcfg, tb)
        loss, _ = pm.loss_fn(model, pcfg, tb)
        loss.backward()
        rec = {"logits": float((logits.detach() - torch.from_numpy(
            np.array(r_logits))).abs().max()),
               "loss": abs(float(loss.detach()) - float(r_loss))}
        rec["grad_rel"] = max(grad_errors(pcfg, model, r_grads).values())
        if "decode_32k" not in SKIP_CELLS.get(arch, set()):
            toks = np.random.default_rng(2).integers(
                0, rcfg.vocab_size, (B, steps)).astype(np.int32)
            step = jax.jit(lambda p, t, c, pos: rm.decode_step(
                p, rcfg, t, c, pos))
            r_cache = rm.init_cache(rcfg, B, 8)
            cache = pm.init_cache(pcfg, B, 8, device="cpu")
            rec["decode"] = rec["cache"] = 0.0
            with torch.no_grad():
                for t in range(steps):
                    r_lg, r_cache = step(params, jnp.asarray(toks[:, t:t + 1]),
                                         r_cache, jnp.int32(t))
                    lg, cache = pm.decode_step(model, pcfg, torch.from_numpy(
                        toks[:, t:t + 1]), cache, t)
                    rec["decode"] = max(rec["decode"], float(np.abs(
                        lg.numpy() - np.asarray(r_lg)).max()))
            mine = dict(carry.flatten_tree(cache))
            for path, v in carry.flatten_tree(to_numpy(r_cache)):
                rec["cache"] = max(rec["cache"], float(np.abs(
                    mine[path].numpy() - v).max()))
        print(arch, " ".join(f"{k} {v:.2e}" for k, v in rec.items()),
              flush=True)


if __name__ == "__main__":
    # PYTHONPATH=src:tests JAX_PLATFORMS=cpu python tests/torch_lm.py
    parity_report()
