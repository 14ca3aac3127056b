"""The port's optimizer substrate (``repro_torch.optim``) against the
reference's (``repro.optim``) on the same numpy inputs: the schedules,
the global norm and clipping over a stacked leaf regrouped by unit,
microbatch accumulation, both block codecs, and one AdamW step (float32
moments, 8-bit moments, the bf16 branch).

Tolerances: the schedule within 1e-6 relative (XLA's float32 ``cos`` is
not PyTorch's: up to 3 ulps of the rate seen); norms within 1e-6 relative
(the port sums one leaf a unit, in its own order); 8-bit codes within ±1 of the
reference's (an input at a rounding boundary of √ or the fourth root may
go either way), at most ``FLIP_SHARE`` of them off, scales equal; one
AdamW step on the same inputs within ``ADAM_ULPS`` float32 ulps of the
update (bf16: one bf16 ulp of the weight).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import models as rm
from repro import optim as ropt
from repro.optim import adamw as radamw
from repro_torch import models as pm
from repro_torch import optim as popt
from repro_torch.configs import TrainConfig
from repro_torch.optim import adamw as padamw
from repro_torch.optim.grad_utils import reference_leaves
from torch_lm import GRAD_RTOL, batch, carried, configs, grad_errors
from torch_threads import one_torch_thread  # noqa: F401

FLIP_SHARE = 1e-3
ADAM_ULPS = 4


def test_optim_exports_the_references_names():
    assert popt.__all__ == ropt.__all__


@pytest.mark.parametrize("warmup,total", [(10, 100), (0, 100), (5, 60),
                                          (100, 100)])
def test_warmup_cosine_matches_the_reference(warmup, total):
    for step in range(101):
        want = float(ropt.warmup_cosine(step, peak_lr=3e-3,
                                        warmup_steps=warmup,
                                        total_steps=total))
        got = popt.warmup_cosine(step, peak_lr=3e-3, warmup_steps=warmup,
                                 total_steps=total)
        assert got.dtype == torch.float32 and got.shape == ()
        assert abs(float(got) - want) <= 1e-6 * abs(want), (
            step, float(got), want)
        # the step count as the optimizer keeps it: an int32 0-d tensor
        assert float(popt.warmup_cosine(
            torch.tensor(step, dtype=torch.int32), peak_lr=3e-3,
            warmup_steps=warmup, total_steps=total)) == float(got)
    first = popt.warmup_cosine(0, peak_lr=3e-3, warmup_steps=warmup,
                               total_steps=total)
    assert (float(first) == 0.0) == (warmup > 0)
    assert float(popt.constant(7, peak_lr=0.5)) == float(
        ropt.constant(7, peak_lr=0.5))


def _stacked(seed):
    """A reference tree with a stacked (2, …) units leaf and the port's
    tree of the same numbers, one leaf a unit."""
    rng = np.random.default_rng(seed)
    ref = {"units": {"w": rng.normal(size=(2, 3, 300)).astype(np.float32),
                     "b": rng.normal(size=(2, 5)).astype(np.float32)},
           "embed": rng.normal(size=(7, 4)).astype(np.float32) * 10}
    port = {"embed": torch.from_numpy(ref["embed"].copy())}
    for u in range(2):
        port[f"units.{u}.w"] = torch.from_numpy(ref["units"]["w"][u].copy())
        port[f"units.{u}.b"] = torch.from_numpy(ref["units"]["b"][u].copy())
    return ref, port


def test_reference_leaves_order_and_groups():
    names = ["units.1.l0.w", "lm_head.table", "units.0.l0.w", "embed.t",
             "units.10.l0.w", "units.2.l0.b", "final_norm.g"]
    assert reference_leaves(names, stack=11) == [
        ["embed.t"], ["final_norm.g"], ["lm_head.table"], ["units.2.l0.b"],
        ["units.0.l0.w", "units.1.l0.w", "units.10.l0.w"]]
    # unscanned: a list of units, each leaf its own, units in number order
    assert reference_leaves(["units.10.a", "units.2.a", "units.2.b"], 1) == [
        ["units.2.a"], ["units.2.b"], ["units.10.a"]]


@pytest.mark.parametrize("max_norm", [1.0, 0.3, 1e4])
def test_global_norm_and_clip_match_the_reference(max_norm):
    ref, port = _stacked(0)
    want = float(ropt.global_norm(ref))
    got = popt.global_norm(port)
    assert abs(float(got) - want) <= 1e-6 * want
    r_clipped, r_norm = ropt.clip_by_global_norm(
        jax.tree.map(jnp.asarray, ref), max_norm)
    clipped, norm = popt.clip_by_global_norm(port, max_norm)
    assert clipped is port  # in place
    assert abs(float(norm) - float(r_norm)) <= 1e-6 * float(r_norm)
    for u in range(2):
        np.testing.assert_allclose(clipped[f"units.{u}.w"].numpy(),
                                   np.asarray(r_clipped["units"]["w"][u]),
                                   rtol=2e-6, atol=0)
    np.testing.assert_allclose(clipped["embed"].numpy(),
                               np.asarray(r_clipped["embed"]), rtol=2e-6)


def test_clip_rounds_a_bf16_leaf_once():
    g = torch.tensor([3.0, -1.7, 0.011], dtype=torch.bfloat16)
    tree, norm = popt.clip_by_global_norm({"g": g.clone()}, 0.1)
    r_tree, r_norm = ropt.clip_by_global_norm(
        {"g": jnp.asarray(g.float().numpy()).astype(jnp.bfloat16)}, 0.1)
    assert abs(float(norm) - float(r_norm)) <= 1e-6 * float(r_norm)
    assert tree["g"].dtype == torch.bfloat16
    np.testing.assert_array_equal(tree["g"].float().numpy(),
                                  np.asarray(r_tree["g"], np.float32))


@pytest.mark.parametrize("n_micro", [2, 4])
def test_accumulate_microbatches_matches_the_reference(n_micro):
    rcfg, pcfg = configs("deepseek-v2-lite-16b")
    params, model = carried(rcfg, pcfg, seed=0)
    inp = batch(rcfg, 3, 4, 16)

    def r_loss(p, b):
        return rm.loss_fn(p, rcfg, b)

    (r_l, r_aux), r_g = ropt.accumulate_microbatches(
        r_loss, params, {k: jnp.asarray(v) for k, v in inp.items()}, n_micro)
    (loss, aux), grads = popt.accumulate_microbatches(
        lambda m, b: pm.loss_fn(m, pcfg, b), model,
        {k: torch.from_numpy(v) for k, v in inp.items()}, n_micro)
    assert abs(float(loss) - float(r_l)) <= 2e-5 * abs(float(r_l))
    for k in ("ce", "aux", "loss"):  # the last microbatch's
        assert abs(float(aux[k]) - float(r_aux[k])) <= \
            2e-5 * (1 + abs(float(r_aux[k])))
    assert all(p.grad is None for p in model.parameters())
    for name, p in model.named_parameters():
        p.grad = grads[name]
    errs = grad_errors(pcfg, model, r_g)
    assert max(errs.values()) <= GRAD_RTOL, max(errs.items(),
                                                key=lambda kv: kv[1])


def test_microbatch_backward_seed_is_exact_for_powers_of_two():
    """(loss / n).backward() into ``.grad`` gives, bit for bit, 0 + g₁/n +
    g₂/n (the reference's accumulation) when n is a power of two."""
    _, pcfg = configs("llama3-8b")
    model = pm.init_params(pcfg, device="cpu",
                           generator=torch.Generator().manual_seed(2))
    inp = {k: torch.from_numpy(v) for k, v in batch(pcfg, 4, 4, 16).items()}

    def loss_fn(m, b):
        return pm.loss_fn(m, pcfg, b)

    _, grads = popt.accumulate_microbatches(loss_fn, model, inp, 2)
    want = {n: torch.zeros_like(p) for n, p in model.named_parameters()}
    for i in range(2):
        loss, _ = loss_fn(model, {k: v.reshape(2, 2, -1)[i]
                                  for k, v in inp.items()})
        gs = torch.autograd.grad(loss, list(model.parameters()))
        for (n, _), g in zip(model.named_parameters(), gs):
            want[n] = want[n] + g / 2
    for n, g in grads.items():
        assert torch.equal(g, want[n]), n


def _codes_close(got, want, what):
    d = np.abs(got.astype(np.int64) - np.asarray(want).astype(np.int64))
    assert d.max() <= 1, (what, int(d.max()))
    assert (d > 0).sum() <= FLIP_SHARE * d.size, (what, int((d > 0).sum()))
    return int((d > 0).sum())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["sq", "q4", "lin"])
def test_last_axis_codec_matches_the_reference(kind, dtype):
    rng = np.random.default_rng(5)
    x = rng.standard_cauchy(size=(6, 4, 512)).astype(np.float32) * 1e-3
    x[0, 0, :256] = 0.0  # an all-zero block
    if kind == "q4":
        x = np.abs(x)
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    r = radamw._quantize(jx, kind)
    p = padamw._quantize(tx, kind)
    assert p["q"].dtype == torch.int8 and p["q"].shape == tx.shape
    assert tuple(p["scale"].shape) == r["scale"].shape == (6, 4, 2)
    np.testing.assert_array_equal(p["scale"].numpy(), np.asarray(r["scale"]))
    _codes_close(p["q"].numpy(), r["q"], (kind, dtype))
    # decoding the same codes: the same values
    enc = {k: np.asarray(v) for k, v in r.items()}
    want = radamw._dequantize({k: jnp.asarray(v) for k, v in enc.items()},
                              x.shape, kind=kind, dtype=jx.dtype)
    got = padamw._dequantize({k: torch.from_numpy(v.copy()) for k, v in
                              enc.items()}, x.shape, kind=kind,
                             dtype=tx.dtype)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))


@pytest.mark.parametrize("size", [256, 1000, 4097])
def test_flat_codec_matches_the_reference(size):
    x = np.random.default_rng(size).normal(size=(size,)).astype(np.float32)
    r = radamw._quantize_flat(jnp.asarray(x))
    p = padamw._quantize_flat(torch.from_numpy(x))
    np.testing.assert_array_equal(p["scale"].numpy(), np.asarray(r["scale"]))
    _codes_close(p["q"].numpy(), r["q"], size)
    enc = {k: np.asarray(v) for k, v in r.items()}
    want = radamw._dequantize_flat({k: jnp.asarray(v) for k, v in
                                    enc.items()}, (size,), size)
    got = padamw._dequantize_flat({k: torch.from_numpy(v.copy()) for k, v
                                   in enc.items()}, (size,), size)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_q8_eligible_is_judged_on_the_stacked_leaf():
    assert padamw.q8_eligible(torch.empty(256, 256))
    assert not padamw.q8_eligible(torch.empty(128, 256))
    assert padamw.q8_eligible(torch.empty(128, 256), 2)
    assert not padamw.q8_eligible(torch.empty(128, 300), 8)
    for shape, stack in (((256, 256), 1), ((2, 128, 256), 1),
                         ((128, 300), 1)):
        assert padamw.q8_eligible(torch.empty(shape), stack) == \
            radamw.q8_eligible(jnp.zeros(shape))
    state = popt.adamw_init({"units.0.w": torch.zeros(128, 256),
                             "units.1.w": torch.zeros(128, 256),
                             "other": torch.zeros(128, 256)},
                            bits8=True, stack=2)
    assert isinstance(state["m"]["units.0.w"], dict)
    assert isinstance(state["v"]["units.1.w"], dict)
    assert state["m"]["other"].dtype == torch.float32


def _leaves(seed, dtype):
    rng = np.random.default_rng(seed)
    p = {"w": rng.normal(size=(64, 1024)).astype(np.float32),
         "b": rng.normal(size=(100,)).astype(np.float32)}
    g = {k: (rng.normal(size=v.shape) * rng.exponential(size=v.shape)
             ).astype(np.float32) * 1e-2 for k, v in p.items()}
    cast = (lambda a: jnp.asarray(a).astype(jnp.bfloat16)) \
        if dtype == "bfloat16" else jnp.asarray
    return p, g, cast


@pytest.mark.parametrize("bits8,dtype", [(False, "float32"),
                                         (True, "float32"),
                                         (True, "bfloat16")])
def test_adamw_step_matches_the_reference(bits8, dtype):
    """Two AdamW steps from zero moments on the same weights and
    gradients: weights, float32 moments, codes and scales."""
    p, g, cast = _leaves(1, dtype)
    r_params = {k: cast(v) for k, v in p.items()}
    r_state = ropt.adamw_init(r_params, bits8=bits8)
    t_dtype = getattr(torch, dtype)
    params = {k: torch.from_numpy(np.array(v, np.float32)).to(t_dtype)
              for k, v in r_params.items()}
    state = popt.adamw_init(params, bits8=bits8)
    for step in range(2):
        gs = {k: v * (1 + step) for k, v in g.items()}
        r_params, r_state = ropt.adamw_update(
            {k: cast(v) for k, v in gs.items()}, r_state, r_params,
            lr=jnp.float32(1e-2), weight_decay=0.1, bits8=bits8)
        out, state = popt.adamw_update(
            {k: torch.from_numpy(np.array(cast(v), np.float32)).to(t_dtype)
             for k, v in gs.items()}, state, params,
            lr=torch.tensor(1e-2), weight_decay=0.1, bits8=bits8)
        assert out is params and int(state["step"]) == step + 1
        for k in params:
            want = np.asarray(r_params[k], np.float32)
            got = params[k].float().numpy()
            tol = (2.0 ** -8 * np.abs(want) if dtype == "bfloat16"
                   else ADAM_ULPS * np.spacing(np.float32(1e-2)))
            assert (np.abs(got - want) <= tol).all(), (
                k, step, float(np.abs(got - want).max()))
            for mv in ("m", "v"):
                r, t = r_state[mv][k], state[mv][k]
                if isinstance(r, dict):
                    _codes_close(t["q"].numpy(), r["q"], (k, mv, step))
                    np.testing.assert_allclose(
                        t["scale"].numpy(), np.asarray(r["scale"]),
                        rtol=2.0 ** -6 if dtype == "bfloat16" else 1e-6)
                else:
                    np.testing.assert_allclose(t.numpy(), np.asarray(r),
                                               rtol=1e-6, atol=1e-12)
    assert isinstance(state["m"]["w"], dict) == bits8
    assert not isinstance(state["m"]["b"], dict)


def test_make_optimizer_takes_the_train_config():
    tcfg = TrainConfig(optimizer="adamw8bit", b1=0.8, b2=0.9, eps=1e-6,
                       weight_decay=0.0)
    init, update = popt.make_optimizer(tcfg, stack=4)
    assert init.keywords == {"bits8": True, "stack": 4}
    assert update.keywords == dict(b1=0.8, b2=0.9, eps=1e-6,
                                   weight_decay=0.0, bits8=True)
