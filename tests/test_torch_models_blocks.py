"""The port's MoE, Mamba and xLSTM blocks (``repro_torch.models.moe``,
``.mamba``, ``.xlstm``) against the reference's on the same numpy inputs
and the reference's initial weights, float32 on the CPU (``torch_lm``
tolerances). MoE routing — the top-k experts, their stable order and the
capacity drops — is held exactly."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import mamba as rmb
from repro.models import moe as rmoe
from repro.models import xlstm as rxl
from repro_torch.models import layers as pl
from repro_torch.models import mamba as pmb
from repro_torch.models import moe as pmoe
from repro_torch.models import xlstm as pxl
from torch_lm import close, close_trees, configs, to_torch

B, S = 2, 16


def _x(seed, *shape, scale=1.0):
    return (scale * np.random.default_rng(seed).normal(size=shape)).astype(
        np.float32)


def _rng(seed=0):
    return pl.Init(torch.device("cpu"),
                   torch.Generator().manual_seed(seed))


def _shapes(tree):
    return {k: (tuple(v.shape), str(v.dtype).removeprefix("torch."))
            for k, v in _flat(tree)}


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def _same_layout(port_tree, ref_tree):
    want = {k: (tuple(v.shape), np.dtype(v.dtype).name)
            for k, v in _flat(ref_tree)}
    assert _shapes(port_tree) == want


# -------------------------------------------------------------------- MoE


def _route_both(xf, router, k, E):
    r = [np.asarray(a) for a in rmoe._route(jnp.asarray(xf),
                                            jnp.asarray(router), k, E, 1.0)]
    p = [a.numpy() for a in pmoe._route(torch.tensor(xf),
                                        torch.tensor(router), k, E, 1.0)]
    return r, p


def _assert_same_routing(r, p):
    se, st, pos, wts, counts, probs = r
    for name, a, b in (("expert", se, p[0]), ("token", st, p[1]),
                       ("position", pos, p[2]), ("counts", counts, p[4])):
        assert np.array_equal(a, b.astype(a.dtype)), name
    close(p[3], wts)
    close(p[5], probs)


@pytest.mark.parametrize("k,E", [(1, 4), (2, 4), (2, 16), (6, 64)])
def test_route_equals_the_reference_exactly(k, E):
    xf, router = _x(1, 40, 24), _x(2, 24, E, scale=0.3)
    r, p = _route_both(xf, router, k, E)
    # Exact routing is meaningful away from near-ties: the gap between the
    # k-th and (k+1)-th probability of every token is far above the two
    # packages' rounding of a probability (≤ 1e-7 observed).
    srt = np.sort(r[5], axis=1)[:, ::-1]
    assert (srt[:, k - 1] - srt[:, k]).min() > 1e-6
    _assert_same_routing(r, p)


def test_route_breaks_ties_toward_the_lower_expert():
    """Integer logits (exact in float32) with equal top values: as
    ``lax.top_k``, the lower expert index comes first."""
    E, k = 6, 3
    xf = np.eye(8, 4, dtype=np.float32) + np.eye(8, 4, -4, dtype=np.float32)
    router = np.zeros((4, E), np.float32)
    router[0, [1, 4]] = 2.0            # token 0: experts 1 and 4 tie
    router[1, :] = 1.0                 # token 1: all six tie
    router[2, [5, 0, 3]] = 3.0         # token 2: three tie
    r, p = _route_both(xf, router, k, E)
    _assert_same_routing(r, p)
    top = p[0][np.argsort(p[1], kind="stable")].reshape(8, k)
    assert sorted(top[0]) == [0, 1, 4] and sorted(top[1]) == [0, 1, 2]


def _moe(arch, cf=None, seed=3):
    rcfg, pcfg = configs(arch)
    if cf is not None:
        rcfg, pcfg = (dataclasses.replace(c, moe=dataclasses.replace(
            c.moe, capacity_factor=cf)) for c in (rcfg, pcfg))
    p = rmoe.moe_init(jax.random.key(seed), rcfg, jnp.float32)
    return rcfg, pcfg, p, to_torch(p)


@pytest.mark.parametrize("arch,cf", [
    ("jamba-v0.1-52b", None),              # 4 experts top-2
    ("deepseek-v2-lite-16b", None),        # + a shared expert
    ("llama4-maverick-400b-a17b", None),   # top-1 + shared
    ("jamba-v0.1-52b", 0.5),               # capacity drops
    ("deepseek-v2-lite-16b", 0.5),
])
def test_moe_apply(arch, cf):
    rcfg, pcfg, p, pt = _moe(arch, cf)
    x = _x(4, B, S, rcfg.d_model)
    y, aux = pmoe.moe_apply(pt, pcfg, torch.from_numpy(x))
    r_y, r_aux = rmoe.moe_apply(p, rcfg, x)
    close(y, r_y)
    close(aux, r_aux)
    _layout = pmoe.moe_init(_rng(), pcfg, "float32")
    _same_layout(_layout, p)


def test_capacity_drops_the_reference_rows():
    """capacity_factor 0.5: the rows at positions ≥ C are the reference's,
    really drop (zero back), and the kept rows' outputs match."""
    rcfg, pcfg, p, pt = _moe("jamba-v0.1-52b", cf=0.5)
    m = rcfg.moe
    x = _x(5, B, S, rcfg.d_model)
    xf = x.reshape(B * S, -1)
    r, q = _route_both(xf, np.asarray(p["router"]), m.top_k, m.num_experts)
    _assert_same_routing(r, q)
    C = rmoe._capacity(B * S, m.top_k, m.num_experts, 0.5)
    dropped = q[2] >= C
    assert dropped.sum() > 0 and np.array_equal(dropped, r[2] >= C)
    args = [np.array(p[n]) for n in ("w_gate", "w_up", "w_down")]
    want = rmoe._expert_block(*args, xf, *r[:3], C)
    got = pmoe._expert_block(*map(torch.from_numpy, args),
                             torch.from_numpy(xf),
                             *map(torch.from_numpy, q[:3]), C)
    close(got, want)
    assert not got[torch.from_numpy(dropped)].any()


# ------------------------------------------------------------------ Mamba


def _mamba(seed=6):
    rcfg, pcfg = configs("jamba-v0.1-52b")
    p = rmb.mamba_init(jax.random.key(seed), rcfg, jnp.float32)
    return rcfg, pcfg, p, to_torch(p)


def test_mamba_init_layout_and_dt_bias():
    rcfg, pcfg, p, _ = _mamba()
    mine = pmb.mamba_init(_rng(), pcfg, "float32")
    _same_layout(mine, p)
    # softplus(dt_bias) spans the standard init range [1e-3, 1e-1].
    dt = torch.nn.functional.softplus(mine["dt_bias"])
    assert dt.min() >= 1e-3 * (1 - 1e-5) and dt.max() <= 0.1 * (1 + 1e-5)
    close(mine["A_log"], p["A_log"], rtol=0, atol=0)


@pytest.mark.parametrize("chunk", [16, 4, 5])   # 5: no multiple → 1 chunk
def test_mamba_train(chunk):
    rcfg, pcfg, p, pt = _mamba()
    rcfg, pcfg = (dataclasses.replace(c, mamba=dataclasses.replace(
        c.mamba, chunk=chunk)) for c in (rcfg, pcfg))
    x = _x(7, B, S, rcfg.d_model)
    xi = _x(14, B, S, rcfg.mamba_d_inner)
    close(pmb._conv_causal(pt, torch.from_numpy(xi)),
          rmb._conv_causal(p, xi))
    close(pmb.mamba_train(pt, pcfg, torch.from_numpy(x)),
          rmb.mamba_train(p, rcfg, x))


def test_mamba_decode_rolls_the_window_and_state():
    rcfg, pcfg, p, pt = _mamba()
    r_cache = {k: jnp.zeros(v.shape, v.dtype) for k, v in
               rmb.mamba_cache_shape(rcfg, B, jnp.float32).items()}
    shapes = pmb.mamba_cache_shape(pcfg, B, "float32")
    cache = {k: torch.zeros(v.shape, dtype=v.dtype) for k, v in
             shapes.items()}
    assert shapes["ssm"].dtype == torch.float32
    xs = _x(8, B, 6, rcfg.d_model)
    outs = []
    for t in range(6):
        r_out, r_cache = rmb.mamba_decode(p, rcfg, xs[:, t:t + 1], r_cache)
        out, cache = pmb.mamba_decode(pt, pcfg, torch.from_numpy(
            xs[:, t:t + 1]), cache)
        close(out, r_out)
        close_trees(cache, r_cache)
        outs.append(out[:, 0])
    close(torch.stack(outs, 1), pmb.mamba_train(
        pt, pcfg, torch.from_numpy(xs)).detach().numpy())


def test_mamba_ssm_state_stays_float32_under_bf16():
    _, pcfg, _, pt = _mamba()
    pcfg = dataclasses.replace(pcfg, dtype="bfloat16")
    shapes = pmb.mamba_cache_shape(pcfg, 1, "bfloat16")
    cache = {k: torch.zeros(v.shape, dtype=v.dtype) for k, v in
             shapes.items()}
    out, new = pmb.mamba_decode(pt, pcfg, torch.randn(
        1, 1, pcfg.d_model).to(torch.bfloat16), cache)
    assert new["ssm"].dtype == torch.float32
    assert new["conv"].dtype == torch.bfloat16 and out.dtype == torch.bfloat16


# ------------------------------------------------------------------ xLSTM


def _xlstm(kind, seed=9):
    rcfg, pcfg = configs("xlstm-125m")
    init = getattr(rxl, f"{kind}_init")
    p = init(jax.random.key(seed), rcfg, jnp.float32)
    # Non-zero biases, so that the doubled sLSTM gate bias shows.
    if kind == "slstm":
        for n in ("z", "i", "o"):
            p["gates"][n]["b"] = jnp.asarray(_x(10, rcfg.d_model, scale=0.5))
    return rcfg, pcfg, p, to_torch(p)


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_xlstm_init_layout(kind):
    rcfg, pcfg, p, _ = _xlstm(kind)
    mine = getattr(pxl, f"{kind}_init")(_rng(), pcfg, "float32")
    _same_layout(mine, p)
    if kind == "mlstm":
        close(mine["wf"]["b"], p["wf"]["b"], rtol=0, atol=0)
    else:
        close(mine["gates"]["f"]["b"], np.full(pcfg.d_model, 3.0, np.float32),
              rtol=0, atol=0)


@pytest.mark.parametrize("kind,chunk", [("mlstm", 16), ("mlstm", 4),
                                        ("slstm", 16)])
def test_xlstm_train(kind, chunk):
    rcfg, pcfg, p, pt = _xlstm(kind)
    rcfg, pcfg = (dataclasses.replace(c, xlstm=dataclasses.replace(
        c.xlstm, chunk=chunk)) for c in (rcfg, pcfg))
    x = _x(11, B, S, rcfg.d_model)
    fn = f"{kind}_train"
    close(getattr(pxl, fn)(pt, pcfg, torch.from_numpy(x)),
          getattr(rxl, fn)(p, rcfg, x))


def test_slstm_adds_the_gate_bias_twice_as_the_reference():
    rcfg, _, p, pt = _xlstm("slstm")
    x = _x(12, B, S, rcfg.d_model)
    pre = pxl._slstm_pre(pt, torch.from_numpy(x))
    r_pre = rxl._slstm_pre(p, x)
    for n in ("z", "i", "f", "o"):
        g = pt["gates"][n]
        close(pre[n], r_pre[n])
        close(pre[n], (torch.from_numpy(x) @ g["w"] + 2 * g["b"]).numpy())


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_xlstm_decode(kind):
    rcfg, pcfg, p, pt = _xlstm(kind)
    shape_fn = f"{kind}_cache_shape"
    r_cache = {k: jnp.full(v.shape, -1e30 if k == "m" else 0.0, v.dtype)
               for k, v in getattr(rxl, shape_fn)(rcfg, B, None).items()}
    shapes = getattr(pxl, shape_fn)(pcfg, B, "float32")
    cache = {k: torch.full(v.shape, pxl.M_INIT if k == "m" else 0.0,
                           dtype=v.dtype) for k, v in shapes.items()}
    xs = _x(13, B, 5, rcfg.d_model)
    outs = []
    for t in range(5):
        x = xs[:, t:t + 1]
        r_out, r_cache = getattr(rxl, f"{kind}_decode")(p, rcfg, x, r_cache)
        out, cache = getattr(pxl, f"{kind}_decode")(
            pt, pcfg, torch.from_numpy(x), cache)
        close(out, r_out)
        close_trees(cache, r_cache)
        outs.append(out[:, 0])
    close(torch.stack(outs, 1), getattr(pxl, f"{kind}_train")(
        pt, pcfg, torch.from_numpy(xs)).detach().numpy())
