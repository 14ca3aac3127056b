"""xLSTM blocks: mLSTM (matrix memory) and sLSTM (scalar memory) — the
port of ``repro.models.xlstm``.

mLSTM: per-head outer-product memory C ∈ R^{dk×dv} with exponential
input/forget gates, stabilized in log space (the stabilizer m starts at
-1e30). Training runs a time loop in chunks (each recomputed in the
backward with ``cfg.remat`` and grad on); decode is an O(1) state update.

sLSTM: scalar-memory recurrence with per-head block-diagonal recurrent
weights, strictly sequential. As in the reference, ``_slstm_pre`` adds
each gate's bias twice: ``dense`` adds ``b`` already, then ``b`` is added
once more (the forget gate's 3.0 acts as 6.0). The port keeps this so
that it computes the reference's function.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.models.layers import (_init, abstract, dense, dense_init,
                                       rmsnorm, rmsnorm_init, zeros)

M_INIT = -1e30  # the log-space stabilizer's start ("-inf")


# ----------------------------------------------------------------- mLSTM


def mlstm_init(rng, cfg, dtype):
    D, H = cfg.d_model, cfg.n_heads
    d_in = int(cfg.xlstm.proj_factor_m * D)
    s = 1.0 / math.sqrt(d_in)
    return {
        "up": dense_init(rng, D, 2 * d_in, dtype),
        "wq": dense_init(rng, d_in, d_in, dtype),
        "wk": dense_init(rng, d_in, d_in, dtype),
        "wv": dense_init(rng, d_in, d_in, dtype),
        "wi": {"w": _init(rng, (d_in, H), s, "float32"),
               "b": zeros(rng, (H,), "float32")},
        "wf": {"w": _init(rng, (d_in, H), s, "float32"),
               "b": 3.0 + torch.arange(H, dtype=torch.float32,
                                       device=rng.device)},  # open forget
        "norm": rmsnorm_init(rng, d_in, dtype),
        "down": dense_init(rng, d_in, D, dtype),
    }


def _mlstm_gates(p, u):
    """log-input/forget gate pre-activations per head: (B, S, H) f32."""
    u32 = u.float()
    logi = u32 @ p["wi"]["w"] + p["wi"]["b"]
    logf = F.logsigmoid(u32 @ p["wf"]["w"] + p["wf"]["b"])
    return logi, logf


def _mlstm_qkv(p, cfg, u):
    B, S, d_in = u.shape
    H = cfg.n_heads
    dh = d_in // H
    q = dense(p["wq"], u).reshape(B, S, H, dh)
    k = dense(p["wk"], u).reshape(B, S, H, dh) / math.sqrt(dh)
    v = dense(p["wv"], u).reshape(B, S, H, dh)
    return q, k, v


def _mlstm_step(carry, t):
    """carry: (C (B,H,dk,dv), n (B,H,dk), m (B,H)); t: per-step tensors."""
    C, n, m = carry
    q, k, v, logi, logf = t  # (B,H,dk),(B,H,dk),(B,H,dv),(B,H),(B,H)
    m_new = torch.maximum(logf + m, logi)
    i_ = torch.exp(logi - m_new)[..., None]
    f_ = torch.exp(logf + m - m_new)[..., None]
    C = f_[..., None] * C + i_[..., None] * (k[..., :, None] * v[..., None, :])
    n = f_ * n + i_ * k
    num = torch.einsum("bhkv,bhk->bhv", C, q)
    den = torch.clamp_min(torch.abs(torch.einsum("bhk,bhk->bh", n, q)), 1.0)
    return (C, n, m_new), num / den[..., None]


def _mlstm_chunk(C, n, m, *ts):
    """The steps of one chunk (time-major inputs) → (C, n, m, ys)."""
    carry, ys = (C, n, m), []
    for t in range(ts[0].shape[0]):
        carry, y = _mlstm_step(carry, tuple(a[t] for a in ts))
        ys.append(y)
    return (*carry, torch.stack(ys))


def mlstm_train(p, cfg, x):
    B, S, D = x.shape
    H = cfg.n_heads
    u, z = dense(p["up"], x).chunk(2, dim=-1)  # (B,S,d_in) each
    d_in = u.shape[-1]
    dh = d_in // H
    q, k, v = _mlstm_qkv(p, cfg, u)
    logi, logf = _mlstm_gates(p, u)
    ts = tuple(a.float().transpose(0, 1) for a in (q, k, v, logi, logf))
    ck = min(cfg.xlstm.chunk, S)
    nchunk = S // ck if S % ck == 0 else 1
    ck = S // nchunk

    C = torch.zeros((B, H, dh, dh), dtype=torch.float32, device=x.device)
    n = torch.zeros((B, H, dh), dtype=torch.float32, device=x.device)
    m = torch.full((B, H), M_INIT, dtype=torch.float32, device=x.device)
    remat = cfg.remat and torch.is_grad_enabled()
    ys = []
    for c in range(nchunk):
        args = (C, n, m) + tuple(a[c * ck:(c + 1) * ck] for a in ts)
        C, n, m, y_c = (checkpoint(_mlstm_chunk, *args, use_reentrant=False)
                        if remat else _mlstm_chunk(*args))
        ys.append(y_c)
    y = torch.cat(ys).transpose(0, 1).reshape(B, S, d_in)
    y = rmsnorm(p["norm"], y.to(x.dtype), cfg.norm_eps)
    return dense(p["down"], y * F.silu(z))


def mlstm_decode(p, cfg, x, cache):
    B = x.shape[0]
    u, z = dense(p["up"], x).chunk(2, dim=-1)
    q, k, v = _mlstm_qkv(p, cfg, u)
    logi, logf = _mlstm_gates(p, u)
    sq = lambda a: a[:, 0].float()  # noqa: E731
    carry = (cache["C"], cache["n"], cache["m"])
    (C, n, m), y = _mlstm_step(
        carry, (sq(q), sq(k), sq(v), sq(logi), sq(logf)))
    y = y.reshape(B, 1, -1).to(x.dtype)
    y = rmsnorm(p["norm"], y, cfg.norm_eps)
    out = dense(p["down"], y * F.silu(z))
    return out, {"C": C, "n": n, "m": m}


def mlstm_cache_shape(cfg, batch, dtype):
    H = cfg.n_heads
    dh = int(cfg.xlstm.proj_factor_m * cfg.d_model) // H
    return {
        "C": abstract((batch, H, dh, dh), "float32"),
        "n": abstract((batch, H, dh), "float32"),
        "m": abstract((batch, H), "float32"),
    }


# ----------------------------------------------------------------- sLSTM


def slstm_init(rng, cfg, dtype):
    D, H = cfg.d_model, cfg.n_heads
    dh = D // H
    d_ff = int(2 * cfg.xlstm.proj_factor_s * D) // 2 * 2
    s = 1.0 / math.sqrt(D)
    gates = {}
    for name in ("z", "i", "f", "o"):
        gates[name] = {
            "w": _init(rng, (D, D), s, dtype),
            "r": _init(rng, (H, dh, dh), 1.0 / math.sqrt(dh), dtype),
            "b": (3.0 if name == "f" else 0.0) * torch.ones(
                (D,), dtype=torch.float32, device=rng.device),
        }
    return {
        "gates": gates,
        "ffn_gate": dense_init(rng, D, d_ff, dtype),
        "ffn_up": dense_init(rng, D, d_ff, dtype),
        "ffn_down": dense_init(rng, d_ff, D, dtype),
        "norm": rmsnorm_init(rng, D, dtype),
    }


def _slstm_pre(p, x):
    """Input contributions of all four gates: (B, S, D) each, f32. The bias
    is added twice (inside ``dense``, then again), as in the reference."""
    g = p["gates"]
    return {n: dense(g[n], x).float() + g[n]["b"]
            for n in ("z", "i", "f", "o")}


def _slstm_step(p, cfg, carry, pre_t):
    """carry: (h, c, n, m) all (B, D) f32."""
    h, c, n, m = carry
    H = cfg.n_heads
    B, D = h.shape
    dh = D // H
    g = p["gates"]
    hh = h.reshape(B, H, dh)

    def rec(name):
        r = g[name]["r"].float()
        return torch.einsum("bhd,hde->bhe", hh, r).reshape(B, D)

    z = torch.tanh(pre_t["z"] + rec("z"))
    o = torch.sigmoid(pre_t["o"] + rec("o"))
    logi = pre_t["i"] + rec("i")
    logf = F.logsigmoid(pre_t["f"] + rec("f"))
    m_new = torch.maximum(logf + m, logi)
    i_ = torch.exp(logi - m_new)
    f_ = torch.exp(logf + m - m_new)
    c = f_ * c + i_ * z
    n = f_ * n + i_
    h_new = o * c / torch.clamp_min(n, 1.0)
    return (h_new, c, n, m_new), h_new


def slstm_train(p, cfg, x):
    B, S, D = x.shape
    pre = _slstm_pre(p, x)
    z0 = torch.zeros((B, D), dtype=torch.float32, device=x.device)
    carry = (z0, z0, z0, torch.full((B, D), M_INIT, dtype=torch.float32,
                                    device=x.device))
    hs = []
    for t in range(S):
        carry, h = _slstm_step(p, cfg, carry,
                               {k: v[:, t] for k, v in pre.items()})
        hs.append(h)
    y = torch.stack(hs, dim=1).to(x.dtype)
    y = rmsnorm(p["norm"], y, cfg.norm_eps)
    h = F.silu(dense(p["ffn_gate"], y)) * dense(p["ffn_up"], y)
    return dense(p["ffn_down"], h)


def slstm_decode(p, cfg, x, cache):
    pre = {k: v[:, 0] for k, v in _slstm_pre(p, x).items()}
    carry = (cache["h"], cache["c"], cache["n"], cache["m"])
    (h, c, n, m), y = _slstm_step(p, cfg, carry, pre)
    y = rmsnorm(p["norm"], y[:, None, :].to(x.dtype), cfg.norm_eps)
    hgate = F.silu(dense(p["ffn_gate"], y)) * dense(p["ffn_up"], y)
    return dense(p["ffn_down"], hgate), {"h": h, "c": c, "n": n, "m": m}


def slstm_cache_shape(cfg, batch, dtype):
    return {k: abstract((batch, cfg.d_model), "float32")
            for k in ("h", "c", "n", "m")}
