"""Mamba (S6) selective-state-space mixer — the Jamba hybrid's workhorse
(the port of ``repro.models.mamba``).

Training runs the selective scan as a time loop over chunks of
``cfg.mamba.chunk`` steps, carrying the (B, d_inner, N) float32 state
across chunks; with ``cfg.remat`` and grad on, each chunk is recomputed
in the backward (the reference's ``jax.checkpoint``; the values are the
same). Decode is a single-step state update with a rolling conv window —
O(1) in context length.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.models.layers import _init, abstract, dense, dense_init, zeros


def mamba_init(rng, cfg, dtype):
    D = cfg.d_model
    d_in = cfg.mamba_d_inner
    N, R, K = cfg.mamba.d_state, cfg.mamba_dt_rank, cfg.mamba.d_conv
    in_proj = dense_init(rng, D, 2 * d_in, dtype)
    conv_w = _init(rng, (K, d_in), 1.0 / math.sqrt(K), dtype)
    x_proj = dense_init(rng, d_in, R + 2 * N, dtype)
    dt_proj = dense_init(rng, R, d_in, dtype)
    out_proj = dense_init(rng, d_in, D, dtype)
    # dt bias: softplus⁻¹ of ~[1e-3, 1e-1] (standard Mamba init)
    u = torch.empty((d_in,), dtype=torch.float32, device=rng.device)
    if not rng.abstract:
        u.uniform_(generator=rng.generator)
    dt0 = torch.exp(u * (math.log(0.1) - math.log(1e-3)) + math.log(1e-3))
    A = torch.arange(1, N + 1, dtype=torch.float32, device=rng.device)
    return {
        "in_proj": in_proj,
        "conv_w": conv_w,
        "conv_b": zeros(rng, (d_in,), dtype),
        "x_proj": x_proj,
        "dt_proj": dt_proj,
        "dt_bias": dt0 + torch.log(-torch.expm1(-dt0)),
        "A_log": torch.log(A.repeat(d_in, 1)),
        "D_skip": torch.ones((d_in,), dtype=torch.float32,
                             device=rng.device),
        "out_proj": out_proj,
    }


def _conv_causal(p, x):
    """Depthwise causal conv over (B, S, d_in) with taps K (K small)."""
    K = p["conv_w"].shape[0]
    w = p["conv_w"].to(x.dtype)
    y = x * w[K - 1]
    for i in range(1, K):
        shifted = F.pad(x, (0, 0, i, 0))[:, : x.shape[1]]
        y = y + shifted * w[K - 1 - i]
    return y + p["conv_b"].to(x.dtype)


def _ssm_inputs(p, cfg, xc):
    """dt (B,S,d_in) f32, Bp/Cp (B,S,N) f32, A (d_in,N) f32."""
    N, R = cfg.mamba.d_state, cfg.mamba_dt_rank
    proj = dense(p["x_proj"], xc)
    dt_r, Bp, Cp = torch.split(proj, [R, N, N], dim=-1)
    dt = F.softplus(dense(p["dt_proj"], dt_r).float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    return dt, Bp.float(), Cp.float(), A


def _scan_chunk(state, dt_c, bx_c, c_c, A):
    """One chunk of the selective scan, time-major inputs; state
    (B, d_in, N). Returns (state, ys (ck, B, d_in))."""
    ys = []
    for t in range(dt_c.shape[0]):
        dA = torch.exp(dt_c[t][..., None] * A)  # (B, d_in, N)
        state = dA * state + bx_c[t]
        ys.append(torch.einsum("bdn,bn->bd", state, c_c[t]))
    return state, torch.stack(ys)


def mamba_train(p, cfg, x):
    """x: (B, S, D) → (B, S, D)."""
    B, S, D = x.shape
    d_in = cfg.mamba_d_inner
    N = cfg.mamba.d_state
    x_in, z = dense(p["in_proj"], x).chunk(2, dim=-1)
    xc = F.silu(_conv_causal(p, x_in))
    dt, Bp, Cp, A = _ssm_inputs(p, cfg, xc)
    ck = min(cfg.mamba.chunk, S)
    nchunk = S // ck if S % ck == 0 else 1
    ck = S // nchunk

    xc32 = xc.float()
    # time-major
    dt_t = dt.transpose(0, 1)
    bx_t = ((dt * xc32)[..., None] * Bp[:, :, None, :]).transpose(0, 1)
    c_t = Cp.transpose(0, 1)

    state = torch.zeros((B, d_in, N), dtype=torch.float32, device=x.device)
    remat = cfg.remat and torch.is_grad_enabled()
    ys = []
    for c in range(nchunk):
        sl = slice(c * ck, (c + 1) * ck)
        args = (state, dt_t[sl], bx_t[sl], c_t[sl], A)
        state, y_c = (checkpoint(_scan_chunk, *args, use_reentrant=False)
                      if remat else _scan_chunk(*args))
        ys.append(y_c)
    y = torch.cat(ys).transpose(0, 1)  # (B, S, d_in)
    y = y + p["D_skip"] * xc32
    y = y.to(x.dtype) * F.silu(z)
    return dense(p["out_proj"], y)


def mamba_decode(p, cfg, x, cache):
    """Single-token step. x: (B, 1, D); cache {conv (B,K-1,d_in),
    ssm (B,d_in,N)} → (out (B,1,D), new cache)."""
    x_in, z = dense(p["in_proj"], x).chunk(2, dim=-1)  # (B,1,d_in)
    window = torch.cat([cache["conv"], x_in], dim=1)  # (B,K,d_in)
    w = p["conv_w"].to(x.dtype)
    xc = F.silu(torch.einsum("bkd,kd->bd", window, w)[:, None, :]
                + p["conv_b"].to(x.dtype))
    dt, Bp, Cp, A = _ssm_inputs(p, cfg, xc)
    dA = torch.exp(dt[:, 0, :, None] * A)
    bx = (dt[:, 0] * xc[:, 0].float())[..., None] * Bp[:, 0, None, :]
    state = dA * cache["ssm"] + bx
    y = torch.einsum("bdn,bn->bd", state, Cp[:, 0])[:, None, :]
    y = y + p["D_skip"] * xc.float()
    out = dense(p["out_proj"], y.to(x.dtype) * F.silu(z))
    return out, {"conv": window[:, 1:], "ssm": state}


def mamba_cache_shape(cfg, batch, dtype):
    return {
        "conv": abstract(
            (batch, cfg.mamba.d_conv - 1, cfg.mamba_d_inner), dtype),
        "ssm": abstract(
            (batch, cfg.mamba_d_inner, cfg.mamba.d_state), "float32"),
    }
