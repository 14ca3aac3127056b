"""Shared helpers of the training parity tests: one reference train state
made with JAX from a seed, carried into the port
(``repro_torch.training.carry.state_from_numpy``), then the same batches
through both packages' ``make_train_step``.

Tolerances (float32 smoke configs, the reference under XLA against eager
PyTorch; ``parity_report`` prints the observed maxima a case,
``PYTHONPATH=src:tests JAX_PLATFORMS=cpu python tests/torch_train.py``):

* metrics (``ce``, ``aux``, ``loss``, ``grad_norm``, ``lr``): ``RTOL`` /
  ``ATOL`` of ``torch_lm``.
* weights, in two tiers. Adam divides by √v̂: at step 1 an element moves
  by lr·g/(|g| + eps) ≈ ±lr, whatever |g| is, so where the exact gradient
  is 0 (the xLSTM input-gate biases, ``torch_lm``) or is smaller than the
  two packages' rounding noise, their moves may differ by up to 2·lr a
  step. An element is "floor" when its reference gradient RMS √v is below
  ``GRAD_FLOOR`` × the model's largest: |Δ| ≤ 2·lr·steps. Every other
  element: |Δ| ≤ ``PARAM_TOL`` × lr·steps, or ``PARAM_TOL_ROUNDED`` ×
  lr·steps where a one-off rounding feeds the update (8-bit moments: a
  code one off moves m̂ by up to 2/127 of its block's scale; the int8
  wire: a gradient one quantum off).
* float32 moments: |Δ| ≤ ``MOMENT_RTOL`` × the leaf's largest |ref|,
  floored at ``GRAD_FLOOR`` × the model's largest, as gradients; under the
  int8 wire ``MOMENT_RTOL_WIRE`` (a step's gradient one quantum, 1/127 of
  its block's absmax, off).
* bf16 masters: the gradients themselves are bf16, one ulp 2⁻⁸ of their
  value, compounded over steps through weights an ulp apart: moments are
  held to ``MOMENT_RTOL_BF16``, 8-bit scales (a bf16 moment's absmax) to
  four bf16 ulps (``SCALE_RTOL_BF16``), and weights get two bf16 ulps of
  their value (2⁻⁷·|ref|) beside the tiers above.
* 8-bit codes: one step from the same state, every code within ±1 of the
  reference's (a value at a rounding boundary may go either way); over
  free-running steps within ±steps (a code one off feeds the next step's
  moment). Either way at most ``FLIP_SHARE`` of the codes differ at all.
  Scales: relative ``SCALE_RTOL``.
* error buffers (int8 wire): the wire rounds a block to 1/127 of its
  absmax, so where the two packages' inputs straddle a rounding boundary
  the residuals differ by one quantum: |Δ| ≤ 1.01 × the block's quantum
  (the absmax of the reference's gradient plus residual over the block,
  / 127), at most ``FLIP_SHARE`` of the elements differing by more than
  ``ATOL``.
"""


import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import TrainConfig as RefTrainConfig
from repro.optim.adamw import _dequantize as ref_dequantize
from repro.training import make_train_step as ref_make_train_step
from repro_torch.configs import TrainConfig
from repro_torch.models import carry
from repro_torch.training import make_train_step
from repro_torch.training.carry import state_from_numpy, state_to_numpy
from torch_lm import ATOL, GRAD_FLOOR, RTOL, batch, configs

PARAM_TOL = 1e-3
PARAM_TOL_ROUNDED = 0.2
MOMENT_RTOL = 2e-4
MOMENT_RTOL_WIRE = 2e-2
MOMENT_RTOL_BF16 = 1e-2
SCALE_RTOL = 2e-4
SCALE_RTOL_BF16 = 2.0 ** -6
FLIP_SHARE = 1e-3
B, S = 4, 16
LR = 1e-3

# name → (arch, ``dataclasses.replace`` of both configs, TrainConfig
# fields). "wide": llama3-8b smoke widened so that leaves reach the 8-bit
# codec (the smoke widths never do): d_model 256, d_ff 128, vocab 256 make
# the tables (256, 256) eligible on their own, and the unit leaf
# mlp.w_down (128, 256) eligible only stacked over the two units.
WIDE = dict(d_model=256, d_ff=128, vocab_size=256)
CASES = {
    "llama3-8b": ("llama3-8b", {}, {}),
    "qwen1.5-4b": ("qwen1.5-4b", {}, {}),
    "deepseek-v2-lite-16b": ("deepseek-v2-lite-16b", {}, {}),
    "jamba-v0.1-52b": ("jamba-v0.1-52b", {}, {}),
    "xlstm-125m": ("xlstm-125m", {}, {}),
    "hubert-xlarge": ("hubert-xlarge", {}, {}),
    "wide-8bit": ("llama3-8b", WIDE, dict(optimizer="adamw8bit")),
    "wide-8bit-bf16": ("llama3-8b", dict(WIDE, param_dtype="bfloat16"),
                       dict(optimizer="adamw8bit")),
    "int8-ef": ("llama3-8b", {}, dict(grad_compression="int8")),
    "microbatch-2": ("llama3-8b", {}, dict(microbatch=2)),
}


def setup(case, seed=0):
    """(rcfg, pcfg, reference tcfg, port tcfg, reference step (jitted),
    port step, reference state, its numpy tree)."""
    arch, replace, train = CASES[case]
    rcfg, pcfg = configs(arch, **replace)
    kw = dict(learning_rate=LR, warmup_steps=1, total_steps=10, **train)
    rt, pt = RefTrainConfig(**kw), TrainConfig(**kw)
    r_init, r_step, _ = ref_make_train_step(rcfg, rt)
    _, p_step, _ = make_train_step(pcfg, pt)
    state = r_init(jax.random.key(seed))
    return rcfg, pcfg, rt, pt, jax.jit(r_step), p_step, state


def numpy_tree(tree):
    return jax.tree.map(np.asarray, tree)


def batches(cfg, n, seed=10):
    return [batch(cfg, seed + i, B, S) for i in range(n)]


def ref_run(r_step, state, inputs):
    """[(state, metrics)] after each batch, as numpy."""
    out = []
    for b in inputs:
        state, met = r_step(state, {k: jnp.asarray(v) for k, v in b.items()})
        out.append((state, {k: float(v) for k, v in met.items()}))
    return out


def port_step(p_step, state, b):
    state, met = p_step(state, {k: torch.from_numpy(v) for k, v in b.items()})
    return state, {k: float(v) for k, v in met.items()}


def _v_hat_rms(ref_tree):
    """{reference leaf path: √v (the reference's gradient RMS), float64}."""
    out = {}
    for path, _ in carry.flatten_tree(ref_tree["params"]):
        v = _node(ref_tree["opt"]["v"], path)
        if isinstance(v, dict):
            v = ref_dequantize({k: jnp.asarray(x) for k, x in v.items()},
                               v["q"].shape, kind="q4")
        out[path] = np.sqrt(np.maximum(np.asarray(v, np.float64), 0.0))
    return out


def compare(pcfg, pstate, ref_state, *, steps, lr=LR, one_step=False,
            bits8=False, bf16=False, quanta=None, code_limit=None):
    """Hold the port's state (or its ``state_to_numpy`` tree) against the
    reference's (the tolerances above) after ``steps`` steps
    (``one_step``: one step from the reference's own state); returns a
    record of the observed maxima. ``code_limit``: the bound on a code's
    difference, when not the default (1 after ``one_step``, else
    ``steps``).

    8-bit moments under the int8 wire: a gradient element whose wire value
    rounded the other way (its error buffers differ by more than ``ATOL``)
    moves its moment by a tenth of a quantum, which the signed-sqrt and
    quartic maps turn into several codes near zero; those elements are
    free of the code bound (counted among the flips), and the scales are
    held as the wire's float32 moments (``MOMENT_RTOL_WIRE``)."""
    got_tree = (pstate if isinstance(pstate["params"], dict)
                else state_to_numpy(pcfg, pstate))
    got = dict(carry.flatten_tree(got_tree))
    ref_tree = numpy_tree(ref_state)
    want = dict(carry.flatten_tree(ref_tree))
    assert set(got) == set(want), sorted(set(got) ^ set(want), key=str)
    rms = _v_hat_rms(ref_tree)
    top_rms = max(float(r.max()) for r in rms.values())
    rec = {"param_real": 0.0, "param_floor": 0.0, "moment": 0.0,
           "code": 0, "flips": 0, "codes": 0,
           "scale": 0.0, "ebuf_quanta": 0.0, "ebuf_off": 0}
    rounded = bits8 or quanta is not None
    param_tol = (PARAM_TOL_ROUNDED if rounded else PARAM_TOL) * lr * steps
    moment_rtol = (MOMENT_RTOL_BF16 if bf16 else MOMENT_RTOL_WIRE
                   if quanta is not None else MOMENT_RTOL)
    top_m = {k: max([float(np.abs(w).max()) for p, w in want.items()
                     if p[:2] == ("opt", k) and p[-1] not in ("q", "scale")
                     and w.size] or [0.0]) for k in ("m", "v")}
    wire_flip = ({p[1:]: np.abs(got[p].astype(np.float64) - w) > ATOL
                  for p, w in want.items() if p[0] == "ebuf"}
                 if bits8 and quanta is not None else {})
    for path, w in want.items():
        g = got[path]
        assert g.shape == w.shape, (path, g.shape, w.shape)
        where = "/".join(map(str, path))
        if path[0] == "params":
            d = np.abs(g.astype(np.float64) - w)
            if bf16:
                d = np.maximum(d - 2.0 ** -7 * np.abs(w), 0.0)
            floor = rms[path[1:]] < GRAD_FLOOR * top_rms
            real, fl = d[~floor], d[floor]
            rec["param_real"] = max(rec["param_real"], float(real.max())
                                    if real.size else 0.0)
            rec["param_floor"] = max(rec["param_floor"], float(fl.max())
                                     if fl.size else 0.0)
            assert not real.size or real.max() <= param_tol, (
                where, float(real.max()), param_tol)
            assert not fl.size or fl.max() <= 2 * lr * steps, (
                where, float(fl.max()))
        elif path == ("opt", "step"):
            assert int(g) == int(w)
        elif path[-1] == "q":
            d = np.abs(g.astype(np.int64) - w.astype(np.int64))
            rec["code"] = max(rec["code"], int(d.max()))
            rec["flips"] += int((d > 0).sum())
            rec["codes"] += d.size
            limit = code_limit if code_limit is not None else (
                1 if one_step else steps)
            free = wire_flip.get(path[2:-1])
            held = d if free is None else d[~free]
            assert not held.size or held.max() <= limit, (
                where, int(held.max()), limit)
        elif path[-1] == "scale":
            err = float((np.abs(g - w) / np.maximum(np.abs(w), 1e-30)).max())
            rec["scale"] = max(rec["scale"], err)
            assert err <= (SCALE_RTOL_BF16 if bf16 else MOMENT_RTOL_WIRE
                           if wire_flip else SCALE_RTOL), (where, err)
        elif path[0] == "ebuf":
            q = quanta[path]
            d = np.abs(g.astype(np.float64) - w)
            rec["ebuf_quanta"] = max(rec["ebuf_quanta"], float(
                (d[q > 0] / q[q > 0]).max()) if (q > 0).any() else 0.0)
            rec["ebuf_off"] += int((d > ATOL).sum())
            assert (d <= 1.01 * q).all(), (where, float(d.max()))
        else:  # float32 moments
            scale = max(float(np.abs(w).max()), GRAD_FLOOR * top_m[path[1]])
            err = float(np.abs(g - w).max() / scale) if w.size else 0.0
            rec["moment"] = max(rec["moment"], err)
            assert err <= moment_rtol, (where, err)
    assert rec["flips"] <= FLIP_SHARE * max(rec["codes"], 1), rec
    n = sum(w.size for p, w in want.items() if p[0] == "ebuf")
    assert rec["ebuf_off"] <= FLIP_SHARE * max(n, 1), rec
    return rec


def _node(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def ebuf_quanta(rcfg, rt, state, b):
    """{("ebuf", *leaf path): the int8 wire's quantum at each element} of
    the step from the reference ``state`` on batch ``b``: the absmax of
    (gradient + residual) over the element's flat block of 256, / 127."""
    from repro import models as rm

    grads = jax.grad(lambda p: rm.loss_fn(p, rcfg, {
        k: jnp.asarray(v) for k, v in b.items()}, zloss=rt.zloss)[0])(
        state["params"])
    out = {}
    for path, g in carry.flatten_tree(numpy_tree(grads)):
        e = _node(numpy_tree(state["ebuf"]), path)
        flat = (g.astype(np.float32) + e).reshape(-1)
        pad = (-flat.size) % 256
        amax = np.abs(np.pad(flat, (0, pad))).reshape(-1, 256).max(1)
        out[("ebuf",) + path] = (np.repeat(amax, 256)[:flat.size]
                                 .reshape(g.shape) / 127.0)
    return out


def parity_report(cases=None, steps=3):
    """Per case, the largest deviations of the port from the reference
    after one step and after ``steps`` free-running steps."""
    for case in cases or CASES:
        rec = run_case(case, steps)
        print(case, {k: (f"{v:.2e}" if isinstance(v, float) else v)
                     for k, v in rec.items()}, flush=True)


def run_case(case, steps=3):
    """Run ``steps`` batches through both packages from one carried state,
    holding the metrics at every step and the state after the first step
    (one step from the reference's own state: codes within ±1) and after
    the last; for 8-bit moments also one step from each of the
    reference's mid-run states. Returns the observed maxima."""
    rcfg, pcfg, rt, pt, r_step, p_step, state = setup(case)
    bits8 = pt.optimizer == "adamw8bit"
    bf16 = pcfg.param_dtype == "bfloat16"
    inputs = batches(rcfg, steps)
    ref = ref_run(r_step, state, inputs)
    pstate = state_from_numpy(pcfg, pt, numpy_tree(state), device="cpu")
    out = {"metric": 0.0}
    prev = state
    for i, b in enumerate(inputs):
        pstate, met = port_step(p_step, pstate, b)
        want_state, want_met = ref[i]
        for k, v in want_met.items():
            assert abs(met[k] - v) <= ATOL + RTOL * abs(v), (case, i, k)
            out["metric"] = max(out["metric"], abs(met[k] - v))
        quanta = (ebuf_quanta(rcfg, rt, prev, b)
                  if pt.grad_compression == "int8" else None)
        kw = dict(bits8=bits8, bf16=bf16, quanta=quanta)
        if i in (0, steps - 1):
            rec = compare(pcfg, pstate, want_state, steps=i + 1,
                          one_step=i == 0, **kw)
            out.update({f"{k}@{i + 1}": v for k, v in rec.items()})
        if bits8 and i > 0:
            one = state_from_numpy(pcfg, pt, numpy_tree(prev), device="cpu")
            one, _ = port_step(p_step, one, b)
            rec = compare(pcfg, one, want_state, steps=1, one_step=True, **kw)
            out[f"code_one@{i + 1}"] = rec["code"]
        prev = want_state
    return out


if __name__ == "__main__":
    parity_report()
