"""The port's train step (``repro_torch.training.make_train_step``) against
the reference's from one carried state (``repro_torch.training.carry``):
metrics, weights, moments (float32 and 8-bit codes) and error buffers
after one and three steps, on the smoke configs of six archs, the
widened 8-bit config (also with bf16 masters), the int8 wire and two
microbatches; the carry itself (round trip of a mid-run state, refusals);
the state's layout (``init_state``, ``abstract_state``). Tolerances:
``torch_train``."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import TrainConfig as RefTrainConfig
from repro.training import make_train_step as ref_make_train_step
from repro_torch.configs import TrainConfig
from repro_torch.models import carry
from repro_torch.optim.adamw import q8_eligible
from repro_torch.training import make_train_step
from repro_torch.training.carry import state_from_numpy, state_to_numpy
from torch_lm import configs
from torch_threads import one_torch_thread  # noqa: F401
from torch_train import (CASES, WIDE, batches, numpy_tree, ref_run,
                         run_case)


@pytest.mark.parametrize("case", list(CASES))
def test_one_and_three_steps_match_the_reference(case):
    rec = run_case(case, steps=3)
    print(case, rec)


def _mid_run(case, steps):
    """(pcfg, port tcfg, the reference's state after ``steps`` steps)."""
    from torch_train import setup
    rcfg, pcfg, _, pt, r_step, _, state = setup(case)
    state = ref_run(r_step, state, batches(rcfg, steps))[-1][0]
    return pcfg, pt, state


@pytest.mark.parametrize("case", ["wide-8bit", "int8-ef"])
def test_carry_round_trips_a_mid_run_state(case):
    """Step 5 of the reference: non-zero moments, 8-bit codes or error
    buffers, carried into the port and back, bit for bit."""
    pcfg, pt, state = _mid_run(case, 5)
    tree = numpy_tree(state)
    back = state_to_numpy(pcfg, state_from_numpy(pcfg, pt, tree,
                                                 device="cpu"))
    want = carry.flatten_tree(tree)
    got = dict(carry.flatten_tree(back))
    assert set(got) == {p for p, _ in want}
    for path, w in want:
        np.testing.assert_array_equal(got[path], w, err_msg=str(path))
    assert int(tree["opt"]["step"]) == 5
    if pt.optimizer == "adamw8bit":
        codes = [w for p, w in want if p[-1] == "q"]
        assert codes and all(np.abs(c).max() > 0 for c in codes)


def _copy(tree):
    if isinstance(tree, dict):
        return {k: _copy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_copy(v) for v in tree]
    return tree


def test_carry_refuses_a_mismatched_state():
    pcfg, pt, state = _mid_run("wide-8bit", 1)
    tree = numpy_tree(state)
    bad = _copy(tree)
    bad["opt"]["m"]["units"]["l0"]["mlp"]["w_down"]["w"]["q"] = np.zeros(
        (2, 128, 128), np.int8)
    with pytest.raises(ValueError, match="opt/m/units/l0/mlp/w_down/w/q"):
        state_from_numpy(pcfg, pt, bad, device="cpu")
    bad = _copy(tree)
    bad["opt"]["v"]["final_norm"]["g"] = {"q": np.zeros((256,), np.int8),
                                         "scale": np.zeros((1,), np.float32)}
    with pytest.raises(ValueError, match="opt/v/final_norm/g"):
        state_from_numpy(pcfg, pt, bad, device="cpu")
    bad = _copy(tree)
    bad["opt"]["step"] = np.float32(1)
    with pytest.raises(ValueError, match="opt/step"):
        state_from_numpy(pcfg, pt, bad, device="cpu")
    with pytest.raises(ValueError, match="ebuf"):
        state_from_numpy(pcfg, dataclasses.replace(
            pt, grad_compression="int8"), tree, device="cpu")


def test_stacked_eligible_leaf_gets_8bit_moments():
    """mlp.w_down of the widened config is (128, 256) a unit: 32,768
    elements, under the codec's 65,536 alone, eligible stacked over the two
    units (the reference's leaf is (2, 128, 256)). Both packages give it
    int8 codes, whose unit slices are the port's leaves' shapes; the
    (256, 256) tables are eligible on their own, the norms in neither."""
    rcfg, pcfg = configs("llama3-8b", **WIDE)
    kw = dict(optimizer="adamw8bit")
    r_init, _, _ = ref_make_train_step(rcfg, RefTrainConfig(**kw))
    init, _, abstract = make_train_step(pcfg, TrainConfig(**kw))
    ref = numpy_tree(r_init(jax.random.key(0)))["opt"]["m"]
    state = init(torch.Generator().manual_seed(0))
    w = state["params"]["units"][0]["l0"]["mlp"]["w_down"]["w"]
    assert tuple(w.shape) == (128, 256) and not q8_eligible(w)
    assert q8_eligible(w, 2)
    assert pcfg.n_units == 2 and pcfg.scan_layers
    r = ref["units"]["l0"]["mlp"]["w_down"]["w"]
    assert r["q"].dtype == np.int8 and r["q"].shape == (2, 128, 256)
    for u in range(2):
        m = state["opt"]["m"][f"units.{u}.l0.mlp.w_down.w"]
        assert m["q"].dtype == torch.int8
        assert tuple(m["q"].shape) == r["q"].shape[1:]
        assert tuple(m["scale"].shape) == r["scale"].shape[1:]
    for name in ("embed", "lm_head"):
        assert ref[name]["table"]["q"].shape == (256, 256)
        assert state["opt"]["m"][f"{name}.table"]["q"].dtype == torch.int8
    assert ref["final_norm"]["g"].dtype == np.float32
    assert state["opt"]["m"]["final_norm.g"].dtype == torch.float32
    meta = abstract()
    assert meta["params"]["embed"]["table"].device.type == "meta"
    assert meta["opt"]["m"]["units.0.l0.mlp.w_down.w"]["q"].dtype == \
        torch.int8


@pytest.mark.parametrize("case", ["llama3-8b", "int8-ef", "wide-8bit"])
def test_state_layout_matches_the_reference(case):
    """``init_state`` and ``abstract_state`` give the reference's tree:
    every leaf (weights, moments or codes, error buffers, step) with the
    reference's shape and dtype once unstacked."""
    from torch_train import setup
    _, pcfg, _, pt, _, _, state = setup(case)
    want = {p: (w.shape, w.dtype) for p, w in
            carry.flatten_tree(numpy_tree(state))}
    init, _, abstract = make_train_step(pcfg, pt)
    for st in (init(torch.Generator().manual_seed(1)),
               _meta_as_zeros(abstract())):
        got = carry.flatten_tree(state_to_numpy(pcfg, st))
        assert {p: (g.shape, g.dtype) for p, g in got} == want


def _meta_as_zeros(state):
    """A meta-device state as zero tensors of the same layout on the CPU
    (``state_to_numpy`` needs storage)."""
    def z(t):
        return torch.zeros(t.shape, dtype=t.dtype)

    def tree(d):
        return {k: ({j: z(x) for j, x in v.items()} if isinstance(v, dict)
                    else z(v)) for k, v in d.items()}

    params = state["params"].to_empty(device="cpu")
    out = {"params": params, "opt": {"step": z(state["opt"]["step"]),
                                     "m": tree(state["opt"]["m"]),
                                     "v": tree(state["opt"]["v"])}}
    if "ebuf" in state:
        out["ebuf"] = tree(state["ebuf"])
    return out


def test_init_state_is_seeded_and_on_the_generators_device():
    _, pcfg = configs("llama3-8b")
    init, _, _ = make_train_step(pcfg, TrainConfig())
    a = init(torch.Generator().manual_seed(3))
    b = init(torch.Generator().manual_seed(3))
    for (n, x), (_, y) in zip(a["params"].named_parameters(),
                              b["params"].named_parameters()):
        assert x.device.type == "cpu"
        assert torch.equal(x, y), n
    assert a["opt"]["step"].dtype == torch.int32 and int(a["opt"]["step"]) == 0
