"""The port's ``ServeEngine`` (``repro_torch.serving``) against
``repro.serving.ServeEngine`` with the reference's weights carried across:
greedy tokens equal, and temperature sampling at seed 0 equal (the same
host ``numpy`` draws). Also the serve CLI, the configs, the parameter
counts of full configs on the meta device, and what the entry points
refuse (an ``s_max`` too small, the card without CUDA, a mesh)."""

import dataclasses

import numpy as np
import pytest
import torch

from repro import models as rm
from repro.configs import ARCHS, SHAPES, SKIP_CELLS, TrainConfig
from repro.configs import get_config as ref_config
from repro.serving import ServeEngine as RefEngine
from repro_torch import configs as pconfigs
from repro_torch import models as pm
from repro_torch.launch import serve
from repro_torch.models import meshctx
from repro_torch.serving import ServeEngine
from torch_lm import carried, configs

PROMPTS = [[1, 2, 3, 4], [7, 8], [5, 5, 5, 5, 5, 5], [9]]


def _near_ties(rcfg, params, res, prompts):
    """Positions where the reference's own forward over its greedy output
    has a top-two logit gap below 1e-4: only there may tokens differ."""
    import jax.numpy as jnp
    out = set()
    for i, (p, o) in enumerate(zip(prompts, res.tokens)):
        logits, _ = rm.forward_train(params, rcfg, {
            "tokens": jnp.asarray([o], jnp.int32)})
        srt = np.sort(np.asarray(logits[0]), axis=-1)
        gap = srt[:, -1] - srt[:, -2]
        out |= {(i, t + 1) for t in range(len(p) - 1, len(o) - 1)
                if gap[t] < 1e-4}
    return out


@pytest.mark.parametrize("arch", ["llama3-8b", "deepseek-v2-lite-16b",
                                  "jamba-v0.1-52b", "xlstm-125m"])
def test_generate_matches_the_reference_engine(arch):
    rcfg, pcfg = configs(arch)
    params, model = carried(rcfg, pcfg, seed=3)
    ref, mine = RefEngine(rcfg, params, s_max=32), ServeEngine(
        pcfg, model, s_max=32)
    want = ref.generate(PROMPTS, max_new=8)
    got = mine.generate(PROMPTS, max_new=8)
    assert got.steps == want.steps == 8
    if got.tokens != want.tokens:
        # A flipped argmax is excused only at a near-tie of the reference.
        ties = _near_ties(rcfg, params, want, PROMPTS)
        diff = {(i, t) for i, (a, b) in enumerate(zip(got.tokens,
                                                      want.tokens))
                for t in range(len(b)) if a[t] != b[t]}
        first = {(i, min(t for j, t in diff if j == i)) for i, _ in diff}
        assert first <= ties, (got.tokens, want.tokens)
    hot = ref.generate(PROMPTS, max_new=8, temperature=0.8, seed=0)
    assert mine.generate(PROMPTS, max_new=8, temperature=0.8,
                         seed=0).tokens == hot.tokens


def test_generate_shapes_and_eos():
    _, pcfg = configs("llama3-8b")
    model = pm.init_params(pcfg, device="cpu")
    engine = ServeEngine(pcfg, model, s_max=64)
    res = engine.generate(PROMPTS[:3], max_new=8)
    assert len(res.tokens) == 3 and res.steps == 8
    for p, o in zip(PROMPTS, res.tokens):
        assert o[: len(p)] == p and len(o) == len(p) + 8
        assert all(0 <= t < pcfg.vocab_size for t in o)
    # EOS: a row that emits it stops growing; the batch ends when all did.
    eos = res.tokens[0][len(PROMPTS[0])]
    res1 = engine.generate(PROMPTS[:3], max_new=8, eos_id=eos)
    assert res1.tokens[0] == PROMPTS[0] + [eos]
    for p, o, full in zip(PROMPTS[1:3], res1.tokens[1:], res.tokens[1:]):
        n = full[len(p):].index(eos) + 1 if eos in full[len(p):] else 8
        assert o == full[:len(p) + n]
    solo = engine.generate([PROMPTS[0]], max_new=8)
    res2 = engine.generate([PROMPTS[0]], max_new=8,
                           eos_id=solo.tokens[0][len(PROMPTS[0])])
    assert res2.steps == 1 and res2.tokens[0] == solo.tokens[0][:5]


def test_greedy_first_token_is_the_forward_argmax():
    _, pcfg = configs("llama3-8b")
    model = pm.init_params(pcfg, device="cpu",
                           generator=torch.Generator().manual_seed(3))
    prompt = [3, 1, 4, 1, 5, 9]
    res = ServeEngine(pcfg, model, s_max=32).generate([prompt], max_new=1)
    with torch.no_grad():
        logits, _ = pm.forward_train(model, pcfg, {
            "tokens": torch.tensor([prompt])})
    assert res.tokens[0][-1] == int(logits[0, -1].argmax())


def test_s_max_too_small_raises():
    _, pcfg = configs("llama3-8b")
    engine = ServeEngine(pcfg, pm.init_params(pcfg, device="cpu"), s_max=8)
    with pytest.raises(ValueError, match="s_max too small"):
        engine.generate([[1, 2, 3, 4]], max_new=5)


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    _, pcfg = configs("llama3-8b")
    with pytest.raises(RuntimeError, match="not available"):
        pm.init_params(pcfg)
    with pytest.raises(RuntimeError, match="not available"):
        serve.main(["--arch", "llama3-8b"])


def test_serve_cli_on_the_cpu(capsys):
    res = serve.main(["--arch", "xlstm-125m", "--device", "cpu",
                      "--max-new", "4", "--requests", "2"])
    assert len(res.tokens) == 2 and res.steps == 4
    assert "[serve] arch=xlstm-125m-smoke device=cpu" in capsys.readouterr(
    ).out


def test_a_mesh_is_refused():
    """Anything but a ``DeviceMesh`` with named dims is refused as a mesh
    (tests/test_torch_mesh_serve.py serves on real ones); without a mesh
    the constraints are the identity and seqpar decode stays off."""
    with pytest.raises(TypeError, match="DeviceMesh"):
        meshctx.set_mesh(object())
    with pytest.raises(TypeError, match="DeviceMesh"):
        with meshctx.use_mesh(object()):
            pass
    meshctx.set_mesh(None)
    meshctx.set_seqpar_decode(True)
    try:
        assert meshctx.get_mesh() is None and not meshctx.seqpar_decode()
        x = torch.ones(2)
        assert meshctx.constrain(x, "dp") is x
    finally:
        meshctx.set_seqpar_decode(False)


def test_configs_are_the_references():
    assert pconfigs.ARCHS == ARCHS
    assert pconfigs.SKIP_CELLS == SKIP_CELLS
    assert {k: dataclasses.asdict(v) for k, v in pconfigs.SHAPES.items()} \
        == {k: dataclasses.asdict(v) for k, v in SHAPES.items()}
    assert pconfigs.all_cells() == [(a, s) for a in ARCHS
                                    for s in pconfigs.cells(a)]
    assert dataclasses.asdict(pconfigs.TrainConfig()) == dataclasses.asdict(
        TrainConfig())
    for arch in ARCHS:
        for smoke in (False, True):
            assert dataclasses.asdict(pconfigs.get_config(arch, smoke=smoke)) \
                == dataclasses.asdict(ref_config(arch, smoke=smoke))
    with pytest.raises(KeyError, match="unknown arch"):
        pconfigs.get_config("gpt-5")


def test_param_counts_reasonable():
    cfg = pconfigs.get_config("llama3-8b")
    n = cfg.param_count()
    assert 7.5e9 < n < 9e9, f"llama3-8b param count {n/1e9:.2f}B"
    assert n == ref_config("llama3-8b").param_count()
    cfg4 = pconfigs.get_config("llama4-maverick-400b-a17b")
    total = cfg4.param_count()
    active = cfg4.active_param_count()
    assert 3.5e11 < total < 4.6e11, f"maverick total {total/1e9:.0f}B"
    assert 1.2e10 < active < 2.2e10, f"maverick active {active/1e9:.1f}B"
    assert active == ref_config(
        "llama4-maverick-400b-a17b").active_param_count()


def test_abstract_params_no_alloc():
    cfg = pconfigs.get_config("nemotron-4-15b")  # full config
    model = pm.abstract_params(cfg)
    assert all(p.is_meta for p in model.parameters())
    n = sum(p.numel() for p in model.parameters())
    assert 1.4e10 < n < 1.8e10, f"nemotron param count {n/1e9:.1f}B"
    assert n == ref_config("nemotron-4-15b").param_count()
