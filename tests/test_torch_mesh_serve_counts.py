"""The mesh serving path issues the collectives it issued before its
collectives became differentiable.

Two gloo ranks, mesh (1, 2) over ("data", "model"), llama3-8b's smoke
config drawn leaf by leaf (``carry.place_params``, seed 0), under
``torch.no_grad()``: one ``decode_step`` of 4 rows and a ``generate`` of 4
prompts × 6 new tokens (s_max 32), with sequence-parallel decode off and
on. ``meshctx.collective_counts()`` by kind and the tokens are held to the
values the same program gave on the tree before ``meshctx.all_reduce``/
``all_gather`` became autograd Functions (recorded there).
"""

import pytest

from torch_mesh import run_world
from torch_threads import one_torch_thread  # noqa: F401

WORLD = 2
PROMPTS = [[3, 5, 7], [11, 2, 9, 4, 1, 8, 6, 10, 12], [1, 2, 3, 4, 5], [7, 7]]
# {seqpar: (decode step counts, generate counts, tokens)}
RECORDED = {
    False: ({"all_reduce_sum": 5, "all_gather": 5},
            {"all_reduce_sum": 75, "all_gather": 75},
            [[3, 5, 7, 1, 31, 45, 58, 58, 58],
             [11, 2, 9, 4, 1, 8, 6, 10, 12, 31, 45, 15, 105, 105, 105],
             [1, 2, 3, 4, 5, 76, 17, 22, 20, 117, 122],
             [7, 7, 1, 31, 100, 111, 127, 77]]),
    True: ({"all_reduce_sum": 7, "all_gather": 3, "all_reduce_max": 2},
           {"all_reduce_sum": 105, "all_gather": 45, "all_reduce_max": 30},
           [[3, 5, 7, 1, 31, 45, 58, 58, 58],
            [11, 2, 9, 4, 1, 8, 6, 10, 12, 31, 45, 15, 105, 105, 105],
            [1, 2, 3, 4, 5, 76, 17, 22, 20, 117, 122],
            [7, 7, 1, 31, 100, 111, 127, 77]]),
}

PORT = """
import json
from repro_torch.configs import get_config
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models import carry, meshctx
from repro_torch.models import transformer as tf
from repro_torch.serving.engine import ServeEngine

mesh = make_test_mesh((1, 2), ("data", "model"), device_type="cpu")
cfg = get_config("llama3-8b", smoke=True)
placed = carry.place_params(cfg, mesh, device="cpu")
rec = {}
with torch.no_grad(), meshctx.use_mesh(mesh):
    for seqpar in (False, True):
        meshctx.set_seqpar_decode(seqpar)
        cache = tf.init_cache(cfg, 4, 16, device="cpu", mesh=mesh)
        meshctx.reset_collective_counts()
        tf.decode_step(placed, cfg, torch.tensor([[3], [5], [7], [9]]),
                       cache, 0)
        rec[f"decode_{seqpar}"] = meshctx.collective_counts()
        meshctx.reset_collective_counts()
        res = ServeEngine(cfg, placed, s_max=32).generate(%r, max_new=6)
        rec[f"generate_{seqpar}"] = meshctx.collective_counts()
        rec[f"tokens_{seqpar}"] = res.tokens
    meshctx.set_seqpar_decode(False)
(OUT / f"counts{RANK}.json").write_text(json.dumps(rec))
""" % (PROMPTS,)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import json
    d = tmp_path_factory.mktemp("mesh_serve_counts")
    run_world(PORT, WORLD, d)
    return [json.loads((d / f"counts{r}.json").read_text())
            for r in range(WORLD)]


@pytest.mark.parametrize("seqpar", (False, True))
def test_serving_collectives_are_unchanged(runs, seqpar):
    decode, generate, tokens = RECORDED[seqpar]
    for r in range(WORLD):
        assert runs[r][f"decode_{seqpar}"] == decode
        assert runs[r][f"generate_{seqpar}"] == generate
        assert runs[r][f"tokens_{seqpar}"] == tokens
