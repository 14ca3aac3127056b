"""The port stands alone: ``repro_torch`` and ``chip_smoke.py`` import
neither ``jax`` nor the reference package ``repro``."""

import ast
import os
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_roots(path: pathlib.Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def test_no_forbidden_imports_in_source():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
    bad = {str(f.relative_to(ROOT)): sorted(_imported_roots(f) & set(FORBIDDEN))
           for f in files}
    assert not {f: r for f, r in bad.items() if r}


def test_importing_the_port_loads_no_jax():
    code = ("import sys, repro_torch.edm, repro_torch.kernels.ops, "
            "repro_torch.kernels.knn_multi_e, repro_torch.kernels.knn_batch, "
            "repro_torch.kernels.lookup, repro_torch.kernels.topk, "
            "repro_torch.kernels.pairwise_dist, "
            "repro_torch.kernels.smap_gram, repro_torch.kernels.knn_append, "
            "repro_torch.kernels.knn_fused, repro_torch.edm.plan, "
            "repro_torch.edm.dataset, repro_torch.edm.carry, "
            "repro_torch.core.knn, repro_torch.core, "
            "repro_torch.core.smap, repro_torch.core.smap_engine, "
            "repro_torch.edm.surrogates, repro_torch.data, "
            "repro_torch.telemetry, repro_torch.core.stats, "
            "repro_torch.telemetry.schema, repro_torch.checkpoint, "
            "repro_torch.distributed.fault, repro_torch.edm.runner, "
            "repro_torch.edm.inspect, repro_torch.serving, "
            "repro_torch.serving.faultinject, repro_torch.serving.state, "
            "repro_torch.serving.subscriptions, "
            "repro_torch.serving.scheduler, "
            "repro_torch.serving.durability, "
            "repro_torch.serving.edm_server, repro_torch.configs, "
            "repro_torch.configs.base, repro_torch.models, "
            "repro_torch.models.layers, repro_torch.models.meshctx, "
            "repro_torch.models.attention, repro_torch.models.moe, "
            "repro_torch.models.mamba, repro_torch.models.xlstm, "
            "repro_torch.models.transformer, repro_torch.models.carry, "
            "repro_torch.serving.engine, repro_torch.launch, "
            "repro_torch.launch.serve, repro_torch.optim, "
            "repro_torch.optim.adamw, repro_torch.optim.grad_utils, "
            "repro_torch.optim.schedule, repro_torch.training, "
            "repro_torch.training.step, repro_torch.training.loop, "
            "repro_torch.training.carry, repro_torch.data.pipeline, "
            "repro_torch.distributed.compression, "
            "repro_torch.launch.train, repro_torch.launch.mesh, "
            "repro_torch.launch.sharding, repro_torch.launch.dryrun, "
            "repro_torch.launch.roofline\n"
            "from repro_torch.configs import ARCHS, get_config\n"
            "[get_config(a, smoke=s) for a in ARCHS for s in (0, 1)]\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r}]\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_the_mesh_train_step_loads_no_jax():
    """The mesh train step's entry points (placed states, the dry run's
    constraints, the differentiable collectives) import and build their
    constraints without loading JAX or the reference."""
    code = ("import sys\n"
            "from repro_torch.training import make_train_step\n"
            "from repro_torch.training.carry import (init_placed_state, "
            "place_state, state_from_numpy, state_to_numpy)\n"
            "from repro_torch.launch.sharding import (dp_batch_constraint, "
            "expert_grad_constraint, to_shardings)\n"
            "from repro_torch.launch.mesh import abstract_mesh\n"
            "from repro_torch.models.meshctx import (all_gather, all_reduce, "
            "all_reduce_, batch_local, rows_activation, sum_grad)\n"
            "from repro_torch.models.layers import unembed_ce\n"
            "from repro_torch.optim.adamw import Cut, codec_cut\n"
            "from repro_torch.optim.grad_utils import (accumulate_microbatches,"
            " sum_over_dp, take_grads)\n"
            "from repro_torch.configs import get_config\n"
            "cfg = get_config('qwen1.5-4b')\n"
            "expert_grad_constraint(cfg, abstract_mesh((2, 2), "
            "('data', 'model')))\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r}]\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_the_dry_run_loads_no_jax():
    """The compile-analysis tools count a cell over a fake world and write
    a report without loading JAX or the reference (the reference's
    launchers set ``XLA_FLAGS`` when imported; the port's set nothing)."""
    code = ("import os, sys, tempfile\n"
            "flags = os.environ.get('XLA_FLAGS')\n"
            "from repro_torch.launch import dryrun, roofline\n"
            "d = tempfile.mkdtemp()\n"
            "assert dryrun.main(['--arch', 'llama3-8b', '--shape', "
            "'decode_32k', '--device', 'cpu', '--out', d]) == 0\n"
            "rows = roofline.main(['--report', '--dryrun', d, '--out', d])\n"
            "assert [(r['arch'], r['shape']) for r in rows] == "
            "[('llama3-8b', 'decode_32k')]\n"
            "assert os.environ.get('XLA_FLAGS') == flags\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r}]\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
