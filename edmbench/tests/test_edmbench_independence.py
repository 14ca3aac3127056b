"""Nothing the benchmark runs imports JAX or the JAX package, the
reference imports nothing of the port, and no file of the benchmark
reads the JAX package's benchmarks or their records. Checked from the
files' imports and from ``sys.modules`` of a fresh process."""

import ast
import json
import os
import pathlib
import subprocess
import sys

from edmbench import spec

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
SOURCES = sorted(spec.HERE.rglob("*.py"))


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_file_imports_jax_or_the_jax_package():
    for path in SOURCES:
        tops = {name.split(".", 1)[0] for name in _imports(path)}
        assert not tops & FORBIDDEN, (path, tops & FORBIDDEN)


def test_the_reference_imports_nothing_of_the_port():
    for path in sorted((spec.HERE / "reference").glob("*.py")):
        tops = {name.split(".", 1)[0] for name in _imports(path)}
        assert "repro_torch" not in tops, path


def test_no_file_reads_the_jax_benchmarks():
    marks = ("bench" + "marks/", "BENCH" + "_")
    for path in SOURCES + sorted(spec.HERE.rglob("*.json")):
        if path.resolve() == pathlib.Path(__file__).resolve():
            continue
        text = path.read_text()
        assert not any(m in text for m in marks), path


def _fresh(code):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(spec.ROOT), str(spec.ROOT / "src")]))
    env.pop("JAX_PLATFORMS", None)
    r = subprocess.run([sys.executable, "-c", code], env=env, cwd=spec.ROOT,
                       capture_output=True, text=True, timeout=120,
                       check=True)
    return json.loads(r.stdout.strip().splitlines()[-1])


def test_a_run_loads_no_forbidden_module():
    loaded = _fresh(
        "import json, sys, copy\n"
        "import torch; torch.set_num_threads(1)\n"
        "from edmbench import harness, spec, control\n"
        "for m in spec.benchmark()['per_layer']:\n"
        "    spec.metric_reader(m['name'])\n"
        "cfg = copy.deepcopy(spec.config('fly80xy'))\n"
        "cfg.update(num_series=4, series_length=120)\n"
        "chk = dict(spec.check('fly80xy-xmap'), sample=4)\n"
        "harness.run('fly80xy-xmap', 3, 0.05, True, device='cpu', cfg=cfg,"
        " check_spec=chk, log=lambda *a: None)\n"
        "print(json.dumps(sorted({n.split('.')[0] for n in sys.modules})))\n")
    assert not set(loaded) & FORBIDDEN
    assert "repro_torch" in loaded  # the system under test was run


def test_the_reference_loads_nothing_of_the_port():
    loaded = _fresh(
        "import json, sys\n"
        "from edmbench.reference import common, simplex_xmap, edim\n"
        "print(json.dumps(sorted({n.split('.')[0] for n in sys.modules})))\n")
    assert not set(loaded) & (FORBIDDEN | {"repro_torch"})
