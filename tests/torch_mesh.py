"""Helpers of the LM substrate's mesh tests: a reference program run in a
JAX subprocess with forced host devices, trees carried through ``.npz``
files, and the port's ranks spawned by ``torch_world.spawn_world``.

One JAX subprocess and one spawned world a test module: each writes
``.npz`` files under the module's directory, and the tests read them.
"""

import os
import pathlib
import subprocess
import sys
import textwrap

import numpy as np

from torch_world import ROOT, spawn_world

REF_TIMEOUT_S = 600


def run_reference(program: str, devices: int, out: pathlib.Path):
    """Run ``program`` (JAX, ``OUT`` bound to ``out``) in a subprocess with
    ``devices`` host devices; raise with its stderr when it fails."""
    head = textwrap.dedent(f"""
        import os
        os.environ["XLA_FLAGS"] = (
            "--xla_force_host_platform_device_count={devices}")
        os.environ["JAX_PLATFORMS"] = "cpu"
        import pathlib
        OUT = pathlib.Path({str(out)!r})
    """)
    env = dict(os.environ, PYTHONPATH=f"{ROOT / 'src'}:{ROOT / 'tests'}",
               OMP_NUM_THREADS="1")
    res = subprocess.run([sys.executable, "-c",
                          head + textwrap.dedent(program)], env=env,
                         capture_output=True, text=True,
                         timeout=REF_TIMEOUT_S)
    if res.returncode != 0:
        raise RuntimeError(res.stderr[-3000:])


def run_world(program: str, world: int, out: pathlib.Path):
    """Run ``program`` as ``world`` gloo ranks on the CPU; it sees
    ``RANK``, ``WORLD``, ``OUT`` and an initialized process group. Raises
    naming the ranks that failed."""
    head = textwrap.dedent(f"""
        import pathlib, sys
        sys.path.insert(0, {str(ROOT / "tests")!r})
        import torch
        import torch.distributed as dist
        RANK, WORLD = int(sys.argv[1]), int(sys.argv[2])
        OUT = pathlib.Path(sys.argv[3])
        torch.set_num_threads(1)
        dist.init_process_group(
            "gloo", store=dist.FileStore(str(OUT / "store"), WORLD),
            rank=RANK, world_size=WORLD)
    """)
    tail = "\ndist.barrier()\ndist.destroy_process_group()\n"
    res = spawn_world(head + textwrap.dedent(program) + tail, world, out)
    bad = [(r, rc, err) for r, (rc, err) in enumerate(res) if rc != 0]
    if bad:
        raise RuntimeError("\n".join(f"rank {r} rc {rc}: {err}"
                                     for r, rc, err in bad))


def save_tree(path, tree, prefix=""):
    """A tree of dicts and lists of arrays to ``.npz`` keys joined by "/"
    (list indices as "#<i>")."""
    flat = {}

    def walk(t, key):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, f"{key}/{k}" if key else str(k))
        elif isinstance(t, (list, tuple)):
            for i, v in enumerate(t):
                walk(v, f"{key}/#{i}")
        else:
            flat[key] = np.asarray(t)

    walk(tree, prefix)
    np.savez(path, **flat)


def load_tree(path, prefix=""):
    """The tree ``save_tree`` wrote (under ``prefix``)."""
    data = np.load(path)
    root: dict = {}
    for key in data.files:
        if prefix and not key.startswith(prefix + "/"):
            continue
        parts = key[len(prefix) + 1:].split("/") if prefix else key.split("/")
        node = root
        for k in parts[:-1]:
            node = node.setdefault(k, {})
        node[parts[-1]] = data[key]

    def lists(t):
        if not isinstance(t, dict):
            return t
        if t and all(k.startswith("#") for k in t):
            return [lists(t[f"#{i}"]) for i in range(len(t))]
        return {k: lists(v) for k, v in t.items()}

    return lists(root)
