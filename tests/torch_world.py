"""Spawn a ``torch.distributed`` world of child processes for the port's
sharded tests: one process a rank on a gloo ``FileStore`` in the test's
own directory, so no TCP port is shared between test workers."""

import os
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
WORLD_TIMEOUT_S = 400


def spawn_world(script: str, world: int, out: pathlib.Path, *args,
                timeout: float = WORLD_TIMEOUT_S):
    """Run ``script`` as ``world`` ranks (``python -c script rank world out
    *args``) → [(returncode, stderr tail)] by rank. When a rank outlives
    ``timeout`` every rank is killed and the unfinished ones report -9."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", script, str(r), str(world), str(out),
         *map(str, args)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(world)]
    out_ = []
    for p in procs:
        try:
            _, err = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            _, err = p.communicate()
            out_.append((-9, err[-3000:]))
            continue
        out_.append((p.returncode, err[-3000:]))
    return out_
