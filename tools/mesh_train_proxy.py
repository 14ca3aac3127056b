"""A CPU proxy of ``chip_smoke.py``'s phase 15: how far the train step on a
mesh lands from the no-mesh step in bf16, at a narrow width.

qwen1.5-4b's configuration cut to 22 layers (the sampled leaf is unit 20's),
d_model 256, 4 heads of 64, d_ff 768 (1.5 blocks of 256 a rank at "model"
2, as 6,912 is 13.5), vocab 1,024, chunked attention (chunks of 32 above
64 positions), bf16 activations over float32 parameters, ``adamw8bit``;
one step of ``TokenPipeline(vocab, 2, S, seed 0)``'s first batch from the
state drawn from a generator seeded 0: without a mesh, on a world of one
(mesh (1, 1)) and on four gloo ranks (mesh (2, 2)). Prints one JSON object:
the world of one against the no-mesh step, and the four ranks against the
world of one, in ``chip_smoke.metric_diff``/``sampled_diff``'s terms (the
quantities phase 15 bounds with ``WORLD_OF_ONE_BOUNDS`` and
``MESH_TRAIN_BOUNDS``).

    PYTHONPATH=src python3 tools/mesh_train_proxy.py [--seq 2048] [--dtype float32]

About 4 minutes on one CPU core at S 2,048.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4

RANK = r"""
import json, os, sys
import numpy as np
import torch
import torch.distributed as dist

rank, world, out, root, seq = sys.argv[1:6]
rank, world = int(rank), int(world)
sys.path[:0] = [root, os.path.join(root, "tools")]
torch.set_num_threads(1)
dist.init_process_group("gloo", store=dist.FileStore(
    os.path.join(out, "store"), world), rank=rank, world_size=world)
import mesh_train_proxy as proxy
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import meshctx

with meshctx.use_mesh(make_mesh((2, 2), ("data", "model"),
                                device_type="cpu")):
    met, rows = proxy.one_step(int(seq))
if rank == 0:
    np.savez(os.path.join(out, "rows.npz"), **rows)
    with open(os.path.join(out, "metrics.json"), "w") as f:
        json.dump(met, f)
dist.barrier()
dist.destroy_process_group()
"""


def config():
    import chip_smoke as cs

    cfg, tcfg = cs.mesh_train_config()
    return dataclasses.replace(
        cfg, n_layers=22, d_model=256, n_heads=4, n_kv_heads=4, d_head=64,
        d_ff=768, vocab_size=1024,
        dtype=os.environ.get("PROXY_DTYPE", cfg.dtype)), tcfg


def one_step(seq: int):
    """(metrics, ``chip_smoke.sample_state`` rows) of one step from the
    state seeded 0, on the mesh ``meshctx`` holds (or none)."""
    import numpy as np
    import torch

    import chip_smoke as cs
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.training import make_train_step

    cfg, tcfg = config()
    hb = TokenPipeline(vocab_size=cfg.vocab_size, batch=2, seq_len=seq,
                       seed=0).global_batch(0)
    init, step, _ = make_train_step(cfg, tcfg)
    state = init(torch.Generator().manual_seed(0))
    state, met = step(state, {k: torch.as_tensor(v) for k, v in hb.items()})
    rows = cs.sample_state(torch, state, cs.mesh_train_rows(
        np, cfg, hb["tokens"]))
    return {k: float(v) for k, v in met.items()}, rows


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seq", type=int, default=2048)
    ap.add_argument("--dtype", default=None,
                    help="the activations' dtype (default: the config's)")
    args = ap.parse_args()
    if args.dtype:
        os.environ["PROXY_DTYPE"] = args.dtype
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch
    import torch.distributed as dist

    import chip_smoke as cs
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import meshctx

    torch.set_num_threads(1)
    plain, plain_rows = one_step(args.seq)
    with meshctx.use_mesh(make_mesh((1, 1), ("data", "model"),
                                    device_type="cpu")):
        one, one_rows = one_step(args.seq)
    dist.destroy_process_group()
    with tempfile.TemporaryDirectory() as out:
        env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
                   OMP_NUM_THREADS="1")
        procs = [subprocess.Popen(
            [sys.executable, "-c", RANK, str(r), str(WORLD), out, ROOT,
             str(args.seq)], env=env, stderr=subprocess.PIPE, text=True)
            for r in range(WORLD)]
        errs = [p.communicate()[1] for p in procs]
        if any(p.returncode for p in procs):
            raise SystemExit("\n".join(e[-2000:] for e in errs))
        four_rows = dict(np.load(os.path.join(out, "rows.npz")))
        with open(os.path.join(out, "metrics.json")) as f:
            four = json.load(f)
    lr = plain["lr"]
    print(json.dumps({
        "seq": args.seq, "dtype": config()[0].dtype,
        "world_of_one_vs_no_mesh": {
            "metrics": cs.metric_diff(one, plain),
            "sampled": cs.sampled_diff(np, one_rows, plain_rows, lr=lr)},
        "four_ranks_vs_world_of_one": {
            "metrics": cs.metric_diff(four, one),
            "sampled": cs.sampled_diff(np, four_rows, one_rows, lr=lr)}}))


if __name__ == "__main__":
    main()
