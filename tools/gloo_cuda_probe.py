"""Which collectives a gloo world serves on CUDA tensors, and which DTensor
redistributions it carries.

Four processes share ``cuda:0`` (NCCL refuses two ranks on one card), so a
mesh of four ranks on one card runs on gloo. Each probe runs in a world of
its own, so a probe that crashes a rank (a segfault) takes no other probe
with it. Prints one JSON object: probe name → "ok", "wrong" (ran, gave
another value), "error: ..." (raised) or "crash rc=..." (a rank died).

    python3 tools/gloo_cuda_probe.py            # four gloo ranks on cuda:0
    python3 tools/gloo_cuda_probe.py --device cpu
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile

WORLD = 4
PROBES = (
    "all_reduce_sum", "all_reduce_max", "all_gather", "all_gather_into_tensor",
    "reduce_scatter", "reduce_scatter_tensor", "all_to_all",
    "all_to_all_single", "broadcast", "subgroup_all_reduce",
    "funcol_all_reduce", "funcol_all_gather", "funcol_reduce_scatter",
    "dtensor_shard_to_replicate", "dtensor_partial_to_replicate",
    "dtensor_shard0_to_shard1", "dtensor_full_tensor", "dtensor_mm_partial",
)


def _child(name, rank, world, store_path, device):
    import torch
    import torch.distributed as dist

    if device == "cuda":
        torch.cuda.set_device(0)
    store = dist.FileStore(store_path, world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world)
    dev = torch.device(device)
    r = rank + 1.0
    n = world
    tot = n * (n + 1) / 2
    ok = False
    if name == "all_reduce_sum":
        t = torch.full((8,), r, device=dev)
        dist.all_reduce(t)
        ok = bool((t == tot).all())
    elif name == "all_reduce_max":
        t = torch.full((8,), r, device=dev)
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        ok = bool((t == n).all())
    elif name == "all_gather":
        t = torch.full((4,), r, device=dev)
        parts = [torch.empty_like(t) for _ in range(n)]
        dist.all_gather(parts, t)
        ok = all(bool((p == i + 1).all()) for i, p in enumerate(parts))
    elif name == "all_gather_into_tensor":
        t = torch.full((4,), r, device=dev)
        out = torch.empty(4 * n, device=dev)
        dist.all_gather_into_tensor(out, t)
        ok = bool((out.view(n, 4)[:, 0] == torch.arange(
            1, n + 1, device=dev)).all())
    elif name == "reduce_scatter":
        ins = [torch.full((4,), r, device=dev) for _ in range(n)]
        out = torch.empty(4, device=dev)
        dist.reduce_scatter(out, ins)
        ok = bool((out == tot).all())
    elif name == "reduce_scatter_tensor":
        t = torch.full((4 * n,), r, device=dev)
        out = torch.empty(4, device=dev)
        dist.reduce_scatter_tensor(out, t)
        ok = bool((out == tot).all())
    elif name == "all_to_all":
        ins = [torch.full((2,), r * 10 + j, device=dev) for j in range(n)]
        outs = [torch.empty(2, device=dev) for _ in range(n)]
        dist.all_to_all(outs, ins)
        ok = all(bool((o == (i + 1) * 10 + rank).all())
                 for i, o in enumerate(outs))
    elif name == "all_to_all_single":
        t = torch.cat([torch.full((2,), r * 10 + j, device=dev)
                       for j in range(n)])
        out = torch.empty_like(t)
        dist.all_to_all_single(out, t)
        ok = all(bool((out[2 * i:2 * i + 2] == (i + 1) * 10 + rank).all())
                 for i in range(n))
    elif name == "broadcast":
        t = torch.full((4,), r, device=dev)
        dist.broadcast(t, src=0)
        ok = bool((t == 1).all())
    elif name == "subgroup_all_reduce":
        from torch.distributed.device_mesh import init_device_mesh
        mesh = init_device_mesh(device, (2, 2), mesh_dim_names=("data",
                                                                "model"))
        t = torch.full((4,), r, device=dev)
        dist.all_reduce(t, group=mesh.get_group("model"))
        want = {0: 3.0, 1: 3.0, 2: 7.0, 3: 7.0}[rank]
        ok = bool((t == want).all())
    elif name.startswith("funcol"):
        import torch.distributed._functional_collectives as fc
        grp = dist.group.WORLD
        if name == "funcol_all_reduce":
            t = fc.all_reduce(torch.full((4,), r, device=dev), "sum", grp)
            ok = bool((fc.wait_tensor(t) == tot).all())
        elif name == "funcol_all_gather":
            t = fc.all_gather_tensor(torch.full((4,), r, device=dev), 0, grp)
            t = fc.wait_tensor(t)
            ok = bool((t.view(n, 4)[:, 0] == torch.arange(
                1, n + 1, device=dev)).all())
        else:
            t = fc.reduce_scatter_tensor(
                torch.full((4 * n,), r, device=dev), "sum", 0, grp)
            ok = bool((fc.wait_tensor(t) == tot).all())
    else:
        from torch.distributed.device_mesh import init_device_mesh
        from torch.distributed.tensor import (DTensor, Partial, Replicate,
                                              Shard)
        mesh = init_device_mesh(device, (n,), mesh_dim_names=("model",))
        full = torch.arange(n * 4 * n, dtype=torch.float32,
                            device=dev).view(n * 4, n)
        if name == "dtensor_shard_to_replicate":
            d = DTensor.from_local(full.chunk(n)[rank], mesh, [Shard(0)])
            ok = bool((d.redistribute(mesh, [Replicate()]).to_local()
                       == full).all())
        elif name == "dtensor_partial_to_replicate":
            d = DTensor.from_local(full / n, mesh, [Partial()])
            ok = bool(torch.allclose(
                d.redistribute(mesh, [Replicate()]).to_local(), full))
        elif name == "dtensor_shard0_to_shard1":
            d = DTensor.from_local(full.chunk(n)[rank], mesh, [Shard(0)])
            got = d.redistribute(mesh, [Shard(1)]).to_local()
            ok = bool((got == full.chunk(n, dim=1)[rank]).all())
        elif name == "dtensor_full_tensor":
            d = DTensor.from_local(full.chunk(n)[rank], mesh, [Shard(0)])
            ok = bool((d.full_tensor() == full).all())
        elif name == "dtensor_mm_partial":
            a = DTensor.from_local(full.T.chunk(n, dim=1)[rank], mesh,
                                   [Shard(1)])
            b = DTensor.from_local(full.chunk(n)[rank], mesh, [Shard(0)])
            got = (a @ b).redistribute(mesh, [Replicate()]).to_local()
            ok = bool(torch.allclose(got, full.T @ full))
    if device == "cuda":
        torch.cuda.synchronize()
    dist.barrier()
    dist.destroy_process_group()
    print("PROBE_OK" if ok else "PROBE_WRONG", flush=True)


def _run(name, device, timeout=90):
    with tempfile.TemporaryDirectory() as tmp:
        store = os.path.join(tmp, "store")
        procs = [subprocess.Popen(
            [sys.executable, __file__, "child", name, str(r), str(WORLD),
             store, device], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True) for r in range(WORLD)]
        results = []
        for p in procs:
            try:
                out, err = p.communicate(timeout=timeout)
            except subprocess.TimeoutExpired:
                for q in procs:
                    q.kill()
                out, err = p.communicate()
                results.append((-9, out, err))
                continue
            results.append((p.returncode, out, err))
    rcs = [rc for rc, _, _ in results]
    if any(rc != 0 for rc in rcs):
        errs = [e.strip().splitlines()[-1] for rc, _, e in results
                if rc != 0 and e.strip()]
        if errs and any(rc == 1 for rc in rcs):
            return f"error: {errs[0][:200]}"
        return f"crash rc={rcs}"
    if all("PROBE_OK" in out for _, out, _ in results):
        return "ok"
    return "wrong"


def main(argv):
    if argv[:1] == ["child"]:
        name, rank, world, store, device = argv[1:6]
        _child(name, int(rank), int(world), store, device)
        return 0
    device = "cpu" if "--device" in argv and argv[
        argv.index("--device") + 1] == "cpu" else "cuda"
    import torch
    print(json.dumps({"torch": torch.__version__,
                      "cuda": torch.version.cuda, "device": device,
                      "world": WORLD}), flush=True)
    table = {name: _run(name, device) for name in PROBES}
    print(json.dumps(table, indent=1), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
