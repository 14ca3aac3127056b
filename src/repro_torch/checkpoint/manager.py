"""Checkpointing: atomic save/restore of nested array trees.

* atomic: a step is written to ``step_XXXX.tmp`` and renamed — a
  preempted writer never corrupts the latest checkpoint;
* auto-resume: ``latest_step()`` + ``restore()`` make restart loops
  trivial;
* retention: the last K checkpoints are kept;
* validated restore: every leaf is stored whole (``np.save``) with its
  shape and dtype in a manifest, and a leaf that no longer matches the
  manifest is refused with the leaf named.

A tree is a leaf or a dict, list or tuple of trees; dict keys are walked
in sorted order. A leaf is an ``np.ndarray`` or a ``torch.Tensor``
(saved through ``.cpu().numpy()``); ``restore`` hands each leaf back as
the type, dtype and device of the matching leaf of ``like``. An
``nn.Module`` (a model's parameters) is saved as the dict of its named
parameters, and ``restore`` writes them back into the module of ``like``
in place and returns that module.

Elastic restore: ``restore(like, shardings=)`` places each stored, whole
leaf onto a mesh (``shardings``: a tree matching ``like`` of
``launch.sharding.NamedSharding``, None for a leaf left whole), every
rank keeping its block; a module's parameters become those DTensors. A
module whose parameters are DTensors already (``models.carry.
place_params``) takes each rank's block of the stored leaf in place.
Saving a DTensor stores it whole: every rank of its world calls ``save``
and rank 0 writes, so a placed train state restores onto a mesh of
another shape (``shardings=launch.sharding.to_shardings(mesh,
state_specs(...))``).
"""

from __future__ import annotations

import json
import os
import shutil

import numpy as np
import torch


def _is_sharding(t) -> bool:
    return t is None or hasattr(t, "placements")


def _flatten(tree, keep=None) -> tuple[list, str]:
    """(leaves in a fixed order, a string of the tree's structure); a node
    that ``keep`` accepts is a leaf."""
    leaves: list = []

    def walk(t) -> str:
        if keep is not None and keep(t):
            leaves.append(t)
            return "*"
        if isinstance(t, torch.nn.Module):
            t = dict(t.named_parameters())
        if isinstance(t, dict):
            keys = sorted(t)
            return "{" + ",".join(f"{k!r}:{walk(t[k])}" for k in keys) + "}"
        if isinstance(t, (list, tuple)):
            inner = ",".join(walk(v) for v in t)
            return f"[{inner}]" if isinstance(t, list) else f"({inner})"
        leaves.append(t)
        return "*"

    return leaves, walk(tree)


def _unflatten(like, leaves):
    from repro_torch.models import meshctx

    it = iter(leaves)

    def build(t):
        if isinstance(t, torch.nn.Module):
            params = dict(t.named_parameters())
            with torch.no_grad():
                for k in sorted(params):
                    new = next(it)
                    if meshctx.is_dtensor(new):
                        owner, _, leaf = k.rpartition(".")
                        mod = t.get_submodule(owner) if owner else t
                        setattr(mod, leaf, torch.nn.Parameter(
                            new, requires_grad=params[k].requires_grad))
                    elif meshctx.is_dtensor(params[k]):
                        p = params[k]
                        p.to_local().copy_(meshctx.local_slice(
                            new, p.device_mesh, p.placements))
                    else:
                        params[k].copy_(new)
            return t
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        return next(it)

    return build(like)


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        from repro_torch.models import meshctx

        return meshctx.full(leaf.detach()).cpu().numpy()
    return np.asarray(leaf)


def _like(arr: np.ndarray, ref, sharding=None):
    """``arr`` as the type, dtype and device of the leaf ``ref``; placed
    on ``sharding``'s mesh when one is given."""
    if sharding is not None:
        from repro_torch.models import meshctx

        mesh = sharding.mesh
        dev = (torch.device("cuda", torch.cuda.current_device())
               if mesh.device_type == "cuda" else torch.device("cpu"))
        dtype = ref.dtype if isinstance(ref, torch.Tensor) else None
        t = torch.as_tensor(arr).to(device=dev, dtype=dtype)
        return meshctx.place(t, mesh, sharding.placements)
    if isinstance(ref, torch.Tensor):
        return torch.as_tensor(arr).to(device=ref.device, dtype=ref.dtype)
    return np.asarray(arr, dtype=ref.dtype)


class CheckpointManager:
    def __init__(self, directory: str, *, keep: int = 3):
        self.dir = os.path.abspath(directory)
        self.keep = keep
        os.makedirs(self.dir, exist_ok=True)

    # ------------------------------------------------------------- paths

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:010d}")

    def steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp"):
                try:
                    out.append(int(name[5:]))
                except ValueError:
                    pass
        return sorted(out)

    def latest_step(self):
        s = self.steps()
        return s[-1] if s else None

    # -------------------------------------------------------------- save

    def save(self, step: int, state) -> str:
        """Write ``state`` as step ``step``. A state holding DTensors is
        saved by every rank of their world together: each leaf is
        gathered whole on every rank, rank 0 writes, and all return once
        the step is published."""
        from repro_torch.models import meshctx

        leaves, treedef = _flatten(state)
        final = self._step_dir(step)
        tmp = final + ".tmp"
        placed = any(meshctx.is_dtensor(t) for t in leaves)
        if placed:
            import torch.distributed as dist
        writer = not placed or dist.get_rank() == 0
        if writer:
            if os.path.exists(tmp):
                shutil.rmtree(tmp)
            os.makedirs(tmp)
        manifest = {"treedef": treedef, "n_leaves": len(leaves),
                    "step": step, "leaves": []}
        for i, leaf in enumerate(leaves):
            arr = _host(leaf)
            if writer:
                np.save(os.path.join(tmp, f"leaf_{i:05d}.npy"), arr)
            manifest["leaves"].append(
                {"shape": list(arr.shape), "dtype": str(arr.dtype)})
        if not writer:
            dist.barrier()
            return final
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)  # atomic publish
        self._retain()
        if placed:
            dist.barrier()
        return final

    def _retain(self):
        steps = self.steps()
        for s in steps[: max(0, len(steps) - self.keep)]:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

    # ----------------------------------------------------------- restore

    def restore(self, like, *, step: int | None = None, shardings=None):
        """Restore into the structure of ``like`` (a tree of arrays or
        tensors; each leaf comes back as its ``like`` leaf's type).
        ``shardings``: a tree matching ``like`` of ``NamedSharding``s (or
        None leaves) for elastic placement onto a mesh."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        d = self._step_dir(step)
        leaves, treedef = _flatten(like)
        if shardings is None:
            shard_leaves = [None] * len(leaves)
        else:
            shard_leaves, shard_def = _flatten(shardings, keep=_is_sharding)
            if shard_def != treedef:
                raise ValueError("shardings do not match the structure of "
                                 "the restore target")
        try:
            with open(os.path.join(d, "manifest.json")) as f:
                manifest = json.load(f)
        except (OSError, json.JSONDecodeError) as e:
            raise ValueError(
                f"checkpoint step {step} has an unreadable manifest "
                f"({os.path.join(d, 'manifest.json')}): {e}") from e
        if manifest["n_leaves"] != len(leaves):
            raise ValueError(
                f"checkpoint has {manifest['n_leaves']} leaves, "
                f"target structure has {len(leaves)}")
        if len(manifest.get("leaves", ())) != manifest["n_leaves"]:
            raise ValueError(
                f"checkpoint step {step} manifest is corrupt: "
                f"{len(manifest.get('leaves', ()))} leaf records for "
                f"{manifest['n_leaves']} leaves")
        out = []
        for i, (ref, shd) in enumerate(zip(leaves, shard_leaves)):
            path = os.path.join(d, f"leaf_{i:05d}.npy")
            try:
                arr = np.load(path)
            except Exception as e:
                raise ValueError(
                    f"checkpoint step {step} leaf {i} is unreadable "
                    f"({path}): {e} — the checkpoint is corrupt; delete "
                    f"the step directory and resume from an earlier one"
                ) from e
            # A leaf that no longer matches the shape/dtype recorded at
            # save time was truncated or swapped after the atomic publish:
            # fail here with the leaf named, not deep in the consumer.
            meta = manifest["leaves"][i]
            if (list(arr.shape) != list(meta["shape"])
                    or str(arr.dtype) != meta["dtype"]):
                raise ValueError(
                    f"checkpoint step {step} leaf {i} ({path}) does not "
                    f"match its manifest: loaded {arr.dtype}{arr.shape}, "
                    f"manifest says {meta['dtype']}{tuple(meta['shape'])} "
                    f"— the checkpoint is corrupt")
            if tuple(arr.shape) != tuple(ref.shape):
                raise ValueError(
                    f"leaf {i}: checkpoint shape {arr.shape} != "
                    f"{tuple(ref.shape)}")
            out.append(_like(arr, ref, shd))
        return _unflatten(like, out)
