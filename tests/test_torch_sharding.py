"""Port vs reference: the LM substrate's sharding rules, abstractly, at full
width.

``repro_torch.launch.sharding`` against ``repro.launch.sharding`` for all
ten architectures' full configs, on the production meshes (16, 16) over
("data", "model") and (2, 16, 16) over ("pod", "data", "model") given as
plain stand-ins (both packages' rules read only the dims' names and
sizes), so no world and no device is needed. The reference's leaves come
from ``jax.eval_shape`` (``abstract_params``, ``abstract_state``,
``init_cache(..., abstract=True)``), the port's from the meta device.

A port parameter (``units.<u>.…``) is matched to its reference leaf by
``repro_torch.models.carry.port_names``; its spec must equal the
reference's spec of the stacked leaf without the leading None. Every
other spec must be equal as it stands.
"""

import types

import jax
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from repro.configs import ARCHS as REF_ARCHS
from repro.configs import TrainConfig as RefTrainConfig
from repro.configs import get_config as ref_config
from repro.launch import sharding as rsh
from repro.models import transformer as rtf
from repro.training.step import make_train_step as ref_make_train_step
from repro_torch.configs import ARCHS, TrainConfig, get_config
from repro_torch.launch import sharding as psh
from repro_torch.launch.mesh import abstract_mesh
from repro_torch.models import carry
from repro_torch.models import transformer as tf
from repro_torch.training.step import make_train_step

MESHES = {"pod": ((16, 16), ("data", "model")),
          "multi_pod": ((2, 16, 16), ("pod", "data", "model"))}


def stand_in(kind):
    """A mesh's names and sizes, as both packages' rules read them."""
    shape, names = MESHES[kind]
    return types.SimpleNamespace(shape=dict(zip(names, shape)),
                                 axis_names=names)


def _key(k):
    return k.key if hasattr(k, "key") else k.idx


def ref_leaves(tree):
    """[(path of str/int, leaf)] of a reference tree whose leaves are
    arrays or PartitionSpecs."""
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, JP))
    return [(tuple(_key(k) for k in path), leaf) for path, leaf in flat]


def port_leaves(tree, prefix=()):
    """[(path, spec)] of a port tree of specs (dicts and lists)."""
    if isinstance(tree, psh.P):
        return [(prefix, tree)]
    if isinstance(tree, dict):
        return [x for k in tree for x in port_leaves(tree[k], prefix + (k,))]
    return [x for i, v in enumerate(tree)
            for x in port_leaves(v, prefix + (i,))]


def spec(s):
    return tuple(s)


def test_arch_lists_agree():
    assert tuple(ARCHS) == tuple(REF_ARCHS)


@pytest.mark.parametrize("mesh_kind", tuple(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal(arch, mesh_kind):
    rcfg, pcfg = ref_config(arch), get_config(arch)
    mesh = stand_in(mesh_kind)
    ref = jax.tree_util.tree_map_with_path(
        lambda path, leaf: rsh.param_spec(path, leaf, rcfg, mesh),
        rtf.abstract_params(rcfg))
    port = psh.param_specs(pcfg, mesh, tf.abstract_params(pcfg))
    seen = set()
    for path, s in ref_leaves(ref):
        for name, idx in carry.port_names(pcfg, path):
            want = spec(s)[1:] if idx else spec(s)
            assert spec(port[name]) == want, (name, port[name], s)
            seen.add(name)
    assert seen == set(port)


@pytest.mark.parametrize("optimizer", ("adamw", "adamw8bit"))
@pytest.mark.parametrize("arch", ARCHS)
def test_state_specs_equal(arch, optimizer):
    """Float32 moments, and 8-bit ``q``/``scale`` with their own rule, with
    the int8 wire's error buffers; on both production meshes."""
    rcfg, pcfg = ref_config(arch), get_config(arch)
    kw = dict(optimizer=optimizer, grad_compression="int8")
    r_state = ref_make_train_step(rcfg, RefTrainConfig(**kw))[2]()
    p_state = make_train_step(pcfg, TrainConfig(**kw))[2]()
    for kind in MESHES:
        mesh = stand_in(kind)
        ref = rsh.state_specs(rcfg, mesh, r_state)
        port = psh.state_specs(pcfg, mesh, p_state)
        assert spec(port["opt"]["step"]) == spec(ref["opt"]["step"])
        n = 0
        for where in (("opt", "m"), ("opt", "v"), ("ebuf",)):
            rtree, ptree = ref, port
            for k in where:
                rtree, ptree = rtree[k], ptree[k]
            for path, s in ref_leaves(rtree):
                sub = ()
                if path[-1] in ("q", "scale"):
                    path, sub = path[:-1], (path[-1],)
                for name, idx in carry.port_names(pcfg, path):
                    got = ptree[name]
                    for k in sub:
                        got = got[k]
                    want = spec(s)[1:] if idx else spec(s)
                    assert spec(got) == want, (where, name, sub, got, s)
                    n += 1
        assert n == sum(len(port_leaves(port[k]))
                        for k in ("opt", "ebuf")) - 1  # step


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs_equal(arch):
    """Batch over dp where divisible (32 is; 4 is not), the sequence (or
    an inner dim) over "model" where divisible (32,768 is; 100 is not)."""
    rcfg, pcfg = ref_config(arch), get_config(arch)
    for B, s_max in ((32, 32768), (4, 100)):
        r_cache = rtf.init_cache(rcfg, B, s_max, abstract=True)
        p_cache = tf.init_cache(pcfg, B, s_max, abstract=True)
        for kind in MESHES:
            mesh = stand_in(kind)
            ref = ref_leaves(rsh.cache_specs(rcfg, mesh, r_cache))
            port = dict(port_leaves(psh.cache_specs(pcfg, mesh, p_cache)))
            assert len(ref) == len(port)
            for path, s in ref:
                assert spec(port[path]) == spec(s), (path, port[path], s)


@pytest.mark.parametrize("arch", ARCHS)
def test_batch_specs_equal(arch):
    rcfg, pcfg = ref_config(arch), get_config(arch)
    for B in (256, 24):
        if pcfg.embed_inputs:
            shapes = {"embeds": (B, 64, pcfg.d_model), "labels": (B, 64)}
        else:
            shapes = {"tokens": (B, 64), "labels": (B, 64)}
        rb = {k: jax.ShapeDtypeStruct(s, "float32")
              for k, s in shapes.items()}
        pb = {k: torch.empty(s, device="meta") for k, s in shapes.items()}
        for kind in MESHES:
            mesh = stand_in(kind)
            ref = rsh.batch_specs(rcfg, mesh, rb)
            port = psh.batch_specs(pcfg, mesh, pb)
            assert {k: spec(v) for k, v in port.items()} == {
                k: spec(v) for k, v in ref.items()}


def test_to_placements():
    from torch.distributed.tensor import Replicate, Shard

    m2 = abstract_mesh((2, 2), ("data", "model"))
    assert psh.to_placements(m2, psh.P("data", "model")) == [Shard(0),
                                                              Shard(1)]
    assert psh.to_placements(m2, psh.P(None, "data")) == [Shard(1),
                                                           Replicate()]
    assert psh.to_placements(m2, psh.P()) == [Replicate(), Replicate()]
    m3 = abstract_mesh((2, 2, 2), ("pod", "data", "model"))
    assert psh.to_placements(m3, psh.P(("pod", "data"), "model")) == [
        Shard(0), Shard(0), Shard(1)]
    assert psh.to_placements(m3, psh.P("model", None, "pod")) == [
        Shard(2), Replicate(), Shard(0)]


def test_spec_writes_one_axis_as_its_name():
    assert psh.P(("data",), None) == ("data", None)
    assert spec(JP(("data",), None)) == spec(psh.P(("data",), None))
    assert psh.P(("pod", "data")) == (("pod", "data"),)


def test_named_sharding_places_by_its_spec():
    m2 = abstract_mesh((2, 2), ("data", "model"))
    sh = psh.NamedSharding(m2, psh.P(None, "model"))
    assert [str(p) for p in sh.placements] == ["R", "S(1)"]
