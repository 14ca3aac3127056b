"""Whole models of the port (``repro_torch.models``) against the reference
(``repro.models``) for each of the ten architectures, with the reference's
weights carried across (``repro_torch.models.carry``): the parameter tree,
``forward_train`` logits and MoE aux, ``loss_fn`` and its metrics, and the
gradients (``jax.value_and_grad`` against ``backward()``), float32 on the
CPU (``torch_lm`` tolerances)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import models as rm
from repro.configs import ARCHS
from repro_torch import models as pm
from repro_torch.models import carry
from torch_lm import GRAD_RTOL, batch, carried, close, configs, grad_errors

B, S = 2, 16


@pytest.mark.parametrize("arch", ARCHS)
def test_parameter_tree_is_the_references(arch):
    rcfg, pcfg = configs(arch)
    want = {}
    for path, sds in carry.flatten_tree(rm.abstract_params(rcfg)):
        for name, idx in carry.port_names(pcfg, path):
            want[name] = (tuple(sds.shape[len(idx):]),
                          np.dtype(sds.dtype).name)
    got = {n: (tuple(p.shape), str(p.dtype).removeprefix("torch."))
           for n, p in pm.init_params(pcfg, device="cpu").named_parameters()}
    assert got == want


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_loss_and_grads_match_the_reference(arch):
    rcfg, pcfg = configs(arch)
    params, model = carried(rcfg, pcfg, seed=0)
    inp = batch(rcfg, 1, B, S)
    jb = {k: jnp.asarray(v) for k, v in inp.items()}
    tb = {k: torch.from_numpy(v) for k, v in inp.items()}

    r_logits, r_aux = rm.forward_train(params, rcfg, jb)
    logits, aux = pm.forward_train(model, pcfg, tb)
    assert logits.dtype == torch.float32
    close(logits, r_logits)
    close(aux, r_aux)

    def ref_loss(p):
        return rm.loss_fn(p, rcfg, jb, zloss=1e-3)

    (r_loss, r_met), r_grads = jax.value_and_grad(ref_loss, has_aux=True)(
        params)
    loss, met = pm.loss_fn(model, pcfg, tb, zloss=1e-3)
    loss.backward()
    close(loss, r_loss)
    for k in ("ce", "aux", "loss"):
        close(met[k], r_met[k])
    errs = grad_errors(pcfg, model, r_grads)
    assert set(errs) == {n for n, _ in model.named_parameters()}
    bad = {n: e for n, e in errs.items() if not e <= GRAD_RTOL}
    assert not bad, bad


@pytest.mark.parametrize("arch", ["llama3-8b", "jamba-v0.1-52b",
                                  "xlstm-125m"])
def test_remat_and_unscanned_layers_change_no_value(arch):
    """``cfg.remat`` recomputes in the backward and ``scan_layers=False``
    lists the units: the loss and every gradient are the same bits."""
    _, pcfg = configs(arch)
    inp = {k: torch.from_numpy(v) for k, v in batch(pcfg, 2, B, S).items()}
    out = []
    for replace in ({}, dict(remat=False), dict(scan_layers=False)):
        cfg = dataclasses.replace(pcfg, **replace)
        model = pm.init_params(cfg, device="cpu",
                               generator=torch.Generator().manual_seed(5))
        loss, _ = pm.loss_fn(model, cfg, inp)
        loss.backward()
        out.append((loss.detach(), [p.grad for p in model.parameters()]))
    for loss, grads in out[1:]:
        assert torch.equal(loss, out[0][0])
        assert all(torch.equal(a, b) for a, b in zip(grads, out[0][1]))


def test_loss_at_init_is_near_log_vocab():
    for arch in ARCHS:
        _, pcfg = configs(arch)
        inp = {k: torch.from_numpy(v) for k, v in
               batch(pcfg, 3, B, S).items()}
        model = pm.init_params(pcfg, device="cpu")
        with torch.no_grad():
            loss, _ = pm.loss_fn(model, pcfg, inp)
        assert torch.isfinite(loss)
        assert float(loss) < 3 * np.log(pcfg.vocab_size) + 5, arch
