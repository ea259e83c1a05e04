"""The port's training loss (``Model.loss``: the train-mode forward with
remat per group, the CE over f32 logits, chunked or in one pass, the
router aux loss) and its gradients against ``jax.value_and_grad`` of the
JAX package's ``model.loss``, on the CPU at reduced sizes (d_model 128,
vocab 512) in f32 compute.

Cases cover the dense (qwen3: tied, qk_norm), vlm, audio, moe, ssm and
hybrid families; the chunked CE (``loss_chunk=16`` at S = 32: two chunks)
and the single pass; ``ce_onehot`` on and off; a ``loss_mask``.  Bars:
the loss within rtol 1e-5 (ce and aux too); each gradient leaf, read
through ``interop.lm_tree(grads=True)`` in the JAX tree, within 1e-4 of
the JAX leaf's own max |g|.  The port's gradients with remat off equal
those with remat on, and a recompute routes every MoE token as the
forward pass did.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from _torch_train_common import (jax_grad_fn, leaves_close, numpy_params,
                                 port_model, run_f32, torch_batch,
                                 train_batch)
from repro.configs.base import get_config as jget_config
from repro_torch import interop
from repro_torch.configs.base import get_config
from repro_torch.models import moe as TM

torch.set_num_threads(2)
jax.config.update("jax_platform_name", "cpu")

#: (arch, positions with a label, config changes, loss_mask)
CASES = {
    "qwen3-chunked-mask": ("qwen3-1.7b", 32, dict(loss_chunk=16), True),
    "internvl2-chunked-onehot": ("internvl2-26b", 32,
                                 dict(loss_chunk=16, ce_onehot=True), False),
    "hubert-onehot-mask": ("hubert-xlarge", 32, dict(ce_onehot=True), True),
    "qwen2-moe-chunked": ("qwen2-moe-a2.7b", 32, dict(loss_chunk=16), False),
    "falcon-mamba-pad": ("falcon-mamba-7b", 40, {}, False),
    "zamba2-chunked": ("zamba2-2.7b", 32, dict(loss_chunk=16), False),
}


def _cfgs(arch, changes):
    return (dataclasses.replace(jget_config(arch).reduced(), **changes),
            dataclasses.replace(get_config(arch).reduced(), **changes))


@pytest.fixture(scope="module")
def jax_loss():
    """JAX's (params, batch, ((loss, metrics), grads)) by case, each
    computed once."""
    cache = {}

    def get(case):
        if case not in cache:
            arch, S, changes, mask = CASES[case]
            jcfg, _ = _cfgs(arch, changes)
            params = numpy_params(jcfg, 0)
            batch = train_batch(jcfg, S, 1, mask)
            cache[case] = (params, batch,
                           run_f32(jax_grad_fn(jcfg), params, batch))
        return cache[case]
    return get


def _port_grads(cfg, params, batch, remat=True):
    cfg = dataclasses.replace(cfg, remat=remat)
    model = port_model(cfg, params)
    loss, metrics = model.loss(torch_batch(batch))
    loss.backward()
    return loss, metrics, interop.lm_tree(model, grads=True)


@pytest.mark.parametrize("case", list(CASES))
def test_loss_and_grads_match_jax(case, jax_loss):
    arch, S, changes, _ = CASES[case]
    _, cfg = _cfgs(arch, changes)
    params, batch, ((jloss, jmetrics), jgrads) = jax_loss(case)
    loss, metrics, grads = _port_grads(cfg, params, batch)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    for k in ("ce", "aux"):
        np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]),
                                   rtol=1e-5, atol=1e-7)
    if cfg.family == "moe":
        assert float(metrics["aux"]) > 0
    worst = leaves_close(grads, jgrads)
    print(f"{case}: loss {float(loss):.6f} (JAX {float(jloss):.6f}); worst "
          f"gradient leaf {worst:.2e} of its max |g|")


@pytest.mark.parametrize("case", ["qwen3-chunked-mask", "qwen2-moe-chunked",
                                  "zamba2-chunked"])
def test_remat_off_gives_the_same_gradients(case, jax_loss):
    arch, _, changes, _ = CASES[case]
    _, cfg = _cfgs(arch, changes)
    params, batch, _ = jax_loss(case)
    on = _port_grads(cfg, params, batch, remat=True)
    off = _port_grads(cfg, params, batch, remat=False)
    assert float(on[0]) == float(off[0])
    leaves_close(on[2], off[2], rel=1e-6)


def test_recompute_routes_as_the_forward():
    """Under remat, backward recomputes each MoE group: every recompute's
    expert ids equal its forward pass's (the groups come back in reverse
    order)."""
    _, cfg = _cfgs("qwen2-moe-a2.7b", {})
    params = numpy_params(jget_config("qwen2-moe-a2.7b").reduced(), 0)
    batch = torch_batch(train_batch(cfg, 32, 1))
    model = port_model(cfg, params)
    route, seen = TM._route, []

    def recorded(logits, cfg):
        gate, idx, aux = route(logits, cfg)
        seen.append(idx.clone())
        return gate, idx, aux
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TM, "_route", recorded)
        loss, _ = model.loss(batch)
        n = len(seen)
        loss.backward()
    assert n == cfg.n_layers and len(seen) == 2 * n
    for first, again in zip(seen[:n], reversed(seen[n:])):
        assert torch.equal(first, again)


def test_padded_vocab_columns_take_no_gradient():
    """A vocabulary that is not a multiple of 16 pads the head; the pad
    logits stay at -1e30, take no probability and give the pad rows of the
    tied table no gradient."""
    _, cfg = _cfgs("qwen3-1.7b", dict(vocab_size=500))
    params = numpy_params(dataclasses.replace(
        jget_config("qwen3-1.7b").reduced(), vocab_size=500), 0)
    model = port_model(cfg, params)
    loss, _ = model.loss(torch_batch(train_batch(cfg, 32, 1)))
    loss.backward()
    g = model.params.embed["table"].grad
    assert cfg.padded_vocab == 512
    assert float(g[cfg.vocab_size:].abs().max()) == 0.0
    assert float(g[:cfg.vocab_size].abs().max()) > 0
