"""The port's ``train_step_bundle`` (forward, backward, clip, AdamW; with
gradient accumulation over ``cfg.microbatches`` slices) against the JAX
package's jitted ``bundle.fn``, on the CPU at reduced sizes in f32
compute: two steps from the same numpy parameters on the same numpy
batches, at A = 1 (qwen3) and A = 2 (qwen2-moe, whose capacity then
counts a slice's tokens, and falcon-mamba).

Bars: the same metric keys; loss, ce, aux, lr and grad_norm within rtol
1e-5; each moment leaf within 1e-4 of its own max |.| (the moments are
sums of gradients); each parameter within 2 * sum(lr_t) of JAX's (Adam's
step is about lr an element whatever the gradient's size, so an element
whose gradient is near zero may step either way), and 99.9 % of all the
elements within 1e-5 of their leaf's max |.|.  ``bundle_for`` gives a
train step for ``train_4k``.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from _torch_train_common import (B, leaves_close, mesh, numpy_params,
                                 port_model, run_f32, torch_batch,
                                 train_batch)
from repro.configs.base import ShapeSpec as JShapeSpec
from repro.configs.base import get_config as jget_config
from repro.launch.steps import train_step_bundle as jtrain_step_bundle
from repro.optim import adamw as jadamw
from repro_torch import interop
from repro_torch.configs.base import ShapeSpec, get_config
from repro_torch.launch.steps import bundle_for, train_step_bundle
from repro_torch.optim import adamw

torch.set_num_threads(2)
jax.config.update("jax_platform_name", "cpu")

S = 32
KNOBS = dict(lr=1e-3, warmup_steps=1, total_steps=10)
CASES = {"qwen3-A1": ("qwen3-1.7b", 1, B),
         "qwen2-moe-A2": ("qwen2-moe-a2.7b", 2, 2 * B),
         "falcon-mamba-A2": ("falcon-mamba-7b", 2, 2 * B)}


def param_bar(got, want, lrs):
    """Each leaf within 2 * sum(lr_t), and 99.9 % of all the elements
    within 1e-5 of their leaf's max |.|."""
    bound = 2 * sum(lrs)
    near, total = [0], [0]

    def one(path, g, w):
        d = np.abs(np.asarray(g, np.float32) - np.asarray(w, np.float32))
        name = jax.tree_util.keystr(path)
        assert float(d.max()) <= bound, (name, float(d.max()), bound)
        near[0] += int((d <= 1e-5 * np.abs(w).max()).sum())
        total[0] += d.size
    jax.tree_util.tree_map_with_path(one, got, want)
    assert near[0] >= 0.999 * total[0], (near[0], total[0])


@pytest.mark.parametrize("case", list(CASES))
def test_train_step_matches_jax(case):
    arch, A, batch_size = CASES[case]
    jcfg = dataclasses.replace(jget_config(arch).reduced(), microbatches=A)
    cfg = dataclasses.replace(get_config(arch).reduced(), microbatches=A)
    jshape = JShapeSpec("t", S, batch_size, "train")
    shape = ShapeSpec("t", S, batch_size, "train")
    params = numpy_params(jcfg, 0)
    batches = []
    for seed in (1, 2):
        one, two = train_batch(jcfg, S, seed), train_batch(jcfg, S, seed + 10)
        batches.append({k: np.concatenate([one[k], two[k]])[:batch_size]
                        for k in one})

    jb = jtrain_step_bundle(jcfg, jshape, mesh(), jadamw.AdamWConfig(**KNOBS))
    jfn = jax.jit(jb.fn)
    jp, jopt = params, jadamw.init(params)
    jmetrics = []
    for b in batches:
        jp, jopt, jm = run_f32(jfn, jp, jopt, b)
        jmetrics.append(jm)

    bundle = train_step_bundle(cfg, shape, opt_cfg=adamw.AdamWConfig(**KNOBS))
    assert bundle.policy.global_batch == batch_size // A
    model = port_model(cfg, params)
    opt = adamw.init(dict(model.params.named_parameters()))
    lrs = []
    for b, jm in zip(batches, jmetrics):
        model, opt, m = bundle.fn(model, opt, torch_batch(b))
        assert set(m) == set(jm) == {"ce", "aux", "loss", "lr", "grad_norm"}
        for k in jm:
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5,
                                       atol=1e-8, err_msg=k)
        lrs.append(float(m["lr"]))
    assert int(opt.step) == int(jopt.step) == 2
    assert all(p.grad is None for p in model.parameters())
    want = interop.adamw_state(jopt, model)
    for got, ref in ((opt.m, want.m), (opt.v, want.v)):
        leaves_close({n: t.numpy() for n, t in got.items()},
                     {n: t.numpy() for n, t in ref.items()}, what="moment")
    param_bar(interop.lm_tree(model), jp, lrs)


def test_bundle_for_gives_a_train_step():
    cfg = get_config("qwen3-1.7b").reduced()
    b = bundle_for(cfg, "train_4k")
    assert set(b.input_specs) == {"tokens", "labels"}
    assert b.input_specs["tokens"].shape == (256, 4096)
    assert b.policy.kind == "train"


def test_batch_must_split_into_the_micro_batches():
    cfg = dataclasses.replace(get_config("qwen3-1.7b").reduced(),
                              microbatches=2)
    bundle = train_step_bundle(cfg, ShapeSpec("t", 8, 4, "train"))
    model = port_model(cfg, numpy_params(jget_config("qwen3-1.7b").reduced(),
                                         0))
    opt = adamw.init(dict(model.params.named_parameters()))
    batch = {"tokens": torch.zeros((3, 8), dtype=torch.int32),
             "labels": torch.zeros((3, 8), dtype=torch.int32)}
    with pytest.raises(ValueError, match="micro-batches"):
        bundle.fn(model, opt, batch)
