"""The port's training loop (``runtime/trainer.py``), its data
(``data/pipeline.py``, ``data/selection.py``) and the CLI
(``launch/train.py``), on the CPU at the reduced qwen3 size.

The JAX package's ``tests/test_runtime.py`` properties hold for the port:
resume from a checkpoint is exact (bit for bit here), a preempted run
saves at the end, the straggler flag, ``elastic_remesh`` resumes, and the
selection pipeline runs in training.  Against the JAX package: a port
trainer and a JAX trainer fed the same numpy batches from the same numpy
parameters for 3 steps in f32 compute (losses within rtol 1e-4, every
parameter within 2 * sum(lr_t): Adam's step is about lr an element, so an
element whose gradient is near zero may step either way);
``doc_embeddings`` equal to JAX's on tokens near 2^32 (the uint32 hash
wraps); ``SelectionPipeline`` gives JAX's curated batch on the same pool
with the sample round's uniforms drawn from JAX's keys.
"""

import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_train_common import (mesh, numpy_params, run_f32, torch_batch,
                                 train_batch)
from repro.configs.base import ShapeSpec as JShapeSpec
from repro.configs.base import get_config as jget_config
from repro.data import pipeline as jpipeline
from repro.data.selection import SelectionPipeline as JSelectionPipeline
from repro.models.sharding import make_policy as jmake_policy
from repro.optim import adamw as jadamw
from repro.runtime.trainer import TrainConfig as JTrainConfig
from repro.runtime.trainer import Trainer as JTrainer
from repro_torch import interop
from repro_torch.configs.base import ShapeSpec, get_config
from repro_torch.data.pipeline import DataConfig, SyntheticLM, doc_embeddings
from repro_torch.data.selection import SelectionPipeline
from repro_torch.launch import train as train_cli
from repro_torch.models.sharding import make_policy
from repro_torch.optim import adamw
from repro_torch.runtime.trainer import (StepRecord, TrainConfig, Trainer,
                                         elastic_remesh)
from test_torch_mapreduce import jax_mesh_uniforms

torch.set_num_threads(2)
jax.config.update("jax_platform_name", "cpu")

CFG = get_config("qwen3-1.7b").reduced()
SHAPE = ShapeSpec("t", 64, 4, "train")


def _trainer(tmp, steps=4, **kw):
    return Trainer(CFG, SHAPE, data=DataConfig(global_batch=4, seq_len=64),
                   train=TrainConfig(steps=steps, ckpt_dir=tmp, ckpt_every=2,
                                     log_every=100),
                   opt=adamw.AdamWConfig(lr=1e-3, warmup_steps=2),
                   device="cpu", **kw)


def test_checkpoint_resume_exact():
    """4 steps straight vs 2 + checkpoint + 2 resumed: the same bits (the
    checkpoint carries the parameters, the opt state and the cursor)."""
    with tempfile.TemporaryDirectory() as tmp1, \
            tempfile.TemporaryDirectory() as tmp2:
        m_full, o_full = _trainer(tmp1, steps=4).run()
        _trainer(tmp2, steps=2).run()
        t_b = _trainer(tmp2, steps=4)
        m_res, o_res = t_b.run()
        assert t_b.history[0].step == 2  # resumed, not restarted
        for (n, a), (_, b) in zip(m_full.params.named_parameters(),
                                  m_res.params.named_parameters()):
            assert torch.equal(a, b), n
        assert int(o_full.step) == int(o_res.step) == 4
        for n in o_full.m:
            assert torch.equal(o_full.m[n], o_res.m[n])
            assert torch.equal(o_full.v[n], o_res.v[n])


def test_straggler_detection():
    recs = []
    with tempfile.TemporaryDirectory() as tmp:
        t = _trainer(tmp, steps=3)
        t.run(on_step=recs.append)
    assert len(recs) == 3
    assert all(isinstance(r, StepRecord) for r in recs)
    assert [r.step for r in recs] == [0, 1, 2]
    # a step past factor x the EWMA is a straggler
    t._ewma = 0.01
    assert 10.0 > t.train_cfg.straggler_factor * t._ewma


def test_preemption_stop_and_final_save():
    with tempfile.TemporaryDirectory() as tmp:
        t = _trainer(tmp, steps=100)
        calls = {"n": 0}

        def stop():
            calls["n"] += 1
            return calls["n"] > 3
        t.run(should_stop=stop)
        assert len(t.history) == 3
        # the final blocking save holds the cursor of the first step not
        # taken, so the resumed run takes step 3 (the JAX package's saves
        # step 4 here and would skip it)
        assert t.ckpt.latest_step() == 3
        t2 = _trainer(tmp, steps=4)
        t2.run()
        assert [r.step for r in t2.history] == [3]


def test_elastic_remesh_resumes():
    with tempfile.TemporaryDirectory() as tmp:
        t = _trainer(tmp, steps=2)
        t.run()
        t2 = elastic_remesh(t, None)
        assert t2.device == t.device and t2.ckpt.dir == tmp
        t2.run()  # restores the step-2 checkpoint; 2 steps: nothing to do
        assert t2.history == [] and t2.ckpt.latest_step() >= 2


def test_selection_pipeline_in_training():
    with tempfile.TemporaryDirectory() as tmp:
        t = Trainer(CFG, SHAPE,
                    data=DataConfig(global_batch=4, seq_len=64,
                                    select_every=2),
                    train=TrainConfig(steps=3, ckpt_dir=tmp, ckpt_every=10,
                                      log_every=100),
                    opt=adamw.AdamWConfig(lr=1e-3, warmup_steps=2),
                    select=True, device="cpu")
        t.run()
        assert len(t.history) == 3
        assert all(np.isfinite(r.loss) for r in t.history)
        sel = t.pipeline._last_sel
        assert sel is not None and int(sel.sol_size) > 0


def _carried(params):
    """The port trainer's initial state holding the numpy parameters."""
    model = interop.lm_params(params, CFG, dtype=torch.float32)
    model.requires_grad_(True)
    return model, adamw.init(dict(model.params.named_parameters())), 0


def test_trainer_matches_jax_trainer():
    """The same numpy parameters and batches through both trainers for 3
    steps, f32 compute: losses within rtol 1e-4, parameters within
    2 * sum(lr_t)."""
    jcfg = jget_config("qwen3-1.7b").reduced()
    knobs = dict(lr=1e-3, warmup_steps=2)
    params = numpy_params(jcfg, 0)
    batches = [train_batch(jcfg, 64, 20 + s) for s in range(3)]
    batches = [{k: np.concatenate([b[k], b[k][::-1]]) for k in b}
               for b in batches]                     # 4 rows
    jt = JTrainer(jcfg, JShapeSpec("t", 64, 4, "train"), mesh(),
                  train=JTrainConfig(steps=3, log_every=100),
                  opt=jadamw.AdamWConfig(**knobs))
    t = Trainer(CFG, SHAPE, train=TrainConfig(steps=3, log_every=100),
                opt=adamw.AdamWConfig(**knobs), device="cpu")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jt, "init_state",
                   lambda: (jax.tree.map(jnp.asarray, params),
                            jadamw.init(params), 0))
        mp.setattr(jt.pipeline, "batch_at",
                   lambda s: {k: jnp.asarray(v) for k, v in batches[s].items()})
        mp.setattr(t, "init_state", lambda: _carried(params))
        mp.setattr(t.pipeline, "batch_at", lambda s: torch_batch(batches[s]))
        jfinal, _ = run_f32(jt.run)
        model, opt = t.run()
    jl = [r.loss for r in jt.history]
    tl = [r.loss for r in t.history]
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    lrs = [float(adamw.schedule(adamw.AdamWConfig(**knobs),
                                torch.tensor(s + 1))) for s in range(3)]
    bound = 2 * sum(lrs)
    got = interop.lm_tree(model)
    worst = jax.tree.map(lambda g, w: float(np.abs(g - np.asarray(w)).max()),
                         got, jfinal)
    assert max(jax.tree.leaves(worst)) <= bound, (worst, bound)
    assert int(opt.step) == 3


def test_doc_embeddings_match_jax_near_2_32():
    """Tokens whose uint32 value lies near 2^32 (negative int32) and near
    2^31: the hash wraps as JAX's uint32 product does."""
    toks = np.array([[-1, -2, -3, -7, -2**31, 2**31 - 1, 0, 1],
                     [-123456789, 2**31 - 5, 151935, 65023, -1, 7, -8, 3]],
                    np.int32)
    for dim in (64, 7, 256):
        want = np.asarray(jpipeline.doc_embeddings(
            {"tokens": jnp.asarray(toks)}, dim))
        got = doc_embeddings({"tokens": torch.from_numpy(toks)}, dim)
        np.testing.assert_array_equal(got.numpy(), want)
    frames = np.random.default_rng(0).normal(size=(3, 5, 80)).astype(
        np.float32)
    want = np.asarray(jpipeline.doc_embeddings(
        {"frames": jnp.asarray(frames, jnp.bfloat16)}, 64))
    got = doc_embeddings({"frames": interop.tensor(
        np.asarray(jnp.asarray(frames, jnp.bfloat16)))}, 64)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "internvl2-26b",
                                  "hubert-xlarge", "falcon-mamba-7b"])
def test_synthetic_lm_is_a_pure_function_of_seed_and_step(arch):
    cfg, jcfg = get_config(arch).reduced(), jget_config(arch).reduced()
    data = DataConfig(seed=3, global_batch=4, seq_len=48)
    a, b = SyntheticLM(cfg, data, "cpu"), SyntheticLM(cfg, data, "cpu")
    want = jax.eval_shape(jpipeline.SyntheticLM(jcfg, jpipeline.DataConfig(
        seed=3, global_batch=4, seq_len=48)).batch_at, 5)
    x5 = a.batch_at(5)
    a.batch_at(6)
    assert set(x5) == set(want)
    for k, v in x5.items():
        assert tuple(v.shape) == want[k].shape, k
        assert str(v.dtype).replace("torch.", "") == want[k].dtype.name, k
        assert torch.equal(v, b.batch_at(5)[k]), k          # same (seed, step)
        assert torch.equal(v, a.batch_at(5)[k]), k          # any call order
        assert not torch.equal(v, a.batch_at(6)[k]), k      # another step
    for k in ("tokens", "labels"):
        if k in x5:
            assert int(x5[k].min()) >= 0 and int(x5[k].max()) < cfg.vocab_size
    other = SyntheticLM(cfg, DataConfig(seed=4, global_batch=4, seq_len=48),
                        "cpu").batch_at(5)
    assert not torch.equal(next(iter(other.values())),
                           next(iter(x5.values())))


def test_selection_pipeline_matches_jax():
    """One curated batch from the same 4 x 4 pool in both packages: the JAX
    pipeline's two_round on its (1, 1) mesh, the port's on one simulated
    machine with the JAX sample round's uniforms; the same documents in the
    same order."""
    jcfg = jget_config("qwen3-1.7b").reduced()
    data = dict(seed=0, global_batch=4, seq_len=64, select_every=2)
    rng = np.random.default_rng(7)
    pools = {}

    def pool(step):
        if step not in pools:
            # documents of a few hot tokens each, so coverage differs
            hot = rng.integers(0, CFG.vocab_size, (4, 6))
            pick = rng.integers(0, 6, (4, 65))
            toks = np.take_along_axis(hot, pick, 1).astype(np.int32)
            pools[step] = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        return pools[step]

    jbase = jpipeline.SyntheticLM(jcfg, jpipeline.DataConfig(**data))
    jpipe = JSelectionPipeline(jbase, jmake_policy(mesh(), 4, "train"))
    base = SyntheticLM(CFG, DataConfig(**data), "cpu")
    pipe = SelectionPipeline(base, make_policy(None, 4, "train"))
    step = 4
    key = jax.random.fold_in(jax.random.PRNGKey(data["seed"] + 77), step)
    u = jax_mesh_uniforms([key], 1, pipe.pool)
    select = pipe.selector.select
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jbase, "batch_at",
                   lambda s: {k: jnp.asarray(v) for k, v in pool(s).items()})
        mp.setattr(base, "batch_at", lambda s: torch_batch(pool(s)))
        mp.setattr(pipe.selector, "select",
                   lambda emb, opt, generator=None: select(emb, opt,
                                                           uniforms=u))
        want = jpipe.batch_at(step)
        got = pipe.batch_at(step)
    np.testing.assert_array_equal(pipe._last_sel.sol_ids.numpy(),
                                  np.asarray(jpipe._last_sel.sol_ids))
    assert int(pipe._last_sel.sol_size) == 4
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    # an off step is the base stream's batch
    off = SelectionPipeline(base, make_policy(None, 4, "train")).batch_at(3)
    assert torch.equal(off["tokens"], base.batch_at(3)["tokens"])


def test_cli_on_cpu(capsys):
    train_cli.main(["--device", "cpu", "--steps", "2", "--batch", "2",
                    "--seq", "32", "--select", "--select-every", "2"])
    out = capsys.readouterr().out
    assert "[train] step=0 loss=" in out
    assert "[train] done: steps=2 loss " in out
    with pytest.raises(SystemExit):
        train_cli.main(["--device", "cpu", "--model-parallel", "2"])
