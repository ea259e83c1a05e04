"""The rank side of the port's LM training-on-a-mesh tests
(``test_torch_lm_train_mesh.py``).

``spawn(world, cases)`` (``_torch_mesh_ranks.spawn`` with this module as
the rank side) starts ``world`` gloo ranks that run every case on a
(data, model) mesh; a case is a plain dict, so the ranks import only
torch, numpy and repro_torch, never JAX.  Kinds: ``step`` (``run_step``:
train steps from given parameters and batches), ``resume`` (``run_resume``:
the Trainer saved, resumed and re-meshed), ``curate`` (``run_curate``:
the Trainer with curation, and the curated rows of every rank) and
``serve`` (``_torch_lm_ranks.run_lm``: a prefill and decode steps), so one
spawn serves and trains.
"""

from __future__ import annotations

import dataclasses
import os
import pickle
import shutil
import sys

import numpy as np
import torch
import torch.distributed as dist

import _torch_lm_ranks
import _torch_mesh_ranks as mesh_ranks
from repro_torch import interop
from repro_torch.configs.base import ShapeSpec, get_config
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.data.selection import SelectionPipeline
from repro_torch.launch.mesh import make_mesh_for
from repro_torch.launch.steps import train_step_bundle
from repro_torch.models import collectives as C
from repro_torch.models.model import build_model
from repro_torch.optim import adamw
from repro_torch.runtime.trainer import TrainConfig, Trainer, elastic_remesh


def spawn(world: int, cases, timeout: float = 240.0):
    return mesh_ranks.spawn(world, cases, timeout,
                            module="_torch_train_ranks")


def _mesh(meshes, shape):
    if shape not in meshes:
        meshes[shape] = make_mesh_for(int(np.prod(shape)),
                                      model_parallel=shape[1])
    return meshes[shape]


def f32(trainer):
    """``trainer`` with its state drawn as ``init_state`` draws it but in
    f32 (the fresh state, and the template a restore fills)."""
    def init_state():
        gen = torch.Generator(device=trainer.device).manual_seed(
            trainer.train_cfg.seed)
        model = build_model(trainer.cfg, gen, trainer.device, torch.float32,
                            policy=trainer.policy)
        model.requires_grad_(True)
        return model, adamw.init(dict(model.params.named_parameters())), 0
    trainer.init_state = init_state
    return trainer


def config(case):
    return dataclasses.replace(get_config(case["arch"]).reduced(),
                               **case["cfg"])


def blocks(named):
    return {n: t.detach().numpy().copy() for n, t in named.items()}


def run_step(case, meshes):
    """Train steps on a mesh in f32 compute: ``params`` (the JAX-structured
    numpy tree), one step a global batch of ``batches``, AdamW ``opt``
    knobs.  Returns each step's metrics, gradient blocks (as the update
    takes them) and collectives (kind, axes) -> (calls, bytes), and this
    rank's parameter and moment blocks after the last step with their
    specs."""
    mesh = _mesh(meshes, case["mesh"])
    cfg = config(case)
    B, S = case["batches"][0]["tokens"].shape
    bundle = train_step_bundle(cfg, ShapeSpec("t", S, B, "train"), mesh,
                               adamw.AdamWConfig(**case["opt"]))
    model = interop.lm_params(case["params"], cfg, "cpu", torch.float32,
                              policy=bundle.policy)
    opt = adamw.init(dict(model.params.named_parameters()))
    grads, saved = [], adamw.update

    def update(c, params, g, state, **kw):
        grads.append(blocks(g))
        return saved(c, params, g, state, **kw)

    metrics, counts = [], []
    adamw.update = update
    try:
        for b in case["batches"]:
            C.reset_counts()
            model, opt, m = bundle.fn(model, opt, {
                k: torch.from_numpy(v) for k, v in b.items()})
            counts.append(C.counts())
            metrics.append({k: float(v) for k, v in m.items()})
    finally:
        adamw.update = saved
    named = dict(model.params.named_parameters())
    return dict(metrics=metrics, grads=grads, counts=counts,
                params=blocks(named), m=blocks(opt.m), v=blocks(opt.v),
                specs={n: p.spec for n, p in named.items()},
                coords=dict(mesh.coords),
                batch_axes=bundle.policy.batch_axes,
                seq_shard=bundle.policy.seq_shard)


def run_resume(case, meshes):
    """The Trainer on ``mesh`` in f32: one step saved to ``dir/a``; two
    straight steps; the second step resumed from ``dir/a`` on the same
    mesh, from a copy ``dir/b`` re-meshed to ``remesh`` by
    ``elastic_remesh``, and from a copy ``dir/e`` that only rank 0 sees
    (the other ranks' directories are empty); rank 0 also leaves a copy
    ``dir/c``.  Returns each run's step losses and final parameter blocks,
    with their specs."""
    mesh = _mesh(meshes, case["mesh"])
    cfg = config(case)
    d = case["dir"]
    shape = ShapeSpec("t", case["seq"], case["batch"], "train")
    data = DataConfig(global_batch=case["batch"], seq_len=case["seq"])

    def trainer(steps, where, on):
        return f32(Trainer(cfg, shape, on, data=data,
                           train=TrainConfig(
                               steps=steps, ckpt_async=False, log_every=100,
                               ckpt_dir=None if where is None else
                               os.path.join(d, where)),
                           opt=adamw.AdamWConfig(**case["opt"]),
                           device="cpu"))

    def result(t, model):
        named = dict(model.params.named_parameters())
        return dict(losses=[r.loss for r in t.history],
                    steps=[r.step for r in t.history],
                    params=blocks(named),
                    specs={n: p.spec for n, p in named.items()},
                    shape=dict(t.mesh.shape))

    trainer(1, "a", mesh).run()
    if mesh.rank == 0:
        for copy in ("b", "c", "e"):
            shutil.copytree(os.path.join(d, "a"), os.path.join(d, copy))
    dist.barrier()
    out = {}
    t = trainer(2, None, mesh)
    out["straight"] = result(t, t.run()[0])
    t = trainer(2, "a", mesh)
    out["resumed"] = result(t, t.run()[0])
    t = f32(elastic_remesh(trainer(2, "b", mesh),
                           _mesh(meshes, case["remesh"])))
    out["remeshed"] = result(t, t.run()[0])
    where = "e" if mesh.rank == 0 else f"empty{mesh.rank}"
    os.makedirs(os.path.join(d, where), exist_ok=True)
    t = trainer(2, where, mesh)
    out["rank0_only"] = result(t, t.run()[0])
    return out


def run_curate(case, meshes):
    """The Trainer of ``launch/train.py --select`` on ``mesh`` (bf16,
    ``steps`` steps of ``batch`` x ``seq``, curated every 2); returns its
    losses and the curated batch of ``SelectionPipeline.batch_at(0)`` at
    twice the batch on the same mesh (its ids and tokens)."""
    mesh = _mesh(meshes, case["mesh"])
    cfg = get_config("qwen3-1.7b").reduced()
    B, S = case["batch"], case["seq"]
    t = Trainer(cfg, ShapeSpec("t", S, B, "train"), mesh,
                data=DataConfig(global_batch=B, seq_len=S, select_every=2),
                train=TrainConfig(steps=case["steps"], log_every=100),
                select=True, device="cpu")
    t.run()
    data = DataConfig(global_batch=2 * B, seq_len=S, select_every=2)
    bundle = train_step_bundle(cfg, ShapeSpec("t", S, 2 * B, "train"), mesh)
    pipe = SelectionPipeline(SyntheticLM(cfg, data, "cpu"), bundle.policy)
    batch = pipe.batch_at(0)
    return dict(losses=[r.loss for r in t.history],
                ids=pipe._last_sel.sol_ids.numpy(),
                tokens=batch["tokens"].numpy())


KINDS = {"step": run_step, "resume": run_resume, "curate": run_curate,
         "serve": _torch_lm_ranks.run_lm}


def main(argv) -> None:
    rank, world, store, cases, out = argv
    torch.set_num_threads(1)
    mesh_ranks._init(int(rank), int(world), store)
    with open(cases, "rb") as f:
        cases = pickle.load(f)
    meshes = {}
    results = [KINDS[c.get("kind", "step")](c, meshes) for c in cases]
    dist.destroy_process_group()
    with open(out, "wb") as f:
        pickle.dump(results, f)


if __name__ == "__main__":
    main(sys.argv[1:])
