"""Production training loop: the step function from launch.steps, data
from the (selection-)pipeline, async checkpointing, fault-tolerance hooks.

The port of the JAX package's ``repro.runtime.trainer``:

* **checkpoint/restart** — state = (params, opt, data cursor); restore is
  resume-exact because the pipeline is cursor-addressable.  The
  ``Checkpointer`` copies every leaf to the host before ``save`` returns,
  so the step's in-place updates cannot tear an async save.
* **straggler mitigation** — a per-step wall-clock EWMA with a deadline
  multiple; a step exceeding it is recorded as a straggler.
* **elastic re-mesh** — ``elastic_remesh`` rebuilds the trainer on a new
  mesh and carries the state through the checkpoint.  The selector state
  needs no migration: the paper's random partition is oblivious to m.
* **preemption signal** — a cooperative ``should_stop`` callable checked per
  step, with a final blocking save at the first step not taken.

The model owns its parameters, so the state the loop carries is (model,
opt state); it runs on the card unless ``device`` asks for the CPU.

On a ``launch.mesh.Mesh`` of several ranks (the dense, moe, ssm and hybrid
families, under ZeRO-3 or TP + FSDP) every rank runs the loop: it draws the same global batch of each
step, holds its blocks of the parameters and moments (placed by the train
policy), and takes part in every save.  The checkpoint is mesh-independent,
as the JAX package's (whose ``save`` writes global arrays): every rank's
block of a leaf is gathered to rank 0, which writes the whole leaf; a
restore has rank 0 read the whole leaves and scatter each rank's block, so
a run saved on one mesh resumes on another or on one rank.  The gathers
and scatters run on the host under gloo and on the card under NCCL.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import torch
import torch.distributed as dist

from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.data.selection import SelectionPipeline
from repro_torch.device import resolve_device
from repro_torch.launch.steps import train_step_bundle
from repro_torch.models.model import build_model
from repro_torch.models.sharding import assemble, block, mesh_ranks
from repro_torch.optim import adamw


@dataclasses.dataclass
class TrainConfig:
    steps: int = 100
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 50
    ckpt_async: bool = True
    log_every: int = 10
    straggler_factor: float = 3.0   # deadline = factor * EWMA(step time)
    seed: int = 0


@dataclasses.dataclass
class StepRecord:
    step: int
    loss: float
    seconds: float
    straggler: bool


class Trainer:
    def __init__(self, cfg: ArchConfig, shape: ShapeSpec, mesh=None,
                 data: DataConfig = None, train: TrainConfig = None,
                 opt: adamw.AdamWConfig = None, select: bool = False,
                 verbose: bool = False, device=None):
        self.cfg, self.shape, self.mesh = cfg, shape, mesh
        self.device = resolve_device(device)
        self.train_cfg = train or TrainConfig()
        self.data_cfg = data or DataConfig(
            global_batch=shape.global_batch, seq_len=shape.seq_len)
        self.opt_cfg = opt or adamw.AdamWConfig()
        self.verbose = verbose

        self.bundle = train_step_bundle(cfg, shape, mesh, self.opt_cfg)
        self.policy = self.bundle.policy
        self._step_fn = self.bundle.fn

        base = SyntheticLM(cfg, self.data_cfg, self.device)
        self.pipeline = SelectionPipeline(base, self.policy) if select \
            else base

        self.ckpt = Checkpointer(self.train_cfg.ckpt_dir) \
            if self.train_cfg.ckpt_dir else None
        self.history: list[StepRecord] = []
        self._ewma: Optional[float] = None

    # ------------------------------------------------------------------
    def init_state(self):
        """(model drawn from the train seed, with gradients on, placed by
        the train policy on a mesh; a fresh opt state; cursor 0)."""
        gen = torch.Generator(device=self.device).manual_seed(
            self.train_cfg.seed)
        model = build_model(self.cfg, gen, self.device, policy=self.policy)
        model.requires_grad_(True)
        opt = adamw.init(dict(model.params.named_parameters()))
        return model, opt, 0

    def _sharded(self) -> bool:
        return mesh_ranks(self.mesh) > 1

    def restore_or_init(self):
        """The latest checkpoint's state, each leaf cut to this rank's
        block, else ``init_state``.  On a mesh rank 0 alone looks for the
        checkpoint (another rank's disk need not hold it), reads the whole
        leaves and scatters every rank's block (a collective call of every
        rank)."""
        latest = self.ckpt.latest_step() if self.ckpt else None
        if self.ckpt and self._sharded():
            latest = int(self._exchange(torch.tensor(
                -1 if latest is None else latest)))
            latest = None if latest < 0 else latest
        if latest is None:
            return self.init_state()
        model, opt, _ = self.init_state()
        params = dict(model.params.named_parameters())
        state = None
        if not self._sharded() or self.mesh.rank == 0:
            # whole leaves on the host; this rank's blocks go to the device
            host = torch.zeros(())
            names = {n: host for n in params}
            tmpl = {"params": names,
                    "opt": adamw.OptState(step=host, m=names, v=names),
                    "cursor": host}
            state, _ = self.ckpt.restore(tmpl, latest)
        with torch.no_grad():
            for name, p in params.items():
                for dst, kind in ((p, "params"), (opt.m[name], "m"),
                                  (opt.v[name], "v")):
                    whole = None
                    if state is not None:
                        tree = state["params"] if kind == "params" else \
                            getattr(state["opt"], kind)
                        whole = tree[name]
                    dst.copy_(self._block(whole, dst, getattr(p, "spec", ())))
            counters = torch.zeros(2, dtype=torch.int64)
            if state is not None:
                counters[0] = int(state["opt"].step)
                counters[1] = int(state["cursor"])
            if self._sharded():
                counters = self._exchange(counters)
            opt.step.copy_(counters[0])
        return model, opt, int(counters[1])

    def _exchange(self, t):
        """``t`` broadcast from rank 0, on the backend's side of the card
        (the host for gloo, the card for NCCL)."""
        t = t.to(self._wire())
        dist.broadcast(t, src=0)
        return t.cpu()

    def _wire(self) -> torch.device:
        return torch.device("cpu") if dist.get_backend() == "gloo" \
            else self.device

    def _block(self, whole, like, spec):
        """This rank's block (``like``'s shape) of the leaf that rank 0
        holds ``whole``: scattered from rank 0 on a mesh."""
        if not self._sharded():
            return whole
        mesh, wire = self.mesh, self._wire()
        parts = None
        if mesh.rank == 0:
            parts = [whole[block(whole.shape, spec, mesh.shape,
                                 mesh.coords_of(r))].contiguous().to(wire)
                     for r in range(mesh_ranks(mesh))]
        out = torch.empty(like.shape, dtype=like.dtype, device=wire)
        dist.scatter(out, parts, src=0)
        return out

    def _whole(self, t, spec):
        """The whole leaf of this rank's block ``t`` under ``spec`` on
        rank 0's host (None on the others): every block gathered to rank
        0."""
        mesh, wire = self.mesh, self._wire()
        blk = t.detach().to(wire).contiguous()
        parts = [torch.empty_like(blk) for _ in range(mesh_ranks(mesh))] \
            if mesh.rank == 0 else None
        dist.gather(blk, parts, dst=0)
        return None if parts is None else assemble(parts, spec,
                                                   mesh.shape).cpu()

    def save(self, model, opt, step: int, blocking: bool = False):
        """Write (parameters, moments, cursor) as step ``step``: on a mesh
        every rank's blocks are gathered to rank 0, leaf by leaf, and rank
        0 writes the whole leaves (a collective call of every rank)."""
        if not self.ckpt:
            return
        params = dict(model.params.named_parameters())
        if self._sharded():
            specs = {n: p.spec for n, p in params.items()}
            params = {n: self._whole(p, specs[n]) for n, p in params.items()}
            opt = adamw.OptState(
                step=opt.step.cpu(),
                m={n: self._whole(t, specs[n]) for n, t in opt.m.items()},
                v={n: self._whole(t, specs[n]) for n, t in opt.v.items()})
            if self.mesh.rank != 0:
                return
        state = {"params": params, "opt": opt,
                 "cursor": torch.tensor(step, dtype=torch.int32)}
        self.ckpt.save(step, state,
                       blocking=blocking or not self.train_cfg.ckpt_async)

    # ------------------------------------------------------------------
    def run(self, should_stop: Callable[[], bool] = None,
            on_step: Callable[[StepRecord], None] = None):
        model, opt, start = self.restore_or_init()
        tc = self.train_cfg
        # the cursor: the first step not taken.  The JAX package's final
        # save writes step + 1 (src/repro/runtime/trainer.py:156), one past
        # the cursor after a preempted break or a run with no step to take,
        # so its resume would skip a batch
        done = start
        for step in range(start, tc.steps):
            if should_stop and should_stop():
                break
            batch = self.pipeline.batch_at(step)
            t0 = time.time()
            model, opt, metrics = self._step_fn(model, opt, batch)
            loss = float(metrics["loss"])
            dt = time.time() - t0
            done = step + 1

            ew = self._ewma
            self._ewma = dt if ew is None else 0.9 * ew + 0.1 * dt
            straggler = ew is not None and dt > tc.straggler_factor * ew
            rec = StepRecord(step, loss, dt, straggler)
            self.history.append(rec)
            if on_step:
                on_step(rec)
            if self.verbose and step % tc.log_every == 0:
                print(f"[train] step={step} loss={loss:.4f} "
                      f"dt={dt * 1e3:.0f}ms"
                      f"{' STRAGGLER' if straggler else ''}", flush=True)
            if self.ckpt and done % tc.ckpt_every == 0:
                self.save(model, opt, done)
        if self.ckpt:
            self.save(model, opt, done, blocking=True)
            self.ckpt.wait()
            if self._sharded():
                # no rank restores before rank 0's write is in place
                dist.barrier()
        return model, opt


# ---------------------------------------------------------------------------
# elastic re-mesh
# ---------------------------------------------------------------------------

def elastic_remesh(trainer: Trainer, new_mesh) -> Trainer:
    """Machine loss/gain: rebuild the trainer on ``new_mesh``, carrying state
    through the checkpoint.  The paper's selection state migrates for free
    (random partition is oblivious to m); the model and opt state come back
    on restore."""
    return Trainer(trainer.cfg, trainer.shape, new_mesh,
                   data=trainer.data_cfg, train=trainer.train_cfg,
                   opt=trainer.opt_cfg,
                   select=isinstance(trainer.pipeline, SelectionPipeline),
                   verbose=trainer.verbose, device=trainer.device)
