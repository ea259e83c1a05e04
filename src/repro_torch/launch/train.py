"""Training launcher.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \
        --steps 100 --batch 8 --seq 256 [--smoke] [--select] \
        [--ckpt-dir DIR] [--device cpu]

It runs on the CUDA card unless ``--device cpu`` asks for the CPU.
``--smoke`` (the default on the CPU) swaps in the reduced same-family
config; without it the full config is used.  Weights are random, drawn
from the train seed 0 on the device; compute is bf16.  ``--select`` curates
every ``--select-every``-th batch with the paper's two-round selector.

Under ``torchrun`` (``WORLD_SIZE`` ranks) the job trains on a (data, model)
mesh with ``--model-parallel`` ranks on the model axis (the dense, moe,
ssm and hybrid families, under the config's ``parallelism``: ZeRO-3 for
"fsdp", TP + FSDP for "tp", as falcon-mamba-7b): NCCL with one rank a
card, gloo with ``--device cpu``; rank 0 prints the log.

    PYTHONPATH=src python -m torch.distributed.run --standalone \
        --nproc-per-node 4 -m repro_torch.launch.train --device cpu \
        --model-parallel 2
"""

from __future__ import annotations

import argparse
import datetime
import os

import torch
import torch.distributed as dist

from repro_torch.configs.base import ShapeSpec, get_config
from repro_torch.data.pipeline import DataConfig
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import make_mesh_for
from repro_torch.optim import adamw
from repro_torch.runtime.trainer import TrainConfig, Trainer


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="train an assigned arch")
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--smoke", action="store_true", default=None,
                    help="use the reduced config (default when on CPU)")
    ap.add_argument("--no-smoke", dest="smoke", action="store_false")
    ap.add_argument("--select", action="store_true",
                    help="enable submodular batch curation (the paper)")
    ap.add_argument("--select-every", type=int, default=4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; no fall-back between them")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    mesh = None
    if "WORLD_SIZE" in os.environ:
        # NCCL on this rank's card, gloo on the CPU
        if device.type == "cuda":
            device = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
            torch.cuda.set_device(device)
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                                timeout=datetime.timedelta(seconds=300))
        mesh = make_mesh_for(dist.get_world_size(),
                             model_parallel=args.model_parallel)
    elif args.model_parallel != 1:
        raise SystemExit("--model-parallel > 1 runs under torchrun "
                         "(WORLD_SIZE ranks, a multiple of it)")
    try:
        _train(args, device, mesh)
    finally:
        if mesh is not None:
            dist.destroy_process_group()


def _train(args, device, mesh) -> None:
    smoke = args.smoke
    if smoke is None:
        smoke = device.type == "cpu"
    cfg = get_config(args.arch)
    if smoke:
        cfg = cfg.reduced()
    shape = ShapeSpec("cli", args.seq, args.batch, "train")
    log = mesh is None or mesh.rank == 0

    trainer = Trainer(
        cfg, shape, mesh,
        data=DataConfig(global_batch=args.batch, seq_len=args.seq,
                        select_every=args.select_every if args.select else 0),
        train=TrainConfig(steps=args.steps, ckpt_dir=args.ckpt_dir,
                          ckpt_every=args.ckpt_every),
        opt=adamw.AdamWConfig(lr=args.lr),
        select=args.select, verbose=log, device=device)
    if log and mesh is not None:
        print(f"[train] mesh={mesh.shape} batch axes "
              f"{trainer.policy.batch_axes} seq_shard "
              f"{trainer.policy.seq_shard}", flush=True)
    trainer.run()
    losses = [r.loss for r in trainer.history]
    if log and losses:
        print(f"[train] done: steps={len(losses)} "
              f"loss {losses[0]:.4f} -> {losses[-1]:.4f}")


if __name__ == "__main__":
    main()
