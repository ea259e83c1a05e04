"""Serving launcher: batched prefill + greedy decode with a ring KV cache.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b \
        --batch 4 --prompt-len 64 --gen 32 [--smoke] [--device cpu]

    PYTHONPATH=src torchrun --nproc_per_node 4 \
        -m repro_torch.launch.serve --model-parallel 2 [--device cpu]

One ``prefill`` processes the request batch's prompts and builds the
caches (KV rings, SSM states, or both for the hybrid family); one
``serve_step`` then appends one token per request per call
(continuous-batching style: requests are slots in the fixed batch).  Every
architecture that decodes is served on one rank: the dense, vlm, moe, ssm
and hybrid families.  It runs on the CUDA card unless ``--device cpu``
asks for the CPU, and then at the architecture's reduced size unless
``--no-smoke`` says otherwise.  Weights are random, drawn from seed 0 on
the device.

Under ``torchrun`` (``WORLD_SIZE`` set) the ranks form the mesh
``make_mesh_for(world, model_parallel)``, as the JAX CLI builds it, over
NCCL on ``cuda:LOCAL_RANK`` or gloo with ``--device cpu``; the dense,
moe, ssm and hybrid families are served there (vlm and audio raise).  Every rank draws the
same prompts and weights, keeps its block of the weights (the decode
policy's layout) and generates the same ids; rank 0 prints the
``[serve]`` lines.
"""

from __future__ import annotations

import argparse
import datetime
import os
import time

import torch
import torch.distributed as dist

from repro_torch.configs.base import ShapeSpec, get_config
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import make_mesh_for
from repro_torch.launch.steps import decode_step_bundle, prefill_bundle
from repro_torch.models.model import build_model


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="serve an assigned arch")
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--smoke", action="store_true", default=None)
    ap.add_argument("--no-smoke", dest="smoke", action="store_false")
    ap.add_argument("--model-parallel", type=int, default=1)
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
        _serve(args, device, mesh)
    finally:
        if mesh is not None:
            dist.destroy_process_group()


def _serve(args, device, mesh) -> None:
    smoke = args.smoke
    if smoke is None:
        smoke = device.type == "cpu"
    cfg = get_config(args.arch)
    if smoke:
        cfg = cfg.reduced()
    if not cfg.supports_decode:
        raise SystemExit(f"{args.arch} is encoder-only: no decode path")

    B = args.batch
    cache_len = args.prompt_len + args.gen
    pre = prefill_bundle(cfg, ShapeSpec("cli", args.prompt_len, B,
                                        "prefill"), mesh)
    dec = decode_step_bundle(cfg, ShapeSpec("cli", cache_len, B, "decode"),
                             mesh)
    model = build_model(cfg, torch.Generator(device=device).manual_seed(0),
                        device, policy=dec.policy)

    with torch.inference_mode():
        toks = torch.randint(
            0, cfg.vocab_size, (B, args.prompt_len), device=device,
            generator=torch.Generator(device=device).manual_seed(1))
        batch = {"tokens": toks}
        if cfg.family == "vlm":
            batch["image_embeds"] = torch.zeros(
                (B, cfg.num_image_tokens, cfg.d_model), dtype=torch.bfloat16,
                device=device)
        t0 = time.perf_counter()
        logits, caches = pre.fn(model, batch, cache_len=cache_len)
        _sync(device)
        t_prefill = time.perf_counter() - t0

        prompt_tok = args.prompt_len + (cfg.num_image_tokens
                                        if cfg.family == "vlm" else 0)
        tok = model.greedy(logits, pre.policy)
        out = [tok]
        t0 = time.perf_counter()
        for i in range(args.gen - 1):
            pos = torch.full((B, 1), prompt_tok + i, dtype=torch.int32,
                             device=device)
            logits, caches = dec.fn(model, caches, tok, pos)
            tok = model.greedy(logits, dec.policy)
            out.append(tok)
        _sync(device)
        t_decode = time.perf_counter() - t0

    gen = torch.cat(out, dim=1)
    if mesh is not None and mesh.rank != 0:
        return
    where = "" if mesh is None else f" mesh={mesh.shape}"
    print(f"[serve] arch={cfg.name} batch={B} prompt={args.prompt_len} "
          f"gen={gen.shape[1]}{where}")
    print(f"[serve] prefill {t_prefill * 1e3:.0f}ms "
          f"({B * args.prompt_len / max(t_prefill, 1e-9):.0f} tok/s), "
          f"decode {t_decode * 1e3:.0f}ms "
          f"({B * (args.gen - 1) / max(t_decode, 1e-9):.0f} tok/s)")
    print(f"[serve] sample continuation ids: {gen[0, :16].tolist()}")


if __name__ == "__main__":
    main()
