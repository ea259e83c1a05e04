"""Standalone distributed-selection launcher on PyTorch: select k of n
synthetic embedded documents with the OPT-free MapReduce drivers, the m
machines simulated on one device.

    PYTHONPATH=src python -m repro_torch.launch.select --n 1048576 --k 64 \
        --d 256 --machines 16 --engine fused --use-kernel \
        [--oracle facility_location]

Embeddings are U[0, 1)^2; facility location's reference set is 256 rows of
U[0, 1) drawn after them from the same generator, as the JAX CLI draws
them, and saturated coverage's and graph cut's ``total`` is the embeddings'
f32 column sum, as the JAX CLI computes it (before any bf16 cast).  The
log-det oracles take k_max = k; ``--mi-noise`` is mutual information's
sensor noise.  Runs on the CUDA card
unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.core.grids import SCHEDULE_KINDS
from repro_torch.core.precision import PRECISION_NAMES
from repro_torch.core.selector import (ALGORITHMS, PORTED_ORACLES,
                                       DistributedSelector, SelectorSpec)
from repro_torch.core.threshold import ENGINES
from repro_torch.device import resolve_device


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=8192)
    ap.add_argument("--k", type=int, default=64)
    ap.add_argument("--d", type=int, default=64)
    ap.add_argument("--oracle", default="feature_coverage",
                    choices=list(PORTED_ORACLES))
    ap.add_argument("--algorithm", default="two_round",
                    choices=list(ALGORITHMS))
    ap.add_argument("--engine", default="dense", choices=list(ENGINES),
                    help="ThresholdGreedy engine for the central phases")
    ap.add_argument("--chunk", type=int, default=128,
                    help="lazy/fused-engine chunk size")
    ap.add_argument("--use-kernel", action="store_true",
                    help="route oracle marginals/accepts through the CUDA "
                         "kernels (their plain versions on the CPU)")
    ap.add_argument("--precision", default="f32",
                    choices=list(PRECISION_NAMES),
                    help="storage precision policy (accumulators stay f32)")
    ap.add_argument("--epochs", type=int, default=None,
                    help="multi_epoch threshold levels (2 rounds each); "
                         "default derives ceil(1/eps) from --eps")
    ap.add_argument("--mi-noise", type=float, default=1.0,
                    help="mutual_information sensor noise")
    ap.add_argument("--eps", type=float, default=0.15)
    ap.add_argument("--schedule", default="paper",
                    choices=list(SCHEDULE_KINDS))
    ap.add_argument("--machines", type=int, default=8,
                    help="simulated MapReduce machines (must divide --n)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (cuda or cpu)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    spec = SelectorSpec(k=args.k, oracle=args.oracle,
                        algorithm=args.algorithm, eps=args.eps,
                        epochs=args.epochs, schedule_kind=args.schedule,
                        engine=args.engine, chunk=args.chunk,
                        use_kernel=args.use_kernel, precision=args.precision,
                        mi_noise=args.mi_noise)
    device = resolve_device(args.device)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    emb = torch.rand((args.n, args.d), generator=gen, device=device) ** 2
    reference = total = None
    if args.oracle == "facility_location":
        reference = torch.rand((spec.reference_size, args.d), generator=gen,
                               device=device)
    if args.oracle in ("saturated_coverage", "graph_cut"):
        total = emb.sum(0)
    sel = DistributedSelector(spec, n_total=args.n, feat_dim=args.d,
                              n_machines=args.machines, device=device,
                              reference=reference, total=total)

    t0 = time.perf_counter()
    res = sel.select(emb, generator=gen)
    value = float(res.value)  # waits for the device
    dt = time.perf_counter() - t0

    print(f"[select] oracle={args.oracle} n={args.n} k={args.k} d={args.d} "
          f"algo={args.algorithm} "
          f"engine={args.engine} machines={args.machines} "
          f"precision={args.precision} device={sel.device}")
    print(sel.round_log.summary())
    print(f"[select] f(S)={value:.4f} |S|={int(res.sol_size)} "
          f"dropped={int(res.n_dropped)} wall={dt * 1e3:.0f}ms")


if __name__ == "__main__":
    main()
