"""Standalone distributed-selection launcher on PyTorch: select k of n
synthetic embedded documents with the paper's MapReduce drivers.

    PYTHONPATH=src python -m repro_torch.launch.select --n 1048576 --k 64 \
        --d 256 --machines 16 --engine fused --use-kernel \
        [--oracle facility_location] [--algorithm multi_threshold --t 3]

Run as above, the m machines are simulated on one device (``--machines``).
Under ``torchrun`` (``WORLD_SIZE`` in the environment) every rank is one
machine of a mesh of the whole job, ``make_mesh_for(world_size,
model_parallel=1)`` as the JAX CLI builds it: NCCL with ``cuda:LOCAL_RANK``,
or gloo with ``--device cpu``; every rank makes the same corpus and prints
its result.

    PYTHONPATH=src python -m torch.distributed.run --nproc-per-node 2 \
        -m repro_torch.launch.select --device cpu --n 2048 --k 16 --d 16

``--fault-rate r`` runs under ``faults.chaos_plan(r, seed=--fault-seed)``
and prints the realized faults, ``degraded`` and the guarantee haircut.

The known-OPT algorithms (``multi_threshold``, ``two_round_known_opt``)
run the JAX CLI's estimate loop: v = opt_upper_bound / k (the max
singleton), then max(4, ceil(log k / 0.25) + 1) selects at the estimates
v * 1.25^(j+1), estimate j drawing its sample from a generator seeded
seed + j; the best value is kept.

Embeddings are U[0, 1)^2; facility location's and exemplar's reference
set is 256 rows of U[0, 1) drawn after them from the same generator, as the
JAX CLI draws them, and saturated coverage's and graph cut's ``total`` is
the embeddings' f32 column sum, as the JAX CLI computes it (before any bf16
cast).  The log-det oracles take k_max = k; ``--mi-noise`` is mutual
information's sensor noise.

``--constraint knapsack`` draws per-element costs U[0.5, 2) after the
reference, from the same generator, with the budget ``--budget`` (default
k * 1.25 / 2); ``--constraint partition_matroid`` draws part labels
uniformly over ``--n-parts`` parts, each capped at max(1, k // n_parts),
as the JAX CLI does.  Runs on the CUDA card unless ``--device cpu`` is
given.
"""

from __future__ import annotations

import argparse
import dataclasses
import datetime
import math
import os
import time

import torch
import torch.distributed as dist

from repro_torch.core.constraints import CONSTRAINT_NAMES
from repro_torch.core.faults import chaos_plan, fault_summary
from repro_torch.core.grids import SCHEDULE_KINDS
from repro_torch.core.precision import PRECISION_NAMES
from repro_torch.core.selector import (ALGORITHMS, OPT_FREE_ALGORITHMS,
                                       PORTED_ORACLES, DistributedSelector,
                                       SelectorSpec)
from repro_torch.core.threshold import ENGINES
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import make_mesh_for


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
    ap.add_argument("--constraint", default="cardinality",
                    choices=list(CONSTRAINT_NAMES),
                    help="feasibility constraint on the selection; the "
                         "launcher draws synthetic per-element costs / part "
                         "labels to exercise it")
    ap.add_argument("--budget", type=float, default=None,
                    help="knapsack cost budget (default: k * mean cost / 2)")
    ap.add_argument("--n-parts", type=int, default=8,
                    help="partition_matroid: number of parts (capacities "
                         "split k evenly)")
    ap.add_argument("--mi-noise", type=float, default=1.0,
                    help="mutual_information sensor noise")
    ap.add_argument("--t", type=int, default=3,
                    help="multi_threshold: thresholds (2 rounds each)")
    ap.add_argument("--eps", type=float, default=0.15)
    ap.add_argument("--schedule", default="paper",
                    choices=list(SCHEDULE_KINDS))
    ap.add_argument("--machines", type=int, default=8,
                    help="simulated MapReduce machines (must divide --n)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (cuda or cpu)")
    ap.add_argument("--fault-rate", type=float, default=0.0,
                    help="chaos injection: per-epoch shard-loss rate (with "
                         "message drop/corrupt/straggler at rate/2, /4, /4)")
    ap.add_argument("--fault-seed", type=int, default=0,
                    help="seed of the deterministic fault schedule")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    mesh = None
    device = resolve_device(args.device)
    if "WORLD_SIZE" in os.environ:
        # one machine a rank: NCCL on this rank's card, gloo on the CPU
        if device.type == "cuda":
            device = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
            torch.cuda.set_device(device)
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                                timeout=datetime.timedelta(seconds=300))
        mesh = make_mesh_for(dist.get_world_size(), model_parallel=1)
    faults = chaos_plan(args.fault_rate, seed=args.fault_seed)

    spec = SelectorSpec(k=args.k, oracle=args.oracle,
                        algorithm=args.algorithm, t=args.t, eps=args.eps,
                        epochs=args.epochs, schedule_kind=args.schedule,
                        engine=args.engine, chunk=args.chunk,
                        use_kernel=args.use_kernel, precision=args.precision,
                        mi_noise=args.mi_noise, constraint=args.constraint,
                        faults=faults)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    emb = torch.rand((args.n, args.d), generator=gen, device=device) ** 2
    reference = total = None
    if args.oracle in ("facility_location", "exemplar"):
        reference = torch.rand((spec.reference_size, args.d), generator=gen,
                               device=device)
    if args.oracle in ("saturated_coverage", "graph_cut"):
        total = emb.sum(0)
    costs = parts = part_caps = None
    if args.constraint == "knapsack":
        costs = 0.5 + 1.5 * torch.rand(args.n, generator=gen, device=device)
        budget = args.budget if args.budget is not None else args.k * 1.25 / 2
        spec = dataclasses.replace(spec, knapsack_budget=budget)
    elif args.constraint == "partition_matroid":
        parts = torch.randint(0, args.n_parts, (args.n,), generator=gen,
                              device=device)
        part_caps = torch.full((args.n_parts,), max(1, args.k // args.n_parts),
                               dtype=torch.int32)
    sel = DistributedSelector(spec, n_total=args.n, feat_dim=args.d,
                              n_machines=args.machines, device=device,
                              reference=reference, total=total,
                              element_costs=costs, parts=parts,
                              part_caps=part_caps, mesh=mesh)

    # on a mesh every rank made the whole corpus and selects over its shard
    local = emb if mesh is None else sel.data_sharding(emb)
    t0 = time.perf_counter()
    if args.algorithm in OPT_FREE_ALGORITHMS:
        res = sel.select(local, generator=gen)
    else:
        # OPT lies in [v, k v] for the max singleton v: try geometric
        # estimates and keep the best selection
        v = float(sel.opt_upper_bound(emb)) / args.k
        n_est = max(4, int(math.ceil(math.log(args.k) / 0.25)) + 1)
        res = None
        for j in range(n_est):
            r = sel.select(local, v * 1.25 ** (j + 1),
                           generator=torch.Generator(device=device)
                           .manual_seed(args.seed + j))
            if res is None or float(r.value) > float(res.value):
                res = r
    value = float(res.value)  # waits for the device
    dt = time.perf_counter() - t0

    rank = "" if mesh is None else f" rank={mesh.rank}"
    if mesh is None or mesh.rank == 0:
        print(f"[select] oracle={args.oracle} n={args.n} k={args.k} "
              f"d={args.d} algo={args.algorithm} "
              f"constraint={args.constraint} engine={args.engine} "
              f"machines={sel.cfg.n_machines} precision={args.precision} "
              f"device={sel.device}"
              + ("" if mesh is None else f" mesh={mesh.shape}"))
        print(sel.round_log.summary())
    print(f"[select{rank}] f(S)={value:.4f} |S|={int(res.sol_size)} "
          f"dropped={int(res.n_dropped)} wall={dt * 1e3:.0f}ms")
    if mesh is not None:
        print(f"[select{rank}] ids={res.sol_ids.tolist()}")
    if faults is not None:
        realized, frac = fault_summary(sel.round_log)
        print(f"[select{rank}] chaos rate={args.fault_rate:g} "
              f"seed={args.fault_seed}: degraded={int(res.degraded)} "
              f"haircut={float(res.haircut):.3f} "
              f"events={sel.round_log.fault_events()}")
        # a realized fault must be reported degraded
        if int(res.degraded) != int(realized) or (
                realized and abs(float(res.haircut) - frac) > 1e-6):
            raise RuntimeError("fault records and the result's degraded "
                               "flag or haircut disagree")
    if mesh is not None:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
