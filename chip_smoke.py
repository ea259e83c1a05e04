#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py        (from the root of a checkout)

Phases, each printing its lines; any failure raises and exits non-zero:

1. Build the CUDA kernels from src/repro_torch/kernels/csrc with nvcc (one
   process per source, all at once).
2. Hold each of the fifteen kernels against its plain PyTorch version on
   the card, at the main paths' shapes (L = 37 lanes, C = 1,048,576 rows
   for a filter, B = 128 for a chunk, d = r = 256, k_max = 64, f32 and
   bf16) and at odd ones, every lane mode, each launch repeated bitwise,
   and time kernel, plain version and, where one exists, the PyTorch call
   of the same product: the coverage, facility, weighted and saturated
   coverage, graph cut, log-det and exemplar kernels.  log-det runs at the
   lanes' sizes (974 of 2368 basis rows live), full and, unbatched, at
   size 0, each call with sizes bit for bit the call without them, its
   bound and library call over the live rows and over every row;
   graph_cut_marginals' and weighted_coverage_marginals' shared skinny
   tile runs on dyadic data at 42 shapes each (L = 2 .. 130, d = 3, 45,
   256), bit for bit the plain version; logdet_accept's narrow instance
   gives the bits of the first port's row loop (its wide instance, forced
   at the same shape) in 28 cases (lane sizes 0, 1, k - 1, k, appends into
   k_max, budget 3, both modes, B = 1, 70, 128, 300, L = 1, 37, 130, k = 7
   on d = 45).
   facility_marginals and exemplar_marginals also run on dyadic data at
   the ragged edges of their 128 x 128 tile (C = 1000, 65; r = 45, 100,
   130, 300; d = 45, 70, 130; L = 1, 37, 100, 130), bit for bit the plain
   versions; the build prints ptxas's registers and spills and the SASS
   instruction mix of their tile.  facility_accept and exemplar_accept are
   also timed at tau = -inf, where every eligible row is accepted, and
   coverage_marginals and saturated_coverage_marginals at the shapes of
   their "filter" launches (one lane over the corpus, the gathered sample
   of 98,560 rows, a lane's 34,048 gathered survivors, a chunk) and at the
   partition matroid's one row, each launch repeated bitwise; both also
   run every instance of their lane walk (csrc/lane_rows.cuh: the shared-x
   warp tiles of 4 x 8, 8 x 4, 16 x 2 and 32 x 1 rows x lanes, one-lane
   and per-lane tiles of 16, 8 and 1 rows), f32 and bf16, against the plain
   version and bitwise on a second launch, and the build prints ptxas's
   registers and spills of every lane walk kernel.  rectified_residual_sum
   runs at its main-path shapes (unbatched over the corpus and over the
   sample, the sample shared by 37 lanes, 37 lanes' per-lane survivors,
   unbatched over the wide FacilityLocation select's 262,144 x 8192 aux)
   and two odd ones, beside a read-rate yardstick (``aux.sum(-1)`` over the
   corpus's 1 GiB aux, not the same function), each line naming the card
   and its power limit.
3. The knapsack cost mode of the seven accept sweeps against their plain
   versions, with budgets that bind inside the chunk in half the lanes;
   then each sweep's wide instance (d = 2049 and 4096 features, r = 4097
   and 8192 reference rows, log-det bases (k, d) = (64, 1024) and
   (256, 256)) in both modes, f32 and bf16.
4. Drive each oracle's main path at full width through
   DistributedSelector.select: two_round with n = 1,048,576 rows of
   d = 256 (a 1 GiB f32 corpus on the card), k = 64, m = 16 simulated
   machines, eps = 0.15, once per engine on the kernel route and once on
   the plain route, then multi_epoch (E = 2) and bf16 storage on the fused
   engine; check the routes' and engines' agreement, the (1/2 - eps)
   guarantee against sequential greedy, and that every kernel of the path
   launched; each kernel's launches are also split by the rows a lane each
   launch took (more than a chunk, a chunk, one row), and the "filter"
   launches of coverage_marginals, saturated_coverage_marginals and
   rectified_residual_sum by lanes, shared or per-lane x (the aux) and
   rows.  FeatureCoverage; FacilityLocation and ExemplarClustering
   with a 256-row reference set; WeightedCoverage; SaturatedCoverage
   (total = X.sum(0), alpha = 0.25, and once more at alpha = 2^-16, where
   the cap binds); GraphCut (lam = 0.5); LogDetDiversity (alpha = 1) and
   MutualInformationGaussian (noise = 1), which must give log-det's ids
   and exactly half its value.
5. Knapsack selection (costs U[0.5, 2), budget 40) on all eight oracles,
   fused on the kernel route against lazy on the plain route, each sweep
   in its cost mode and the chosen costs within the budget; FeatureCoverage
   on all three engines (the same ids) and with unit costs and budget k
   (the cardinality select's ids); a partition matroid (8 parts, caps 8)
   on FeatureCoverage; the time of the plane split's copy.
6. The known-OPT algorithms, the query axis and the Theorem-4 instance
   (their launches stay out of the kernel table's), each part printing its
   seconds: (a) two_round_known_opt and multi_threshold (t = 3) per oracle
   at full width, opt = sequential greedy's value on the first 65,536
   rows, one lane each, fused on the kernel route against lazy on the
   plain route (rtol 1e-3), nothing dropped, Algorithm 4 >= gval / 2 and
   Algorithm 5 >= (3/4)^3 gval, MI half of log-det with its ids, and one
   knapsack multi_threshold within its budget; (b) select_batch of
   budgets (64, 32, 16, 1) per oracle on the fused kernel route (Q x J =
   148 lanes where the oracle takes no per-query hyper-parameters),
   GraphCut also at lam = (0.5, 0.25, 0.125, 0) and LogDet at alpha = (1,
   0.5, 2, 0.25): query 0 gives the two_round fused kernel select's ids
   and value, each query the ids of a Q = 1 batch of it, and the 148-lane
   filter launches show in ``ops.filter_launch_counts()``; (c)
   multi_threshold on the Theorem-4 instance (k = 120, t = 1, 2, 4), whose
   ratio must meet 1 - (t/(t+1))^t within 5e-3 and the CPU run's value.
7. Three selects whose fused engine runs a wide instance, each on a
   1 GiB corpus, against the lazy plain route (the same ids, values within
   rtol 1e-3): FeatureCoverage on 65,536 x 4096, LogDetDiversity (k = 64)
   on 262,144 x 1024, FacilityLocation with 8192 reference rows on
   262,144 x 256.
8. The mesh substrate on the same corpus (fused engine, kernel route),
   printing each part's seconds: (a) one rank over NCCL in this process,
   mesh (data = 1, model = 1): two_round for all eight oracles and, on
   FeatureCoverage, multi_epoch (E = 2), two_round_known_opt,
   multi_threshold (t = 3), knapsack (budget 40) and select_batch (64,
   32, 16, 1), each against the sim selector at m = 1 with the same
   generator (the same ids, sizes, overflow and fallback counts and
   RoundLog records; the value's bits, or the difference printed); (b)
   four ranks spawned on the one card over gloo, mesh (data = 4, model =
   1), each drawing the corpus from seed 0: two_round for all eight
   oracles, FeatureCoverage multi_epoch (E = 2), select_batch (64, 32,
   16, 1), and two_round under chaos_plan(0.25, seed=0), each against the
   sim at m = 4 (under the same plan: the same fault records, degraded,
   haircut), with each rank's peak memory; (c) the tensor-parallel oracle
   on (data = 2, model = 2), FeatureCoverage and WeightedCoverage two_round
   on the lazy engine against the sim at m = 2 on the full-width oracle
   (the same ids, values within rtol 1e-5), with each rank's all_reduce
   and all_gather counts, and the fused engine's row scan
   (TPOracle.chunk_accept, one all_reduce a row) on one (37, 128, 256)
   chunk against the full-width coverage_accept kernel; every rank must
   equal rank 0, and every select must launch its oracle's kernels; (d)
   rand_greedi on
   FeatureCoverage at m = 16 beside two_round's value; (a) and (b) also
   run sieve_and_merge_mesh (FeatureCoverage, dense kernel route, 65,536-
   row chunks) against sieve_and_merge_sim at m = 1 and m = 4, (b) also
   under the first chaos_plan(0.25) seed that realizes a fault on its one
   gather: the sim's ids, value bits, records and FaultRecords.  Its
   launches go on a line of their own.
9. The streaming path (k = 64, eps = 0.15: 37 lanes, a 128-row
   reservoir; 65,536-row sieve chunks of the main path's corpus, copied
   once to the host and streamed through prefetch_to_device), each part
   printing its seconds: the prefetch's host -> device rate beside one
   pinned copy's; (a) FeatureCoverage over all 2^20 rows on the dense and
   fused kernel routes against the lazy plain route (the same ids, rtol
   1e-3), the (1/2 - eps/2) floor against greedy, four uneven batches
   bit for bit the one-shot ingest (every SieveState leaf), bf16 storage
   (>= 0.99 x f32), a knapsack (budget 40) and a partition matroid (8 x
   8) on the dense engine, select(budget=16); (b) the other seven oracles
   over 2^18 rows on both engines against the plain route, and mutual
   information finishing log-det's state at exactly half its value with
   its ids; (c) sieve_and_merge_sim at m = 16 (one chunk a machine): one
   gather, nothing dropped, the (1/2 - eps) floor, its ratio to the
   two_round fused select, and under chaos_plan(0.25) at the first seed
   that realizes a fault; (d) SelectionService killed with os._exit in a
   child after an async save, restored here, against the uninterrupted
   run (ids, value bits, every sieve leaf); (e) the select_serve CLI at
   n = 2^20 (8 slots, 24 requests, 65,536-document ingests, checkpoints
   every 2 steps, --use-kernel), then again with --restore.  Its launches
   go on a `[stream]` line of their own; every kernel must show there.
10. The LM serving path (``repro_torch.models``, ``launch/steps.py``,
   ``launch/serve.py``; random weights drawn on the card from seeded
   generators, bf16 compute), each part printing its seconds: (a)
   qwen3-1.7b at full width (28 layers, d_model 2048, vocab 151,936)
   through prefill_bundle / decode_step_bundle at launch/serve.py's
   defaults (B = 4, prompt 64, generate 32): prefill and decode ms and
   tok/s, peak memory, the same greedy ids twice, every decode step's
   logits against a prefill over the same tokens (rtol = atol = 0.08,
   argmax agreement >= 0.95), and one decode step's roofline bound from
   repro_torch.roofline (the f32 weights and the caches over 3.35 TB/s
   against model_flops_for over the bf16 peak) beside the measured step;
   (b) a qwen3-1.7b prefill of B = 8 x 4096 tokens (q_block 512 and
   kv_block 1024 both tile), ms, tok/s, model_flops_for over the bf16
   peak and peak memory; (c) h2o-danube-1.8b (window 4096, head_dim 80;
   4 of its 24 layers), B = 1, prompt 4160, generate 16: the ring branch
   of prefill_to_cache
   and a decode that wraps the ring, with (a)'s decode-vs-prefill check;
   (d) ``python -m repro_torch.launch.serve --arch qwen3-1.7b`` on the
   card; (e) exclude_ids at the 148-lane batch's shape (L = 148, C =
   2^20, k = 64) bit for bit the broadcast it replaced, each one's peak
   extra memory (the new one under 1 GiB), and the FeatureCoverage
   148-lane select_batch with the same ids and value bits either way.
11. The moe, ssm and hybrid families' serving (``models/moe.py``,
   ``models/ssm.py``, their groups in the transformer, the bundles, the
   CLI; random weights on the card, bf16 compute), each part printing its
   seconds, ms, tok/s, peak memory and one decode step against its
   roofline bound: (a) qwen2-moe-a2.7b at full width (60 experts top-4,
   shared width 5632), its 24 layers cut to 4 at launch/serve.py's
   defaults twice (the same ids), the (token, choice) rows its
   capacity_factor 1.25 drops in prefill, and decode against prefill with
   capacity raised to E / k (nothing drops) at (a)'s bf16 bar; (b)
   falcon-mamba-7b at full width (d_inner 8192), its 64 Mamba1 layers
   cut to 8 twice, a B = 1 x 4096 prefill (32 chunks of 128), and decode
   against prefill in f32 compute (within 1e-3, every argmax equal); (c)
   zamba2-2.7b at full width, its 9 groups (6 Mamba2 layers + the
   shared block each) cut to 3, prompt 200 (the chunk's pad branch), the shared block's
   9 group copies of its cache, decode against prefill in f32; (d)
   llama4-scout-17b-a16e at full width cut to one group of 4 layers (3
   chunked-local + 1 global), B = 1, prompt 8256 past the 8192 chunk: the
   local rings hold the last 8192 positions, decode against prefill with
   capacity raised; (e) ``python -m repro_torch.launch.serve --arch
   zamba2-2.7b`` on the card.
12. LM training (launches no kernel; the JAX package's LM stack reaches
   no ``pl.pallas_call``): (a) qwen3-1.7b at full width and depth, 10 x
   4096 tokens, the Trainer for 2 steps with curation every 2, bf16
   compute; each step's ms, tokens/s, loss, grad norm, lr and MFU, the
   peak memory under 70 GiB; (b) a step, a checkpoint, a resumed step
   against 2 straight (1 layer), bit-equal; (c) falcon-mamba-7b at full
   width cut to 2 layers, one step at A = 8 micro-batches and one at A =
   1: loss, parameters, every gradient leaf and the grad norm; (d) one
   step of qwen2-moe-a2.7b (2 layers) and of zamba2-2.7b (2 groups): a
   finite loss and aux, every parameter a non-zero gradient, the MoE's
   recompute under remat routes as its forward; (e) reduced qwen3,
   falcon-mamba and qwen2-moe in f32, one step on the card against the
   CPU; (f) the curation's kernel route gives the plain route's ids; (g)
   ``python -m repro_torch.launch.train`` on the card.
13. LM serving on a (data, model) mesh of gloo ranks sharing the card
   (``models/sharding.py``'s multi-rank policy, ``models/collectives.py``,
   the sharded layers, the MoE's ep / tp / all-to-all modes, the bundles
   on a mesh; launches no kernel), each part against the one-rank serving
   of the same seeded weights on the card, the decode steps fed the
   one-rank run's ids, every rank's ids equal to rank 0's; each prints
   its seconds, prefill and decode ms, each rank's parameter bytes and
   peak memory, and the collectives' calls and operand bytes by kind and
   axes of the prefill and of a decode step: (a) qwen3-1.7b at full width
   cut to 4 of its 28 layers on (2, 2), B = 4, prompt 64, generate 8, bf16
   (rtol = atol 0.08, argmax agreement >= 0.95 where the top-2 gap
   exceeds it), then 2 layers in f32 (within 1e-4, every argmax equal)
   and a B = 1 prefill of 1024 tokens (the seq_shard branch, within
   1e-4); (b) llama4-scout-17b-a16e at full width on (2, 2), 2 layers
   (one chunked-local, one global: four ranks of its 4-layer group
   would hold 84 GB), f32, capacity E / k: prefill's all-to-all dispatch,
   decode's ep, within 1e-4 and every argmax equal; (c) qwen2-moe-a2.7b
   at full width on (1, 8), 1 layer, f32, capacity E / k: 60 experts do
   not divide 8, so decode runs tp and prefill ZeRO without EP (its
   sequence over "model"), within 1e-4 and every argmax equal.
14. LM training on a (data, model) mesh of four gloo ranks sharing the
   card (the ZeRO-3 train step: the collectives' backward, the
   vocab-parallel CE, AdamW over shards; the mesh-independent checkpoint;
   the curation on the training mesh; launches no LM kernel), each part
   against the one-rank step of the same seeded weights and batch on the
   card, every rank's metrics equal to rank 0's, printing step ms,
   tokens/s, the collectives' calls and operand bytes by kind and axes,
   each rank's parameter and moment bytes and peak memory: (a)
   qwen3-1.7b at full width cut to 2 layers on (2, 2), batch 4 x 4096:
   the Trainer for 3 bf16 steps curated every 2, one bf16 step against
   one rank's (loss rtol 2e-2, gradients within 1e-2 of their max,
   parameters rtol 5e-2 atol 5e-3, grad norm rtol 1e-3) and one f32 step
   (metrics rtol 1e-5, gradients and moments within 1e-4 of their leaf's
   max, parameters within 2 lr); (b) the same at batch 2 in f32, the
   sequence over "model" (seq_shard); (c) qwen2-moe-a2.7b at full width
   cut to 2 layers on (1, 4), batch 4 x 1024, f32, capacity E / k: the
   all-to-all dispatch and its inverse in backward; (d) (a)'s f32 run
   saved after step 1 (the blocks gathered to rank 0, which writes the
   whole leaves), step 2
   resumed on (2, 2) bit for bit the straight run's and re-meshed to (1,
   4) within the f32 bars; (e) (a)'s step-0 curation pool through the
   selector on the training mesh, kernel route, dense and fused engines:
   the plain route's ids on every rank.
15. The ssm and hybrid families on the (2, 2) mesh of four gloo ranks
   sharing the card (the Mamba1 / Mamba2 blocks split over d_inner under
   TP or gathered whole under ZeRO-3, the shared block, the Mamba caches
   handed to the decode layout; launches no LM kernel), each part against
   one rank on the same seeded weights, batch and card at phases 13's and
   14's bars, printing the collectives' calls and operand bytes by kind
   and axes, each rank's parameter bytes and peak memory and ms beside
   one rank's: (a) falcon-mamba-7b at full width cut to 2 of 64 layers,
   B = 4, prompt 64 and 8 decode steps under TP in bf16 and in f32, and
   one TP train step in f32 of its 8 micro-batches of 2 x 256 (the
   Megatron pair's backward sums over "model"); (b) zamba2-2.7b cut to 1
   of 9 groups (6 Mamba2 layers and the shared block), a ZeRO-3 prefill
   of B = 4, prompt 200, then 8 TP decode steps, a B = 1 prefill of 1024
   tokens (seq_shard), and one ZeRO-3 train step in f32 of 4 x 1024.
16. Print the kernel table as one JSON line, the card's name and power
   limit, and last the result line.

Exits non-zero, printing no result, without a CUDA card or outside a
checkout.  Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
import zlib
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, f32 FLOP/s off the
# tensor cores
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12

N, D, K, M, EPS, CHUNK = 1 << 20, 256, 64, 16, 0.15, 128
L = 37                 # tau-grid lanes at k=64, eps=0.15
B = CHUNK              # lazy / fused chunk rows
R = 256                # facility location reference rows
S_ROWS = 98_560        # gathered sample (16 x 6160 rows)
F_ROWS = 34_048        # gathered survivors per lane (16 x 2128 rows)
GREEDY_ROWS = 1 << 16  # rows of the sequential greedy yardstick
TILE = 1 << 18         # row tile of the plain versions at full width
RTOL = ATOL = 1e-5     # coverage-family kernels: sums over d in another
#                        order
SAT_ALPHA = 2.0 ** -16  # the saturating select: cap ~ 5.3 per feature
KNAP_BUDGET = K * 1.25 / 2  # knapsack budget (the JAX CLI's default): 40
N_PARTS, PART_CAP = 8, 8    # partition matroid: parts, cap of each
#: a launch's shape class by its rows a lane (kernels._wrap.SHAPES): more
#: than the engines' chunk, up to it, one row
SHAPES = ("filter", "chunk", "row")
#: the kernels whose filter-class launches split by lanes, x and rows
#: (kernels.ops.filter_launch_counts; rectified_residual_sum's x is its
#: aux, timed at its own shapes in phase_facility_kernels), and the
#: coverage kernels' shapes: (label, lanes, rows a lane, per-lane x) for
#: one lane over the corpus (the singleton passes), the gathered sample
#: (shared x), a lane's gathered survivors (per-lane x), a chunk and one
#: row (the partition matroid's row scan)
FILTER_SPLIT_KERNELS = ("coverage_marginals", "saturated_coverage_marginals",
                        "rectified_residual_sum")
FILTER_SHAPES = (("one lane", 1, N, False), ("sample", L, S_ROWS, False),
                 ("survivors", L, F_ROWS, True), ("chunk", L, B, True),
                 ("one row", L, 1, True))
#: the lane walk's (csrc/lane_rows.cuh) instances, each at a shape that
#: runs it: (label, lanes, rows a lane, per-lane x); a shared-x launch of
#: L >= 2 lanes over at least 32 rows runs a warp tile of 32 / J rows x J
#: lanes for each lane group J in the binary digits of L (8s first), any
#: other launch tiles of R rows of one lane (R = 16 where the tiles fill
#: the card, else 8, or 1 for fewer than 8 rows)
WALK_INSTANCES = (("shared 4 rows x 8 lanes", 8, 1000, False),
                  ("shared 8 rows x 4 lanes", 4, 1000, False),
                  ("shared 16 rows x 2 lanes", 2, 1000, False),
                  ("shared 32 rows x 1 lane (L = 9)", 9, 1000, False),
                  ("one lane, 16-row tiles", 1, N, False),
                  ("per-lane, 16-row tiles", L, F_ROWS, True),
                  ("per-lane, 8-row tiles", L, B, True),
                  ("per-lane, 1-row tiles", L, 7, True),
                  ("shared, fewer rows than a tile", 9, 31, False))


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def add_launches(launches, counts, names):
    """Add the launches of kernels ``names`` in one select's ``counts``, and
    their split by shape ("<name>@<shape>") and of the filter class by
    lanes, x and rows ("<name>@filter/<key>"), to ``launches``."""
    for name in names:
        split = [key for key in counts if key.startswith(f"{name}@filter/")]
        for key in (name, *(f"{name}@{shape}" for shape in SHAPES), *split):
            launches[key] = launches.get(key, 0) + counts.get(key, 0)


def smi():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def cuda_ms(fn, iters):
    """Mean milliseconds of ``fn`` over ``iters`` calls, after a warm-up,
    with CUDA events around the whole run.

    The card first spins for twice the host time it takes to issue the
    calls (at an assumed 2 GHz clock), so the host has enqueued every
    launch before the first one runs: the events then time the launches
    back to back, and a kernel shorter than its Python wrapper is not
    timed as the wrapper.  A version that waits on the card inside each
    call (the plain sweeps) is timed with its host gaps, as a caller would
    see it."""
    import torch
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    fn()
    head_start_s = 2 * (time.perf_counter() - t) * iters
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(min(head_start_s, 1.0) * 2e9))
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def bound_ms(n_bytes, n_ops):
    t_bytes, t_ops = n_bytes / PEAK_BYTES, n_ops / PEAK_F32
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def check_sweep(name, got, want, tau, near_tol, close):
    """Hold a kernel's accept sweep (mask, state, gains), (L, ...) each,
    against the plain sweep.  Masks may part only at a row whose plain gain
    is within ``near_tol[l]`` of its threshold (tau (L,), or per row
    (L, B): tau * cost in the cost mode); the gains are then compared up to
    that row.  Returns (near-tau ties, max abs err)."""
    km, ks, kg = got
    pm, ps, pg = want
    ties, err = 0, 0.0
    for l in range(km.shape[0]):
        diff = (km[l] != pm[l]).nonzero()
        upto = km.shape[1]
        if len(diff):
            i = int(diff[0])
            t = float(tau[l, i] if tau.dim() == 2 else tau[l])
            check(abs(float(pg[l, i]) - t) <= float(near_tol[l]),
                  f"{name} lane {l} row {i}: masks differ away from tau "
                  f"(gain {float(pg[l, i])}, tau {t})")
            ties, upto = ties + 1, i + 1
        else:
            check(close(l, ks[l], ps[l], "state"),
                  f"{name} lane {l}: states differ")
            err = max(err, (ks[l] - ps[l]).abs().max().item())
        check(close(l, kg[l, :upto], pg[l, :upto], "gains"),
              f"{name} lane {l}: gains differ")
        err = max(err, (kg[l, :upto] - pg[l, :upto]).abs().max().item())
    return ties, err


def all_accept_ms(torch, name, sweep, eligible):
    """A sweep's ms with tau = -inf and the budget B, where every eligible
    row is accepted: its slowest walk.  ``sweep(tau, budget)`` launches it
    on its path-case operands with these eligible rows."""
    Lk, Bk = eligible.shape
    tau = torch.full((Lk,), float("-inf"), device=eligible.device)
    budget = torch.full((Lk,), Bk, dtype=torch.int32, device=eligible.device)
    mask = sweep(tau, budget)[0]
    check(torch.equal(mask, eligible), f"{name}: tau = -inf did not accept "
          f"every eligible row")
    ms = cuda_ms(lambda: sweep(tau, budget), 50)
    print(f"[kernels] {name} ({Lk}, {Bk}) tau=-inf, budget {Bk}: "
          f"accepted={int(mask.sum())} kernel_ms={ms}")
    return ms


def lane_taus(torch, gains):
    """Per-lane thresholds from "accept most rows" to "accept few"."""
    q = torch.linspace(0.05, 0.95, gains.shape[0], device=gains.device)
    return torch.stack([gains[l].quantile(q[l])
                        for l in range(gains.shape[0])]).contiguous()


def phase_coverage_kernels(torch, ref, cm, ca):
    """Coverage kernels vs plain versions on the card; returns the JSON
    rows."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    rows = {}

    # -- coverage_marginals: shared x at the filter shape, per-lane x at the
    #    lazy chunk shape
    worst = 0.0
    for label, shape in (("shared", (N, D)), ("per-lane", (L, B, D))):
        for dtype in (torch.float32, torch.bfloat16):
            for weighted in (False, True):
                x = (torch.rand(shape, generator=g, device=dev) ** 2).to(dtype)
                state = torch.rand((L, D), generator=g, device=dev) * 4
                w = (torch.rand(D, generator=g, device=dev) + 0.5
                     if weighted else None)

                def plain():
                    if label == "per-lane":
                        return ref.coverage_marginals(x, state, w)
                    # one lane at a time: the (L, C, d) temporaries of
                    # the plain version would not fit in device memory
                    return torch.stack([ref.coverage_marginals(x, state[l], w)
                                        for l in range(L)])

                got = cm.coverage_marginals(x, state, w)
                want = plain()
                torch.cuda.synchronize()
                err = (got - want).abs().max().item()
                check(torch.allclose(got, want, rtol=RTOL, atol=ATOL),
                      f"coverage_marginals {label} {dtype} w={weighted}: "
                      f"max abs err {err}")
                worst = max(worst, err)
                ms = cuda_ms(lambda: cm.coverage_marginals(x, state, w), 10)
                pms = cuda_ms(plain, 2)
                C = shape[-2]
                x_bytes = x.numel() * x.element_size()
                b_ms, b_by = bound_ms(x_bytes + L * D * 4 + L * C * 4 +
                                      (D * 4 if weighted else 0),
                                      5 * L * C * D + L * D)
                print(f"[kernels] coverage_marginals {label} x{tuple(shape)} "
                      f"{str(dtype)[6:]} weighted={weighted}: max_abs_err={err} "
                      f"kernel_ms={ms} plain_ms={pms} bound_ms={b_ms} ({b_by})")
                if label == "shared" and dtype == torch.float32 and not weighted:
                    rows["coverage_marginals"] = dict(
                        ms=ms, plain_ms=pms, bound_ms=b_ms, bound_by=b_by)
    rows["coverage_marginals"]["max_abs_err"] = worst

    # -- coverage_accept at the fused engine's shape
    worst = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for weighted in (False, True):
            x = (torch.rand((L, B, D), generator=g, device=dev) ** 2).to(dtype)
            state = torch.rand((L, D), generator=g, device=dev) * 4
            w = torch.rand(D, generator=g, device=dev) + 0.5 if weighted else None
            elig = torch.rand((L, B), generator=g, device=dev) < 0.9
            tau = lane_taus(torch, ref.coverage_marginals(x, state, w))
            budget = torch.where(torch.arange(L, device=dev) % 5 == 0, 3,
                                 K).to(torch.int32)
            got = ca.coverage_accept(x, state, w, elig, tau, budget)
            want = ref.coverage_accept(x, state, w, elig, tau, budget)
            torch.cuda.synchronize()
            ties, err = check_sweep(
                "coverage_accept", got, want, tau, RTOL * tau.abs(),
                lambda l, a, b, what: torch.allclose(a, b, rtol=RTOL,
                                                     atol=ATOL))
            worst = max(worst, err)
            n_acc = int(want[0].sum())
            ms = cuda_ms(lambda: ca.coverage_accept(x, state, w, elig, tau,
                                                    budget), 50)
            pms = cuda_ms(lambda: ref.coverage_accept(x, state, w, elig, tau,
                                                      budget), 3)
            b_ms, b_by = bound_ms(
                x.numel() * x.element_size() + 2 * L * D * 4 + L * B * 6
                + L * 8 + (D * 4 if weighted else 0),
                5 * L * B * D + 2 * n_acc * D)
            print(f"[kernels] coverage_accept x({L}, {B}, {D}) "
                  f"{str(dtype)[6:]} weighted={weighted}: max_abs_err={err} "
                  f"near_tau_ties={ties} accepted={n_acc} kernel_ms={ms} "
                  f"plain_ms={pms} bound_ms={b_ms} ({b_by})")
            if dtype == torch.float32 and not weighted:
                rows["coverage_accept"] = dict(ms=ms, plain_ms=pms,
                                               bound_ms=b_ms, bound_by=b_by)
    rows["coverage_accept"]["max_abs_err"] = worst
    return rows


def phase_facility_kernels(torch, ref, fm, fa):
    """Facility kernels vs plain versions on the card; returns the JSON
    rows.  Tolerances: ``ref.gemm_gain_tol`` for gains through a similarity
    product (the f32 rounding bound of two evaluations that sum in
    different orders), 2 r 2^-24 times the summed magnitudes for the
    rectified residual sum."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(2)
    rows = {}

    def within(name, got, want, tol):
        err = (got - want).abs()
        check(bool((err <= tol).all()),
              f"{name}: max abs err {err.max().item()} beyond tolerance")
        return err.max().item()

    def repeat(name, fn, first):
        check(torch.equal(fn(), first), f"{name}: a repeated launch differs")

    # -- facility_marginals: shared at the filter shape, unbatched over the
    #    corpus, per-lane at the lazy chunk shape, two odd shapes, and a grid
    #    wider than one CTA's lane group (two groups)
    worst = 0.0
    for label, Lk, C, r, d in (("shared", L, N, R, D), ("unbatched", 1, N, R, D),
                               ("per-lane", L, B, R, D),
                               ("odd shared", 100, 1000, 45, 70),
                               ("odd per-lane", 1, 65, 45, 70),
                               ("odd shared", 130, 1000, 45, 70)):
        per_lane = label.endswith("per-lane")
        unbatched = label == "unbatched"
        for dtype in (torch.float32, torch.bfloat16):
            if label.startswith("odd") and dtype == torch.bfloat16:
                continue
            shape = (Lk, C, d) if per_lane else (C, d)
            cand = (torch.rand(shape, generator=g, device=dev) ** 2).to(dtype)
            Rm = torch.rand((r, d), generator=g, device=dev)
            state = torch.rand((r,) if unbatched else (Lk, r), generator=g,
                               device=dev) * d / 4
            if per_lane or C <= TILE:
                plain = lambda: ref.facility_marginals(cand, Rm, state)  # noqa: E731
            elif unbatched:
                plain = lambda: torch.cat([  # noqa: E731
                    ref.facility_marginals(cand[t:t + TILE], Rm, state)
                    for t in range(0, C, TILE)])
            else:
                # one lane at a time, in row tiles: the plain version's
                # (L, C, r) temporaries would not fit in device memory
                plain = lambda: torch.stack([torch.cat([  # noqa: E731
                    ref.facility_marginals(cand[t:t + TILE], Rm, state[l])
                    for t in range(0, C, TILE)]) for l in range(Lk)])
            got = fm.facility_marginals(cand, Rm, state)
            want = plain()
            torch.cuda.synchronize()
            tol = ref.gemm_gain_tol(cand, Rm)
            err = within(f"facility_marginals {label} {dtype}", got, want,
                         tol if per_lane or unbatched else tol.expand(Lk, C))
            repeat("facility_marginals", lambda: fm.facility_marginals(
                cand, Rm, state), got)
            worst = max(worst, err)
            ms = cuda_ms(lambda: fm.facility_marginals(cand, Rm, state), 10)
            pms = cuda_ms(plain, 1)
            rows_c = Lk * C if per_lane else C
            b_ms, b_by = bound_ms(cand.numel() * cand.element_size()
                                  + r * d * 4 + Lk * r * 4 + Lk * C * 4,
                                  2 * rows_c * r * d + 3 * Lk * C * r)
            line = (f"[kernels] facility_marginals {label} cand{tuple(shape)} "
                    f"ref({r}, {d}) L={Lk} {str(dtype)[6:]}: max_abs_err={err} "
                    f"tol_max={tol.max().item()} kernel_ms={ms} plain_ms={pms} "
                    f"bound_ms={b_ms} ({b_by}) repeat=bitwise")
            if not label.startswith("odd"):
                # one PyTorch call of the product alone (no such call takes
                # the residual sum as well)
                cf = cand.float()
                if per_lane:
                    lib_ms = cuda_ms(lambda: torch.bmm(
                        cf, Rm.T.expand(Lk, d, r)), 10)
                else:
                    lib_ms = cuda_ms(lambda: torch.matmul(cf, Rm.T), 10)
                line += f" library_ms={lib_ms} (torch.matmul of the product)"
            if label == "shared" and dtype == torch.float32:
                rows["facility_marginals"] = dict(ms=ms, plain_ms=pms,
                                                  bound_ms=b_ms, bound_by=b_by,
                                                  library_ms=lib_ms)
            print(line)
    rows["facility_marginals"]["max_abs_err"] = worst
    print(f"[kernels] yardstick: torch.matmul with allow_tf32="
          f"{torch.backends.cuda.matmul.allow_tf32}")

    # -- rectified_residual_sum: unbatched over the corpus (local_top) and
    #    over the sample (max_singleton), the shared sample with 37 lanes
    #    (dense phase 1), per-lane survivors (dense phase 2), the wide
    #    FacilityLocation select's local_top (its 262,144 rows against 8192
    #    reference rows: an 8.6 GB aux), two odd shapes
    worst, card, times = 0.0, smi(), {}
    for label, Lk, C, r in (("unbatched", 1, N, R),
                            ("unbatched sample", 1, S_ROWS, R),
                            ("shared", L, S_ROWS, R),
                            ("per-lane", L, F_ROWS, R),
                            ("unbatched wide", 1, WIDE_SELECTS[2][1],
                             WIDE_SELECTS[2][3]),
                            ("odd shared", 100, 1000, 45),
                            ("odd per-lane", 1, 65, 45)):
        per_lane = label.endswith("per-lane")
        unbatched = label.startswith("unbatched")
        aux = got = want = tol = None  # free the last shape's first
        aux = torch.rand((Lk, C, r) if per_lane else (C, r), generator=g,
                         device=dev).mul_(40)
        state = torch.rand((r,) if unbatched else (Lk, r),
                           generator=g, device=dev) * 40
        if per_lane or unbatched:
            plain = lambda: ref.rectified_residual_sum(aux, state)  # noqa: E731
        else:
            plain = lambda: torch.stack([  # noqa: E731
                ref.rectified_residual_sum(aux, state[l]) for l in range(Lk)])
        got = fm.rectified_residual_sum(aux, state)
        want = plain()
        torch.cuda.synchronize()
        tol = 2 * r * 2.0 ** -24 * (aux.abs().sum(-1)
                                    + state.abs().sum(-1, keepdim=True))
        err = within(f"rectified_residual_sum {label}", got, want, tol)
        repeat("rectified_residual_sum",
               lambda: fm.rectified_residual_sum(aux, state), got)
        worst = max(worst, err)
        ms = cuda_ms(lambda: fm.rectified_residual_sum(aux, state), 10)
        pms = cuda_ms(plain, 1)
        b_ms, b_by = bound_ms(aux.numel() * 4 + state.numel() * 4
                              + Lk * C * 4, 3 * Lk * C * r)
        times[f"{label} {tuple(aux.shape)} L={Lk}"] = dict(ms=ms,
                                                         bound_ms=b_ms)
        line = (f"[kernels] rectified_residual_sum {label} "
                f"aux{tuple(aux.shape)} L={Lk}: max_abs_err={err} "
                f"kernel_ms={ms} plain_ms={pms} bound_ms={b_ms} ({b_by}) "
                f"repeat=bitwise")
        if label == "unbatched":
            rows["rectified_residual_sum"] = dict(ms=ms, plain_ms=pms,
                                                  bound_ms=b_ms, bound_by=b_by)
            # what the card reads at: one PyTorch reduction over the same
            # 1 GiB, a yardstick of the read rate, not the same function
            line += (f"; read-rate yardstick aux.sum(-1) ms "
                     f"{cuda_ms(lambda: aux.sum(-1), 10)}")
        print(f"{line}; card {card}")
    rows["rectified_residual_sum"]["filter_shapes_ms"] = times
    rows["rectified_residual_sum"]["max_abs_err"] = worst

    # -- facility_accept at the fused engine's shape, r = 256 and 1024, and
    #    two odd shapes
    worst = 0.0
    for label, Lk, Bk, r, d in (("path", L, B, R, D), ("wide r", L, B, 1024, D),
                                ("odd L=1", 1, 70, 45, 70),
                                ("odd L=100", 100, B, 45, 70)):
        for dtype in (torch.float32, torch.bfloat16):
            if label.startswith("odd") and dtype == torch.bfloat16:
                continue
            cand = (torch.rand((Lk, Bk, d), generator=g, device=dev) ** 2
                    ).to(dtype)
            Rm = torch.rand((r, d), generator=g, device=dev)
            state = torch.rand((Lk, r), generator=g, device=dev) * d / 4
            elig = torch.rand((Lk, Bk), generator=g, device=dev) < 0.9
            tau = lane_taus(torch, ref.facility_marginals(cand, Rm, state))
            budget = torch.where(torch.arange(Lk, device=dev) % 5 == 0, 3,
                                 K).to(torch.int32)
            got = fa.facility_accept(cand, Rm, state, elig, tau, budget)
            want = ref.facility_accept(cand, Rm, state, elig, tau, budget)
            torch.cuda.synchronize()
            # a gain and the state it is taken against are both sums of
            # similarities: twice the worst row's bound covers them
            lane_tol = 2 * ref.gemm_gain_tol(cand, Rm).amax(-1)
            ties, err = check_sweep(
                "facility_accept", got, want, tau, lane_tol,
                lambda l, a, b, what: bool(((a - b).abs() <= lane_tol[l]).all()))
            again = fa.facility_accept(cand, Rm, state, elig, tau, budget)
            check(all(torch.equal(a, b) for a, b in zip(got, again)),
                  "facility_accept: a repeated launch differs")
            worst = max(worst, err)
            n_acc = int(want[0].sum())
            ms = cuda_ms(lambda: fa.facility_accept(cand, Rm, state, elig, tau,
                                                    budget), 50)
            pms = cuda_ms(lambda: ref.facility_accept(cand, Rm, state, elig,
                                                      tau, budget), 2)
            b_ms, b_by = bound_ms(
                cand.numel() * cand.element_size() + r * d * 4
                + 2 * Lk * r * 4 + Lk * Bk * 6 + Lk * 8,
                2 * Lk * Bk * r * d + 4 * Lk * Bk * r + n_acc * r)
            print(f"[kernels] facility_accept cand({Lk}, {Bk}, {d}) r={r} "
                  f"{str(dtype)[6:]}: max_abs_err={err} near_tau_ties={ties} "
                  f"accepted={n_acc} kernel_ms={ms} plain_ms={pms} "
                  f"bound_ms={b_ms} ({b_by}) repeat=bitwise")
            if label == "path" and dtype == torch.float32:
                rows["facility_accept"] = dict(
                    ms=ms, plain_ms=pms, bound_ms=b_ms, bound_by=b_by,
                    all_accept_ms=all_accept_ms(
                        torch, "facility_accept",
                        lambda tau, budget: fa.facility_accept(
                            cand, Rm, state, elig, tau, budget), elig))
    rows["facility_accept"]["max_abs_err"] = worst
    return rows


def phase_filter_shapes(torch, ref, cm, sm, rows):
    """coverage_marginals and saturated_coverage_marginals at the shapes of
    FILTER_SHAPES, f32, each within RTOL/ATOL of its plain version (a lane
    at a time where the plain temporaries would not fit) and timed; the
    times go into each kernel's row as ``filter_shapes_ms``."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(3)
    X = torch.rand((N, D), generator=g, device=dev) ** 2
    Xs = torch.rand((L, F_ROWS, D), generator=g, device=dev) ** 2
    # saturated states straddle the cap (0, below, at, above it), as in
    # phase_weighted_saturated_kernels
    cap = torch.rand(D, generator=g, device=dev) * 2 + 0.25
    frac = torch.tensor([0.0, 0.5, 0.9, 1.0, 1.5], device=dev)
    for name, kernel, plain in (
            ("coverage_marginals", cm.coverage_marginals,
             ref.coverage_marginals),
            ("saturated_coverage_marginals",
             lambda x, st: sm.saturated_coverage_marginals(x, st, cap),
             lambda x, st: ref.saturated_coverage_marginals(x, st, cap))):
        times = {}
        for label, lanes, C, per_lane in FILTER_SHAPES:
            x = (Xs[:, :C] if C < F_ROWS else Xs) if per_lane else X[:C]
            x = x.contiguous()
            state = (torch.rand((lanes, D), generator=g, device=dev) * 4
                     if name == "coverage_marginals"
                     else frac[torch.randint(0, 5, (lanes, D), generator=g,
                                             device=dev)] * cap)
            if lanes == 1:
                state = state[0]
            got = kernel(x, state)
            torch.cuda.synchronize()
            for l in range(lanes):
                want = plain(x[l] if per_lane else x,
                             state if lanes == 1 else state[l])
                check(torch.allclose(got if lanes == 1 else got[l], want,
                                     rtol=RTOL, atol=ATOL),
                      f"{name} {label}: lane {l} differs from plain")
            check(torch.equal(kernel(x, state), got),
                  f"{name} {label}: a repeated launch differs")
            ms = cuda_ms(lambda: kernel(x, state), 10 if C > B else 50)
            b_ms, b_by = bound_ms(x.numel() * 4 + lanes * D * 4
                                  + lanes * C * 4, 5 * lanes * C * D)
            times[f"{label} ({lanes}, {C}, {D})"] = ms
            print(f"[kernels] {name} {label} x{tuple(x.shape)} L={lanes} "
                  f"f32: kernel_ms={ms} bound_ms={b_ms} ({b_by}) "
                  f"repeat=bitwise")
        rows[name]["filter_shapes_ms"] = times
        # every instance of the walk, f32 and bf16, weighted and not: within
        # RTOL/ATOL of the plain version and bit for bit on a second launch
        for label, lanes, C, per_lane in WALK_INSTANCES:
            for dtype in (torch.float32, torch.bfloat16):
                weighted = dtype == torch.bfloat16
                w = (torch.rand(D, generator=g, device=dev) + 0.5
                     if weighted else None)
                x = (Xs[:lanes, :C] if per_lane else X[:C]).contiguous(
                    ).to(dtype)
                state = (torch.rand((lanes, D), generator=g, device=dev) * 4
                         if name == "coverage_marginals"
                         else frac[torch.randint(0, 5, (lanes, D),
                                                 generator=g, device=dev)]
                         * cap)
                if name == "coverage_marginals":
                    call = lambda: cm.coverage_marginals(  # noqa: E731
                        x, state, w)
                    want = [ref.coverage_marginals(
                        x[l] if per_lane else x, state[l], w)
                        for l in range(lanes)]
                else:
                    call = lambda: sm.saturated_coverage_marginals(  # noqa: E731
                        x, state, cap, w)
                    want = [ref.saturated_coverage_marginals(
                        x[l] if per_lane else x, state[l], cap, w)
                        for l in range(lanes)]
                got = call()
                torch.cuda.synchronize()
                err = max((got[l] - want[l]).abs().max().item()
                          for l in range(lanes))
                check(all(torch.allclose(got[l], want[l], rtol=RTOL,
                                         atol=ATOL) for l in range(lanes)),
                      f"{name} {label} {dtype}: max abs err {err}")
                check(torch.equal(call(), got),
                      f"{name} {label} {dtype}: a repeated launch differs")
                rows[name]["max_abs_err"] = max(rows[name]["max_abs_err"],
                                                err)
            print(f"[kernels] {name} walk instance {label} "
                  f"x({lanes}, {C}, {D}) f32 and bf16 (weighted): within "
                  f"rtol/atol {RTOL} of plain, repeat=bitwise")
    del X, Xs


def phase_weighted_saturated_kernels(torch, ref, wm, wa, sm, sa):
    """WeightedCoverage and SaturatedCoverage kernels vs plain versions on
    the card; returns the JSON rows.  Saturated states straddle the cap:
    0, below it, at it, above it, and just below it so that s + x crosses
    it.  Tolerance rtol/atol 1e-5 (sums over d in another order), and a
    second launch must give the same bits."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(3)
    frac = torch.tensor([0.0, 0.5, 0.9, 1.0, 1.5], device=dev)
    rows = {}

    def with_w(name, weighted):
        return "" if name.startswith("weighted") else f" weighted={weighted}"

    def straddling(shape, cap):
        return (frac[torch.randint(0, 5, shape, generator=g, device=dev)]
                * cap).contiguous()

    def operands(name, d, weighted):
        """(state maker, kernel, plain, per-feature bytes) of ``name``."""
        if name == "weighted_coverage_marginals":
            return ((lambda shape: torch.rand(shape, generator=g, device=dev)
                     * 2),
                    wm.weighted_coverage_marginals,
                    ref.weighted_coverage_marginals, 0)
        cap = torch.rand(d, generator=g, device=dev) * 2 + 0.25
        w = torch.rand(d, generator=g, device=dev) + 0.5 if weighted else None
        return ((lambda shape: straddling(shape, cap)),
                lambda x, st: sm.saturated_coverage_marginals(x, st, cap, w),
                lambda x, st: ref.saturated_coverage_marginals(x, st, cap, w),
                (2 if weighted else 1) * d * 4)

    # -- marginals: shared at the filter shape, unbatched over the corpus
    #    (max singleton, top singletons), per-lane at the lazy chunk shape,
    #    and odd shapes
    for name, n_ops in (("weighted_coverage_marginals", 2),
                        ("saturated_coverage_marginals", 5)):
        worst = 0.0
        for label, Lk, C, d in (("shared", L, N, D), ("unbatched", 1, N, D),
                                ("per-lane", L, B, D),
                                ("odd shared", 130, 1000, 70),
                                ("odd per-lane", 1, 65, 45),
                                ("odd unbatched", 1, 1000, 45)):
            per_lane = label.endswith("per-lane")
            for dtype in (torch.float32, torch.bfloat16):
                weighted = dtype == torch.bfloat16
                make_state, kern, plain_fn, op_bytes = operands(name, d,
                                                                weighted)
                shape = (Lk, C, d) if per_lane else (C, d)
                x = (torch.rand(shape, generator=g, device=dev) ** 2).to(dtype)
                state = make_state((d,) if label.endswith("unbatched")
                                   else (Lk, d))
                if label == "shared":
                    # one lane at a time: the plain version's (L, C, d)
                    # temporaries would not fit in device memory
                    plain = lambda: torch.stack([  # noqa: E731
                        plain_fn(x, state[l]) for l in range(Lk)])
                else:
                    plain = lambda: plain_fn(x, state)  # noqa: E731
                got = kern(x, state)
                want = plain()
                torch.cuda.synchronize()
                err = (got - want).abs().max().item()
                check(torch.allclose(got, want, rtol=RTOL, atol=ATOL),
                      f"{name} {label} {dtype}: max abs err {err}")
                check(torch.equal(kern(x, state), got),
                      f"{name} {label}: a repeated launch differs")
                worst = max(worst, err)
                line = (f"[kernels] {name} {label} x{tuple(shape)} L={Lk} "
                        f"{str(dtype)[6:]}{with_w(name, weighted)}: "
                        f"max_abs_err={err} repeat=bitwise")
                if not label.startswith("odd"):
                    ms = cuda_ms(lambda: kern(x, state), 10)
                    pms = cuda_ms(plain, 2)
                    b_ms, b_by = bound_ms(
                        x.numel() * x.element_size() + state.numel() * 4
                        + op_bytes + Lk * C * 4,
                        n_ops * Lk * C * d + (Lk * d if n_ops == 5 else 0))
                    line += (f" kernel_ms={ms} plain_ms={pms} bound_ms={b_ms} "
                             f"({b_by})")
                    if name == "weighted_coverage_marginals" and not weighted:
                        lib = {"shared": lambda: torch.matmul(x, state.T),
                               "unbatched": lambda: torch.mv(x, state),
                               "per-lane": lambda: torch.bmm(
                                   x, state[:, :, None])}[label]
                        lib_ms = cuda_ms(lib, 10)
                        line += f" library_ms={lib_ms}"
                    if label == "shared" and not weighted:
                        rows[name] = dict(ms=ms, plain_ms=pms, bound_ms=b_ms,
                                          bound_by=b_by)
                        if name == "weighted_coverage_marginals":
                            rows[name]["library_ms"] = lib_ms
                print(line)
        rows[name]["max_abs_err"] = worst
    print(f"[kernels] yardstick: torch.matmul / mv / bmm with allow_tf32="
          f"{torch.backends.cuda.matmul.allow_tf32}")

    # -- weighted_coverage_marginals' shared-x route (graph cut's skinny
    #    tile) on dyadic data (rows a/8, states b/8: every product and sum
    #    exact) at lane counts around its 8-lane groups and 64-lane tiles,
    #    features below, off and on its 32-deep slices, rows past its
    #    256-row items: bit for bit the plain version, twice
    n_dyadic = 0
    for Lk in (2, 8, 37, 40, 64, 65, 130):
        for d, C in ((3, 1001), (45, 257), (256, 1000)):
            for dtype in (torch.float32, torch.bfloat16):
                x = (torch.randint(0, 9, (C, d), generator=g, device=dev)
                     / 8.0).to(dtype)
                state = torch.randint(0, 17, (Lk, d), generator=g,
                                      device=dev) / 8.0
                got = wm.weighted_coverage_marginals(x, state)
                torch.cuda.synchronize()
                check(torch.equal(got, ref.weighted_coverage_marginals(
                          x, state))
                      and torch.equal(got, wm.weighted_coverage_marginals(
                          x, state)),
                      f"weighted_coverage_marginals L={Lk} C={C} d={d} "
                      f"{dtype}: not bit for bit the plain version on dyadic "
                      f"data")
                n_dyadic += 1
    print(f"[kernels] weighted_coverage_marginals on dyadic data at "
          f"{n_dyadic} shapes (L = 2 .. 130, d = 3, 45, 256), f32 and bf16: "
          f"bit for bit the plain version, repeat=bitwise")

    # -- accept sweeps at the fused engine's shape and two odd shapes
    for name in ("weighted_coverage_accept", "saturated_coverage_accept"):
        worst = 0.0
        for label, Lk, Bk, d in (("path", L, B, D), ("odd L=1", 1, 70, 45),
                                 ("odd L=130", 130, B, 70)):
            for dtype in (torch.float32, torch.bfloat16):
                weighted = dtype == torch.bfloat16
                x = (torch.rand((Lk, Bk, d), generator=g, device=dev) ** 2
                     ).to(dtype)
                elig = torch.rand((Lk, Bk), generator=g, device=dev) < 0.9
                if name == "weighted_coverage_accept":
                    state = torch.rand((Lk, d), generator=g, device=dev) * 2
                    kern = lambda: wa.weighted_coverage_accept(  # noqa: E731
                        x, state, elig, tau, budget)
                    plain = lambda: ref.weighted_coverage_accept(  # noqa: E731
                        x, state, elig, tau, budget)
                    g0 = ref.weighted_coverage_marginals(x, state)
                    op_bytes, n_ops, upd = 0, 2, 2
                else:
                    cap = torch.rand(d, generator=g, device=dev) * 2 + 0.25
                    w = (torch.rand(d, generator=g, device=dev) + 0.5
                         if weighted else None)
                    state = straddling((Lk, d), cap)
                    kern = lambda: sa.saturated_coverage_accept(  # noqa: E731
                        x, state, cap, w, elig, tau, budget)
                    plain = lambda: ref.saturated_coverage_accept(  # noqa: E731
                        x, state, cap, w, elig, tau, budget)
                    g0 = ref.saturated_coverage_marginals(x, state, cap, w)
                    op_bytes = (2 if weighted else 1) * d * 4
                    n_ops, upd = 5, 2
                tau = lane_taus(torch, g0)
                budget = torch.where(torch.arange(Lk, device=dev) % 5 == 0, 3,
                                     K).to(torch.int32)
                got, want = kern(), plain()
                torch.cuda.synchronize()
                ties, err = check_sweep(
                    name, got, want, tau, RTOL * tau.abs(),
                    lambda l, a, b, what: torch.allclose(a, b, rtol=RTOL,
                                                         atol=ATOL))
                check(all(torch.equal(a, b) for a, b in zip(got, kern())),
                      f"{name}: a repeated launch differs")
                worst = max(worst, err)
                n_acc = int(want[0].sum())
                line = (f"[kernels] {name} {label} x({Lk}, {Bk}, {d}) "
                        f"{str(dtype)[6:]}{with_w(name, weighted)}: "
                        f"max_abs_err={err} near_tau_ties={ties} "
                        f"accepted={n_acc} repeat=bitwise")
                if label == "path":
                    ms = cuda_ms(kern, 50)
                    pms = cuda_ms(plain, 3)
                    b_ms, b_by = bound_ms(
                        x.numel() * x.element_size() + 2 * Lk * d * 4
                        + op_bytes + Lk * Bk * 6 + Lk * 8,
                        n_ops * Lk * Bk * d + upd * n_acc * d)
                    line += (f" kernel_ms={ms} plain_ms={pms} bound_ms={b_ms} "
                             f"({b_by})")
                    if not weighted:
                        rows[name] = dict(ms=ms, plain_ms=pms, bound_ms=b_ms,
                                          bound_by=b_by)
                print(line)
        rows[name]["max_abs_err"] = worst
    return rows


def graph_cut_tol(x, coef, lam):
    """Per (lane, row) bound on how far two float32 evaluations of a graph
    cut gain may differ when they sum in different orders: each is within
    (d + 2) 2^-24 of the summed term magnitudes,
    sum_f |x_f| |c_f| + lam x_f^2.  x (C, d) or (L, C, d), coef (L, d);
    shapes follow the gains, (L, C)."""
    x = x.float()
    d = x.shape[-1]
    mag = (x.abs() @ coef.abs().T).T if x.dim() == 2 else \
        (x.abs() @ coef.abs().unsqueeze(-1)).squeeze(-1)
    return 2.0 * (d + 2) * 2.0 ** -24 * (mag + lam * (x * x).sum(-1))


def logdet_bases(torch, ref, g, L, k, d, sizes, alpha, dtype):
    """(U (L, k, d), logdet (L,), size (L,)) of lanes that hold ``sizes``
    rows of U[0, 1)^2 rounded to ``dtype``, appended with the plain
    Gram-Schmidt append (rows past a lane's size stay zero)."""
    dev = sizes.device
    rows = torch.stack([
        (torch.rand((L, d), generator=g, device=dev) ** 2).to(dtype).float()
        for _ in range(k)])
    return ref.logdet_basis(rows, sizes, alpha)


def phase_graph_cut_logdet_kernels(torch, ref, gm, ga, lm, la):
    """GraphCut and log-det kernels vs plain versions on the card; returns
    the JSON rows.  GraphCut states put 2 lam s between 0 and 1.2 t, so the
    redundancy term cancels part or all of the linear one; tolerance
    ``graph_cut_tol`` for gains, states bitwise (the same f32 adds).  Log-det
    bases hold 0 rows, some, and k (full), and a sweep's appends run into
    k_max; tolerance rtol 1e-5 / atol 1e-4 (the JAX package's own for
    log-det gains) for gains, logdet and U.  Every kernel must also give the
    same bits when launched twice."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(4)
    lam, alpha = 0.5, 1.0
    LD_RTOL, LD_ATOL = 1e-5, 1e-4
    rows = {}

    def lane_sizes(Lk, k):
        s = (torch.arange(Lk, device=dev) * 13) % (k + 1)
        s[:2] = torch.tensor([0, k], device=dev)[:Lk]
        return s.to(torch.int32)

    def gc_states(Lk, t, lam=lam):
        # lam = 0 has no redundancy term: lam 0.5's states then
        frac = torch.rand((Lk, 1), generator=g, device=dev) * 1.2
        return (t * frac / (2 * (lam or 0.5))).contiguous()

    # -- graph_cut_marginals: shared at the filter shape, unbatched over the
    #    corpus (max singleton, top singletons), per-lane at the lazy chunk
    #    shape, odd shapes
    worst = 0.0
    for label, Lk, C, d in (("shared", L, N, D), ("unbatched", 1, N, D),
                            ("per-lane", L, B, D),
                            ("odd shared", 130, 1000, 70),
                            ("odd per-lane", 1, 65, 45),
                            ("odd unbatched", 1, 1000, 45)):
        per_lane = label.endswith("per-lane")
        for dtype in (torch.float32, torch.bfloat16):
            shape = (Lk, C, d) if per_lane else (C, d)
            x = (torch.rand(shape, generator=g, device=dev) ** 2).to(dtype)
            # the ground set's sum at full width; a sum of that size else
            t = (x.float().sum(0) if x.dim() == 2 and C == N else
                 torch.rand(d, generator=g, device=dev) * N / 3).contiguous()
            state = gc_states(Lk, t)
            if label.endswith("unbatched"):
                state = state[0].contiguous()
            coef = t - 2.0 * lam * state.reshape(-1, d)
            got = gm.graph_cut_marginals(x, t, state, lam)
            want = ref.graph_cut_marginals(x, t, state, lam)
            torch.cuda.synchronize()
            tol = graph_cut_tol(x, coef, lam).reshape(got.shape)
            err = (got - want).abs()
            check(bool((err <= tol).all()),
                  f"graph_cut_marginals {label} {dtype}: max abs err "
                  f"{err.max().item()} beyond tolerance")
            check(torch.equal(gm.graph_cut_marginals(x, t, state, lam), got),
                  f"graph_cut_marginals {label}: a repeated launch differs")
            worst = max(worst, err.max().item())
            line = (f"[kernels] graph_cut_marginals {label} x{tuple(shape)} "
                    f"L={Lk} {str(dtype)[6:]}: max_abs_err={err.max().item()} "
                    f"tol_max={tol.max().item()} "
                    f"min_gain={want.min().item()} repeat=bitwise")
            if not label.startswith("odd"):
                ms = cuda_ms(lambda: gm.graph_cut_marginals(x, t, state, lam),
                             10)
                pms = cuda_ms(lambda: ref.graph_cut_marginals(x, t, state,
                                                              lam), 2)
                b_ms, b_by = bound_ms(
                    x.numel() * x.element_size() + state.numel() * 4 + d * 4
                    + Lk * C * 4,
                    2 * Lk * C * d + 2 * (Lk if per_lane else 1) * C * d
                    + Lk * C + 2 * Lk * d)
                xf = x.float()
                lib = {"shared": lambda: torch.matmul(xf, coef.T),
                       "unbatched": lambda: torch.mv(xf, coef[0]),
                       "per-lane": lambda: torch.bmm(
                           xf, coef[:, :, None])}[label]
                lib_ms = cuda_ms(lib, 10)
                line += (f" kernel_ms={ms} plain_ms={pms} bound_ms={b_ms} "
                         f"({b_by}) library_ms={lib_ms}")
                if label == "shared" and dtype == torch.float32:
                    rows["graph_cut_marginals"] = dict(
                        ms=ms, plain_ms=pms, bound_ms=b_ms, bound_by=b_by,
                        library_ms=lib_ms)
            print(line)
    rows["graph_cut_marginals"]["max_abs_err"] = worst

    # -- graph_cut_marginals' shared-x tile on dyadic data (rows a/8, a
    #    dyadic total, states with 2 lam s a quarter-multiple of it, lam
    #    0.5: every product and sum is exact) at lane counts around its
    #    8-lane groups and 64-lane tiles, features below, off and on its
    #    32-deep slices, rows past its 256-row items: bit for bit the plain
    #    version, twice
    n_dyadic = 0
    for Lk in (2, 8, 37, 40, 64, 65, 130):
        for d, C in ((3, 1001), (45, 257), (256, 1000)):
            for dtype in (torch.float32, torch.bfloat16):
                x = (torch.randint(0, 9, (C, d), generator=g, device=dev)
                     / 8.0).to(dtype)
                t = torch.randint(0, 64, (d,), generator=g, device=dev) / 2.0
                state = (t * torch.randint(0, 6, (Lk, 1), generator=g,
                                           device=dev) / 4.0).contiguous()
                got = gm.graph_cut_marginals(x, t, state, lam)
                torch.cuda.synchronize()
                check(torch.equal(got, ref.graph_cut_marginals(x, t, state,
                                                               lam))
                      and torch.equal(got, gm.graph_cut_marginals(
                          x, t, state, lam)),
                      f"graph_cut_marginals L={Lk} C={C} d={d} {dtype}: not "
                      f"bit for bit the plain version on dyadic data")
                n_dyadic += 1
    print(f"[kernels] graph_cut_marginals on dyadic data at {n_dyadic} "
          f"shapes (L = 2 .. 130, d = 3, 45, 256), f32 and bf16: bit for "
          f"bit the plain version, repeat=bitwise")

    # -- graph_cut_accept at the fused engine's shape and odd shapes
    worst = 0.0
    for label, Lk, Bk, d in (("path", L, B, D), ("odd L=1", 1, 70, 45),
                             ("odd L=130", 130, B, 70)):
        for dtype in (torch.float32, torch.bfloat16):
            x = (torch.rand((Lk, Bk, d), generator=g, device=dev) ** 2
                 ).to(dtype)
            t = (torch.rand(d, generator=g, device=dev) * N / 3).contiguous()
            state = gc_states(Lk, t)
            elig = torch.rand((Lk, Bk), generator=g, device=dev) < 0.9
            tau = lane_taus(torch, ref.graph_cut_marginals(x, t, state, lam))
            budget = torch.where(torch.arange(Lk, device=dev) % 5 == 0, 3,
                                 K).to(torch.int32)
            kern = lambda: ga.graph_cut_accept(  # noqa: E731
                x, t, state, elig, tau, budget, lam)
            plain = lambda: ref.graph_cut_accept(  # noqa: E731
                x, t, state, elig, tau, budget, lam)
            got, want = kern(), plain()
            torch.cuda.synchronize()
            # a gain taken against a state that has grown by accepted rows:
            # the same bound at the largest state of the sweep
            lane_tol = graph_cut_tol(
                x, t + 2 * lam * (state + x.float().sum(1)), lam).amax(-1)
            ties, err = check_sweep(
                "graph_cut_accept", got, want, tau, lane_tol,
                lambda l, a, b, what: (torch.equal(a, b) if what == "state"
                                       else bool(((a - b).abs()
                                                  <= lane_tol[l]).all())))
            check(all(torch.equal(a, b) for a, b in zip(got, kern())),
                  "graph_cut_accept: a repeated launch differs")
            worst = max(worst, err)
            n_acc = int(want[0].sum())
            line = (f"[kernels] graph_cut_accept {label} x({Lk}, {Bk}, {d}) "
                    f"{str(dtype)[6:]}: max_abs_err={err} near_tau_ties={ties} "
                    f"accepted={n_acc} repeat=bitwise")
            if label == "path":
                ms = cuda_ms(kern, 50)
                pms = cuda_ms(plain, 3)
                b_ms, b_by = bound_ms(
                    x.numel() * x.element_size() + 2 * Lk * d * 4 + d * 4
                    + Lk * Bk * 6 + Lk * 8,
                    5 * Lk * Bk * d + 3 * n_acc * d)
                line += (f" kernel_ms={ms} plain_ms={pms} bound_ms={b_ms} "
                         f"({b_by})")
                if dtype == torch.float32:
                    rows["graph_cut_accept"] = dict(ms=ms, plain_ms=pms,
                                                    bound_ms=b_ms,
                                                    bound_by=b_by)
            print(line)
    rows["graph_cut_accept"]["max_abs_err"] = worst

    # -- the query axis's other lam (QUERY_LAMS; at lam = 0 the gain is the
    #    plain dot product <x, t>): graph_cut_marginals at the shared filter
    #    shape and graph_cut_accept at the fused engine's, f32, with the
    #    tolerances above
    for q_lam in QUERY_LAMS[1:]:
        x = torch.rand((N, D), generator=g, device=dev) ** 2
        t = x.sum(0).contiguous()
        state = gc_states(L, t, q_lam)
        got = gm.graph_cut_marginals(x, t, state, q_lam)
        want = ref.graph_cut_marginals(x, t, state, q_lam)
        torch.cuda.synchronize()
        tol = graph_cut_tol(x, t - 2.0 * q_lam * state, q_lam)
        err_m = (got - want).abs()
        err_m, tol_m = err_m.max().item(), tol.max().item()
        check(bool(((got - want).abs() <= tol.reshape(got.shape)).all()),
              f"graph_cut_marginals shared lam={q_lam}: max abs err "
              f"{err_m} beyond tolerance")
        del x, got, want, tol
        x = torch.rand((L, B, D), generator=g, device=dev) ** 2
        t = (torch.rand(D, generator=g, device=dev) * N / 3).contiguous()
        state = gc_states(L, t, q_lam)
        elig = torch.rand((L, B), generator=g, device=dev) < 0.9
        tau = lane_taus(torch, ref.graph_cut_marginals(x, t, state, q_lam))
        budget = torch.where(torch.arange(L, device=dev) % 5 == 0, 3,
                             K).to(torch.int32)
        got = ga.graph_cut_accept(x, t, state, elig, tau, budget, q_lam)
        want = ref.graph_cut_accept(x, t, state, elig, tau, budget, q_lam)
        torch.cuda.synchronize()
        lane_tol = graph_cut_tol(
            x, t + 2 * q_lam * (state + x.sum(1)), q_lam).amax(-1)
        ties, err_a = check_sweep(
            f"graph_cut_accept lam={q_lam}", got, want, tau, lane_tol,
            lambda l, a, b, what: (torch.equal(a, b) if what == "state"
                                   else bool(((a - b).abs()
                                              <= lane_tol[l]).all())))
        print(f"[kernels] graph_cut lam={q_lam} float32: marginals shared "
              f"x({N}, {D}) L={L} max_abs_err={err_m} tol_max={tol_m}; "
              f"accept x({L}, {B}, {D}) max_abs_err={err_a} "
              f"near_tau_ties={ties} accepted={int(want[0].sum())}")
        for name, err in (("graph_cut_marginals", err_m),
                          ("graph_cut_accept", err_a)):
            rows[name]["max_abs_err"] = max(rows[name]["max_abs_err"], err)

    def ld_close(a, b):
        return torch.allclose(a, b, rtol=LD_RTOL, atol=LD_ATOL)

    # -- logdet_marginals: shared at the filter shape at the lanes' sizes
    #    (974 of 2368 basis rows live) and full, unbatched over the corpus
    #    full and empty (the singleton passes), per-lane at the lazy chunk
    #    shape; odd shapes with k = 1, 7 and 100 (a lane's rows cross the
    #    128-column tiles) and 300 lanes (two lane groups); scale 1 and 0.5.
    #    Every call passes the lanes' sizes, and must give the bits of the
    #    same call without them (the rows past size are zero).
    worst = 0.0
    for label, Lk, C, d, k, kind in (
            ("shared", L, N, D, K, "lanes"), ("shared full", L, N, D, K, "full"),
            ("unbatched", 1, N, D, K, "full"),
            ("unbatched empty", 1, N, D, K, "empty"),
            ("per-lane", L, B, D, K, "lanes"),
            ("odd shared", 130, 1000, 70, 7, "lanes"),
            ("odd shared", 130, 1000, 45, 1, "lanes"),
            ("odd shared", 5, 1000, 70, 100, "lanes"),
            ("odd shared", 300, 1000, 45, 7, "lanes"),
            ("odd per-lane", 3, 65, 45, 7, "lanes"),
            ("odd unbatched", 1, 1000, 45, 1, "full")):
        per_lane = label.endswith("per-lane")
        unbatched = "unbatched" in label
        for dtype in (torch.float32, torch.bfloat16):
            scale = 1.0 if dtype == torch.float32 else 0.5
            shape = (Lk, C, d) if per_lane else (C, d)
            x = (torch.rand(shape, generator=g, device=dev) ** 2).to(dtype)
            sizes = {"lanes": lane_sizes(Lk, k),
                     "full": torch.full((Lk,), k, dtype=torch.int32,
                                        device=dev),
                     "empty": torch.zeros(Lk, dtype=torch.int32,
                                          device=dev)}[kind]
            U, _, sz = logdet_bases(torch, ref, g, Lk, k, d, sizes, alpha,
                                    dtype)
            if unbatched:
                U, sz = U[0].contiguous(), sz[0]
            if label.startswith("shared"):
                # one lane at a time: the plain version's (L, C, k)
                # projection would take 10 GB
                plain = lambda: torch.stack([  # noqa: E731
                    ref.logdet_marginals(x, U[l], alpha, scale=scale,
                                         size=sz[l])
                    for l in range(Lk)])
            else:
                plain = lambda: ref.logdet_marginals(  # noqa: E731
                    x, U, alpha, scale=scale, size=sz)
            got = lm.logdet_marginals(x, U, alpha, scale, sz)
            want = plain()
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            check(ld_close(got, want), f"logdet_marginals {label} k={k} "
                  f"{dtype}: max abs err {err}")
            check(torch.equal(lm.logdet_marginals(x, U, alpha, scale, sz),
                              got),
                  f"logdet_marginals {label}: a repeated launch differs")
            check(torch.equal(lm.logdet_marginals(x, U, alpha, scale), got),
                  f"logdet_marginals {label}: the call without sizes gives "
                  f"other bits")
            worst = max(worst, err)
            n_live = int(sz.clamp(0, k).sum())
            line = (f"[kernels] logdet_marginals {label} x{tuple(shape)} "
                    f"L={Lk} k={k} live_rows={n_live} {str(dtype)[6:]} "
                    f"scale={scale}: max_abs_err={err} gains=["
                    f"{want.min().item()}, {want.max().item()}] "
                    f"repeat=bitwise without_sizes=bitwise")
            if not label.startswith("odd"):
                ms = cuda_ms(lambda: lm.logdet_marginals(x, U, alpha, scale,
                                                         sz), 5)
                pms = cuda_ms(plain, 2)
                rows_c = Lk * C if per_lane or U.dim() == 3 else C
                x_ops = 2 * (Lk if per_lane else 1) * C * d + 6 * rows_c
                x_bytes = x.numel() * x.element_size() + got.numel() * 4
                # the rows the kernel multiplies, and every row of U
                b_ms, b_by = bound_ms(x_bytes + n_live * d * 4,
                                      2 * C * n_live * (d + 1) + x_ops)
                b_all, b_all_by = bound_ms(
                    x_bytes + U.numel() * 4,
                    2 * rows_c * k * (d + 1) + x_ops)
                xf = x.float()
                lib = {"shared": lambda: torch.matmul(
                           xf, U.reshape(-1, d).T),
                       "unbatched": lambda: torch.matmul(xf, U.T),
                       "per-lane": lambda: torch.bmm(
                           xf, U.transpose(1, 2))}[label.split()[0]]
                lib_all = cuda_ms(lib, 5)
                lib_live = None
                if not per_lane and n_live:
                    # the live rows gathered once, outside the timing
                    live = (torch.arange(k, device=dev)
                            < sz.reshape(-1, 1)).reshape(-1)
                    Uc = U.reshape(-1, d)[live].contiguous()
                    lib_live = cuda_ms(lambda: torch.matmul(xf, Uc.T), 5)
                line += (f" kernel_ms={ms} plain_ms={pms} bound_ms={b_ms} "
                         f"({b_by}, live rows) bound_all_rows_ms={b_all} "
                         f"({b_all_by}) library_ms={lib_live} (live rows) "
                         f"library_all_rows_ms={lib_all}")
                if label == "shared" and dtype == torch.float32:
                    rows["logdet_marginals"] = dict(
                        ms=ms, plain_ms=pms, bound_ms=b_ms, bound_by=b_by,
                        library_ms=lib_live, bound_all_rows_ms=b_all,
                        library_all_rows_ms=lib_all)
            print(line)
    rows["logdet_marginals"]["max_abs_err"] = worst
    print(f"[kernels] yardstick: torch.matmul / mv / bmm with allow_tf32="
          f"{torch.backends.cuda.matmul.allow_tf32}")

    # -- logdet_accept at the fused engine's shape and odd shapes; lanes at
    #    size k - 2 with budget k run their appends into k_max
    worst = 0.0
    for label, Lk, Bk, d, k in (("path", L, B, D, K), ("odd L=1", 1, 70, 45, 7),
                                ("odd L=130", 130, B, 70, 1),
                                ("odd k=7", 9, B, 45, 7)):
        for dtype in (torch.float32, torch.bfloat16):
            scale = 1.0 if dtype == torch.float32 else 0.5
            x = (torch.rand((Lk, Bk, d), generator=g, device=dev) ** 2
                 ).to(dtype)
            sizes = lane_sizes(Lk, k)
            sizes[2::3] = max(k - 2, 0)
            U, ld, sz = logdet_bases(torch, ref, g, Lk, k, d, sizes, alpha,
                                     dtype)
            elig = torch.rand((Lk, Bk), generator=g, device=dev) < 0.9
            tau = lane_taus(torch, ref.logdet_marginals(x, U, alpha,
                                                        scale=scale))
            tau[2::3] = 0.0   # accept every eligible row: run into k_max
            budget = torch.where(torch.arange(Lk, device=dev) % 5 == 0, 3,
                                 K).to(torch.int32)
            kern = lambda: la.logdet_accept(  # noqa: E731
                x, U, ld, sz, elig, tau, budget, alpha, scale)
            plain = lambda: ref.logdet_accept(  # noqa: E731
                x, U, ld, sz, elig, tau, budget, alpha, scale=scale)
            got, want = kern(), plain()
            torch.cuda.synchronize()
            near = LD_ATOL + LD_RTOL * tau.abs()
            ties, err = check_sweep(
                "logdet_accept", (got[0], got[1], got[4]),
                (want[0], want[1], want[4]), tau, near,
                lambda l, a, b, what: ld_close(a, b))
            same = (got[0] == want[0]).all(-1)
            check(torch.equal(got[3][same], want[3][same])
                  and ld_close(got[2][same], want[2][same]),
                  "logdet_accept: logdet or size differ")
            full = want[3] > k   # appends were dropped at k_max
            check(Lk < 3 or bool((full & same).any()),
                  "logdet_accept: no lane ran its appends into k_max")
            check(all(torch.equal(a, b) for a, b in zip(got, kern())),
                  "logdet_accept: a repeated launch differs")
            worst = max(worst, err)
            n_acc = int(want[0].sum())
            line = (f"[kernels] logdet_accept {label} x({Lk}, {Bk}, {d}) "
                    f"k={k} {str(dtype)[6:]} scale={scale}: max_abs_err={err} "
                    f"near_tau_ties={ties} accepted={n_acc} "
                    f"lanes_past_k_max={int(full.sum())} repeat=bitwise")
            if label == "path":
                ms = cuda_ms(kern, 50)
                pms = cuda_ms(plain, 3)
                # live rows of U at each scanned row, from the plain sweep
                before = want[0].to(torch.int64).cumsum(1) - want[0].long()
                live = (sz[:, None].long() + before).clamp(max=k)
                n_ops = int((2 * d * live + 2 * d + 2 * live).sum()
                            + (want[0] * (2 * d * live + 3 * d)).sum())
                b_ms, b_by = bound_ms(
                    x.numel() * x.element_size() + 2 * U.numel() * 4
                    + Lk * 16 + Lk * Bk * 6 + Lk * 8, n_ops)
                line += (f" kernel_ms={ms} plain_ms={pms} bound_ms={b_ms} "
                         f"({b_by})")
                if dtype == torch.float32:
                    rows["logdet_accept"] = dict(ms=ms, plain_ms=pms,
                                                 bound_ms=b_ms, bound_by=b_by)
            print(line)

    # -- logdet_accept's narrow instance (projections formed up front, a
    #    walk that reduces only on accept) against the first port's row
    #    loop, the wide instance forced at the same shape: the same bits in
    #    mask, basis, logdet, size and gains; and against the plain sweep
    #    with the tie rule.  Lanes start at sizes 0, 1, k - 1 and k, every
    #    fourth takes tau = 0 (every eligible row, into k_max), every fifth
    #    budget 3, even lanes a cost budget of 6 in the cost mode; at the
    #    path shape, B = 70 and B = 1, 130 lanes and one, k = 7 on d = 45,
    #    and 300 rows (three row blocks), both modes, f32 and bf16
    n_loop, instance = 0, la.instance
    for label, Lk, Bk, d, k in (("path", L, B, D, K), ("B=70", L, 70, D, K),
                                ("B=1", L, 1, D, K), ("L=130", 130, B, D, K),
                                ("L=1", 1, B, D, K), ("k=7", 9, B, 45, 7),
                                ("B=300", 9, 300, 45, 7)):
        for dtype in (torch.float32, torch.bfloat16):
            for mode in ("cardinality", "cost"):
                x = (torch.rand((Lk, Bk, d), generator=g, device=dev) ** 2
                     ).to(dtype)
                lanes = torch.arange(Lk, device=dev)
                sizes = torch.tensor([0, 1, k - 1, k],
                                     device=dev)[lanes % 4].to(torch.int32)
                U, ld, sz = logdet_bases(torch, ref, g, Lk, k, d, sizes,
                                         alpha, dtype)
                elig = torch.rand((Lk, Bk), generator=g, device=dev) < 0.9
                tau = lane_taus(torch, ref.logdet_marginals(x, U, alpha,
                                                            size=sz))
                tau[lanes % 4 == 3] = 0.0
                budget = torch.where(lanes % 5 == 2, 3, Bk).to(torch.int32)
                cost = cb = None
                if mode == "cost":
                    cost = (0.5 + 1.5 * torch.rand((Lk, Bk), generator=g,
                                                   device=dev)).contiguous()
                    cb = torch.where(lanes % 2 == 0, 6.0, 1e9).to(dev)
                args = (x, U, ld, sz, elig, tau, budget, alpha, 1.0, cost,
                        cb)
                got = la.logdet_accept(*args)
                la.instance = lambda k, d: "global"
                try:
                    loop = la.logdet_accept(*args)
                finally:
                    la.instance = instance
                torch.cuda.synchronize()
                check(all(torch.equal(a, b) for a, b in zip(got, loop)),
                      f"logdet_accept {label} {mode} {dtype}: the narrow "
                      f"instance does not give the row loop's bits")
                want = ref.logdet_accept(x, U, ld, sz, elig, tau, budget,
                                         alpha, cost=cost, cost_budget=cb)
                thr = tau if cost is None else tau[:, None] * cost
                near = LD_ATOL + LD_RTOL * thr.abs().reshape(Lk, -1).amax(-1)
                ties, err = check_sweep(
                    f"logdet_accept {label} {mode}", (got[0], got[1], got[4]),
                    (want[0], want[1], want[4]), thr, near,
                    lambda l, a, b, what: ld_close(a, b))
                worst = max(worst, err)
                n_loop += 1
                print(f"[kernels] logdet_accept {label} x({Lk}, {Bk}, {d}) "
                      f"k={k} {str(dtype)[6:]} {mode}: the row loop's bits; "
                      f"max_abs_err={err} near_tau_ties={ties} "
                      f"accepted={int(got[0].sum())} "
                      f"lanes_past_k_max={int((got[3] > k).sum())}")
    print(f"[kernels] logdet_accept: the narrow instance gives the row "
          f"loop's bits in all {n_loop} cases")
    rows["logdet_accept"]["max_abs_err"] = worst

    # -- the query axis's other alpha (QUERY_ALPHAS; alpha scales the Schur
    #    terms): logdet_marginals at the shared filter shape at the lanes'
    #    sizes and logdet_accept at the fused engine's, f32, with the
    #    tolerances above
    for q_alpha in QUERY_ALPHAS[1:]:
        x = torch.rand((N, D), generator=g, device=dev) ** 2
        U, _, sz = logdet_bases(torch, ref, g, L, K, D, lane_sizes(L, K),
                                q_alpha, torch.float32)
        got = lm.logdet_marginals(x, U, q_alpha, 1.0, sz)
        want = torch.stack([ref.logdet_marginals(x, U[l], q_alpha,
                                                 size=sz[l])
                            for l in range(L)])
        torch.cuda.synchronize()
        err_m = (got - want).abs().max().item()
        check(ld_close(got, want), f"logdet_marginals shared alpha={q_alpha}: "
              f"max abs err {err_m}")
        del x, got, want
        x = torch.rand((L, B, D), generator=g, device=dev) ** 2
        sizes = lane_sizes(L, K)
        sizes[2::3] = K - 2
        U, ld, sz = logdet_bases(torch, ref, g, L, K, D, sizes, q_alpha,
                                 torch.float32)
        elig = torch.rand((L, B), generator=g, device=dev) < 0.9
        tau = lane_taus(torch, ref.logdet_marginals(x, U, q_alpha))
        tau[2::3] = 0.0   # accept every eligible row: run into k_max
        budget = torch.where(torch.arange(L, device=dev) % 5 == 0, 3,
                             K).to(torch.int32)
        got = la.logdet_accept(x, U, ld, sz, elig, tau, budget, q_alpha, 1.0)
        want = ref.logdet_accept(x, U, ld, sz, elig, tau, budget, q_alpha)
        torch.cuda.synchronize()
        ties, err_a = check_sweep(
            f"logdet_accept alpha={q_alpha}", (got[0], got[1], got[4]),
            (want[0], want[1], want[4]), tau, LD_ATOL + LD_RTOL * tau.abs(),
            lambda l, a, b, what: ld_close(a, b))
        same = (got[0] == want[0]).all(-1)
        check(torch.equal(got[3][same], want[3][same])
              and ld_close(got[2][same], want[2][same]),
              f"logdet_accept alpha={q_alpha}: logdet or size differ")
        print(f"[kernels] logdet alpha={q_alpha} float32: marginals shared "
              f"x({N}, {D}) L={L} k={K} max_abs_err={err_m}; accept "
              f"x({L}, {B}, {D}) max_abs_err={err_a} near_tau_ties={ties} "
              f"accepted={int(want[0].sum())} "
              f"lanes_past_k_max={int((want[3] > K).sum())}")
        for name, err in (("logdet_marginals", err_m),
                          ("logdet_accept", err_a)):
            rows[name]["max_abs_err"] = max(rows[name]["max_abs_err"], err)
    return rows


def phase_exemplar_kernels(torch, ref, em, ea):
    """ExemplarClustering kernels vs plain versions on the card; returns the
    JSON rows.  Candidates and references are U[0, 1) (the distances'
    three terms nearly cancel: ||r||^2 ~ 85, 2 <c, r> ~ 128, ||c||^2 ~ 85
    at d = 256), states m0 = ||r||^2 times U[0, 1) (a min-distance vector
    never exceeds m0).  Tolerance ``ref.exemplar_gain_tol`` for gains (the
    f32 rounding bound of two evaluations of the three-term distance,
    summed over r), twice its worst row for a sweep's gains and state.
    Every kernel must give the same bits when launched twice."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(5)
    rows = {}

    def inputs(shape_c, r, d, dtype, lanes):
        cand = torch.rand(shape_c + (d,), generator=g, device=dev).to(dtype)
        Rm = torch.rand((r, d), generator=g, device=dev).to(dtype)
        m0 = (Rm.float() ** 2).sum(-1)
        frac = torch.rand((lanes, r) if lanes else (r,), generator=g,
                          device=dev)
        return cand, Rm, (m0 * frac).contiguous()

    # -- exemplar_marginals: shared at the filter shape, unbatched over the
    #    corpus (max singleton, top singletons), per-lane at the lazy chunk
    #    shape; ragged d = 45, 70 and r = 100, 300; L = 1 and 130
    worst = 0.0
    for label, Lk, C, r, d in (("shared", L, N, R, D), ("unbatched", 1, N, R, D),
                               ("per-lane", L, B, R, D),
                               ("odd shared", 130, 1000, 100, 45),
                               ("odd shared", 100, 1000, 300, 70),
                               ("odd per-lane", 1, 65, 100, 70)):
        per_lane = label.endswith("per-lane")
        unbatched = label == "unbatched"
        for dtype in (torch.float32, torch.bfloat16):
            if label.startswith("odd") and dtype == torch.bfloat16:
                continue
            cand, Rm, state = inputs((Lk, C) if per_lane else (C,), r, d,
                                     dtype, None if unbatched else Lk)
            if per_lane or C <= TILE:
                plain = lambda: ref.exemplar_marginals(cand, Rm, state)  # noqa: E731
            elif unbatched:
                plain = lambda: torch.cat([  # noqa: E731
                    ref.exemplar_marginals(cand[t:t + TILE], Rm, state)
                    for t in range(0, C, TILE)])
            else:
                # one lane at a time, in row tiles: the plain version's
                # (L, C, r) temporaries would not fit in device memory
                plain = lambda: torch.stack([torch.cat([  # noqa: E731
                    ref.exemplar_marginals(cand[t:t + TILE], Rm, state[l])
                    for t in range(0, C, TILE)]) for l in range(Lk)])
            got = em.exemplar_marginals(cand, Rm, state)
            want = plain()
            torch.cuda.synchronize()
            tol = ref.exemplar_gain_tol(cand, Rm)
            if label.endswith("shared"):
                tol = tol.expand(Lk, C)
            err = (got - want).abs()
            check(bool((err <= tol).all()),
                  f"exemplar_marginals {label} {dtype}: max abs err "
                  f"{err.max().item()} beyond tolerance")
            check(torch.equal(em.exemplar_marginals(cand, Rm, state), got),
                  "exemplar_marginals: a repeated launch differs")
            worst = max(worst, err.max().item())
            line = (f"[kernels] exemplar_marginals {label} cand"
                    f"{tuple(cand.shape)} ref({r}, {d}) L={Lk} "
                    f"{str(dtype)[6:]}: max_abs_err={err.max().item()} "
                    f"tol_max={tol.max().item()} repeat=bitwise")
            if not label.startswith("odd"):
                ms = cuda_ms(lambda: em.exemplar_marginals(cand, Rm, state),
                             10)
                pms = cuda_ms(plain, 1)
                rows_c = Lk * C if per_lane else C
                b_ms, b_by = bound_ms(
                    cand.numel() * cand.element_size() + r * d * 4 + r * 4
                    + state.numel() * 4 + got.numel() * 4,
                    2 * rows_c * r * d + 4 * rows_c * r + 2 * rows_c * d
                    + 3 * Lk * C * r)
                cf, rf = cand.float(), Rm.float()
                lib_ms = cuda_ms(lambda: torch.matmul(cf, rf.T), 10)
                line += (f" kernel_ms={ms} plain_ms={pms} bound_ms={b_ms} "
                         f"({b_by}) library_ms={lib_ms} (torch.matmul of the "
                         f"product)")
                if label == "shared" and dtype == torch.float32:
                    rows["exemplar_marginals"] = dict(
                        ms=ms, plain_ms=pms, bound_ms=b_ms, bound_by=b_by,
                        library_ms=lib_ms)
            print(line)
    rows["exemplar_marginals"]["max_abs_err"] = worst

    # -- exemplar_accept at the fused engine's shape, r = 256 and 1024, and
    #    ragged shapes
    worst = 0.0
    for label, Lk, Bk, r, d in (("path", L, B, R, D), ("wide r", L, B, 1024, D),
                                ("odd L=1", 1, 70, 100, 70),
                                ("odd L=100", 100, B, 300, 45)):
        for dtype in (torch.float32, torch.bfloat16):
            if label.startswith("odd") and dtype == torch.bfloat16:
                continue
            cand, Rm, state = inputs((Lk, Bk), r, d, dtype, Lk)
            elig = torch.rand((Lk, Bk), generator=g, device=dev) < 0.9
            tau = lane_taus(torch, ref.exemplar_marginals(cand, Rm, state))
            budget = torch.where(torch.arange(Lk, device=dev) % 5 == 0, 3,
                                 K).to(torch.int32)
            kern = lambda: ea.exemplar_accept(  # noqa: E731
                cand, Rm, state, elig, tau, budget)
            plain = lambda: ref.exemplar_accept(  # noqa: E731
                cand, Rm, state, elig, tau, budget)
            got, want = kern(), plain()
            torch.cuda.synchronize()
            lane_tol = 2 * ref.exemplar_gain_tol(cand, Rm).amax(-1)
            ties, err = check_sweep(
                "exemplar_accept", got, want, tau, lane_tol,
                lambda l, a, b, what: bool(((a - b).abs()
                                            <= lane_tol[l]).all()))
            check(all(torch.equal(a, b) for a, b in zip(got, kern())),
                  "exemplar_accept: a repeated launch differs")
            worst = max(worst, err)
            n_acc = int(want[0].sum())
            line = (f"[kernels] exemplar_accept cand({Lk}, {Bk}, {d}) r={r} "
                    f"{str(dtype)[6:]}: max_abs_err={err} near_tau_ties={ties} "
                    f"accepted={n_acc} repeat=bitwise")
            if label == "path":
                ms = cuda_ms(kern, 50)
                pms = cuda_ms(plain, 2)
                b_ms, b_by = bound_ms(
                    cand.numel() * cand.element_size() + r * d * 4 + r * 4
                    + 2 * Lk * r * 4 + Lk * Bk * 6 + Lk * 8,
                    2 * Lk * Bk * r * d + 7 * Lk * Bk * r + 2 * Lk * Bk * d
                    + n_acc * r)
                line += (f" kernel_ms={ms} plain_ms={pms} bound_ms={b_ms} "
                         f"({b_by})")
                if dtype == torch.float32:
                    rows["exemplar_accept"] = dict(
                        ms=ms, plain_ms=pms, bound_ms=b_ms, bound_by=b_by,
                        all_accept_ms=all_accept_ms(
                            torch, "exemplar_accept",
                            lambda tau, budget: ea.exemplar_accept(
                                cand, Rm, state, elig, tau, budget), elig))
            print(line)
    rows["exemplar_accept"]["max_abs_err"] = worst
    return rows


def sweep_cases(torch, ref, sweeps, g, names, dtype=None, d=D, r=R, k=K,
                d_ref=D, d_ld=D):
    """The accept sweeps ``names`` on L = 37 lanes of B = 128 rows, each as
    (kernel, plain, gains0, lane_tol, close): kernel and plain take
    (eligible, tau, budget, cost, cost_budget); gains0 are the rows' gains
    against the starting state; lane_tol the sweep's per-lane tolerance
    (None: rtol / atol on tau * cost); close(l, a, b, what) compares a
    lane's states or gains.  Features are d wide (d_ref for the facility
    and exemplar rows against r reference rows, d_ld for log-det with a
    k-row basis), rows rounded to ``dtype`` (f32 by default)."""
    dev = torch.device("cuda")
    dtype = dtype or torch.float32
    lam, alpha = 0.5, 1.0
    LD_RTOL, LD_ATOL = 1e-5, 1e-4

    def rand(*shape):
        return torch.rand(shape, generator=g, device=dev)

    def feature_close(l, a, b, what):
        return torch.allclose(a, b, rtol=RTOL, atol=ATOL)

    cases = {}
    if "coverage_accept" in names:
        x = (rand(L, B, d) ** 2).to(dtype)
        st = rand(L, d) * 4
        cases["coverage_accept"] = (
            lambda *cc: sweeps["coverage_accept"].coverage_accept(
                x, st, None, *cc),
            lambda *cc: ref.coverage_accept(x, st, None, *cc),
            ref.coverage_marginals(x, st), None, feature_close)
    if "weighted_coverage_accept" in names:
        xw, sw = (rand(L, B, d) ** 2).to(dtype), rand(L, d)
        cases["weighted_coverage_accept"] = (
            lambda *cc: sweeps["weighted_coverage_accept"]
            .weighted_coverage_accept(xw, sw, *cc),
            lambda *cc: ref.weighted_coverage_accept(xw, sw, *cc),
            ref.weighted_coverage_marginals(xw, sw), None, feature_close)
    if "saturated_coverage_accept" in names:
        xs, cap = (rand(L, B, d) ** 2).to(dtype), rand(d) * 4 + 1
        ss = (rand(L, d) * 1.2 * cap).contiguous()
        cases["saturated_coverage_accept"] = (
            lambda *cc: sweeps["saturated_coverage_accept"]
            .saturated_coverage_accept(xs, ss, cap, None, *cc),
            lambda *cc: ref.saturated_coverage_accept(xs, ss, cap, None, *cc),
            ref.saturated_coverage_marginals(xs, ss, cap), None,
            feature_close)
    if "graph_cut_accept" in names:
        xg, t = (rand(L, B, d) ** 2).to(dtype), (rand(d) * N / 3).contiguous()
        sg = (t * rand(L, 1) * 1.2 / (2 * lam)).contiguous()
        gc_tol = graph_cut_tol(xg, t + 2 * lam * (sg + xg.float().sum(1)),
                               lam).amax(-1)
        cases["graph_cut_accept"] = (
            lambda *cc: sweeps["graph_cut_accept"].graph_cut_accept(
                xg, t, sg, *cc[:3], lam, *cc[3:]),
            lambda *cc: ref.graph_cut_accept(xg, t, sg, *cc[:3], lam,
                                             *cc[3:]),
            ref.graph_cut_marginals(xg, t, sg, lam), gc_tol,
            lambda l, a, b, what: (torch.equal(a, b) if what == "state"
                                   else bool(((a - b).abs()
                                              <= gc_tol[l]).all())))
    if "facility_accept" in names:
        cf, Rf = (rand(L, B, d_ref) ** 2).to(dtype), rand(r, d_ref)
        sf = rand(L, r) * d_ref / 4
        fa_tol = 2 * ref.gemm_gain_tol(cf, Rf).amax(-1)
        cases["facility_accept"] = (
            lambda *cc: sweeps["facility_accept"].facility_accept(
                cf, Rf, sf, *cc),
            lambda *cc: ref.facility_accept(cf, Rf, sf, *cc),
            ref.facility_marginals(cf, Rf, sf), fa_tol,
            lambda l, a, b, what: bool(((a - b).abs() <= fa_tol[l]).all()))
    if "exemplar_accept" in names:
        ce, Re = rand(L, B, d_ref).to(dtype), rand(r, d_ref)
        se = ((Re * Re).sum(-1) * rand(L, r)).contiguous()
        ex_tol = 2 * ref.exemplar_gain_tol(ce, Re).amax(-1)
        cases["exemplar_accept"] = (
            lambda *cc: sweeps["exemplar_accept"].exemplar_accept(
                ce, Re, se, *cc),
            lambda *cc: ref.exemplar_accept(ce, Re, se, *cc),
            ref.exemplar_marginals(ce, Re, se), ex_tol,
            lambda l, a, b, what: bool(((a - b).abs() <= ex_tol[l]).all()))
    if "logdet_accept" in names:
        xl = (rand(L, B, d_ld) ** 2).to(dtype)
        sizes = ((torch.arange(L, device=dev) * 13) % (k + 1)).to(torch.int32)
        U, ld, sz = logdet_bases(torch, ref, g, L, k, d_ld, sizes, alpha,
                                 dtype)
        cases["logdet_accept"] = (
            lambda *cc: sweeps["logdet_accept"].logdet_accept(
                xl, U, ld, sz, *cc[:3], alpha, 1.0, *cc[3:]),
            lambda *cc: ref.logdet_accept(xl, U, ld, sz, *cc[:3], alpha,
                                          cost=cc[3], cost_budget=cc[4]),
            ref.logdet_marginals(xl, U, alpha), None,
            lambda l, a, b, what: torch.allclose(a, b, rtol=LD_RTOL,
                                                 atol=LD_ATOL))
    return cases


#: the four sweeps of csrc/feature_sweep.cuh
FEATURE_SWEEPS = ("coverage_accept", "weighted_coverage_accept",
                  "saturated_coverage_accept", "graph_cut_accept")


def phase_cost_sweeps(torch, ref, sweeps, rows):
    """The knapsack cost mode of the seven accept sweeps vs their plain
    versions, at the fused engine's shape (L = 37, B = 128, d = 256, r =
    256, k_max = 64, f32), with costs U[0.5, 2) and per-lane remaining
    budgets: half the cost the cardinality sweep spends in even lanes (the
    spend test cuts accepts inside the chunk), unbounded in odd lanes.
    Masks may part only at a row whose gain is within the sweep's tolerance
    of tau * cost.  Adds ``cost_ms`` (and the accepts the budget cut) to
    each sweep's row, and for the four feature sweeps ``all_accept_ms`` on
    the same rows (tau = -inf, budget B); repeats must be bitwise."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(6)
    LD_RTOL, LD_ATOL = 1e-5, 1e-4
    even = torch.arange(L, device=dev) % 2 == 0

    def rand(*shape):
        return torch.rand(shape, generator=g, device=dev)

    cases = sweep_cases(torch, ref, sweeps, g, tuple(sweeps))
    for name, (kern, plain, gains0, lane_tol, close) in cases.items():
        elig = rand(L, B) < 0.9
        cost = (0.5 + 1.5 * rand(L, B)).contiguous()
        tau = lane_taus(torch, gains0 / cost.mean())
        budget = torch.full((L,), K, dtype=torch.int32, device=dev)
        card = plain(elig, tau, budget, None, None)
        spent_card = torch.where(card[0], cost, 0.0).sum(-1)
        free = plain(elig, tau, budget, cost, torch.full((L,), 1e9,
                                                         device=dev))
        spent_free = torch.where(free[0], cost, 0.0).sum(-1)
        cb = torch.where(even, 0.5 * spent_free, 1e9).contiguous()
        got = kern(elig, tau, budget, cost, cb)
        want = plain(elig, tau, budget, cost, cb)
        torch.cuda.synchronize()
        three = (lambda o: (o[0], o[1], o[4])) if name == "logdet_accept" \
            else (lambda o: o)
        thr = tau[:, None] * cost
        if lane_tol is None:
            lane_tol = (LD_ATOL + LD_RTOL * thr.abs().amax(-1)
                        if name == "logdet_accept"
                        else ATOL + RTOL * thr.abs().amax(-1))
        ties, err = check_sweep(f"{name}[cost]", three(got), three(want),
                                thr, lane_tol, close)
        spent = torch.where(got[0], cost, 0.0).sum(-1)
        check(bool((spent <= cb * (1 + 1e-6)).all()),
              f"{name}[cost]: a lane spent beyond its budget")
        cut = free[0].sum(-1) - want[0].sum(-1)
        check(int(cut[even].max()) > 0 and int(cut[~even].abs().max()) == 0,
              f"{name}[cost]: the budget cut no accept in a bound lane")
        check(all(torch.equal(a, b) for a, b in zip(got, kern(
            elig, tau, budget, cost, cb))),
            f"{name}[cost]: a repeated launch differs")
        ms = cuda_ms(lambda: kern(elig, tau, budget, cost, cb), 50)
        card_ms = cuda_ms(lambda: kern(elig, tau, budget, None, None), 50)
        pms = cuda_ms(lambda: plain(elig, tau, budget, cost, cb), 2)
        rows[name]["cost_ms"] = ms
        rows[name]["max_abs_err"] = max(rows[name]["max_abs_err"], err)
        if name in FEATURE_SWEEPS:
            rows[name]["all_accept_ms"] = all_accept_ms(
                torch, name, lambda tau, budget: kern(elig, tau, budget, None,
                                                      None), elig)
        print(f"[kernels] {name} cost mode x({L}, {B}, {D}) f32: "
              f"max_abs_err={err} near_tau_ties={ties} "
              f"accepted={int(want[0].sum())} (cardinality "
              f"{int(card[0].sum())}, unbounded budget "
              f"{int(free[0].sum())}) cut_by_budget={int(cut.sum())} in "
              f"{int((cut > 0).sum())} of {int(even.sum())} bound lanes "
              f"cost_ms={ms} cardinality_ms={card_ms} plain_ms={pms} "
              f"repeat=bitwise")
    return rows


#: the wide shapes of each sweep: past its narrow instance's 2048 features
#: (the feature sweeps), 4096 reference rows (facility, exemplar) or 227 KiB
#: of shared memory for the basis (log-det)
WIDE_SWEEPS = tuple(
    [(name, dict(d=w), f"d={w}") for name in (
        "coverage_accept", "weighted_coverage_accept",
        "saturated_coverage_accept", "graph_cut_accept") for w in (2049, 4096)]
    + [(name, dict(r=w), f"r={w}") for name in (
        "facility_accept", "exemplar_accept") for w in (4097, 8192)]
    + [("logdet_accept", dict(k=64, d_ld=1024), "k=64 d=1024"),
       ("logdet_accept", dict(k=256, d_ld=256), "k=256 d=256")])


def phase_wide_sweeps(torch, ref, sweeps, wrap, la, rows):
    """Each sweep's wide instance (the state in global memory) against its
    plain version, at L = 37, B = 128 and the widths of WIDE_SWEEPS, f32
    and bf16, in the cardinality mode and the knapsack cost mode (half the
    unbounded spend in even lanes), with the cost-mode tolerances of
    phase_cost_sweeps and bitwise repeats.  Adds ``wide_ms`` (f32,
    cardinality, at the widest shape) to each sweep's row."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(8)
    LD_RTOL, LD_ATOL = 1e-5, 1e-4
    even = torch.arange(L, device=dev) % 2 == 0
    for name, kw, label in WIDE_SWEEPS:
        if name == "logdet_accept":
            picked = la.instance(kw["k"], kw["d_ld"]) == "global"
        elif name in ("facility_accept", "exemplar_accept"):
            picked = wrap.reference_sweep_per(kw["r"]) == 0
        else:
            picked = wrap.feature_sweep_per(kw["d"]) == 0
        check(picked, f"{name} {label}: the wrapper did not pick the wide "
              f"instance")
        for dtype in (torch.float32, torch.bfloat16):
            kern, plain, gains0, lane_tol, close = sweep_cases(
                torch, ref, sweeps, g, (name,), dtype, **kw)[name]
            elig = torch.rand((L, B), generator=g, device=dev) < 0.9
            budget = torch.where(torch.arange(L, device=dev) % 5 == 0, 3,
                                 K).to(torch.int32)
            three = (lambda o: (o[0], o[1], o[4])) if name == "logdet_accept" \
                else (lambda o: o)
            for mode in ("cardinality", "cost"):
                if mode == "cardinality":
                    # half the lanes' quantiles, so most lanes accept more
                    # than one row
                    cost = cb = None
                    tau = lane_taus(torch, gains0 / 2)
                    thr = tau
                else:
                    cost = (0.5 + 1.5 * torch.rand((L, B), generator=g,
                                                   device=dev)).contiguous()
                    tau = lane_taus(torch, gains0 / cost.mean())
                    free = plain(elig, tau, budget, cost,
                                 torch.full((L,), 1e9, device=dev))
                    cb = torch.where(even, 0.5 * torch.where(
                        free[0], cost, 0.0).sum(-1), 1e9).contiguous()
                    thr = tau[:, None] * cost
                got = kern(elig, tau, budget, cost, cb)
                want = plain(elig, tau, budget, cost, cb)
                torch.cuda.synchronize()
                tol = lane_tol
                if tol is None:
                    tol = (LD_ATOL + LD_RTOL * thr.abs().reshape(L, -1).amax(-1)
                           if name == "logdet_accept"
                           else ATOL + RTOL * thr.abs().reshape(L, -1).amax(-1))
                ties, err = check_sweep(f"{name} {label} {mode}", three(got),
                                        three(want), thr, tol, close)
                if name == "logdet_accept":
                    same = (got[0] == want[0]).all(-1)
                    check(torch.equal(got[3][same], want[3][same]),
                          f"{name} {label}: sizes differ")
                if cost is not None:
                    spent = torch.where(got[0], cost, 0.0).sum(-1)
                    check(bool((spent <= cb * (1 + 1e-6)).all()),
                          f"{name} {label}: a lane spent beyond its budget")
                check(all(torch.equal(a, b) for a, b in zip(
                    got, kern(elig, tau, budget, cost, cb))),
                    f"{name} {label} {mode}: a repeated launch differs")
                line = (f"[wide] {name} {label} {str(dtype)[6:]} {mode}: "
                        f"max_abs_err={err} near_tau_ties={ties} "
                        f"accepted={int(want[0].sum())} repeat=bitwise")
                if dtype == torch.float32 and mode == "cardinality":
                    ms = cuda_ms(lambda: kern(elig, tau, budget, None, None),
                                 10)
                    line += f" kernel_ms={ms}"
                    rows[name]["wide_ms"] = ms
                    rows[name]["max_abs_err"] = max(rows[name]["max_abs_err"],
                                                    err)
                print(line)
    return rows


def read_counts(ops):
    """The launch counts since the last reset, by kernel, with each sweep's
    cost-mode launches under "<name>[cost]", each kernel's split by shape
    under "<name>@<shape>" and the filter class's by lanes, x and rows
    under "<name>@filter/<key>"."""
    counts = ops.launch_counts()
    counts.update({f"{name}[cost]": n
                   for name, n in ops.cost_launch_counts().items()})
    counts.update({f"{name}@{shape}": n
                   for name, split in ops.shape_launch_counts().items()
                   for shape, n in split.items()})
    counts.update({f"{name}@filter/{key}": n
                   for name, split in ops.filter_launch_counts().items()
                   for key, n in split.items()})
    return counts


def drive(torch, tsel, ops, X, label, reference=None, total=None,
          sel_kw=None, opt=None, tag="main", **spec_kw):
    """One select through the public entry point, with the launch counts
    set to 0 just before and read just after.  ``sel_kw`` are the
    selector's per-element constraint data, ``opt`` the known-OPT
    algorithms' estimate; ``tag`` names the printed lines.  Returns
    (result, value, wall ms, launch counts as ``read_counts`` gives
    them)."""
    spec = tsel.SelectorSpec(k=K, eps=EPS, chunk=CHUNK, **spec_kw)
    n, d = X.shape
    sel = tsel.DistributedSelector(spec, n_total=n, feat_dim=d, n_machines=M,
                                   device="cuda", reference=reference,
                                   total=total, **(sel_kw or {}))
    gen = torch.Generator(device="cuda").manual_seed(1)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res = sel.select(X, opt_estimate=opt, generator=gen)
    value = float(res.value)  # waits for the device
    wall = (time.perf_counter() - t0) * 1e3
    counts = read_counts(ops)
    size = int(res.sol_size)
    ids = res.sol_ids.cpu()[:size]
    # facility location over all-positive similarities, weighted coverage
    # (whose remaining weight decays geometrically), saturated coverage at a
    # binding cap and exemplar clustering saturate after a few picks, a
    # knapsack or partition budget stops a lane early, and a known-OPT
    # threshold need not fill k, so those selects may stop short of k
    full = (spec.oracle == "feature_coverage"
            and spec.constraint == "cardinality"
            and spec.algorithm in tsel.OPT_FREE_ALGORITHMS)
    check(res.sol_ids.shape == (K,) and (size == K if full else 1 <= size <= K),
          f"{label}: got size {size}")
    check(len(set(ids.tolist())) == size and int(ids.min()) >= 0
          and int(ids.max()) < n, f"{label}: ids not {size} distinct rows")
    check(value == value and value > 0 and value != float("inf"),
          f"{label}: value {value}")
    nonzero = {k: v for k, v in counts.items() if v and "@" not in k}
    # the chosen ids in order, as one checksum, to set a run beside another
    ids_crc = zlib.crc32(ids.to(torch.int64).numpy().tobytes())
    print(f"[{tag}] {label}: value={value} |S|={size} ids_crc32={ids_crc} "
          f"n_dropped={int(res.n_dropped)} tau_fallback={int(res.tau_fallback)} "
          f"wall_ms={wall} launches={nonzero}")
    print(sel.round_log.summary())
    return res, value, wall, counts


def greedy_value(torch, tsel, tseq, X, oracle, reference=None, total=None,
                 **spec_kw):
    """Sequential greedy's value on the first GREEDY_ROWS rows (<= OPT)."""
    greedy_oracle = tsel.make_oracle(
        tsel.SelectorSpec(k=K, oracle=oracle, **spec_kw), D, "cuda",
        reference=reference, total=total)
    _, _, gval = tseq.greedy(greedy_oracle, X[:GREEDY_ROWS],
                             torch.ones(GREEDY_ROWS, dtype=torch.bool,
                                        device="cuda"), K)
    return float(gval)


def main_path(torch, tsel, tseq, ops, X, oracle, kernels, accept_kernel,
              reference=None, total=None, results=None):
    """Drive one oracle's main path: three engines on the kernel route, the
    lazy engine on the plain route, multi_epoch E = 2 and bf16 storage on
    the fused engine.  Returns the launches of each of ``kernels`` summed
    over the kernel-route selects, and sequential greedy's value on the
    first GREEDY_ROWS rows (<= OPT); ``results``, when given, receives each
    select's (result, value) by label."""
    launches = {}
    results = {} if results is None else results

    def run(label, **kw):
        res, value, _, counts = drive(torch, tsel, ops, X,
                                      f"{oracle} {label}", reference, total,
                                      oracle=oracle, **kw)
        results[label] = (res, value)
        fused = kw.get("engine") == "fused"
        for name in kernels:
            want = fused if name == accept_kernel else True
            check((counts[name] > 0) == want,
                  f"{oracle} {label}: {name} launched {counts[name]} times")
        add_launches(launches, counts, kernels)
        return res, value

    runs = {e: run(f"two_round {e} kernel", engine=e, use_kernel=True)
            for e in ("dense", "lazy", "fused")}
    res_p, value_p, _, counts = drive(torch, tsel, ops, X,
                                      f"{oracle} two_round lazy plain",
                                      reference, total, oracle=oracle,
                                      engine="lazy", use_kernel=False)
    results["two_round lazy plain"] = (res_p, value_p)
    check(not any(counts.values()), f"plain route launched kernels {counts}")
    for engine, (res, value) in runs.items():
        check(abs(value - value_p) <= 1e-3 * abs(value_p),
              f"{oracle} {engine} value {value} vs plain {value_p}")
        overlap = len(set(res.sol_ids.tolist()) & set(res_p.sol_ids.tolist())
                      - {-1})
        print(f"[main] {oracle} {engine} vs plain: rel_diff="
              f"{abs(value - value_p) / value_p} id_overlap={overlap}/"
              f"{int(res_p.sol_size)}")

    gval = greedy_value(torch, tsel, tseq, X, oracle, reference, total)
    for engine, (_, value) in runs.items():
        check(value >= (0.5 - EPS) * gval,
              f"{oracle} {engine}: value {value} below (1/2 - eps) x greedy "
              f"{gval}")
    print(f"[main] {oracle} greedy on the first {GREEDY_ROWS} rows: "
          f"value={gval}; two_round/greedy = "
          f"{ {e: v / gval for e, (_, v) in runs.items()} }")

    _, v_me = run("multi_epoch E=2 fused kernel", algorithm="multi_epoch",
                  epochs=2, engine="fused", use_kernel=True)
    check(v_me >= (0.5 - EPS) * gval, f"{oracle} multi_epoch value {v_me}")
    _, v_bf = run("two_round fused kernel bf16", engine="fused",
                  use_kernel=True, precision="bf16")
    v_f32 = runs["fused"][1]
    check(v_bf >= 0.99 * v_f32, f"{oracle} bf16 value {v_bf} < 0.99 x f32 "
          f"{v_f32}")
    print(f"[main] {oracle} bf16/f32 fused value ratio = {v_bf / v_f32}")
    return launches, gval


#: each oracle's kernels on the main path, its accept sweep, and which
#: corpus statistic it needs ("reference" or "total")
ORACLES = (
    ("feature_coverage", ("coverage_marginals", "coverage_accept"),
     "coverage_accept", None),
    ("facility_location", ("facility_marginals", "rectified_residual_sum",
                           "facility_accept"), "facility_accept", "reference"),
    ("weighted_coverage", ("weighted_coverage_marginals",
                           "weighted_coverage_accept"),
     "weighted_coverage_accept", None),
    ("saturated_coverage", ("saturated_coverage_marginals",
                            "saturated_coverage_accept"),
     "saturated_coverage_accept", "total"),
    ("graph_cut", ("graph_cut_marginals", "graph_cut_accept"),
     "graph_cut_accept", "total"),
    ("log_det", ("logdet_marginals", "logdet_accept"), "logdet_accept", None),
    ("mutual_information", ("logdet_marginals", "logdet_accept"),
     "logdet_accept", None),
    ("exemplar", ("exemplar_marginals", "exemplar_accept"), "exemplar_accept",
     "reference"))


def knapsack_selects(torch, tsel, ops, X, stats, costs, card_fc):
    """Knapsack selection (costs U[0.5, 2) per row, budget k * 1.25 / 2 =
    40, the JAX CLI's): one fused two_round select on the kernel route for
    each of the eight oracles, held against the lazy engine on the plain
    route (rtol 1e-3); every fused select must launch its oracle's sweep,
    each time in the cost mode, and its chosen rows' costs must sum, in
    float64 on the host, to at most the budget.  FeatureCoverage also runs
    dense and lazy on the kernel route (for accept="first" they must give
    the fused ids), and once with unit costs and budget k, which must give
    the cardinality select's ids (``card_fc``).  Returns the kernel
    launches of the kernel-route selects."""
    launches = {}
    costs64 = costs.double().cpu()
    sel_kw = dict(element_costs=costs)
    for oracle, kernels, accept_kernel, needs in ORACLES:
        kw = dict(oracle=oracle, constraint="knapsack",
                  knapsack_budget=KNAP_BUDGET, sel_kw=sel_kw,
                  **({needs: stats[needs]} if needs else {}))
        label = f"{oracle} knapsack two_round"
        res, value, _, counts = drive(torch, tsel, ops, X,
                                      f"{label} fused kernel", engine="fused",
                                      use_kernel=True, **kw)
        n = counts[accept_kernel]
        check(n > 0 and counts[f"{accept_kernel}[cost]"] == n,
              f"{label}: {accept_kernel} launched {n} times, "
              f"{counts[f'{accept_kernel}[cost]']} in the cost mode")
        add_launches(launches, counts, kernels)
        ids = res.sol_ids[:int(res.sol_size)].long().cpu()
        spent = float(costs64[ids].sum())
        check(spent <= KNAP_BUDGET, f"{label}: chosen costs sum to {spent}")
        _, value_p, _, counts_p = drive(torch, tsel, ops, X,
                                        f"{label} lazy plain", engine="lazy",
                                        use_kernel=False, **kw)
        check(not any(counts_p.values()),
              f"plain route launched kernels {counts_p}")
        check(abs(value - value_p) <= 1e-3 * abs(value_p),
              f"{label}: fused value {value} vs plain {value_p}")
        print(f"[knapsack] {oracle}: value={value} plain={value_p} "
              f"|S|={int(res.sol_size)} spent={spent} of {KNAP_BUDGET} "
              f"{accept_kernel}[cost] launches={n}")
        if oracle == "feature_coverage":
            fused_ids = res.sol_ids
            for engine in ("dense", "lazy"):
                r_e, _, _, _ = drive(torch, tsel, ops, X,
                                     f"{label} {engine} kernel",
                                     engine=engine, use_kernel=True, **kw)
                check(torch.equal(r_e.sol_ids, fused_ids),
                      f"{label}: {engine} ids {r_e.sol_ids.tolist()} differ "
                      f"from fused {fused_ids.tolist()}")
            unit = drive(torch, tsel, ops, X,
                         "feature_coverage knapsack unit costs, budget k",
                         engine="fused", use_kernel=True, oracle=oracle,
                         constraint="knapsack", knapsack_budget=float(K),
                         sel_kw=dict(element_costs=torch.ones_like(costs)))[0]
            check(torch.equal(unit.sol_ids, card_fc.sol_ids),
                  "unit-cost knapsack with budget k did not give the "
                  "cardinality select's ids")
            print("[knapsack] feature_coverage: dense, lazy and fused give the "
                  "same ids; unit costs with budget k give the cardinality "
                  "select's ids")
    return launches


def partition_select(torch, tsel, ops, X, parts):
    """A partition matroid of N_PARTS parts, each capped at PART_CAP, on
    FeatureCoverage: the fused engine (its sweep is the plain constrained
    row scan, the JAX design, scoring rows through coverage_marginals)
    against the lazy engine, both on the kernel route; the per-part counts
    of the chosen rows must keep to the caps.  Returns the launches."""
    caps = torch.full((N_PARTS,), PART_CAP, dtype=torch.int32)
    kw = dict(oracle="feature_coverage", constraint="partition_matroid",
              use_kernel=True, sel_kw=dict(parts=parts, part_caps=caps))
    label = f"feature_coverage partition({N_PARTS} x {PART_CAP}) two_round"
    res, value, _, counts = drive(torch, tsel, ops, X, f"{label} fused kernel",
                                  engine="fused", **kw)
    check(counts["coverage_marginals"] > 0,
          f"{label}: coverage_marginals never launched")
    _, value_l, _, _ = drive(torch, tsel, ops, X, f"{label} lazy kernel",
                             engine="lazy", **kw)
    check(abs(value - value_l) <= 1e-3 * abs(value_l),
          f"{label}: fused value {value} vs lazy {value_l}")
    ids = res.sol_ids[:int(res.sol_size)].long()
    per_part = torch.bincount(parts[ids].long(), minlength=N_PARTS).cpu()
    check(bool((per_part <= PART_CAP).all()),
          f"{label}: per-part counts {per_part.tolist()} beyond {PART_CAP}")
    print(f"[partition] value={value} lazy={value_l} |S|={int(res.sol_size)} "
          f"per-part counts={per_part.tolist()} caps={PART_CAP}")
    launches = {}
    add_launches(launches, counts, ("coverage_marginals",))
    return launches


KO_T = 3                    # multi_threshold's thresholds in the known-OPT
#                             phase
QUERY_KS = (64, 32, 16, 1)  # the query batch's budgets: Q x J = 148 lanes
#: the same budgets reversed: the k = 64 query takes lanes 111-147, past
#: the 128 lanes of one CTA of the shared-x tiles
QUERY_KS_REV = QUERY_KS[::-1]
QUERY_LAMS = (0.5, 0.25, 0.125, 0.0)     # GraphCut's per-query lam
QUERY_ALPHAS = (1.0, 0.5, 2.0, 0.25)     # LogDetDiversity's per-query alpha
ADV_K, ADV_TS = 120, (1, 2, 4)           # the Theorem-4 instance
ADV_MARGIN = 2e-3  # the instance's decoys sit this far above the
#                    thresholds, which lifts the ratio 1.0e-3 to 1.2e-3
#                    over the bound (the JAX package's run too)


def known_opt_selects(torch, tsel, ops, X, stats, gvals, costs):
    """Part (a) of the known-OPT phase: two_round_known_opt (Algorithm 4)
    and multi_threshold (Algorithm 5, t = KO_T) per oracle at full width,
    opt = sequential greedy's value on the first GREEDY_ROWS rows (<= OPT),
    fused on the kernel route against lazy on the plain route (rtol 1e-3).
    Each select carries one lane; nothing may be dropped, Algorithm 4 must
    reach gval / 2 and Algorithm 5 (t/(t+1))^t gval (for any opt' <= OPT
    with nothing dropped, f(S) >= min(|S| alpha_t, OPT - k alpha_t)); MI
    at noise 1 must give log-det's ids and half its value; the kernel-route
    selects must launch the oracle's filter and accept kernels (the path
    runs no max-singleton or top-singleton pass, so FacilityLocation's
    rectified_residual_sum has no call); one knapsack multi_threshold on
    FeatureCoverage must keep to its budget."""
    t0 = time.perf_counter()
    got = {}
    for oracle, kernels, accept_kernel, needs in ORACLES:
        gval = gvals[oracle]
        kw = dict(oracle=oracle, opt=gval, tag="known_opt", t=KO_T,
                  **({needs: stats[needs]} if needs else {}))
        floors = {"two_round_known_opt": 0.5,
                  "multi_threshold": (KO_T / (KO_T + 1)) ** KO_T}
        for algorithm, floor in floors.items():
            label = f"{oracle} {algorithm}" + (
                f" t={KO_T}" if algorithm == "multi_threshold" else "")
            res, value, wall, counts = drive(
                torch, tsel, ops, X, f"{label} fused kernel",
                algorithm=algorithm, engine="fused", use_kernel=True, **kw)
            for name in kernels:
                if name != "rectified_residual_sum":
                    check(counts[name] > 0,
                          f"{label}: {name} launched {counts[name]} times")
            res_p, value_p, wall_p, counts_p = drive(
                torch, tsel, ops, X, f"{label} lazy plain",
                algorithm=algorithm, engine="lazy", use_kernel=False, **kw)
            check(not any(counts_p.values()),
                  f"plain route launched kernels {counts_p}")
            check(abs(value - value_p) <= 1e-3 * abs(value_p),
                  f"{label}: fused value {value} vs plain {value_p}")
            check(int(res.n_dropped) == 0 and int(res_p.n_dropped) == 0,
                  f"{label}: dropped {int(res.n_dropped)} / "
                  f"{int(res_p.n_dropped)}")
            check(value >= floor * gval,
                  f"{label}: value {value} below {floor} x greedy {gval}")
            got[(oracle, algorithm)] = (res, value)
            launched = {name: counts[name] for name in kernels}
            print(f"[known_opt] {label}: value={value} plain={value_p} "
                  f"|S|={int(res.sol_size)} gval={gval} ratio={value / gval} "
                  f"floor={floor} wall_ms={wall} plain_wall_ms={wall_p} "
                  f"launches={launched}")
    for algorithm in floors:
        res, value = got[("log_det", algorithm)]
        res_mi, value_mi = got[("mutual_information", algorithm)]
        check(torch.equal(res_mi.sol_ids, res.sol_ids)
              and value_mi == 0.5 * value,
              f"{algorithm}: mutual information {value_mi} is not half of "
              f"log-det {value} with the same ids")
    res, value, wall, counts = drive(
        torch, tsel, ops, X,
        f"feature_coverage knapsack multi_threshold t={KO_T} fused kernel",
        oracle="feature_coverage", algorithm="multi_threshold", t=KO_T,
        opt=gvals["feature_coverage"], tag="known_opt", engine="fused",
        use_kernel=True, constraint="knapsack", knapsack_budget=KNAP_BUDGET,
        sel_kw=dict(element_costs=costs))
    n = counts["coverage_accept"]
    check(n > 0 and counts["coverage_accept[cost]"] == n,
          f"knapsack multi_threshold: coverage_accept launched {n} times, "
          f"{counts['coverage_accept[cost]']} in the cost mode")
    ids = res.sol_ids[:int(res.sol_size)].long().cpu()
    spent = float(costs.double().cpu()[ids].sum())
    check(spent <= KNAP_BUDGET, f"knapsack multi_threshold: chosen costs sum "
          f"to {spent}")
    print(f"[known_opt] feature_coverage knapsack multi_threshold: "
          f"value={value} |S|={int(res.sol_size)} spent={spent} of "
          f"{KNAP_BUDGET} wall_ms={wall} coverage_accept[cost] launches={n}")
    print(f"[known_opt] MI at noise 1 = 0.5 x log_det, same ids, in both "
          f"algorithms")
    tight_selects(torch, tsel, ops, X, stats)
    print(f"[known_opt] part (a) took {time.perf_counter() - t0:.3f} s")


#: the oracles whose known-OPT selects at opt = gval fill their lane from
#: the sample's first chunk (FacilityLocation, WeightedCoverage and
#: ExemplarClustering saturate early and walk the whole sample there)
TIGHT_ORACLES = ("feature_coverage", "saturated_coverage", "graph_cut",
                 "log_det", "mutual_information")


def tight_selects(torch, tsel, ops, X, stats):
    """multi_threshold (t = KO_T) for each of TIGHT_ORACLES at opt = 1.2 k v
    for the max singleton v, above the upper bound k v on OPT: its levels'
    thresholds 0.9 v, 0.675 v and 0.506 v sit in the top of the singletons
    (most of this corpus's singletons lie within 0.7-1 v for the oracles
    that are near modular here), so each epoch's one-lane accept walks far
    into the sample and its one-lane filter keeps real survivors.  Fused on
    the kernel route against lazy on the plain route: the same ids, values
    within rtol 1e-3; MutualInformationGaussian at noise 1 (log-det's
    kernels at scale 0.5) against LogDetDiversity's select instead: the
    same ids and half its value.  No floor applies (the estimate is above
    OPT)."""
    got = {}
    for oracle, kernels, _, needs in ORACLES:
        if oracle not in TIGHT_ORACLES:
            continue
        stat = {needs: stats[needs]} if needs else {}
        sel = tsel.DistributedSelector(
            tsel.SelectorSpec(k=K, oracle=oracle), n_total=N, feat_dim=D,
            n_machines=M, device="cuda", **stat)
        v = float(sel.opt_upper_bound(X)) / K
        del sel
        kw = dict(oracle=oracle, opt=1.2 * K * v, tag="known_opt",
                  algorithm="multi_threshold", t=KO_T, **stat)
        label = f"{oracle} multi_threshold t={KO_T} at opt = 1.2 k v"
        res, value, wall, counts = drive(torch, tsel, ops, X,
                                         f"{label} fused kernel",
                                         engine="fused", use_kernel=True,
                                         **kw)
        got[oracle] = (res, value)
        for name in kernels:
            check(counts[name] > 0,
                  f"{label}: {name} launched {counts[name]} times")
        if oracle == "mutual_information":
            res_p, value_p = got["log_det"]
            value_p, wall_p, against = 0.5 * value_p, None, "log_det / 2"
            check(torch.equal(res.sol_ids, res_p.sol_ids)
                  and value == value_p,
                  f"{label}: value {value} ids {res.sol_ids.tolist()} vs "
                  f"half of log_det's {value_p} ids {res_p.sol_ids.tolist()}")
        else:
            res_p, value_p, wall_p, counts_p = drive(
                torch, tsel, ops, X, f"{label} lazy plain", engine="lazy",
                use_kernel=False, **kw)
            against = "lazy plain"
            check(not any(counts_p.values()),
                  f"plain route launched kernels {counts_p}")
            check(torch.equal(res.sol_ids, res_p.sol_ids)
                  and abs(value - value_p) <= 1e-3 * abs(value_p),
                  f"{label}: fused value {value} ids {res.sol_ids.tolist()} "
                  f"vs plain {value_p} ids {res_p.sol_ids.tolist()}")
        print(f"[known_opt] {label}: value={value} {against}={value_p} "
              f"|S|={int(res.sol_size)} v={v} wall_ms={wall} "
              f"plain_wall_ms={wall_p} launches="
              f"{ {name: counts[name] for name in kernels} }; ids equal")


def drive_batch(torch, ops, sel, X, label, queries):
    """One select_batch through the public entry point, on the fused
    engine's kernel route, with the launch counts set to 0 just before and
    read just after; checks each query's size (<= its budget), ids and
    value.  Returns (result, wall ms, launch counts)."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res = sel.select_batch(X, queries, generator=gen)
    values = res.value.tolist()  # waits for the device
    wall = (time.perf_counter() - t0) * 1e3
    peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    counts = read_counts(ops)
    ks, sizes = queries.k.tolist(), res.sol_size.tolist()
    crcs = []
    for q, (kq, size, value) in enumerate(zip(ks, sizes, values)):
        ids = res.sol_ids[q].cpu()
        check(1 <= size <= kq and bool((ids[size:] == -1).all()),
              f"{label} query {q}: size {size} for budget {kq}")
        chosen = ids[:size]
        check(len(set(chosen.tolist())) == size and int(chosen.min()) >= 0
              and int(chosen.max()) < X.shape[0],
              f"{label} query {q}: ids not {size} distinct rows")
        check(value == value and 0 < value != float("inf"),
              f"{label} query {q}: value {value}")
        crcs.append(zlib.crc32(chosen.to(torch.int64).numpy().tobytes()))
    nonzero = {k: v for k, v in counts.items() if v and "@" not in k}
    print(f"[batch] {label}: k={ks} values={values} |S|={sizes} "
          f"ids_crc32={crcs} n_dropped={res.n_dropped.tolist()} "
          f"tau_fallback={res.tau_fallback.tolist()} wall_ms={wall} "
          f"peak_GiB_above_corpus={peak} launches={nonzero}")
    return res, wall, counts


def batch_selects(torch, tsel, tmr, ops, X, stats, by):
    """Part (b) of the known-OPT phase, the query axis: select_batch of
    QUERY_KS on the fused engine's kernel route per oracle, and GraphCut
    with QUERY_LAMS and LogDetDiversity with QUERY_ALPHAS.  Query 0 (k = 64,
    the default hyper-parameters) must give the two_round fused kernel
    select's ids and value (rtol 1e-5; printed whether bit-equal), every
    query the ids of a Q = 1 batch of it (values within rtol 1e-5), and
    every kernel of the oracle must launch; the oracles that take no
    per-query hyper-parameters fold Q x J = 148 lanes into one filter
    launch, which coverage_marginals and saturated_coverage_marginals must
    show in ``ops.filter_launch_counts()``.  For those six, the batch of
    QUERY_KS_REV puts the k = 64 query in lanes 111-147: each of its
    queries must give the ids of the same budget's query in the first batch
    (values within rtol 1e-5), and its k = 64 query the two_round
    select's.  Queries 1-3 of the batches with per-query lam and alpha are
    also held against the lazy engine on the plain route: the same ids,
    values within rtol 1e-3."""
    t0 = time.perf_counter()
    lanes = len(QUERY_KS) * L
    for oracle, kernels, _, needs in ORACLES:
        variants = [("", None, None)]
        if oracle == "graph_cut":
            variants.append((f" lam={QUERY_LAMS}", QUERY_LAMS, None))
        if oracle == "log_det":
            variants.append((f" alpha={QUERY_ALPHAS}", None, QUERY_ALPHAS))
        stat = {needs: stats[needs]} if needs else {}
        sel, plain_sel = (
            tsel.DistributedSelector(
                tsel.SelectorSpec(k=K, eps=EPS, chunk=CHUNK, oracle=oracle,
                                  engine=engine, use_kernel=use_kernel),
                n_total=N, feat_dim=D, n_machines=M, device="cuda", **stat)
            for engine, use_kernel in (("fused", True), ("lazy", False)))
        ref_res, ref_value = by[oracle]["two_round fused kernel"]
        for tag, lams, alphas in variants:
            label = f"{oracle} select_batch{tag}"
            res, wall, counts = drive_batch(
                torch, ops, sel, X, label,
                tmr.make_query_batch(QUERY_KS, lams, alphas, device="cuda"))
            for name in kernels:
                check(counts[name] > 0,
                      f"{label}: {name} launched {counts[name]} times")
            filters = {name: {key[len(name) + 8:]: n for key, n in
                              counts.items()
                              if key.startswith(f"{name}@filter/") and n}
                       for name in kernels if name in FILTER_SPLIT_KERNELS}
            wide = f"{lanes} lanes, shared x, {N} rows"
            for name in ("coverage_marginals",
                         "saturated_coverage_marginals"):
                if name in filters:
                    check(filters[name].get(wide, 0) > 0,
                          f"{label}: no {wide} filter launch of {name}: "
                          f"{filters[name]}")
            value0 = float(res.value[0])
            check(torch.equal(res.sol_ids[0], ref_res.sol_ids)
                  and abs(value0 - ref_value) <= 1e-5 * abs(ref_value),
                  f"{label}: query 0 value {value0} ids "
                  f"{res.sol_ids[0].tolist()} vs two_round {ref_value} ids "
                  f"{ref_res.sol_ids.tolist()}")
            bits = [value0 == ref_value]
            walls = []
            for q, kq in enumerate(QUERY_KS):
                one = tmr.make_query_batch(
                    [kq], None if lams is None else [lams[q]],
                    None if alphas is None else [alphas[q]], device="cuda")
                r1, wall1, _ = drive_batch(torch, ops, sel, X,
                                           f"{label} query {q} alone", one)
                walls.append(wall1)
                v1, vq = float(r1.value[0]), float(res.value[q])
                check(torch.equal(r1.sol_ids[0], res.sol_ids[q])
                      and abs(vq - v1) <= 1e-5 * abs(v1),
                      f"{label} query {q}: value {vq} ids "
                      f"{res.sol_ids[q].tolist()} vs alone {v1} ids "
                      f"{r1.sol_ids[0].tolist()}")
                bits.append(vq == v1)
            print(f"[batch] {label}: query 0 = two_round fused kernel "
                  f"(ids equal, value bit-equal {bits[0]}); each query = its "
                  f"Q = 1 batch (ids equal, values bit-equal {bits[1:]}); "
                  f"wall_ms={wall} alone_wall_ms={walls}; filter launches "
                  f"{filters}")
            if len(variants) == 1:
                batch_reversed(torch, tmr, ops, sel, X, label, res, ref_res,
                               ref_value)
            elif tag:
                # queries 1-3; query 0 takes the defaults, whose select the
                # main path holds against the plain route
                res_p, _, counts_p = drive_batch(
                    torch, ops, plain_sel, X, f"{label} 1-3 lazy plain",
                    tmr.make_query_batch(
                        QUERY_KS[1:], None if lams is None else lams[1:],
                        None if alphas is None else alphas[1:],
                        device="cuda"))
                check(not any(counts_p.values()),
                      f"plain route launched kernels {counts_p}")
                values = res.value.tolist()[1:]
                values_p = res_p.value.tolist()
                check(torch.equal(res.sol_ids[1:], res_p.sol_ids)
                      and all(abs(v - vp) <= 1e-3 * abs(vp)
                              for v, vp in zip(values, values_p)),
                      f"{label}: fused kernel values {values} ids "
                      f"{res.sol_ids.tolist()} vs lazy plain {values_p} ids "
                      f"{res_p.sol_ids.tolist()}")
                print(f"[batch] {label}: queries 1-3 fused kernel = lazy "
                      f"plain (ids equal, values bit-equal "
                      f"{[v == vp for v, vp in zip(values, values_p)]})")
    print(f"[batch] part (b) took {time.perf_counter() - t0:.3f} s")


def batch_reversed(torch, tmr, ops, sel, X, label, res, ref_res, ref_value):
    """The batch of QUERY_KS_REV beside ``res``, the batch of QUERY_KS:
    each query must give the ids of the same budget's query there (values
    within rtol 1e-5), so the k = 64 query's lanes 111-147 must give what
    its lanes 0-36 gave, and that query the two_round select's ids and
    value (rtol 1e-5)."""
    rev, wall, _ = drive_batch(torch, ops, sel, X, f"{label} reversed",
                               tmr.make_query_batch(QUERY_KS_REV,
                                                    device="cuda"))
    bits = []
    for q, kq in enumerate(QUERY_KS_REV):
        p = QUERY_KS.index(kq)
        v, vp = float(rev.value[q]), float(res.value[p])
        check(torch.equal(rev.sol_ids[q], res.sol_ids[p])
              and abs(v - vp) <= 1e-5 * abs(vp),
              f"{label} reversed query {q} (k = {kq}): value {v} ids "
              f"{rev.sol_ids[q].tolist()} vs {vp} ids "
              f"{res.sol_ids[p].tolist()}")
        bits.append(v == vp)
    q64 = QUERY_KS_REV.index(K)
    v64 = float(rev.value[q64])
    check(torch.equal(rev.sol_ids[q64], ref_res.sol_ids)
          and abs(v64 - ref_value) <= 1e-5 * abs(ref_value),
          f"{label} reversed: k = {K} query value {v64} vs two_round "
          f"{ref_value}")
    print(f"[batch] {label} reversed, k={list(QUERY_KS_REV)}: each query = "
          f"the same budget's query of k={list(QUERY_KS)} (ids equal, "
          f"values bit-equal {bits}); the k = {K} query in lanes "
          f"{q64 * L}-{(q64 + 1) * L - 1} = two_round fused kernel (ids "
          f"equal, value bit-equal {v64 == ref_value}); wall_ms={wall}")


def theorem4_selects(torch, tF, tmr):
    """Part (c) of the known-OPT phase: multi_threshold on the Theorem-4
    instance (AdversarialThreshold, k = ADV_K, one machine, caps the whole
    set) with adversarial_schedule, on the card: the ratio must lie
    between the bound 1 - (t/(t+1))^t and ADV_MARGIN above it and equal
    the same run on the CPU (rtol 1e-6) for t in ADV_TS."""
    t0 = time.perf_counter()
    for t in ADV_TS:
        alphas = [(1 - 1 / (t + 1)) ** ell for ell in range(1, t + 1)]
        feats, opt = tF.make_adversarial_instance(ADV_K, alphas)
        n = feats.shape[0]
        cfg = tmr.MRConfig(k=ADV_K, n_total=n, n_machines=1, sample_cap=n,
                           survivor_cap=n)
        values, walls = {}, {}
        for where, dev in (("card", "cuda"), ("host", "cpu")):
            gen = torch.Generator(device=dev).manual_seed(0)
            t1 = time.perf_counter()
            res, _ = tmr.multi_threshold_sim(
                tF.AdversarialThreshold(feat_dim=2, k=ADV_K, device=dev),
                torch.from_numpy(feats).to(dev)[None],
                torch.arange(n, dtype=torch.int32, device=dev)[None],
                torch.ones((1, n), dtype=torch.bool, device=dev), opt, t, cfg,
                generator=gen, schedule=tF.adversarial_schedule(alphas))
            values[where] = float(res.value)
            walls[where] = (time.perf_counter() - t1) * 1e3
        ratio, bound = values["card"] / opt, 1 - (t / (t + 1)) ** t
        check(bound <= ratio <= bound + ADV_MARGIN,
              f"Theorem 4, t={t}: ratio {ratio} not within {ADV_MARGIN} "
              f"above the bound {bound}")
        check(abs(values["card"] - values["host"]) <= 1e-6 * values["host"],
              f"Theorem 4, t={t}: card {values['card']} vs CPU "
              f"{values['host']}")
        print(f"[known_opt] Theorem 4, k={ADV_K} t={t} n={n}: ratio={ratio} "
              f"bound={bound} gap={ratio - bound} card value={values['card']} "
              f"CPU value={values['host']} wall_ms={walls['card']}")
    print(f"[known_opt] part (c) took {time.perf_counter() - t0:.3f} s")


def plane_split(torch, X, costs):
    """Print the time of the contiguous copy that ``split_plane`` takes of
    the (m, n/m, d + 1) augmented shard at the filter (f32), and its
    rate."""
    aug = torch.cat([X, costs[:, None]], 1).reshape(M, N // M, D + 1)
    ms = cuda_ms(lambda: aug[..., :-1].contiguous(), 5)
    moved = aug.numel() * 4 + X.numel() * 4
    print(f"[knapsack] plane split copy ({M}, {N // M}, {D + 1}) -> "
          f"({M}, {N // M}, {D}) f32: {ms} ms, {moved / ms / 1e9} TB/s")


def saturating_select(torch, tsel, tseq, ops, X, total):
    """SaturatedCoverage at alpha = 2^-16 (cap ~ 5.3 per feature), where the
    cap binds within the first picks, so the min branch of both kernels
    runs: the fused engine on the kernel route against the lazy engine on
    the plain route, the cap's effect on the value, and the (1/2 - eps)
    guarantee.  Returns the kernel-route select's launch counts."""
    kw = dict(oracle="saturated_coverage", saturated_alpha=SAT_ALPHA)
    label = "saturated_coverage alpha=2^-16 two_round"
    res, value, _, counts = drive(torch, tsel, ops, X, f"{label} fused kernel",
                                  total=total, engine="fused", use_kernel=True,
                                  **kw)
    for name in ("saturated_coverage_marginals", "saturated_coverage_accept"):
        check(counts[name] > 0, f"{label}: {name} never launched")
    _, value_p, _, counts_p = drive(torch, tsel, ops, X, f"{label} lazy plain",
                                    total=total, engine="lazy",
                                    use_kernel=False, **kw)
    check(not any(counts_p.values()), f"plain route launched kernels {counts_p}")
    check(abs(value - value_p) <= 1e-3 * abs(value_p),
          f"{label}: fused value {value} vs plain {value_p}")
    picked = res.sol_ids[:int(res.sol_size)].long()
    unsaturated = float(X[picked].sum())
    check(value < 0.999 * unsaturated,
          f"{label}: value {value} vs the rows' sum {unsaturated}: the cap "
          f"did not bind")
    gval = greedy_value(torch, tsel, tseq, X, "saturated_coverage",
                        total=total, saturated_alpha=SAT_ALPHA)
    check(value >= (0.5 - EPS) * gval,
          f"{label}: value {value} below (1/2 - eps) x greedy {gval}")
    print(f"[main] {label}: value={value} plain={value_p} rows' sum="
          f"{unsaturated} greedy on the first {GREEDY_ROWS} rows={gval} "
          f"ratio={value / gval}")
    return counts


#: the wide selects: (oracle, n, d, reference rows, the kernels of its
#: path, its accept sweep); each corpus is 1 GiB of f32 on the card
WIDE_SELECTS = (
    ("feature_coverage", 1 << 16, 4096, 0,
     ("coverage_marginals", "coverage_accept"), "coverage_accept"),
    ("log_det", 1 << 18, 1024, 0, ("logdet_marginals", "logdet_accept"),
     "logdet_accept"),
    ("facility_location", 1 << 18, 256, 8192,
     ("facility_marginals", "rectified_residual_sum", "facility_accept"),
     "facility_accept"))


def wide_selects(torch, tsel, ops, wrap, la):
    """Selects whose fused engine runs a sweep's wide instance (the users
    who hold 1024- to 4096-wide embeddings or a large reference sample):
    FeatureCoverage on 65,536 x 4096 rows, LogDetDiversity (k_max = 64) on
    262,144 x 1024, FacilityLocation with 8192 reference rows on 262,144 x
    256; two_round, k = 64, m = 16.  The fused engine on the kernel route
    must launch every kernel of its path and pick the lazy plain route's
    ids, with values within rtol 1e-3.  Returns the kernel launches."""
    launches = {}
    for oracle, n, d, r, kernels, accept in WIDE_SELECTS:
        wide = {"coverage_accept": wrap.feature_sweep_per(d) == 0,
                "logdet_accept": la.instance(K, d) == "global",
                "facility_accept": wrap.reference_sweep_per(r) == 0}[accept]
        check(wide, f"{oracle}: {accept} would not run its wide instance")
        gen = torch.Generator(device="cuda").manual_seed(9)
        X = torch.rand((n, d), generator=gen, device="cuda") ** 2
        reference = (torch.rand((r, d), generator=gen, device="cuda")
                     if r else None)
        label = f"{oracle} wide n={n} d={d}" + (f" r={r}" if r else "")
        res, value, _, counts = drive(torch, tsel, ops, X,
                                      f"{label} two_round fused kernel",
                                      reference, oracle=oracle,
                                      engine="fused", use_kernel=True)
        for name in kernels:
            check(counts[name] > 0, f"{label}: {name} never launched")
        add_launches(launches, counts, kernels)
        res_p, value_p, _, counts_p = drive(torch, tsel, ops, X,
                                            f"{label} two_round lazy plain",
                                            reference, oracle=oracle,
                                            engine="lazy", use_kernel=False)
        check(not any(counts_p.values()),
              f"plain route launched kernels {counts_p}")
        check(abs(value - value_p) <= 1e-3 * abs(value_p),
              f"{label}: fused kernel value {value} vs plain {value_p}")
        ids = set(res.sol_ids[:int(res.sol_size)].tolist())
        ids_p = set(res_p.sol_ids[:int(res_p.sol_size)].tolist())
        check(ids == ids_p, f"{label}: kernel ids {sorted(ids)} differ from "
              f"plain {sorted(ids_p)}")
        print(f"[wide] {label}: value={value} plain={value_p} "
              f"|S|={len(ids)} same ids; {accept} launches={counts[accept]} "
              f"(wide instance)")
        del X, reference, res, res_p
        torch.cuda.empty_cache()
    return launches


def phase_marginals_ragged(torch, ref, fm, em):
    """Both tile kernels on dyadic data (facility: cand (a/8)^2, ref b/8,
    states multiples of 1/64; exemplar: cand a/8, ref b/8, states quarters
    of m0), where every product, distance and sum is exact in f32, at the
    ragged edges of the 128 x 128 tile: C = 1000 and 65 rows, r = 45, 100,
    130 and 300 columns, d = 45, 70 and 130, L = 1, 37, 100 and 130 lanes
    (130: two lane groups), every lane mode, f32 and bf16.  The kernels
    must equal the plain versions bit for bit, twice."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(10)
    shapes = (("shared", 37, 1000, 45, 45), ("shared", 100, 65, 100, 70),
              ("shared", 130, 1000, 130, 130), ("shared", 1, 65, 300, 45),
              ("per-lane", 37, 65, 300, 70), ("per-lane", 100, 1000, 45, 130),
              ("unbatched", 1, 1000, 130, 70), ("unbatched", 1, 65, 100, 130))
    for mode, Lk, C, r, d in shapes:
        shape_c = (Lk, C) if mode == "per-lane" else (C,)
        st_shape = (r,) if mode == "unbatched" else (Lk, r)
        for dtype in (torch.float32, torch.bfloat16):
            a = torch.randint(0, 8, shape_c + (d,), generator=g, device=dev)
            Rm = torch.randint(0, 8, (r, d), generator=g, device=dev) / 8.0
            m0 = (Rm * Rm).sum(-1)
            for name, kern, plain, cand, state in (
                    ("facility_marginals", fm.facility_marginals,
                     ref.facility_marginals, ((a / 8.0) ** 2).to(dtype),
                     torch.randint(0, 4 * d, st_shape, generator=g,
                                   device=dev) / 64.0),
                    ("exemplar_marginals", em.exemplar_marginals,
                     ref.exemplar_marginals, (a / 8.0).to(dtype),
                     (m0 * torch.randint(1, 5, st_shape, generator=g,
                                         device=dev) / 4.0).contiguous())):
                got = kern(cand, Rm, state)
                torch.cuda.synchronize()
                check(torch.equal(got, plain(cand, Rm, state)),
                      f"{name} {mode} L={Lk} C={C} r={r} d={d} {dtype}: "
                      f"not bit for bit the plain version on dyadic data")
                check(torch.equal(got, kern(cand, Rm, state)),
                      f"{name}: a repeated launch differs")
    print(f"[kernels] facility_marginals and exemplar_marginals on dyadic "
          f"data at {len(shapes)} ragged shapes and lane modes, f32 and bf16: "
          f"bit for bit the plain versions, repeat=bitwise")


def print_tile_resources(_build):
    """What ptxas said of the marginals tile's kernels, of the lane walk's
    instances, of the feature walk's and of the residual walk's (registers,
    stack, spills), and the
    tile's SASS instruction mix where cuobjdump is at hand."""
    for name, marker in (("coverage_marginals", "lane_rows"),
                         ("saturated_coverage_marginals", "lane_rows"),
                         ("weighted_coverage_marginals", "lane_rows"),
                         ("graph_cut_marginals", "lane_rows"),
                         *((n, "walk_kernel") for n in FEATURE_SWEEPS),
                         ("facility_marginals", "5mtile"),
                         ("facility_marginals", "rwalk"),
                         ("exemplar_marginals", "5mtile")):
        entry, props = None, ""
        for line in _build.ptxas_report(name).splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1]
            elif "spill" in line:
                props = line.strip()
            elif "Used" in line and entry and marker in entry:
                print(f"[build] ptxas {name} {entry}: "
                      f"{line.split(':', 1)[1].strip()}; {props}")
                entry = None
        if marker != "5mtile":
            continue
        cuobjdump = Path(_build.nvcc_path()).with_name("cuobjdump")
        if not cuobjdump.exists():
            print("[build] cuobjdump not found: no SASS instruction mix")
            continue
        sass = subprocess.run([str(cuobjdump), "-sass",
                               str(_build.build_all()[name])],
                              capture_output=True, text=True).stdout
        for fn in sass.split("Function : ")[1:]:
            fname = fn.split(None, 1)[0]
            if "5mtile" not in fname:
                continue
            ops = [[t for t in ln.split(";")[0].split()[1:]
                    if not t.startswith("@")][0].split(".")[0]
                   for ln in fn.splitlines()
                   if ln.strip().startswith("/*") and ";" in ln]
            mix = {op: sum(1 for o in ops if o == op)
                   for op in ("FFMA", "LDS", "STS", "LDG", "STG", "BAR",
                              "FADD", "FMNMX")}
            print(f"[build] sass {name} {fname}: {len(ops)} instructions, "
                  f"{mix}")


# ---------------------------------------------------------------------------
# phase 8: the mesh substrate
# ---------------------------------------------------------------------------

MESH_WORLD = 4               # ranks of the spawned job, all on the one card
MESH_GROUP_TIMEOUT_S = 300   # a process group's collectives give up after
MESH_JOB_TIMEOUT_S = 600     # the spawned job's limit
MESH_PLAN = (0.25, 0)        # chaos_plan(rate, seed) of the fault select
MESH_BASELINE_M = 16         # rand_greedi's machines

#: part (a), one rank over NCCL: (label, spec knobs, what the select takes
#: beyond the corpus: "opt", "costs", "batch" or None)
MESH_ONE_RANK = (
    *((f"{oracle} two_round", dict(oracle=oracle), None)
      for oracle, *_ in ORACLES),
    ("feature_coverage multi_epoch E=2",
     dict(algorithm="multi_epoch", epochs=2), None),
    ("feature_coverage two_round_known_opt",
     dict(algorithm="two_round_known_opt"), "opt"),
    (f"feature_coverage multi_threshold t={KO_T}",
     dict(algorithm="multi_threshold", t=KO_T), "opt"),
    ("feature_coverage knapsack",
     dict(constraint="knapsack", knapsack_budget=KNAP_BUDGET), "costs"),
    ("feature_coverage select_batch", {}, "batch"),
)

#: parts (b) and (c), four spawned ranks over gloo on the one card: (label,
#: mesh (data, model), spec knobs, extra as above).  Under the
#: tensor-parallel oracle the fused engine's accept is the row scan, one
#: all_reduce a row (about 34,000 a select, 92 s through gloo with four
#: processes on one H100), so the tensor-parallel selects run the lazy
#: engine (one all_reduce a trip) and ``mesh_tp_scan`` holds the row scan
#: on one chunk
MESH_SPAWNED = (
    *((f"{oracle} two_round", (MESH_WORLD, 1), dict(oracle=oracle), None)
      for oracle, *_ in ORACLES),
    ("feature_coverage multi_epoch E=2", (MESH_WORLD, 1),
     dict(algorithm="multi_epoch", epochs=2), None),
    ("feature_coverage select_batch", (MESH_WORLD, 1), {}, "batch"),
    ("feature_coverage two_round chaos", (MESH_WORLD, 1),
     dict(faults="chaos"), None),
    ("feature_coverage two_round tp lazy", (2, 2),
     dict(oracle_tp=True, engine="lazy"), None),
    ("weighted_coverage two_round tp lazy", (2, 2),
     dict(oracle="weighted_coverage", oracle_tp=True, engine="lazy"), None),
)


def mesh_corpus(torch):
    """The main path's corpus, drawn again from seed 0 on the card: X
    (N, D) = U[0,1)^2, the 256-row reference set, the knapsack's costs
    and the ground set's f32 feature sum."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    X = torch.rand((N, D), generator=gen, device="cuda") ** 2
    reference = torch.rand((R, D), generator=gen, device="cuda")
    costs = 0.5 + 1.5 * torch.rand(N, generator=gen, device="cuda")
    return dict(X=X, reference=reference, costs=costs, total=X.sum(0))


def mesh_select(torch, tsel, tmr, tfaults, ops, data, label, extra,
                mesh=None, n_machines=1, **spec_kw):
    """One select of the mesh phase through DistributedSelector, on
    ``mesh`` or on the sim with ``n_machines`` machines: the fused engine
    (unless ``spec_kw`` names another) on the kernel route, the sample
    drawn from a generator seeded 1 (every rank alike), the launch counts
    set to 0 just before and read just after.  Checks the ids; returns
    the result as plain Python, which a rank can pickle."""
    if spec_kw.get("faults") == "chaos":
        spec_kw = dict(spec_kw, faults=tfaults.chaos_plan(*MESH_PLAN))
    spec = tsel.SelectorSpec(**{"k": K, "eps": EPS, "chunk": CHUNK,
                                "engine": "fused", "use_kernel": True,
                                **spec_kw})
    kw = {}
    if spec.oracle in ("facility_location", "exemplar"):
        kw["reference"] = data["reference"]
    if spec.oracle in ("saturated_coverage", "graph_cut"):
        kw["total"] = data["total"]
    if extra == "costs":
        kw["element_costs"] = data["costs"]
    sel = tsel.DistributedSelector(spec, n_total=N, feat_dim=D,
                                   n_machines=n_machines, device="cuda",
                                   mesh=mesh, **kw)
    # a mesh rank selects over its shard: its rows (and its columns under
    # the tensor-parallel oracle)
    X = data["X"] if mesh is None else sel.data_sharding(data["X"])
    gen = torch.Generator(device="cuda").manual_seed(1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    if extra == "batch":
        res = sel.select_batch(X, tmr.make_query_batch(QUERY_KS,
                                                       device="cuda"),
                               generator=gen)
        log = sel.round_log_batch
    else:
        res = sel.select(X, opt_estimate=data["opt"] if extra == "opt"
                         else None, generator=gen)
        log = sel.round_log
    values = res.value.reshape(-1).tolist()  # waits for the device
    wall = (time.perf_counter() - t0) * 1e3
    counts = ops.launch_counts()
    ids = res.sol_ids.reshape(len(values), K).cpu()
    sizes = res.sol_size.reshape(-1).tolist()
    for q, size in enumerate(sizes):
        chosen = ids[q, :size].tolist()
        check(size >= 1 and len(set(chosen)) == size
              and min(chosen) >= 0 and max(chosen) < N
              and all(i == -1 for i in ids[q, size:].tolist()),
              f"[mesh] {label}: ids {chosen} not {size} distinct rows")
    return dict(ids=ids.tolist(), size=sizes, value=values,
                n_dropped=res.n_dropped.reshape(-1).tolist(),
                tau_fallback=res.tau_fallback.reshape(-1).tolist(),
                degraded=int(res.degraded), haircut=float(res.haircut),
                records=[(r.name, r.bytes_per_machine, r.bytes_total,
                          r.detail) for r in log.records],
                faults=[tuple(getattr(r, f) for f in r.__dataclass_fields__)
                        for r in log.faults],
                wall_ms=wall, counts=counts, tp=sel.tp,
                peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)


def mesh_compare(label, want, got, records=True, rtol=1e-5):
    """``got`` (a mesh's select) against ``want`` (the sim's): the same
    ids, sizes, overflow and fallback counts, fault records, ``degraded``
    and ``haircut``, and RoundLog records when ``records``; values within
    ``rtol``, and where their bits differ the line says by how much.
    Returns whether every value has the sim's bits."""
    for key in ("ids", "size", "n_dropped", "tau_fallback", "faults",
                "degraded", "haircut", *(("records",) if records else ())):
        check(got[key] == want[key],
              f"[mesh] {label}: {key} {got[key]} differs from the sim's "
              f"{want[key]}")
    bits = got["value"] == want["value"]
    rel = max(abs(g - w) / abs(w) for g, w in zip(got["value"],
                                                  want["value"]))
    check(rel <= rtol, f"[mesh] {label}: value {got['value']} vs the sim's "
          f"{want['value']} (rel {rel})")
    if not bits:
        print(f"[mesh] {label}: the value's bits differ from the sim's by "
              f"rel {rel} ({got['value']} vs {want['value']})")
    return bits


def mesh_kernels(label, spec_kw, counts, tp=False):
    """Check that the select launched every kernel of its oracle's path
    (the accept sweep's too, but under the tensor-parallel oracle, whose
    accept is the row scan); returns {kernel: launches}."""
    oracle = spec_kw.get("oracle", "feature_coverage")
    _, kernels, accept, _ = next(o for o in ORACLES if o[0] == oracle)
    launched = {name: counts[name] for name in kernels}
    for name, n in launched.items():
        want = not (tp and name == accept)
        check((n > 0) == want, f"[mesh] {label}: {name} launched {n} times")
    return launched


def count_collectives(dist):
    """Count every all_reduce and all_gather call of this process (the
    port calls them through the torch.distributed module)."""
    counts = {"all_reduce": 0, "all_gather": 0}
    for name in counts:
        fn = getattr(dist, name)

        def wrapped(*args, _fn=fn, _name=name, **kw):
            counts[_name] += 1
            return _fn(*args, **kw)
        setattr(dist, name, wrapped)
    return counts


def mesh_tp_scan(torch, mesh, collectives):
    """Part (c)'s row scan: ``TPOracle.chunk_accept`` (the generic scan,
    one all_reduce over the model axis a row) on one chunk at the fused
    engine's shape (L, B, D), with this rank's column block, held against
    the full-width oracle's accept (the coverage_accept kernel) on the
    same rows, as the kernel checks hold a sweep against its plain
    version.  Every rank draws the same chunk.  Returns its wall ms and
    all_reduce calls (``collectives``, count_collectives' counts)."""
    from repro_torch.core import functions as F
    from repro_torch.kernels import ref
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(2)
    x = torch.rand((L, B, D), generator=g, device=dev) ** 2
    state = torch.rand((L, D), generator=g, device=dev) * 4
    elig = torch.rand((L, B), generator=g, device=dev) < 0.9
    tau = lane_taus(torch, ref.coverage_marginals(x, state, None))
    budget = torch.where(torch.arange(L, device=dev) % 5 == 0, 3,
                         K).to(torch.int32)
    w = D // mesh.tp
    cols = slice(mesh.coords["model"] * w, (mesh.coords["model"] + 1) * w)
    tp = F.TPOracle(base=F.FeatureCoverage(feat_dim=w, use_kernel=True,
                                           device=dev),
                    group=mesh.group("model"))
    full = F.FeatureCoverage(feat_dim=D, use_kernel=True, device=dev)
    want = full.chunk_accept(state, x, elig, tau, budget)
    collectives.update(all_reduce=0, all_gather=0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = tp.chunk_accept(state[:, cols].contiguous(),
                          x[..., cols].contiguous(), elig, tau, budget)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    ties, err = check_sweep(
        "[mesh] (c) TPOracle.chunk_accept", got,
        (want[0], want[1][:, cols], want[2]), tau, RTOL * tau.abs(),
        lambda l, a, b, what: torch.allclose(a, b, rtol=RTOL, atol=ATOL))
    return dict(wall_ms=wall, all_reduce=collectives["all_reduce"],
                accepted=int(got[0].sum()), ties=ties, max_abs_err=err)


def mesh_rank(rank, world, store, out_dir):
    """A rank of parts (b) and (c): joins the gloo job on the one card,
    draws the corpus from seed 0, and runs every select of MESH_SPAWNED on
    its mesh; writes its results to ``out_dir``."""
    import datetime
    import pickle
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    import torch.distributed as dist
    from repro_torch.core import faults as tfaults
    from repro_torch.core import mapreduce as tmr
    from repro_torch.core import selector as tsel
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_mesh_for
    torch.cuda.set_device(0)
    dist.init_process_group(
        "gloo", init_method=f"file://{store}", rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=MESH_GROUP_TIMEOUT_S))
    meshes = {shape: make_mesh_for(world, model_parallel=shape[1])
              for shape in sorted({case[1] for case in MESH_SPAWNED})}
    # connect every group before the first timed select
    for mesh in meshes.values():
        for axes in (("data",), ("model",)):
            dist.barrier(group=mesh.group(axes))
    collectives = count_collectives(dist)
    data = mesh_corpus(torch)
    results = []
    for label, shape, spec_kw, extra in MESH_SPAWNED:
        collectives.update(all_reduce=0, all_gather=0)
        r = mesh_select(torch, tsel, tmr, tfaults, ops, data, label, extra,
                        mesh=meshes[shape], **spec_kw)
        r["collectives"] = dict(collectives)
        results.append(r)
        # four ranks share the card: hand back what this select cached
        torch.cuda.empty_cache()
    scan = mesh_tp_scan(torch, meshes[(2, 2)], collectives)
    from repro_torch.streaming import distributed_sieve as tds
    from repro_torch.streaming import sieve as tsieve
    seed = sieve_chaos_seed(tfaults, world)
    sieves = [sieve_merge(torch, tds, tsieve, tsel, tfaults, ops, data["X"],
                          world, mesh=meshes[(world, 1)], seed=s)
              for s in (None, seed)]
    dist.destroy_process_group()
    with open(Path(out_dir) / f"rank{rank}.pkl", "wb") as f:
        pickle.dump((results, scan, sieves), f)


def mesh_spawn(torch):
    """Start the MESH_WORLD ranks (spawn start method) and wait for them;
    any rank that raises, or a job past MESH_JOB_TIMEOUT_S, fails the
    phase, and every rank is gone when this returns.  Returns each rank's
    results."""
    import pickle
    import tempfile
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory() as tmp:
        ctx = mp.start_processes(mesh_rank,
                                 args=(MESH_WORLD, f"{tmp}/store", tmp),
                                 nprocs=MESH_WORLD, join=False,
                                 start_method="spawn")
        deadline = time.monotonic() + MESH_JOB_TIMEOUT_S
        try:
            while not ctx.join(timeout=5):
                check(time.monotonic() < deadline,
                      f"[mesh] the {MESH_WORLD}-rank job outlived "
                      f"{MESH_JOB_TIMEOUT_S} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join()
        out = []
        for r in range(MESH_WORLD):
            with open(Path(tmp) / f"rank{r}.pkl", "rb") as f:
                out.append(pickle.load(f))
        return out


def mesh_phase(torch, tsel, tmr, ops, gval, two_round_value):
    """Phase 8: the mesh substrate on the main path's corpus.  (a) One rank
    over NCCL in this process against the sim at m = 1; (b) four spawned
    ranks over gloo on the one card, (data = 4, model = 1), against the sim
    at m = 4, and under a chaos plan against the sim under the same plan;
    (c) the tensor-parallel oracle on (data = 2, model = 2) against the sim
    at m = 2 on the full-width oracle; (d) rand_greedi at m = 16.  Every
    rank must equal rank 0.  Returns the mesh selects' launches by kernel
    (rank 0's for the spawned job)."""
    import datetime
    import tempfile
    import torch.distributed as dist
    from repro_torch.core import distributed_baselines as tdb
    from repro_torch.core import faults as tfaults
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.streaming import distributed_sieve as tds
    from repro_torch.streaming import sieve as tsieve
    card = smi()
    data = mesh_corpus(torch)
    data["opt"] = gval
    launches = {}

    t0 = time.perf_counter()
    torch.cuda.set_device(0)
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group(
            "nccl", init_method=f"file://{tmp}/store", rank=0, world_size=1,
            timeout=datetime.timedelta(seconds=MESH_GROUP_TIMEOUT_S))
        try:
            mesh = make_smoke_mesh()
            # connect the groups before the first timed select
            for axes in (("data",), ("model",)):
                dist.all_reduce(torch.zeros(1, device="cuda"),
                                group=mesh.group(axes))
            for label, spec_kw, extra in MESH_ONE_RANK:
                want = mesh_select(torch, tsel, tmr, tfaults, ops, data,
                                   label, extra, n_machines=1, **spec_kw)
                got = mesh_select(torch, tsel, tmr, tfaults, ops, data,
                                  label, extra, mesh=mesh, **spec_kw)
                bits = mesh_compare(f"(a) {label}", want, got)
                launched = mesh_kernels(label, spec_kw, got["counts"])
                add_launches(launches, got["counts"], launched)
                print(f"[mesh] (a) one rank, NCCL: {label}: value="
                      f"{got['value']} |S|={got['size']} sim_bits={bits} "
                      f"wall_ms={got['wall_ms']} sim_wall_ms="
                      f"{want['wall_ms']} launches={launched} card: {card}")
            want = sieve_merge(torch, tds, tsieve, tsel, tfaults, ops,
                               data["X"], 1)
            got = sieve_merge(torch, tds, tsieve, tsel, tfaults, ops,
                              data["X"], 1, mesh=mesh)
            sieve_compare("(a) sieve_and_merge", got, want)
            add_launches(launches, got["counts"], ("coverage_marginals",))
            print(f"[mesh] (a) one rank, NCCL: sieve_and_merge_mesh over "
                  f"{N} rows: value={got['value']} |S|={got['size']}, the "
                  f"sim's (m = 1) ids, value bits and records; wall_ms="
                  f"{got['wall_ms']} sim_wall_ms={want['wall_ms']} card: "
                  f"{card}")
        finally:
            dist.destroy_process_group()
    print(f"[mesh] part (a) took {time.perf_counter() - t0:.3f} s")

    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks, scans, sieves = zip(*mesh_spawn(torch))
    t_job = time.perf_counter() - t0
    for r, scan in enumerate(scans):
        check(scan["all_reduce"] == B,
              f"[mesh] (c) rank {r}: the row scan made {scan['all_reduce']} "
              f"all_reduces, not one a row ({B})")
        check(scan["accepted"] == scans[0]["accepted"],
              f"[mesh] (c) rank {r}: the row scan accepted "
              f"{scan['accepted']} rows, rank 0 {scans[0]['accepted']}")
    print(f"[mesh] (c) TPOracle.chunk_accept, the fused engine's row scan, "
          f"on one ({L}, {B}, {D}) chunk, mesh (2, 2), against the "
          f"full-width coverage_accept kernel: accepted="
          f"{scans[0]['accepted']} near_tau_ties={scans[0]['ties']} "
          f"max_abs_err={max(s['max_abs_err'] for s in scans)} all_reduces="
          f"{scans[0]['all_reduce']} wall_ms={[s['wall_ms'] for s in scans]}"
          f" card: {card}")
    for i, (label, shape, spec_kw, extra) in enumerate(MESH_SPAWNED):
        got = ranks[0][i]
        for r in range(1, MESH_WORLD):
            for key in ("ids", "size", "value", "n_dropped", "tau_fallback",
                        "faults", "degraded", "haircut", "records",
                        "collectives"):
                check(ranks[r][i][key] == got[key],
                      f"[mesh] {label}: rank {r}'s {key} "
                      f"{ranks[r][i][key]} is not rank 0's {got[key]}")
        tp = shape[1] > 1
        check(got["tp"] == tp, f"[mesh] {label}: tp={got['tp']}")
        want = mesh_select(torch, tsel, tmr, tfaults, ops, data, label,
                           extra, n_machines=shape[0], **spec_kw)
        bits = mesh_compare(f"({'c' if tp else 'b'}) {label}", want, got,
                            records=not tp)
        if spec_kw.get("faults"):
            check(got["degraded"] == 1 and got["faults"],
                  f"[mesh] {label}: the plan realized no fault")
        launched = mesh_kernels(label, spec_kw, got["counts"], tp=tp)
        add_launches(launches, got["counts"], launched)
        walls = [ranks[r][i]["wall_ms"] for r in range(MESH_WORLD)]
        print(f"[mesh] ({'c' if tp else 'b'}) {MESH_WORLD} ranks on one "
              f"card, gloo, mesh {shape}: {label}: value={got['value']} "
              f"|S|={got['size']} sim_bits={bits} wall_ms={walls} "
              f"sim_wall_ms={want['wall_ms']} collectives a rank="
              f"{got['collectives']} peak_gib a rank="
              f"{[ranks[r][i]['peak_gib'] for r in range(MESH_WORLD)]} "
              f"launches a rank={launched} faults="
              f"{len(got['faults'])} degraded={got['degraded']} haircut="
              f"{got['haircut']} card: {card}")
    seed = sieve_chaos_seed(tfaults, MESH_WORLD)
    for i, s in enumerate((None, seed)):
        want = sieve_merge(torch, tds, tsieve, tsel, tfaults, ops, data["X"],
                           MESH_WORLD, seed=s)
        label = (f"(b) sieve_and_merge" if s is None else
                 f"(b) sieve_and_merge chaos_plan({SIEVE_PLAN_RATE}, "
                 f"seed={s})")
        for r in range(MESH_WORLD):
            sieve_compare(f"{label} rank {r}", sieves[r][i], want)
        got = sieves[0][i]
        if s is not None:
            check(got["degraded"] == 1 and got["faults"],
                  f"[mesh] {label}: the plan realized no fault")
        add_launches(launches, got["counts"], ("coverage_marginals",))
        print(f"[mesh] {label}, {MESH_WORLD} ranks on one card, gloo: value="
              f"{got['value']} |S|={got['size']}, the sim's (m = "
              f"{MESH_WORLD}) ids, value bits, records and faults "
              f"{got['faults']} on every rank; wall_ms="
              f"{[sieves[r][i]['wall_ms'] for r in range(MESH_WORLD)]} "
              f"sim_wall_ms={want['wall_ms']} card: {card}")
    print(f"[mesh] parts (b) and (c): the {MESH_WORLD}-rank job took "
          f"{t_job:.3f} s, with the sim selects "
          f"{time.perf_counter() - t0:.3f} s")

    t0 = time.perf_counter()
    oracle = tsel.make_oracle(tsel.SelectorSpec(k=K, use_kernel=True), D,
                              "cuda")
    m = MESH_BASELINE_M
    ids = torch.arange(N, dtype=torch.int32, device="cuda")
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    res, log = tdb.rand_greedi(oracle, data["X"].reshape(m, N // m, D),
                               ids.reshape(m, -1),
                               torch.ones(m, N // m, dtype=torch.bool,
                                          device="cuda"), K)
    value = float(res.value)
    wall = (time.perf_counter() - t1) * 1e3
    chosen = res.sol_ids[res.sol_ids >= 0].tolist()
    check(len(chosen) == int(res.sol_size) == len(set(chosen)) > 0,
          f"[mesh] rand_greedi: ids {chosen} and size {int(res.sol_size)}")
    print(f"[mesh] (d) rand_greedi m={m}: value={value} |S|="
          f"{int(res.sol_size)} wall_ms={wall}; two_round fused kernel "
          f"(m = {M}) value={two_round_value}; ratio="
          f"{value / two_round_value} rounds={log.n_rounds} card: {card}")
    print(f"[mesh] part (d) took {time.perf_counter() - t0:.3f} s")
    return launches


# ---------------------------------------------------------------------------
# phase 9: the streaming path (the sieve, out-of-core ingest, checkpoint and
# restore, the selection service)
# ---------------------------------------------------------------------------

STREAM_CHUNK = 1 << 16       # sieve chunk rows: 64 MiB of f32 rows a chunk
STREAM_ROWS_B = 1 << 18      # rows a stream of part (b): 4 chunks
STREAM_SPLITS = (100_003, 400_000, 700_001)   # part (a)'s uneven batches
SERVE_INIT = 1 << 18         # part (d)'s initial corpus
SERVE_BATCHES = 4            # part (d)'s ingested batches of STREAM_CHUNK
SERVE_TIMEOUT_S = 300        # part (d)'s child and part (e)'s CLI runs
STREAM_BUDGET = 16           # part (a)'s select(budget=) check
SIEVE_PLAN_RATE = 0.25       # chaos_plan rate of the sieve's fault runs


def sieve_spec(tsieve, **kw):
    """The phase's SieveSpec: k = 64, eps = 0.15 (37 lanes, a reservoir of
    128), the dense engine unless ``kw`` names another."""
    return tsieve.SieveSpec(**{"k": K, "eps": EPS, "chunk": CHUNK, **kw})


def stream_oracle(tsel, name, stats, use_kernel, **spec_kw):
    needs = next(o[3] for o in ORACLES if o[0] == name)
    return tsel.make_oracle(
        tsel.SelectorSpec(k=K, oracle=name, use_kernel=use_kernel, **spec_kw),
        D, "cuda", **({needs: stats[needs]} if needs else {}))


def check_ids(label, res, n):
    """The result's ids are ``sol_size`` distinct rows of n, -1 padded;
    returns their checksum in order."""
    size = int(res.sol_size)
    ids = res.sol_ids.cpu().long()
    chosen = ids[:size].tolist()
    check(size >= 1 and len(set(chosen)) == size and min(chosen) >= 0
          and max(chosen) < n and all(i == -1 for i in ids[size:].tolist()),
          f"[stream] {label}: ids {chosen} not {size} distinct rows")
    return zlib.crc32(ids[:size].numpy().tobytes())


def stream_run(torch, tstream, ops, oracle, spec, rows, label, splits=(),
               budget=None):
    """One StreamingSelector over host ``rows`` (ingested whole, or in the
    batches ``splits`` cuts), then a warm select: the launch counts set to
    0 just before the ingest and read just after the select.  Returns
    (selector, result, value, counts, ms a sieve chunk, select ms)."""
    sel = tstream.StreamingSelector(oracle, spec, D, chunk_elems=STREAM_CHUNK)
    n = rows.shape[0]
    cuts = (0, *splits, n)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    for a, b in zip(cuts[:-1], cuts[1:]):
        sel.ingest(rows[a:b])
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    res = sel.select(budget)
    value = float(res.value)  # waits for the device
    t2 = time.perf_counter()
    counts = read_counts(ops)
    chunks = -(-n // STREAM_CHUNK)
    crc = check_ids(label, res, n)
    check(value == value and 0 < value < float("inf"),
          f"[stream] {label}: value {value}")
    nonzero = {k: v for k, v in counts.items() if v and "@" not in k}
    ms_chunk = (t1 - t0) * 1e3 / chunks
    print(f"[stream] {label}: value={value} |S|={int(res.sol_size)} "
          f"ids_crc32={crc} chunks={chunks} ms_a_chunk={ms_chunk} "
          f"warm_select_ms={(t2 - t1) * 1e3} launches={nonzero}")
    return sel, res, value, counts, ms_chunk, (t2 - t1) * 1e3


def same_stream(label, got, want, rtol=1e-3):
    """``got`` (a kernel-route stream's (result, value)) against ``want``
    (the plain route's): the same ids, values within ``rtol``."""
    (r, v), (rp, vp) = got, want
    check(r.sol_ids.tolist() == rp.sol_ids.tolist(),
          f"[stream] {label}: ids {r.sol_ids.tolist()} differ from the plain "
          f"route's {rp.sol_ids.tolist()}")
    check(abs(v - vp) <= rtol * abs(vp),
          f"[stream] {label}: value {v} vs the plain route's {vp}")
    return abs(v - vp) / abs(vp)


def stream_kernels(label, name, counts, fused, launches):
    """Each kernel of the oracle's path launched (its accept sweep only on
    the fused engine); adds them to ``launches``."""
    _, kernels, accept, _ = next(o for o in ORACLES if o[0] == name)
    for k in kernels:
        want = fused if k == accept else True
        check((counts[k] > 0) == want,
              f"[stream] {label}: {k} launched {counts[k]} times")
    add_launches(launches, counts, kernels)


def prefetch_rates(torch, tstream, rows, card):
    """Host -> device GB/s of prefetch_to_device over ``rows`` (the chunks
    handed over, the consumer doing nothing else), beside one pinned
    STREAM_CHUNK x D copy timed alone (the copy engine's rate)."""
    corpus = tstream.HostCorpus(D, STREAM_CHUNK)
    corpus.append(rows)
    chunk_bytes = STREAM_CHUNK * (D * 4 + 4 + 1)
    n_chunks = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in tstream.prefetch_to_device(corpus.chunks(0), "cuda"):
        n_chunks += 1
    torch.cuda.synchronize()
    prefetch_gbs = n_chunks * chunk_bytes / (time.perf_counter() - t0) / 1e9
    pinned = torch.empty((STREAM_CHUNK, D), pin_memory=True)
    dev = torch.empty((STREAM_CHUNK, D), device="cuda")
    copy_ms = cuda_ms(lambda: dev.copy_(pinned, non_blocking=True), 20)
    copy_gbs = STREAM_CHUNK * D * 4 / copy_ms / 1e6
    print(f"[stream] prefetch_to_device: {n_chunks} chunks of "
          f"{chunk_bytes} B, {prefetch_gbs} GB/s host -> device; one pinned "
          f"{STREAM_CHUNK} x {D} f32 copy alone: {copy_ms} ms, {copy_gbs} "
          f"GB/s; card: {card}")
    return prefetch_gbs, copy_gbs


def stream_part_a(torch, tstream, tsel, tcons, ops, data, X_host, gval,
                  launches, card):
    """Part (a): FeatureCoverage over all 2^20 rows."""
    fc = stream_oracle(tsel, "feature_coverage", data, True)
    plain = stream_oracle(tsel, "feature_coverage", data, False)
    out = {}
    _, res_p, v_p, counts, _, _ = stream_run(
        torch, tstream, ops, plain, sieve_spec(tstream, engine="lazy"),
        X_host, "feature_coverage lazy plain")
    check(not any(counts.values()), f"plain route launched kernels {counts}")
    for engine in ("dense", "fused"):
        sel, res, v, counts, ms, sel_ms = stream_run(
            torch, tstream, ops, fc, sieve_spec(tstream, engine=engine),
            X_host, f"feature_coverage {engine} kernel")
        rel = same_stream(f"feature_coverage {engine}", (res, v), (res_p, v_p))
        stream_kernels(f"feature_coverage {engine}", "feature_coverage",
                       counts, engine == "fused", launches)
        check(v >= (0.5 - EPS / 2) * gval, f"[stream] feature_coverage "
              f"{engine}: value {v} below (1/2 - eps/2) x greedy {gval}")
        print(f"[stream] feature_coverage {engine} kernel vs lazy plain: "
              f"same ids, rel_diff={rel}; value/greedy={v / gval} "
              f"(greedy on the first {GREEDY_ROWS} rows); card: {card}")
        out[engine] = (sel, res, v, ms, sel_ms)

    # the same rows in four uneven batches: the one-shot ingest's bits
    sel1, res1, v1 = out["dense"][:3]
    sel4, res4, v4, _, _, _ = stream_run(
        torch, tstream, ops, fc, sieve_spec(tstream), X_host,
        "feature_coverage dense kernel, 4 uneven batches",
        splits=STREAM_SPLITS)
    from repro_torch.checkpoint.checkpointer import flatten
    leaves1, leaves4 = flatten(sel1.state), flatten(sel4.state)
    check(res4.sol_ids.tolist() == res1.sol_ids.tolist()
          and res4.value.cpu().numpy().tobytes()
          == res1.value.cpu().numpy().tobytes()
          and len(leaves1) == len(leaves4)
          and all(torch.equal(a, b) for (_, a), (_, b) in zip(leaves1,
                                                              leaves4)),
          "[stream] four uneven batches do not give the one-shot bits")
    print(f"[stream] four uneven batches {STREAM_SPLITS}: the one-shot "
          f"ingest's ids, value bits and all {len(leaves1)} SieveState "
          f"leaves")

    _, _, v_bf, counts, _, _ = stream_run(
        torch, tstream, ops, fc, sieve_spec(tstream, precision="bf16"),
        X_host, "feature_coverage dense kernel bf16")
    add_launches(launches, counts, ("coverage_marginals",))
    check(v_bf >= 0.99 * v1, f"[stream] bf16 value {v_bf} < 0.99 x f32 {v1}")
    print(f"[stream] bf16/f32 value ratio = {v_bf / v1}")

    knap = tcons.make_constraint("knapsack", N, costs=data["costs"],
                                 budget=KNAP_BUDGET, device="cuda")
    _, res_k, _, counts, _, _ = stream_run(
        torch, tstream, ops, fc, sieve_spec(tstream, constraint=knap),
        X_host, f"feature_coverage dense kernel knapsack {KNAP_BUDGET}")
    add_launches(launches, counts, ("coverage_marginals",))
    ids = res_k.sol_ids[:int(res_k.sol_size)].long()
    spent = float(data["costs"][ids].double().sum())
    check(spent <= KNAP_BUDGET, f"[stream] knapsack: costs sum to {spent}")
    print(f"[stream] knapsack: |S|={int(res_k.sol_size)} spent={spent} of "
          f"{KNAP_BUDGET}")

    caps = torch.full((N_PARTS,), PART_CAP, dtype=torch.int32)
    part = tcons.make_constraint("partition_matroid", N, parts=data["parts"],
                                 capacities=caps, device="cuda")
    _, res_m, _, counts, _, _ = stream_run(
        torch, tstream, ops, fc, sieve_spec(tstream, constraint=part),
        X_host, f"feature_coverage dense kernel partition({N_PARTS} x "
        f"{PART_CAP})")
    add_launches(launches, counts, ("coverage_marginals",))
    ids = res_m.sol_ids[:int(res_m.sol_size)].long()
    per_part = torch.bincount(data["parts"][ids].long(),
                              minlength=N_PARTS).cpu()
    check(bool((per_part <= PART_CAP).all()),
          f"[stream] partition: per-part counts {per_part.tolist()}")
    print(f"[stream] partition matroid: per-part counts "
          f"{per_part.tolist()} caps={PART_CAP}")

    small = sel1.select(STREAM_BUDGET)
    check_ids("select(budget=16)", small, N)
    check(int(small.sol_size) <= STREAM_BUDGET,
          f"[stream] select(budget={STREAM_BUDGET}) gave "
          f"{int(small.sol_size)} rows")
    print(f"[stream] select(budget={STREAM_BUDGET}): |S|="
          f"{int(small.sol_size)} value={float(small.value)}")
    return {e: out[e][3:] for e in out}


def stream_part_b(torch, tstream, tsel, ops, data, X_host, gvals, launches,
                  card):
    """Part (b): the other seven oracles, 2^18 rows each."""
    rows = X_host[:STREAM_ROWS_B]
    by = {}
    for name, _, _, _ in ORACLES[1:]:
        t0 = time.perf_counter()
        _, res_p, v_p, counts, _, _ = stream_run(
            torch, tstream, ops, stream_oracle(tsel, name, data, False),
            sieve_spec(tstream, engine="lazy"), rows, f"{name} lazy plain")
        check(not any(counts.values()),
              f"plain route launched kernels {counts}")
        for engine in ("dense", "fused"):
            sel, res, v, counts, ms, _ = stream_run(
                torch, tstream, ops, stream_oracle(tsel, name, data, True),
                sieve_spec(tstream, engine=engine), rows,
                f"{name} {engine} kernel")
            rel = same_stream(f"{name} {engine}", (res, v), (res_p, v_p))
            stream_kernels(f"{name} {engine}", name, counts,
                           engine == "fused", launches)
            by[(name, engine)] = (sel, res, v)
            print(f"[stream] {name} {engine} kernel vs lazy plain: same ids, "
                  f"rel_diff={rel}, ms_a_chunk={ms}; value/greedy(main "
                  f"path)={v / gvals[name]}")
        print(f"[stream] {name}: {time.perf_counter() - t0:.3f} s")
    # MutualInformation at noise 1 is exactly half of log-det, but the
    # sieve's lane grid sits at absolute powers of (1 + eps): halving every
    # gain shifts the window by log 2 / log 1.15 = 4.96 exponents, not a
    # whole number, so the two streams run other thresholds.  The finish is
    # scale-equivariant (its grid is v_max (1 + eps)^j / 2k): MI finishing
    # log-det's live state, its v_max and logdet halved (exact), must give
    # log-det's finish ids at exactly half the value
    mi = stream_oracle(tsel, "mutual_information", data, True)
    for engine in ("dense", "fused"):
        sel, res, v = by[("log_det", engine)]
        st = sel.state
        U, logdet, size = st.oracle_states
        half = st._replace(v_max=st.v_max * 0.5,
                           oracle_states=(U, logdet * 0.5, size))
        r_mi = tstream.sieve_finish(mi, sel.spec, half)
        check(r_mi.sol_ids.tolist() == res.sol_ids.tolist()
              and float(r_mi.value) == 0.5 * v,
              f"[stream] {engine}: mutual information's finish of log-det's "
              f"state {float(r_mi.value)} is not half of log-det's {v} with "
              f"its ids")
        _, res_mi, v_mi = by[("mutual_information", engine)]
        same = len(set(res_mi.sol_ids.tolist()) & set(res.sol_ids.tolist()))
        print(f"[stream] {engine}: mutual_information finishing log-det's "
              f"state = 0.5 x log_det's finish, same ids; the two streams "
              f"(other lane thresholds): MI value={v_mi}, 2 x MI / log_det "
              f"= {2 * v_mi / v}, {same}/{K} ids shared")


def sieve_chaos_seed(tfaults, m):
    """The first seed whose chaos_plan(SIEVE_PLAN_RATE) realizes a fault on
    the sieve's one gather (epoch 0's shard loss or gather 0's transient
    faults) at m machines."""
    for seed in range(256):
        plan = tfaults.chaos_plan(SIEVE_PLAN_RATE, seed=seed)
        masks = plan.round_masks(0, m)
        if plan.loss_mask(0, m).any() or any(x.any() for x in masks.values()):
            return seed
    raise RuntimeError("no seed realizes a fault")


def sieve_merge(torch, tds, tsieve, tsel, tfaults, ops, X, m, mesh=None,
                seed=None):
    """sieve_and_merge at m machines of X's rows (one chunk of 65,536 rows
    each at m = 16), FeatureCoverage, the dense engine on the kernel route:
    on the sim, or on ``mesh`` over this rank's rows; under
    chaos_plan(SIEVE_PLAN_RATE, seed) when ``seed`` is given.  Returns the
    result as plain Python, which a rank can pickle."""
    oracle = tsel.make_oracle(tsel.SelectorSpec(k=K, use_kernel=True), D,
                              "cuda")
    plan = (None if seed is None
            else tfaults.chaos_plan(SIEVE_PLAN_RATE, seed=seed))
    spec = sieve_spec(tsieve)
    n_loc = X.shape[0] // m
    ids = torch.arange(X.shape[0], dtype=torch.int32, device="cuda")
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    if mesh is None:
        res, log = tds.sieve_and_merge_sim(
            oracle, X.reshape(m, n_loc, D), ids.reshape(m, n_loc),
            torch.ones(m, n_loc, dtype=torch.bool, device="cuda"), spec,
            chunk_elems=STREAM_CHUNK, faults=plan)
    else:
        run, log = tds.sieve_and_merge_mesh(oracle, spec, mesh,
                                            chunk_elems=STREAM_CHUNK,
                                            faults=plan)
        c = mesh.index(("data",))
        rows = slice(c * n_loc, (c + 1) * n_loc)
        res = run(X[rows].contiguous(), ids[rows])
    value = float(res.value)  # waits for the device
    wall = (time.perf_counter() - t0) * 1e3
    check_ids("sieve_and_merge", res, X.shape[0])
    return dict(ids=res.sol_ids.tolist(), size=int(res.sol_size),
                value=value, n_dropped=int(res.n_dropped),
                degraded=int(res.degraded), haircut=float(res.haircut),
                records=[(r.name, r.bytes_per_machine, r.bytes_total,
                          r.detail) for r in log.records],
                faults=[tuple(getattr(r, f) for f in r.__dataclass_fields__)
                        for r in log.faults],
                wall_ms=wall, counts=read_counts(ops))


def sieve_compare(label, got, want):
    """A mesh's sieve_and_merge against the sim's: the same ids, size,
    overflow, records, fault records, degraded and haircut, and the value's
    bits."""
    for key in ("ids", "size", "value", "n_dropped", "degraded", "haircut",
                "records", "faults"):
        check(got[key] == want[key], f"[mesh] {label}: {key} {got[key]} "
              f"differs from the sim's {want[key]}")


def stream_part_c(torch, tds, tsieve, tsel, tfaults, ops, X, gval, two_round,
                  launches, card):
    """Part (c): sieve_and_merge_sim at m = 16 over the whole corpus."""
    m = M
    r = sieve_merge(torch, tds, tsieve, tsel, tfaults, ops, X, m)
    add_launches(launches, r["counts"], ("coverage_marginals",))
    check(len(r["records"]) == 1 and r["n_dropped"] == 0,
          f"[stream] sieve_and_merge: records {r['records']} n_dropped "
          f"{r['n_dropped']}")
    check(r["value"] >= (0.5 - EPS) * gval,
          f"[stream] sieve_and_merge: value {r['value']} below (1/2 - eps) x "
          f"greedy {gval}")
    print(f"[stream] (c) sieve_and_merge_sim m={m}: value={r['value']} "
          f"|S|={r['size']} n_dropped={r['n_dropped']} wall_ms="
          f"{r['wall_ms']}; two_round fused kernel value={two_round}, "
          f"ratio={r['value'] / two_round}; value/greedy={r['value'] / gval}; "
          f"round: {r['records'][0]}; card: {card}")
    seed = sieve_chaos_seed(tfaults, m)
    rc = sieve_merge(torch, tds, tsieve, tsel, tfaults, ops, X, m, seed=seed)
    add_launches(launches, rc["counts"], ("coverage_marginals",))
    check(rc["faults"] and rc["degraded"] == 1,
          f"[stream] chaos seed {seed}: faults {rc['faults']} degraded "
          f"{rc['degraded']}")
    for rec in rc["faults"]:
        print(f"[stream] (c) chaos_plan({SIEVE_PLAN_RATE}, seed={seed}) "
              f"FaultRecord {rec}")
    print(f"[stream] (c) under chaos_plan({SIEVE_PLAN_RATE}, seed={seed}) "
          f"(the first seed that realizes a fault on the one gather): "
          f"value={rc['value']} degraded={rc['degraded']} haircut="
          f"{rc['haircut']} wall_ms={rc['wall_ms']}")


def serve_data(torch):
    """Part (d)'s corpus: the main path's first SERVE_INIT rows, then
    SERVE_BATCHES batches of STREAM_CHUNK rows, on the host."""
    X = mesh_corpus(torch)["X"]
    init = X[:SERVE_INIT].cpu()
    batches = [X[SERVE_INIT + i * STREAM_CHUNK:
                 SERVE_INIT + (i + 1) * STREAM_CHUNK].cpu()
               for i in range(SERVE_BATCHES)]
    return init, batches


def serve_service(tsel, tserve, init):
    spec = tsel.SelectorSpec(k=K, eps=EPS, chunk=CHUNK, use_kernel=True)
    return tserve.SelectionService(spec, None, init,
                                   stream_chunk=STREAM_CHUNK, device="cuda")


def serve_child(_, ck_dir):
    """Part (d)'s killed service: ingests two batches over the initial
    corpus, saves (async, then waits), and exits without any cleanup."""
    import os
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.core import selector as tsel
    from repro_torch.launch import select_serve as tserve
    torch.cuda.set_device(0)
    init, batches = serve_data(torch)
    svc = serve_service(tsel, tserve, init)
    for b in batches[:2]:
        svc.ingest(b)
    ck = Checkpointer(ck_dir)
    svc.save(ck, 2, blocking=False)
    ck.wait()
    os._exit(0)


def stream_part_d(torch, tsel, ops, launches, card):
    """Part (d): the service killed in a child process and restored here,
    against the uninterrupted run."""
    import tempfile
    import torch.multiprocessing as mp
    from repro_torch.checkpoint.checkpointer import Checkpointer, flatten
    from repro_torch.launch import select_serve as tserve
    init, batches = serve_data(torch)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        ctx = mp.start_processes(serve_child, args=(tmp,), nprocs=1,
                                 join=False, start_method="spawn")
        deadline = time.monotonic() + SERVE_TIMEOUT_S
        try:
            while not ctx.join(timeout=5):
                check(time.monotonic() < deadline,
                      f"[stream] the killed service outlived "
                      f"{SERVE_TIMEOUT_S} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join()
        t_child = time.perf_counter() - t0
        ops.reset_launch_counts()
        svc = serve_service(tsel, tserve, init)
        step = svc.restore(Checkpointer(tmp))
        check(step == 2 and svc.stream.n_streamed == SERVE_INIT
              + 2 * STREAM_CHUNK, f"[stream] restored step {step} at "
              f"{svc.stream.n_streamed} rows")
        for b in batches[2:]:
            svc.ingest(b)
        res = svc.select_warm()
        value = float(res.value)
        add_launches(launches, read_counts(ops), ("coverage_marginals",))
    full = serve_service(tsel, tserve, init)
    for b in batches:
        full.ingest(b)
    res_full = full.select_warm()
    la, lb = flatten(svc.stream.state), flatten(full.stream.state)
    check(res.sol_ids.tolist() == res_full.sol_ids.tolist()
          and res.value.cpu().numpy().tobytes()
          == res_full.value.cpu().numpy().tobytes()
          and len(la) == len(lb)
          and all(torch.equal(a, b) for (_, a), (_, b) in zip(la, lb)),
          "[stream] (d) the restored service is not the uninterrupted run")
    print(f"[stream] (d) service killed after 2 of {SERVE_BATCHES} batches "
          f"(child {t_child:.3f} s, os._exit after an async save), restored, "
          f"2 more batches: value={value} |S|={int(res.sol_size)}, the "
          f"uninterrupted run's ids, value bits and all {len(la)} sieve "
          f"leaves; stats={svc.stats}; card: {card}")


def stream_part_e(card):
    """Part (e): the service CLI at full width, then again with
    --restore."""
    import os
    import tempfile
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    with tempfile.TemporaryDirectory() as tmp:
        cmd = [sys.executable, "-m", "repro_torch.launch.select_serve",
               "--n", str(N), "--d", str(D), "--k", str(K), "--slots", "8",
               "--requests", "24", "--ingest-docs", str(STREAM_CHUNK),
               "--ingest-every", "2", "--stream-chunk", str(STREAM_CHUNK),
               "--checkpoint-dir", tmp, "--checkpoint-every", "2",
               "--use-kernel"]
        for extra in ([], ["--restore"]):
            t0 = time.perf_counter()
            p = subprocess.run(cmd + extra, env=env, cwd=ROOT,
                               capture_output=True, text=True,
                               timeout=SERVE_TIMEOUT_S)
            check(p.returncode == 0, f"[stream] (e) select_serve "
                  f"{' '.join(extra)} exited {p.returncode}:\n"
                  f"{p.stdout[-2000:]}\n{p.stderr[-3000:]}")
            keep = [ln for ln in p.stdout.splitlines()
                    if ln.startswith("[service]") or "latency" in ln
                    or "slots=" in ln or "restored" in ln
                    or "ingested" in ln]
            for ln in keep:
                print(f"[stream] (e) select_serve {' '.join(extra)}: {ln}")
            print(f"[stream] (e) select_serve {' '.join(extra)} took "
                  f"{time.perf_counter() - t0:.3f} s; card: {card}")


def stream_phase(torch, tsel, ops, gvals, two_round_value):
    """Phase 9: the streaming path on the main path's corpus, copied once
    to host memory; its documents cross host -> device through
    prefetch_to_device.  Returns the launches of parts (a)-(d) by kernel
    (part (e)'s CLI runs in its own processes)."""
    from repro_torch import streaming as tstream
    from repro_torch.core import constraints as tcons
    from repro_torch.core import faults as tfaults
    from repro_torch.streaming import distributed_sieve as tds
    from repro_torch.streaming import sieve as tsieve
    card = smi()
    data = mesh_corpus(torch)
    data["parts"] = torch.randint(
        0, N_PARTS, (N,), device="cuda",
        generator=torch.Generator(device="cuda").manual_seed(2))
    X_host = data["X"].cpu()
    launches = {}
    t_phase = time.perf_counter()
    prefetch_rates(torch, tstream, X_host, card)

    t0 = time.perf_counter()
    rates = stream_part_a(torch, tstream, tsel, tcons, ops, data, X_host,
                          gvals["feature_coverage"], launches, card)
    print(f"[stream] part (a) took {time.perf_counter() - t0:.3f} s; ms a "
          f"sieve chunk (dense, fused) = {rates['dense'][0]}, "
          f"{rates['fused'][0]}; warm select ms (dense, fused) = "
          f"{rates['dense'][1]}, {rates['fused'][1]}")
    t0 = time.perf_counter()
    stream_part_b(torch, tstream, tsel, ops, data, X_host, gvals, launches,
                  card)
    print(f"[stream] part (b) took {time.perf_counter() - t0:.3f} s")
    t0 = time.perf_counter()
    stream_part_c(torch, tds, tsieve, tsel, tfaults, ops, data["X"],
                  gvals["feature_coverage"], two_round_value, launches, card)
    print(f"[stream] part (c) took {time.perf_counter() - t0:.3f} s")
    del data, X_host
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    stream_part_d(torch, tsel, ops, launches, card)
    print(f"[stream] part (d) took {time.perf_counter() - t0:.3f} s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    stream_part_e(card)
    print(f"[stream] part (e) took {time.perf_counter() - t0:.3f} s")
    print(f"[stream] phase 9 took {time.perf_counter() - t_phase:.3f} s "
          f"after its corpus copy")
    return launches


# ---------------------------------------------------------------------------
# phase 10: the LM serving path (configs, the dense transformer, Model, the
# serve bundles, launch/serve.py) at full width, and exclude_ids at the
# 148-lane batch's shape
# ---------------------------------------------------------------------------

LM_ARCH = "qwen3-1.7b"          # launch/serve.py's default architecture
LM_B, LM_PROMPT, LM_GEN = 4, 64, 32        # launch/serve.py's defaults
LM_LONG_B, LM_LONG_PROMPT = 8, 4096        # q_block 512 and kv_block 1024
#                                            both tile the prompt
RING_ARCH = "h2o-danube-1.8b"   # sliding window 4096, head_dim 80
RING_B, RING_PROMPT, RING_GEN = 1, 4160, 16  # a prompt past the window: the
#                                              ring branch, decode wraps
RING_LAYERS = 4                 # of h2o-danube's 24, for the time budget (the
#                                 part took 28.7 s at 24 layers, 9.5 s at 8;
#                                 8 before phase 14)
LM_TOL, LM_ARGMAX = 0.08, 0.95  # the JAX package's decode-vs-prefill bar
LM_CLI_TIMEOUT_S = 300
EXCL_LANES = len(QUERY_KS) * L  # the 148-lane batch's filter: (L, C, k) =
EXCL_K = K                      # (148, 2^20, 64) with the corpus's C = N


def lm_model(torch, cfg, seed):
    """The port's Model of ``cfg`` with parameters drawn on the card from a
    seeded generator."""
    from repro_torch.models.model import build_model
    torch.cuda.synchronize()
    model = build_model(cfg, torch.Generator(device="cuda").manual_seed(seed),
                        "cuda")
    torch.cuda.synchronize()
    return model


def lm_serve(torch, steps, cfg, model, B, prompt, gen, seed):
    """Greedy serving through the port's bundles, as launch/serve.py serves:
    one prefill of ``prompt`` tokens into caches of prompt + gen slots,
    then gen - 1 decode steps.  Returns (prompt tokens, generated ids (B,
    gen), prefill ms, decode ms a step, each step's logits, the caches
    after prefill)."""
    from repro_torch.configs.base import ShapeSpec
    pre = steps.prefill_bundle(cfg, ShapeSpec("serve", prompt, B, "prefill"))
    dec = steps.decode_step_bundle(cfg, ShapeSpec("serve", prompt + gen, B,
                                                  "decode"))
    toks = torch.randint(0, cfg.vocab_size, (B, prompt), device="cuda",
                         dtype=torch.int32,
                         generator=torch.Generator(device="cuda")
                         .manual_seed(seed))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, caches = pre.fn(model, {"tokens": toks}, cache_len=prompt + gen)
    torch.cuda.synchronize()
    t_pre = (time.perf_counter() - t0) * 1e3
    prefill_caches = caches
    tok = logits[:, -1:].argmax(-1).to(torch.int32)
    out, step_logits = [tok], []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(gen - 1):
        pos = torch.full((B, 1), prompt + i, dtype=torch.int32,
                         device="cuda")
        logits, caches = dec.fn(model, caches, tok, pos)
        step_logits.append(logits)
        tok = logits[:, -1:].argmax(-1).to(torch.int32)
        out.append(tok)
    torch.cuda.synchronize()
    t_dec = (time.perf_counter() - t0) * 1e3 / (gen - 1)
    return toks, torch.cat(out, 1), t_pre, t_dec, step_logits, prefill_caches


def lm_decode_vs_prefill(torch, cfg, model, toks, ids, step_logits, label,
                         card, tol=LM_TOL, exact=False):
    """Every decode step's logits against a prefill over the same tokens
    (the prompt and the ids generated so far), within rtol = atol = ``tol``.

    Argmax: with random weights a row's top two logits are often closer
    than bf16 rounding at depth (≈ 0.05 here), so a row whose prefill top-2
    gap is within ``tol`` is a near-tie and stays out of the count;
    agreement over the other rows must be >= 0.95, and every row must agree
    when ``exact`` (the f32 check).  The raw agreement and each row that
    differs are printed."""
    V = cfg.vocab_size
    worst, agree, rows, kept, kept_agree, flips = 0.0, 0, 0, 0, 0, []
    for i, lg in enumerate(step_logits):
        ref, _ = model.prefill({"tokens": torch.cat([toks, ids[:, :i + 1]],
                                                    1)})
        a = lg[..., :V].float().reshape(-1, V)
        b = ref[..., :V].float().reshape(-1, V)
        diff = (a - b).abs()
        excess = (diff - tol * b.abs()).max().item()
        worst = max(worst, diff.max().item())
        check(excess <= tol,
              f"{label}: decode step {i} differs from a prefill over the "
              f"same tokens by {excess} beyond rtol {tol}")
        top2 = b.topk(2, -1).values
        gap = top2[:, 0] - top2[:, 1]
        same = a.argmax(-1) == b.argmax(-1)
        wide = gap > tol
        agree += int(same.sum())
        rows += a.shape[0]
        kept += int(wide.sum())
        kept_agree += int((same & wide).sum())
        for r in torch.nonzero(~same).flatten().tolist():
            flips.append((i, r, int(a[r].argmax()), int(b[r].argmax()),
                          round(gap[r].item(), 6),
                          round(diff[r].max().item(), 6)))
    check(agree == rows if exact else kept_agree >= LM_ARGMAX * kept,
          f"{label}: argmax agreement {agree}/{rows}, {kept_agree}/{kept} "
          f"where the prefill's top-2 gap exceeds {tol}; rows that differ "
          f"(step, row, decode's, prefill's, gap, max |diff|): {flips}")
    print(f"[lm] {label}: all {len(step_logits)} decode steps = a prefill "
          f"over the same tokens: max |logit diff| {worst} (bar rtol = atol "
          f"{tol}), argmax agreement {agree}/{rows}, {kept_agree}/{kept} "
          f"where the top-2 gap exceeds {tol}; rows that differ (step, row, "
          f"decode's id, prefill's id, prefill top-2 gap, max |diff|): "
          f"{flips}; card: {card}")


def lm_part_a(torch, steps, analysis, T, card):
    """Part (a): qwen3-1.7b at full width, launch/serve.py's defaults."""
    from repro_torch.configs.base import ShapeSpec, get_config
    cfg = get_config(LM_ARCH)
    check((cfg.n_layers, cfg.d_model, cfg.vocab_size) == (28, 2048, 151_936),
          f"{LM_ARCH} is not at full width: {cfg}")
    model = lm_model(torch, cfg, 0)
    weights = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    runs = [lm_serve(torch, steps, cfg, model, LM_B, LM_PROMPT, LM_GEN, 1)
            for _ in range(2)]
    peak = torch.cuda.max_memory_allocated()
    (toks, ids, t_pre, t_dec, step_logits, caches), again = runs
    check(torch.equal(ids, again[1]),
          f"[lm] (a) two runs gave other greedy ids: {ids[0].tolist()} and "
          f"{again[1][0].tolist()}")
    check(bool(((ids >= 0) & (ids < cfg.vocab_size)).all()),
          f"[lm] (a) ids out of the vocabulary: {ids.tolist()}")
    print(f"[lm] (a) {cfg.name} ({cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads, vocab "
          f"{cfg.vocab_size}, {cfg.param_count()} parameters, f32 weights "
          f"{weights / 2 ** 30:.3f} GiB, bf16 compute) B={LM_B} prompt="
          f"{LM_PROMPT} gen={LM_GEN}: prefill {t_pre:.3f} ms first, "
          f"{again[2]:.3f} ms again ({LM_B * LM_PROMPT / again[2] * 1e3:.0f} "
          f"tok/s); decode {t_dec:.3f} / {again[3]:.3f} ms a step "
          f"({LM_B / again[3] * 1e3:.0f} tok/s); peak "
          f"{peak / 2 ** 30:.3f} GiB ({(peak - weights) / 2 ** 30:.3f} above "
          f"the weights); the same greedy ids twice: "
          f"{ids[0, :16].tolist()}; card: {card}")
    lm_decode_vs_prefill(torch, cfg, model, toks, ids, step_logits,
                         "(a) " + cfg.name, card)
    # one decode step's bound: the weights as stored (f32) and the caches
    # read once, against 2 N flops a token at the bf16 peak
    cache_len = LM_PROMPT + LM_GEN
    roof = analysis.from_costs(
        "decode", 1,
        {"flops": analysis.model_flops_for(
            cfg, ShapeSpec("decode", cache_len, LM_B, "decode")),
         "bytes accessed": T.param_bytes(model.params) + T.cache_bytes(
             caches)}, {})
    bound = roof.t_bound * 1e3
    print(f"[lm] (a) decode step roofline (repro_torch.roofline.analysis, "
          f"H100 SXM {analysis.HBM_BW:.3e} B/s, {analysis.PEAK_FLOPS:.4e} "
          f"bf16 FLOP/s): bytes {roof.bytes_per_device:.0f} -> "
          f"{roof.t_memory * 1e3:.4f} ms, flops {roof.flops_per_device:.0f}"
          f" -> {roof.t_compute * 1e3:.4f} ms; bound {bound:.4f} ms "
          f"({roof.bottleneck}); measured {again[3]:.3f} ms = "
          f"{again[3] / bound:.2f}x the bound; card: {card}")
    return model, cfg


def lm_part_b(torch, steps, analysis, model, cfg, card):
    """Part (b): a long prefill at full width, q_block 512 and kv_block 1024
    both tiling the prompt."""
    from repro_torch.configs.base import ShapeSpec
    check(LM_LONG_PROMPT % cfg.q_block == 0
          and LM_LONG_PROMPT % cfg.kv_block == 0,
          f"prompt {LM_LONG_PROMPT} vs q_block {cfg.q_block}, kv_block "
          f"{cfg.kv_block}")
    shape = ShapeSpec("long", LM_LONG_PROMPT, LM_LONG_B, "prefill")
    pre = steps.prefill_bundle(cfg, shape)
    toks = torch.randint(0, cfg.vocab_size, (LM_LONG_B, LM_LONG_PROMPT),
                         device="cuda", dtype=torch.int32,
                         generator=torch.Generator(device="cuda")
                         .manual_seed(2))
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ms = []
    for _ in range(2):
        t0 = time.perf_counter()
        logits, caches = pre.fn(model, {"tokens": toks})
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated()
    check(bool(torch.isfinite(logits[..., :cfg.vocab_size].float()).all())
          and logits.shape == (LM_LONG_B, 1, cfg.padded_vocab),
          f"[lm] (b) logits {tuple(logits.shape)} not finite")
    check(tuple(caches["sub"][0].k.shape) == (
        cfg.n_layers, LM_LONG_B, LM_LONG_PROMPT, cfg.n_kv_heads,
        cfg.head_dim_), f"[lm] (b) caches {caches['sub'][0].k.shape}")
    flops = analysis.model_flops_for(cfg, shape)
    bound = flops / analysis.PEAK_FLOPS * 1e3
    toks_n = LM_LONG_B * LM_LONG_PROMPT
    print(f"[lm] (b) {cfg.name} prefill B={LM_LONG_B} prompt="
          f"{LM_LONG_PROMPT} (q_block {cfg.q_block}, kv_block "
          f"{cfg.kv_block}): {ms[0]:.3f} ms first, {ms[1]:.3f} ms again "
          f"({toks_n / ms[1] * 1e3:.0f} tok/s); model_flops_for "
          f"{flops:.4e} over the bf16 peak = {bound:.3f} ms "
          f"({bound / ms[1]:.4f} of the time); peak {peak / 2 ** 30:.3f} GiB"
          f" ({(peak - base) / 2 ** 30:.3f} above the weights); card: "
          f"{card}")


def lm_part_c(torch, steps, card):
    """Part (c): h2o-danube-1.8b's ring cache at full width: a prompt past
    the sliding window, so prefill keeps the last 4096 positions at their
    ring slots and decode wraps the ring."""
    import dataclasses
    from repro_torch.configs.base import get_config
    full = get_config(RING_ARCH)
    cfg = dataclasses.replace(full, n_layers=RING_LAYERS)
    print(f"[lm] (c) depth cut: {cfg.n_layers} of {full.n_layers} layers "
          f"(time budget); full width; card: {card}")
    model = lm_model(torch, cfg, 3)
    toks, ids, t_pre, t_dec, step_logits, caches = lm_serve(
        torch, steps, cfg, model, RING_B, RING_PROMPT, RING_GEN, 4)
    C = caches["sub"][0].k.shape[-3]
    spos = caches["sub"][0].slot_pos[0]
    check(C == cfg.sliding_window < RING_PROMPT
          and int(spos.min()) == RING_PROMPT - C
          and int(spos.max()) == RING_PROMPT - 1
          and int(spos[(RING_PROMPT - 1) % C]) == RING_PROMPT - 1,
          f"[lm] (c) ring of {C} slots holds {int(spos.min())}.."
          f"{int(spos.max())}")
    print(f"[lm] (c) {cfg.name} ({cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, head_dim {cfg.head_dim_}, window "
          f"{cfg.sliding_window}) B={RING_B} prompt={RING_PROMPT} "
          f"gen={RING_GEN}: ring of {C} slots holds positions "
          f"{RING_PROMPT - C}..{RING_PROMPT - 1} after prefill; prefill "
          f"{t_pre:.3f} ms, decode {t_dec:.3f} ms a step; ids "
          f"{ids[0].tolist()}; card: {card}")
    lm_decode_vs_prefill(torch, cfg, model, toks, ids, step_logits,
                         "(c) " + cfg.name, card)
    # the same weights in f32 compute: decode must give the prefill's
    # logits to 1e-3 and its argmax in every row
    del model, step_logits, caches
    torch.cuda.empty_cache()
    from repro_torch.models.model import Model
    model = Model(cfg, torch.Generator(device="cuda").manual_seed(3), "cuda",
                  dtype=torch.float32)
    toks, ids, t_pre, t_dec, step_logits, _ = lm_serve(
        torch, steps, cfg, model, RING_B, RING_PROMPT, RING_GEN, 4)
    print(f"[lm] (c) {cfg.name} in f32 compute: prefill {t_pre:.3f} ms, "
          f"decode {t_dec:.3f} ms a step; ids {ids[0].tolist()}; card: "
          f"{card}")
    lm_decode_vs_prefill(torch, cfg, model, toks, ids, step_logits,
                         "(c) " + cfg.name + " f32", card, tol=1e-3,
                         exact=True)


def lm_part_d(card):
    """Part (d): the serve CLI at full width on the card."""
    import os
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
           LM_ARCH]
    t0 = time.perf_counter()
    p = subprocess.run(cmd, env=env, cwd=ROOT, capture_output=True,
                       text=True, timeout=LM_CLI_TIMEOUT_S)
    lines = [ln for ln in p.stdout.splitlines() if ln.startswith("[serve]")]
    check(p.returncode == 0 and len(lines) == 3
          and f"arch={LM_ARCH} batch={LM_B}" in lines[0],
          f"[lm] (d) serve exited {p.returncode}:\n{p.stdout[-2000:]}\n"
          f"{p.stderr[-3000:]}")
    for ln in lines:
        print(f"[lm] (d) {ln}")
    print(f"[lm] (d) python -m repro_torch.launch.serve --arch {LM_ARCH} "
          f"took {time.perf_counter() - t0:.3f} s; card: {card}")


def broadcast_exclude(cand_ids, cand_valid, sol_ids):
    """The id test exclude_ids replaced: an (L, C, k) comparison."""
    hit = (cand_ids.unsqueeze(-1) == sol_ids.unsqueeze(-2)).any(-1)
    return cand_valid & ~hit


def lm_part_e(torch, tsel, tmr, ops, card):
    """Part (e): exclude_ids at the 148-lane batch's shape against the
    broadcast it replaced (mask and peak memory), and the 148-lane
    select_batch with each of them (the same ids and value bits)."""
    from repro_torch.core import rounds, threshold
    gen = torch.Generator(device="cuda").manual_seed(5)
    ids = torch.arange(N, dtype=torch.int32, device="cuda")
    valid = torch.rand(N, generator=gen, device="cuda") < 0.99
    sol = torch.randint(-1, N, (EXCL_LANES, EXCL_K), generator=gen,
                        device="cuda", dtype=torch.int32)
    sizes = torch.randint(0, EXCL_K + 1, (EXCL_LANES, 1), generator=gen,
                          device="cuda")
    sol = torch.where(torch.arange(EXCL_K, device="cuda") < sizes, sol, -1)
    out = {}
    for name, fn in (("exclude_ids", threshold.exclude_ids),
                     ("broadcast", broadcast_exclude)):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        mask = fn(ids, valid, sol)
        torch.cuda.synchronize()
        peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
        out[name] = (mask, cuda_ms(lambda: fn(ids, valid, sol), 5), peak)
    new, old = out["exclude_ids"][0], out["broadcast"][0]
    check(new.shape == (EXCL_LANES, N) and torch.equal(new, old),
          f"[lm] (e) exclude_ids differs from the broadcast in "
          f"{int((new != old).sum())} places")
    check(out["exclude_ids"][2] < 1.0,
          f"[lm] (e) exclude_ids took {out['exclude_ids'][2]} GiB")
    print(f"[lm] (e) exclude_ids (L, C, k) = ({EXCL_LANES}, {N}, {EXCL_K}): "
          f"the broadcast's mask bit for bit ({int(new.sum())} kept); peak "
          f"extra memory {out['exclude_ids'][2]:.4f} GiB (sorted search, "
          f"{threshold.EXCLUDE_TILE} elements a tile) against "
          f"{out['broadcast'][2]:.4f} GiB (broadcast); "
          f"{out['exclude_ids'][1]:.3f} ms against {out['broadcast'][1]:.3f} "
          f"ms (mean of 5 back to back); card: {card}")
    del new, old, out, ids, valid, sol
    torch.cuda.empty_cache()

    X = mesh_corpus(torch)["X"]
    sel = tsel.DistributedSelector(
        tsel.SelectorSpec(k=K, eps=EPS, chunk=CHUNK,
                          oracle="feature_coverage", engine="fused",
                          use_kernel=True),
        n_total=N, feat_dim=D, n_machines=M, device="cuda")
    queries = tmr.make_query_batch(QUERY_KS, device="cuda")
    # in turns: exclude_ids, the broadcast, the broadcast, exclude_ids
    saved, runs = rounds.exclude_ids, []
    for name in ("exclude_ids", "broadcast", "broadcast", "exclude_ids"):
        rounds.exclude_ids = saved if name == "exclude_ids" \
            else broadcast_exclude
        try:
            res, wall, _ = drive_batch(torch, ops, sel, X,
                                       f"(e) select_batch with {name}",
                                       queries)
        finally:
            rounds.exclude_ids = saved
        runs.append((name, res, wall))
    res = runs[0][1]
    for name, other, _ in runs[1:]:
        check(torch.equal(res.sol_ids, other.sol_ids)
              and torch.equal(res.sol_size, other.sol_size)
              and res.value.cpu().numpy().tobytes()
              == other.value.cpu().numpy().tobytes(),
              f"[lm] (e) the 148-lane batch moved with {name}: "
              f"{res.value.tolist()} vs {other.value.tolist()}")
    print(f"[lm] (e) FeatureCoverage select_batch {QUERY_KS} "
          f"({EXCL_LANES} lanes, fused kernel route): the same ids, sizes "
          f"and value bits with exclude_ids as with the broadcast; wall ms "
          f"in turns {[(name, wall) for name, _, wall in runs]}; card: "
          f"{card}")


def lm_phase(torch, tsel, tmr, ops):
    """Phase 10: the LM serving path at full width (parts (a)-(d)) and the
    repaired exclude_ids (part (e)).  The LM path reaches none of the
    fifteen kernels; its launches are counted and printed all the same."""
    from repro_torch.launch import steps
    from repro_torch.models import transformer as T
    from repro_torch.roofline import analysis
    card = smi()
    t_phase = time.perf_counter()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    model, cfg = lm_part_a(torch, steps, analysis, T, card)
    print(f"[lm] part (a) took {time.perf_counter() - t0:.3f} s; card: {card}")
    t0 = time.perf_counter()
    lm_part_b(torch, steps, analysis, model, cfg, card)
    print(f"[lm] part (b) took {time.perf_counter() - t0:.3f} s; card: {card}")
    del model
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    lm_part_c(torch, steps, card)
    torch.cuda.empty_cache()
    print(f"[lm] part (c) took {time.perf_counter() - t0:.3f} s; card: {card}")
    counts = read_counts(ops)
    print(f"[lm] kernel launches on the LM path (parts (a)-(c)): "
          f"{ {k: v for k, v in counts.items() if v and '@' not in k} } "
          f"(it reaches no pallas_call in the JAX package)")
    t0 = time.perf_counter()
    lm_part_d(card)
    print(f"[lm] part (d) took {time.perf_counter() - t0:.3f} s; card: {card}")
    t0 = time.perf_counter()
    lm_part_e(torch, tsel, tmr, ops, card)
    print(f"[lm] part (e) took {time.perf_counter() - t0:.3f} s; card: {card}")
    print(f"[lm] phase 10 took {time.perf_counter() - t_phase:.3f} s; card: "
          f"{card}")


# ---------------------------------------------------------------------------
# phase 11: the moe, ssm and hybrid families' serving (models/moe.py,
# models/ssm.py, their groups in the transformer, the bundles, the CLI) at
# full width, and llama4's chunked-local layers
# ---------------------------------------------------------------------------

MOE_ARCH = "qwen2-moe-a2.7b"        # 24 layers, 60 experts top-4 + shared
SSM_ARCH = "falcon-mamba-7b"        # 64 Mamba1 layers, d_inner 8192
HYBRID_ARCH = "zamba2-2.7b"         # 9 groups of 6 Mamba2 + shared block
# depth cuts for the time budget (phase 13's mesh serving came after them);
# every part keeps its full width
MOE_LAYERS = 4                      # of qwen2-moe's 24 (8 before phase 14)
SSM_LAYERS = 8                      # of falcon-mamba's 64 (16 before
#                                     phase 14)
HYBRID_GROUPS = 3                   # of zamba2's 9 groups
CHUNK_ARCH = "llama4-scout-17b-a16e"  # 16 experts top-1, chunk 8192
SSM_LONG_B, SSM_LONG_PROMPT = 1, 4096  # 32 chunks of ssm_chunk 128
HYBRID_PROMPT = 200                 # not a multiple of 128: the pad branch
CHUNK_LAYERS = 4                    # llama4 cut to one group (3 local + 1
#                                     global); 48 layers would not fit
CHUNK_B, CHUNK_PROMPT, CHUNK_GEN = 1, 8256, 8  # past attention_chunk 8192
F32_TOL = 1e-3                      # decode vs prefill in f32 compute


class DropCount:
    """Counts the (token, choice) rows that ``moe._dispatch_combine``
    drops past capacity while it is entered, by the call's token count (a
    device tensor each: no host sync inside the model)."""

    def __init__(self, moe):
        self.moe, self.by_tokens = moe, {}

    def __enter__(self):
        self.saved = self.moe._dispatch_combine

        def counted(x, *args):
            out = self.saved(x, *args)
            t = x.shape[0] * x.shape[1]
            self.by_tokens[t] = self.by_tokens.get(t, 0) + out[2]
            return out
        self.moe._dispatch_combine = counted
        return self

    def __exit__(self, *exc):
        self.moe._dispatch_combine = self.saved

    def counts(self):
        return {t: int(n) for t, n in sorted(self.by_tokens.items())}


def fam_model(torch, cfg, seed, label, card):
    """The port's Model of ``cfg`` (parameters drawn on the card); prints
    its size."""
    t0 = time.perf_counter()
    model = lm_model(torch, cfg, seed)
    n = sum(p.numel() for p in model.params.parameters())
    weights = torch.cuda.memory_allocated()
    print(f"[fam] {label} {cfg.name}: {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, {n} parameters ({n * 4 / 2 ** 30:.3f} GiB f32, "
          f"param_count {cfg.param_count()}), drawn in "
          f"{time.perf_counter() - t0:.3f} s; memory allocated "
          f"{weights / 2 ** 30:.3f} GiB; card: {card}")
    return model, n


def fam_serve(torch, steps, analysis, T, cfg, model, B, prompt, gen, seed,
              label, card, runs=2):
    """Serve through the bundles ``runs`` times (the same greedy ids each
    time); print prefill and decode ms and tok/s, peak memory against the
    card's, and one decode step against its roofline bound.  Returns the
    last run's (tokens, ids, step logits, caches after prefill)."""
    from repro_torch.configs.base import ShapeSpec
    weights = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = [lm_serve(torch, steps, cfg, model, B, prompt, gen, seed)
           for _ in range(runs)]
    peak = torch.cuda.max_memory_allocated()
    total = torch.cuda.get_device_properties(0).total_memory
    toks, ids, t_pre, t_dec, step_logits, caches = out[-1]
    for other in out[:-1]:
        check(torch.equal(ids, other[1]),
              f"[fam] {label} runs gave other greedy ids: {ids[0].tolist()} "
              f"and {other[1][0].tolist()}")
    check(bool(((ids >= 0) & (ids < cfg.vocab_size)).all()),
          f"[fam] {label} ids out of the vocabulary: {ids.tolist()}")
    check(peak < total, f"[fam] {label} peak {peak} of {total} bytes")
    cache_len = prompt + gen
    roof = analysis.from_costs(
        "decode", 1,
        {"flops": analysis.model_flops_for(
            cfg, ShapeSpec("decode", cache_len, B, "decode")),
         "bytes accessed": T.param_bytes(model.params) + T.cache_bytes(
             caches)}, {})
    bound = roof.t_bound * 1e3
    print(f"[fam] {label} {cfg.name} B={B} prompt={prompt} gen={gen}, bf16 "
          f"compute: prefill {' / '.join(f'{r[2]:.3f}' for r in out)} ms "
          f"({B * prompt / t_pre * 1e3:.0f} tok/s); decode "
          f"{' / '.join(f'{r[3]:.3f}' for r in out)} ms a step "
          f"({B / t_dec * 1e3:.0f} tok/s); peak {peak / 2 ** 30:.3f} GiB "
          f"({(peak - weights) / 2 ** 30:.3f} above the weights) of the "
          f"card's {total / 2 ** 30:.3f}; ids {ids[0, :16].tolist()}"
          f"{' the same in every run' if runs > 1 else ''}; card: {card}")
    print(f"[fam] {label} decode step roofline (H100 SXM {analysis.HBM_BW:.3e}"
          f" B/s, {analysis.PEAK_FLOPS:.4e} bf16 FLOP/s): bytes "
          f"{roof.bytes_per_device:.0f} (f32 weights + caches) -> "
          f"{roof.t_memory * 1e3:.4f} ms, flops {roof.flops_per_device:.0f} "
          f"-> {roof.t_compute * 1e3:.4f} ms; bound {bound:.4f} ms "
          f"({roof.bottleneck}); measured {t_dec:.3f} ms = "
          f"{t_dec / bound:.2f}x the bound; card: {card}")
    return toks, ids, step_logits, caches


def with_capacity(cfg):
    """``cfg`` with capacity_factor E / k: every expert has a slot for
    every token, so a prefill and the decode steps drop nothing."""
    import dataclasses
    return dataclasses.replace(
        cfg, capacity_factor=cfg.n_experts / cfg.experts_per_token)


class RouteLog:
    """Records the expert ids (T, k) of every ``moe._route`` call while it
    is entered, in call order."""

    def __init__(self, moe):
        self.moe, self.calls = moe, []

    def __enter__(self):
        self.saved = self.moe._route

        def recorded(logits, cfg):
            out = self.saved(logits, cfg)
            self.calls.append(out[1])
            return out
        self.moe._route = recorded
        return self

    def __exit__(self, *exc):
        self.moe._route = self.saved


def moe_decode_vs_prefill(torch, cfg, model, moe, toks, ids, step_logits,
                          routes, label, card, tol=LM_TOL):
    """Every decode step against a prefill over the same tokens, with the
    routing of each.  ``routes`` holds the served run's expert ids: its
    prefill's L calls (B * prompt, k), then each decode step's L (B, k).
    A row is routed alike when every one of its tokens, in every layer,
    went to the same experts in the served run (prefill, then the decode
    steps) and in the reference prefill; otherwise a near-tie of the
    router was rounded apart in bf16 (the two evaluation orders round
    differently) and the row is counted with its first layer and max
    |diff|.  Printed, not held to a bar: at full depth nearly every row
    flips somewhere (qwen2-moe: 122 of 124 rows), and a row routed alike
    still drifts to the bar's edge, since the two runs' products round
    differently in bf16.  The exact check is fam_f32_check's f32 run on
    the same weights."""
    V, L, k = cfg.vocab_size, cfg.n_layers, cfg.experts_per_token
    B, P = toks.shape
    served = [r.reshape(B, P, k) for r in routes[:L]]
    flipped, held, held_agree, kept, kept_agree = [], 0, 0, 0, 0
    all_agree, all_kept, beyond = 0, 0, []
    worst_held = worst_flip = 0.0
    for i, lg in enumerate(step_logits):
        steps_i = routes[L:L * (i + 2)]
        with RouteLog(moe) as log:
            ref, _ = model.prefill({"tokens": torch.cat(
                [toks, ids[:, :i + 1]], 1)})
        first = [None] * B
        for layer in range(L):
            mine = torch.cat([served[layer]] + [
                steps_i[s * L + layer].reshape(B, 1, k)
                for s in range(i + 1)], 1)
            theirs = log.calls[layer].reshape(B, P + i + 1, k)
            d = (mine.sort(-1).values != theirs.sort(-1).values).any(-1)
            d = d.any(-1).tolist()
            for r in range(B):
                if d[r] and first[r] is None:
                    first[r] = layer
        a = lg[..., :V].float().reshape(B, V)
        b = ref[..., :V].float().reshape(B, V)
        diff = (a - b).abs()
        excess = (diff - tol * b.abs()).amax(-1)
        top2 = b.topk(2, -1).values
        wide = ((top2[:, 0] - top2[:, 1]) > tol).tolist()
        same = (a.argmax(-1) == b.argmax(-1)).tolist()
        all_kept += sum(wide)
        all_agree += sum(w and m for w, m in zip(wide, same))
        for r in range(B):
            if first[r] is not None:
                flipped.append((i, r, first[r], round(diff[r].max().item(),
                                                      4)))
                worst_flip = max(worst_flip, diff[r].max().item())
                continue
            if excess[r].item() > tol:
                beyond.append((i, r, round(excess[r].item(), 4)))
            worst_held = max(worst_held, diff[r].max().item())
            held += 1
            held_agree += int(same[r])
            kept += int(wide[r])
            kept_agree += int(same[r] and wide[r])
    rows = B * len(step_logits)
    print(f"[fam] {label}: {len(step_logits)} decode steps against a "
          f"prefill over the same tokens, bf16: {len(flipped)} of {rows} "
          f"rows with a routing flip (a token of the row, in some layer, "
          f"sent to other experts), max |logit diff| {worst_flip:.4f}; "
          f"(step, row, first layer, max |diff|): {flipped}; the {held} "
          f"rows routed alike: max |logit diff| {worst_held:.4f}, "
          f"{held - len(beyond)} within rtol = atol {tol} (beyond it: "
          f"(step, row, excess) {beyond}), argmax {held_agree}/{held}, "
          f"{kept_agree}/{kept} "
          f"where the top-2 gap exceeds {tol}; argmax over all rows "
          f"{all_agree}/{all_kept} where the top-2 gap exceeds {tol}; card: "
          f"{card}")


def fam_moe_check(torch, steps, moe, cfg, model, B, prompt, gen, seed,
                  label, card):
    """Decode against prefill on the same weights with capacity raised to
    E / k (with tight capacity the two runs legitimately drop different
    tokens): in bf16 with the routing compared and printed
    (moe_decode_vs_prefill), then in f32 compute, held to F32_TOL with
    every argmax equal (fam_f32_check)."""
    raised = with_capacity(cfg)
    model.cfg = raised
    try:
        with RouteLog(moe) as log:
            toks, ids, _, _, step_logits, _ = lm_serve(
                torch, steps, raised, model, B, prompt, gen, seed)
        moe_decode_vs_prefill(
            torch, raised, model, moe, toks, ids, step_logits,
            log.calls,
            f"{label} {cfg.name} capacity_factor {raised.capacity_factor:g}",
            card)
        del step_logits
        fam_f32_check(torch, steps, raised, model, B, prompt, gen, seed,
                      label, card)
    finally:
        model.cfg = cfg


def fam_f32_check(torch, steps, cfg, model, B, prompt, gen, seed, label,
                  card):
    """The same weights in f32 compute: every decode step's logits within
    F32_TOL of a prefill over the same tokens, every argmax equal (in bf16
    the chunked prefill and the stepwise recurrence drift apart over
    depth)."""
    model.dtype = torch.float32
    try:
        toks, ids, t_pre, t_dec, step_logits, _ = lm_serve(
            torch, steps, cfg, model, B, prompt, gen, seed)
        print(f"[fam] {label} {cfg.name} in f32 compute: prefill "
              f"{t_pre:.3f} ms, decode {t_dec:.3f} ms a step; ids "
              f"{ids[0, :16].tolist()}; card: {card}")
        lm_decode_vs_prefill(torch, cfg, model, toks, ids, step_logits,
                             f"{label} {cfg.name} f32", card, tol=F32_TOL,
                             exact=True)
    finally:
        model.dtype = torch.bfloat16


def fam_part_a(torch, steps, analysis, T, moe, card):
    """Part (a): qwen2-moe-a2.7b at full width, 8 layers, launch/serve.py's
    defaults; the tokens the configured capacity drops."""
    import dataclasses
    from repro_torch.configs.base import get_config
    full = get_config(MOE_ARCH)
    cfg = dataclasses.replace(full, n_layers=MOE_LAYERS)
    check((full.n_layers, cfg.d_model, cfg.n_experts, cfg.experts_per_token,
           cfg.d_ff, cfg.capacity_factor) == (24, 2048, 60, 4, 5632, 1.25),
          f"{MOE_ARCH} is not at full width: {cfg}")
    print(f"[fam] (a) depth cut: {cfg.n_layers} of {full.n_layers} layers "
          f"(time budget); full width; card: {card}")
    model, _ = fam_model(torch, cfg, 10, "(a)", card)
    with DropCount(moe) as drops:
        toks, _, _, _ = fam_serve(torch, steps, analysis, T, cfg, model,
                                  LM_B, LM_PROMPT, LM_GEN, 11, "(a)", card)
    counts = drops.counts()
    T_pre, T_dec = LM_B * LM_PROMPT, LM_B
    C_pre = moe._capacity(cfg, T_pre)
    rows = T_pre * cfg.experts_per_token * cfg.n_layers * 2
    check(set(counts) == {T_pre, T_dec} and counts[T_dec] == 0,
          f"[fam] (a) drops by tokens a call {counts}")
    print(f"[fam] (a) capacity_factor {cfg.capacity_factor}: prefill of "
          f"{T_pre} tokens, {C_pre} slots an expert; (token, choice) rows "
          f"dropped in the two runs' prefills {counts[T_pre]} of {rows} "
          f"({counts[T_pre] / rows:.4%}); decode ({T_dec} tokens, "
          f"{moe._capacity(cfg, T_dec)} slots) dropped {counts[T_dec]}; "
          f"card: {card}")
    fam_moe_check(torch, steps, moe, cfg, model, LM_B, LM_PROMPT, LM_GEN, 11,
                  "(a)", card)


def fam_part_b(torch, steps, analysis, T, card):
    """Part (b): falcon-mamba-7b at full width, 16 layers: serving, a long
    prefill, and decode against prefill in f32 compute."""
    import dataclasses
    from repro_torch.configs.base import ShapeSpec, get_config
    full = get_config(SSM_ARCH)
    cfg = dataclasses.replace(full, n_layers=SSM_LAYERS)
    check((full.n_layers, cfg.d_model, cfg.d_inner, cfg.ssm_state,
           cfg.ssm_chunk) == (64, 4096, 8192, 16, 128),
          f"{SSM_ARCH} is not at full width: {cfg}")
    print(f"[fam] (b) depth cut: {cfg.n_layers} of {full.n_layers} layers "
          f"(time budget); full width; card: {card}")
    model, _ = fam_model(torch, cfg, 12, "(b)", card)
    _, _, _, caches = fam_serve(torch, steps, analysis, T, cfg, model, LM_B,
                                LM_PROMPT, LM_GEN, 13, "(b)", card)
    check(type(caches["sub"][0]).__name__ == "Mamba1Cache"
          and tuple(caches["sub"][0].h.shape) == (
              cfg.n_layers, LM_B, cfg.d_inner, cfg.ssm_state),
          f"[fam] (b) caches {[tuple(t.shape) for t in caches['sub'][0]]}")
    del caches
    shape = ShapeSpec("long", SSM_LONG_PROMPT, SSM_LONG_B, "prefill")
    pre = steps.prefill_bundle(cfg, shape)
    toks = torch.randint(0, cfg.vocab_size, (SSM_LONG_B, SSM_LONG_PROMPT),
                         device="cuda", dtype=torch.int32,
                         generator=torch.Generator(device="cuda")
                         .manual_seed(14))
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ms = []
    for _ in range(2):
        t0 = time.perf_counter()
        logits, caches = pre.fn(model, {"tokens": toks})
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated()
    check(bool(torch.isfinite(logits[..., :cfg.vocab_size].float()).all()),
          "[fam] (b) long prefill logits not finite")
    flops = analysis.model_flops_for(cfg, shape)
    print(f"[fam] (b) {cfg.name} prefill B={SSM_LONG_B} prompt="
          f"{SSM_LONG_PROMPT} ({SSM_LONG_PROMPT // cfg.ssm_chunk} chunks of "
          f"{cfg.ssm_chunk}): {ms[0]:.3f} ms first, {ms[1]:.3f} ms again "
          f"({SSM_LONG_B * SSM_LONG_PROMPT / ms[1] * 1e3:.0f} tok/s); "
          f"model_flops_for {flops:.4e} over the bf16 peak = "
          f"{flops / analysis.PEAK_FLOPS * 1e3:.3f} ms; peak "
          f"{peak / 2 ** 30:.3f} GiB ({(peak - base) / 2 ** 30:.3f} above "
          f"the weights); card: {card}")
    del logits, caches
    torch.cuda.empty_cache()
    fam_f32_check(torch, steps, cfg, model, LM_B, LM_PROMPT, LM_GEN, 13,
                  "(b)", card)


def fam_part_c(torch, steps, analysis, T, card):
    """Part (c): zamba2-2.7b at full width, 3 groups, a prompt that is not
    a multiple of the SSM chunk; the shared block's per-group caches."""
    import dataclasses
    from repro_torch.configs.base import get_config
    full = get_config(HYBRID_ARCH)
    check((full.n_layers, full.shared_attn_every, full.d_model,
           full.ssm_state) == (54, 6, 2560, 64)
          and HYBRID_PROMPT % full.ssm_chunk,
          f"{HYBRID_ARCH} is not at full width: {full}")
    cfg = dataclasses.replace(
        full, n_layers=HYBRID_GROUPS * full.shared_attn_every)
    groups = cfg.n_layers // cfg.shared_attn_every
    print(f"[fam] (c) depth cut: {groups} of "
          f"{full.n_layers // full.shared_attn_every} groups ({cfg.n_layers} "
          f"of {full.n_layers} Mamba2 layers; time budget); full width; "
          f"card: {card}")
    model, _ = fam_model(torch, cfg, 15, "(c)", card)
    _, _, _, caches = fam_serve(torch, steps, analysis, T, cfg, model, LM_B,
                                HYBRID_PROMPT, LM_GEN, 16, "(c)", card)
    shared = caches["shared"]
    check(tuple(shared.k.shape) == (groups, LM_B, HYBRID_PROMPT + LM_GEN,
                                    cfg.n_kv_heads, cfg.head_dim_)
          and bool((shared.slot_pos[:, :HYBRID_PROMPT] >= 0).all())
          and bool((shared.slot_pos[:, HYBRID_PROMPT:] == -1).all())
          and len(caches["sub"]) == cfg.shared_attn_every
          and all(type(c).__name__ == "Mamba2Cache" for c in caches["sub"]),
          f"[fam] (c) caches: shared {tuple(shared.k.shape)}, sub "
          f"{[type(c).__name__ for c in caches['sub']]}")
    print(f"[fam] (c) the shared block's cache holds {shared.k.shape[0]} "
          f"group copies of (B, C, KV, hd) = {tuple(shared.k.shape[1:])}, "
          f"positions 0..{HYBRID_PROMPT - 1} after prefill; "
          f"{len(caches['sub'])} Mamba2 caches a group, h "
          f"{tuple(caches['sub'][0].h.shape)}; "
          f"card: {card}")
    del caches, shared
    fam_f32_check(torch, steps, cfg, model, LM_B, HYBRID_PROMPT, LM_GEN, 16,
                  "(c)", card)


def fam_part_d(torch, steps, analysis, T, moe, card):
    """Part (d): llama4-scout-17b-a16e at full width, its depth cut to one
    group (3 chunked-local layers + 1 global), a prompt past the attention
    chunk: the local rings wrap."""
    import dataclasses
    from repro_torch.configs.base import get_config
    full = get_config(CHUNK_ARCH)
    cfg = dataclasses.replace(full, n_layers=CHUNK_LAYERS)
    check((full.n_layers, cfg.d_model, cfg.n_experts, cfg.experts_per_token,
           cfg.attention_chunk, cfg.global_attn_every) == (
               48, 5120, 16, 1, 8192, 4)
          and CHUNK_PROMPT > cfg.attention_chunk,
          f"{CHUNK_ARCH} is not at full width: {cfg}")
    print(f"[fam] (d) depth cut: {CHUNK_LAYERS} of {full.n_layers} layers "
          f"(one group); all {full.n_layers} would hold "
          f"{full.param_count()} parameters, "
          f"{full.param_count() * 4 / 2 ** 30:.1f} GiB of f32 weights, past "
          f"the card's 80 GB; card: {card}")
    model, _ = fam_model(torch, cfg, 17, "(d)", card)
    with DropCount(moe) as drops:
        _, _, _, caches = fam_serve(torch, steps, analysis, T, cfg, model,
                                    CHUNK_B, CHUNK_PROMPT, CHUNK_GEN, 18,
                                    "(d)", card, runs=1)
    counts = drops.counts()
    T_pre = CHUNK_B * CHUNK_PROMPT
    C = cfg.attention_chunk
    for i in range(CHUNK_LAYERS):
        spos = caches["sub"][i].slot_pos[0]
        if i < CHUNK_LAYERS - 1:   # chunked-local: the last C positions
            want = (C, CHUNK_PROMPT - C, CHUNK_PROMPT - 1)
            last = int(spos[(CHUNK_PROMPT - 1) % C])
        else:                      # global: every position, room for gen
            want = (CHUNK_PROMPT + CHUNK_GEN, 0, CHUNK_PROMPT - 1)
            last = int(spos[CHUNK_PROMPT - 1])
        got = (spos.shape[0], int(spos[spos >= 0].min()), int(spos.max()))
        check(got == want and last == CHUNK_PROMPT - 1,
              f"[fam] (d) layer {i} ring (slots, first, last) {got}, want "
              f"{want}; slot of the last position holds {last}")
    print(f"[fam] (d) rings after prefill: local layers 0-2 hold positions "
          f"{CHUNK_PROMPT - C}..{CHUNK_PROMPT - 1} in {C} slots (position "
          f"p at slot p % {C}), the global layer 0..{CHUNK_PROMPT - 1} in "
          f"{CHUNK_PROMPT + CHUNK_GEN}; capacity_factor "
          f"{cfg.capacity_factor}: {moe._capacity(cfg, T_pre)} slots an "
          f"expert, (token, choice) rows dropped in prefill "
          f"{counts.get(T_pre, 0)} of {T_pre * CHUNK_LAYERS}, in decode "
          f"{sum(n for t, n in counts.items() if t != T_pre)}; card: {card}")
    del caches
    torch.cuda.empty_cache()
    fam_moe_check(torch, steps, moe, cfg, model, CHUNK_B, CHUNK_PROMPT,
                  CHUNK_GEN, 18, "(d)", card)


def fam_part_e(card):
    """Part (e): the serve CLI on zamba2-2.7b at full width on the card."""
    import os
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
           HYBRID_ARCH]
    t0 = time.perf_counter()
    p = subprocess.run(cmd, env=env, cwd=ROOT, capture_output=True,
                       text=True, timeout=LM_CLI_TIMEOUT_S)
    lines = [ln for ln in p.stdout.splitlines() if ln.startswith("[serve]")]
    check(p.returncode == 0 and len(lines) == 3
          and f"arch={HYBRID_ARCH} batch={LM_B}" in lines[0],
          f"[fam] (e) serve exited {p.returncode}:\n{p.stdout[-2000:]}\n"
          f"{p.stderr[-3000:]}")
    for ln in lines:
        print(f"[fam] (e) {ln}")
    print(f"[fam] (e) python -m repro_torch.launch.serve --arch "
          f"{HYBRID_ARCH} took {time.perf_counter() - t0:.3f} s; card: "
          f"{card}")


def families_phase(torch, ops):
    """Phase 11: the moe, ssm and hybrid families served at full width
    (parts (a)-(d)) and the CLI (part (e)).  The path reaches none of the
    fifteen kernels; its launches are counted and printed all the same."""
    from repro_torch.launch import steps
    from repro_torch.models import moe
    from repro_torch.models import transformer as T
    from repro_torch.roofline import analysis
    card = smi()
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    print(f"[fam] phase 11 starts with {torch.cuda.memory_allocated()} bytes "
          f"allocated on the card; card: {card}")
    ops.reset_launch_counts()
    for label, part in (
            ("(a)", lambda: fam_part_a(torch, steps, analysis, T, moe, card)),
            ("(b)", lambda: fam_part_b(torch, steps, analysis, T, card)),
            ("(c)", lambda: fam_part_c(torch, steps, analysis, T, card)),
            ("(d)", lambda: fam_part_d(torch, steps, analysis, T, moe, card))):
        t0 = time.perf_counter()
        part()
        torch.cuda.empty_cache()
        print(f"[fam] part {label} took {time.perf_counter() - t0:.3f} s; "
              f"card: {card}")
    counts = read_counts(ops)
    print(f"[fam] kernel launches on the families' path (parts (a)-(d)): "
          f"{ {k: v for k, v in counts.items() if v and '@' not in k} } "
          f"(it reaches no pallas_call in the JAX package)")
    t0 = time.perf_counter()
    fam_part_e(card)
    print(f"[fam] part (e) took {time.perf_counter() - t0:.3f} s; card: "
          f"{card}")
    print(f"[fam] phase 11 took {time.perf_counter() - t_phase:.3f} s; "
          f"card: {card}")


# ---------------------------------------------------------------------------
# phase 12: LM training (optim/, the loss with remat and the chunked CE,
# train_step_bundle, data/ with the selection pipeline, runtime/trainer.py,
# launch/train.py)
# ---------------------------------------------------------------------------

TRAIN_ARCH = "qwen3-1.7b"
TRAIN_SEQ = 4096                # train_4k's length
TRAIN_B = 10                    # cut from train_4k's 256: the largest batch
#                                 whose peak stays under TRAIN_PEAK_GIB
#                                 (python -m repro_torch.runtime.batch_probe)
TRAIN_PEAK_GIB = 70
TRAIN_STEPS, TRAIN_SELECT_EVERY = 2, 2  # 2 steps (4 before phase 13, 3
#                                        before phase 14, for the time
#                                        budget): curated at 0
RESUME_LAYERS, RESUME_B, RESUME_SEQ = 1, 2, 1024  # 2 layers before phase 14
RESUME_STEPS = 2                # a step, a checkpoint, a resumed step (4
#                                 straight before phase 14, for the time
#                                 budget)
RESUME_TOL = 2e-5               # tests/test_runtime.py's resume bar, where
#                                 an atomic backward reorders a sum
MB_ARCH, MB_LAYERS, MB_B, MB_SEQ = "falcon-mamba-7b", 2, 8, 512  # 4
#                                 layers before phase 14, for the time budget
MB_LOSS_RTOL, MB_RTOL, MB_ATOL = 2e-2, 5e-2, 5e-3  # tests/test_perf_features
# the parameter bar cannot fail after one step at lr 1e-3 (Adam moves an
# element by at most lr (1 + wd |p|)), so the gradients are held too: each
# leaf within a bf16-sized share of its own max |g|, and the grad norm
MB_GRAD_REL, MB_NORM_RTOL = 1e-2, 1e-3
MOE_TRAIN_ARCH, HYBRID_TRAIN_ARCH = "qwen2-moe-a2.7b", "zamba2-2.7b"
ONE_B, ONE_SEQ = 2, 1024
CPU_ARCHS = ("qwen3-1.7b", "falcon-mamba-7b", "qwen2-moe-a2.7b")
CPU_B, CPU_SEQ = 8, 64          # falcon-mamba's 8 micro-batches of one
CPU_LOSS_RTOL, CPU_GRAD_REL = 1e-5, 1e-4
TRAIN_OPT = dict(lr=1e-3, warmup_steps=1)  # parameters move in one step
TRAIN_CLI_STEPS = 2             # 3 before phase 14, for the time budget
TRAIN_CLI = ["--arch", TRAIN_ARCH, "--no-smoke", "--steps",
             str(TRAIN_CLI_STEPS), "--batch",
             "2", "--seq", "512", "--select"]


def train_gib(n):
    return n / 2**30


def spy_steps(trainer):
    """Keep each step's metrics (host floats) of a Trainer's step."""
    seen, step = [], trainer._step_fn

    def spied(model, opt, batch):
        model, opt, m = step(model, opt, batch)
        seen.append({k: float(v) for k, v in m.items()})
        return model, opt, m
    trainer._step_fn = spied
    return seen


class SpyUpdate:
    """While entered, every ``adamw.update`` call of the train step hands
    its gradients to ``keep(grads)`` first."""

    def __init__(self, keep):
        from repro_torch.optim import adamw
        self.adamw, self.keep = adamw, keep

    def __enter__(self):
        update = self.orig = self.adamw.update

        def spied(cfg, params, grads, state, **kw):
            self.keep(grads)
            return update(cfg, params, grads, state, **kw)
        self.adamw.update = spied

    def __exit__(self, *exc):
        self.adamw.update = self.orig


def train_part_a(torch, analysis, card):
    """Part (a): qwen3-1.7b at full width and depth, seq 4096, the Trainer
    with the selection pipeline."""
    from repro_torch.configs.base import SHAPES, ShapeSpec, get_config
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.runtime.trainer import TrainConfig, Trainer
    cfg = get_config(TRAIN_ARCH)
    full = SHAPES["train_4k"]
    check((cfg.n_layers, cfg.d_model, cfg.vocab_size) == (28, 2048, 151_936)
          and full.seq_len == TRAIN_SEQ,
          f"{TRAIN_ARCH} / train_4k are not at full size: {cfg} {full}")
    shape = ShapeSpec("train_4k", TRAIN_SEQ, TRAIN_B, "train")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t = Trainer(cfg, shape,
                data=DataConfig(global_batch=TRAIN_B, seq_len=TRAIN_SEQ,
                                select_every=TRAIN_SELECT_EVERY),
                train=TrainConfig(steps=TRAIN_STEPS),
                select=True, device="cuda")
    metrics = spy_steps(t)
    model, opt = t.run()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    n_params = sum(p.numel() for p in model.parameters())
    state = sum(p.numel() * p.element_size() for p in model.parameters())
    state += sum(2 * m.numel() * m.element_size() for m in opt.m.values())
    flops = analysis.model_flops_for(cfg, shape)
    print(f"[train] (a) {cfg.name}: {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, vocab {cfg.vocab_size}, {n_params} parameters; "
          f"batch {TRAIN_B} x {TRAIN_SEQ} (train_4k's batch "
          f"{full.global_batch} cut to {TRAIN_B}), remat per group, CE in "
          f"chunks of {cfg.loss_chunk}, bf16 compute, curated every "
          f"{TRAIN_SELECT_EVERY} steps; card: {card}")
    check(len(t.history) == TRAIN_STEPS == len(metrics),
          f"[train] (a) took {len(t.history)} steps")
    for rec, m in zip(t.history, metrics):
        ok = all(map(math.isfinite, (rec.loss, m["grad_norm"], m["lr"])))
        check(ok and m["grad_norm"] > 0,
              f"[train] (a) step {rec.step}: loss {rec.loss}, metrics {m}")
        print(f"[train] (a) step {rec.step}: {rec.seconds * 1e3:.1f} ms, "
              f"{TRAIN_B * TRAIN_SEQ / rec.seconds:.0f} tokens/s, loss "
              f"{m['loss']:.6f} (ce {m['ce']:.6f}), grad_norm "
              f"{m['grad_norm']:.6f}, lr {m['lr']:.3e}, MFU "
              f"{100 * flops / rec.seconds / analysis.PEAK_FLOPS:.2f} % "
              f"(model_flops_for {flops:.4e} over the step and "
              f"{analysis.PEAK_FLOPS:.4e} FLOP/s bf16); card: {card}")
    check(peak < TRAIN_PEAK_GIB * 2**30,
          f"[train] (a) peak {train_gib(peak):.2f} GiB over "
          f"{TRAIN_PEAK_GIB} GiB")
    sel = t.pipeline._last_sel
    check(sel is not None and int(sel.sol_size) > 0,
          "[train] (a) the selection pipeline chose no document")
    print(f"[train] (a) peak memory {peak} bytes ({train_gib(peak):.2f} GiB; "
          f"parameters, m and v {train_gib(state):.2f} GiB, the gradients "
          f"{train_gib(state / 3):.2f} GiB at their peak); the last curated "
          f"batch took {int(sel.sol_size)} of {t.pipeline.pool} documents; "
          f"card: {card}")
    return t.pipeline


def train_part_b(torch, card):
    """Part (b): a step, a checkpoint, a resumed step against 2 straight
    (qwen3-1.7b at full width cut to 2 layers)."""
    import dataclasses
    import os
    import shutil
    import tempfile
    from repro_torch.configs.base import ShapeSpec, get_config
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.runtime.trainer import TrainConfig, Trainer
    cfg = dataclasses.replace(get_config(TRAIN_ARCH), n_layers=RESUME_LAYERS)
    shape = ShapeSpec("resume", RESUME_SEQ, RESUME_B, "train")

    def trainer(steps, ckpt):
        return Trainer(cfg, shape, data=DataConfig(global_batch=RESUME_B,
                                                   seq_len=RESUME_SEQ),
                       train=TrainConfig(steps=steps, ckpt_dir=ckpt,
                                         ckpt_every=100, log_every=100),
                       opt=AdamWConfig(**TRAIN_OPT), device="cuda")
    straight = trainer(RESUME_STEPS, None)
    m_full, o_full = straight.run()
    full = {f"params/{n}": p.detach() for n, p in
            m_full.params.named_parameters()}
    full.update({f"m/{n}": t for n, t in o_full.m.items()})
    full.update({f"v/{n}": t for n, t in o_full.v.items()})
    del m_full
    ck = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        trainer(RESUME_STEPS // 2, ck).run()
        nbytes = sum(os.path.getsize(os.path.join(d, f))
                     for d, _, fs in os.walk(ck) for f in fs)
        resumed = trainer(RESUME_STEPS, ck)
        m_res, o_res = resumed.run()
    finally:
        shutil.rmtree(ck, ignore_errors=True)
    check(not os.path.exists(ck), f"[train] (b) {ck} was not removed")
    want_steps = list(range(RESUME_STEPS // 2, RESUME_STEPS))
    check([r.step for r in resumed.history] == want_steps,
          f"[train] (b) the resumed run took steps "
          f"{[r.step for r in resumed.history]}, not {want_steps}")
    got = {f"params/{n}": p.detach() for n, p in
           m_res.params.named_parameters()}
    got.update({f"m/{n}": t for n, t in o_res.m.items()})
    got.update({f"v/{n}": t for n, t in o_res.v.items()})
    differ = [n for n in full if not torch.equal(full[n], got[n])]
    losses = [r.loss for r in straight.history[RESUME_STEPS // 2:]]
    res_losses = [r.loss for r in resumed.history]
    if differ:
        worst = max(float(((got[n] - full[n]).abs() /
                           (RESUME_TOL + RESUME_TOL * full[n].abs())).max())
                    for n in differ)
        check(worst <= 1.0,
              f"[train] (b) resumed vs straight beyond rtol = atol "
              f"{RESUME_TOL} in {differ}")
    print(f"[train] (b) {cfg.name} cut to {RESUME_LAYERS} layers, batch "
          f"{RESUME_B} x {RESUME_SEQ}: steps before a checkpoint of "
          f"{nbytes} bytes (deleted) {RESUME_STEPS // 2}, resumed "
          f"{RESUME_STEPS - RESUME_STEPS // 2} (first StepRecord.step "
          f"{resumed.history[0].step}), against {RESUME_STEPS} straight: "
          + ("every parameter, m and v bit-equal" if not differ else
             f"{len(differ)} of {len(full)} tensors differ, within rtol = "
             f"atol {RESUME_TOL}: {differ}")
          + f"; losses of the resumed steps {res_losses} (straight "
          f"{losses}); "
          f"card: {card}")


def train_part_c(torch, card):
    """Part (c): falcon-mamba-7b at full width cut to 2 layers, one step at
    its configured 8 micro-batches and one at 1, on the same batch."""
    import dataclasses
    from repro_torch.configs.base import ShapeSpec, get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.launch.steps import train_step_bundle
    from repro_torch.models.model import build_model
    from repro_torch.optim import adamw
    cfg = dataclasses.replace(get_config(MB_ARCH), n_layers=MB_LAYERS)
    check((cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.microbatches)
          == (4096, 8192, 16, 8), f"{MB_ARCH} is not at full width: {cfg}")
    shape = ShapeSpec("mb", MB_SEQ, MB_B, "train")
    batch = SyntheticLM(cfg, DataConfig(seed=5, global_batch=MB_B,
                                        seq_len=MB_SEQ), "cuda").batch_at(0)
    out, grads = {}, {}
    for A in (cfg.microbatches, 1):
        c = dataclasses.replace(cfg, microbatches=A)
        bundle = train_step_bundle(c, shape,
                                   opt_cfg=adamw.AdamWConfig(**TRAIN_OPT))
        model = build_model(c, torch.Generator(device="cuda").manual_seed(3),
                            "cuda")
        opt = adamw.init(dict(model.params.named_parameters()))
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        kept = {}
        with SpyUpdate(kept.update):    # references: no copy in the step
            t0 = time.perf_counter()
            model, opt, m = bundle.fn(model, opt, batch)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
        peak = torch.cuda.max_memory_allocated() - base
        grads[A] = {n: g.cpu() for n, g in kept.items()}
        del kept
        out[A] = (float(m["loss"]), {n: p.detach().cpu() for n, p in
                                     model.params.named_parameters()},
                  float(m["grad_norm"]))
        check(math.isfinite(out[A][0]), f"[train] (c) A={A} loss {m}")
        print(f"[train] (c) {cfg.name} cut to {MB_LAYERS} layers, batch "
              f"{MB_B} x {MB_SEQ}, A = {A} micro-batches: {ms:.1f} ms, loss "
              f"{out[A][0]:.6f}, grad_norm {float(m['grad_norm']):.6f}, peak "
              f"{peak} bytes ({train_gib(peak):.2f} GiB) above the "
              f"{train_gib(base):.2f} GiB before the step; card: {card}")
        del model, opt, bundle, m
        torch.cuda.empty_cache()
    (l8, p8, n8), (l1, p1, n1) = out[cfg.microbatches], out[1]
    check(abs(l8 - l1) <= MB_LOSS_RTOL * abs(l1),
          f"[train] (c) loss {l8} at A = 8, {l1} at A = 1")
    worst = max(float(((p8[n] - p1[n]).abs() /
                       (MB_ATOL + MB_RTOL * p1[n].abs())).max()) for n in p1)
    check(worst <= 1.0, f"[train] (c) parameters after A = 8 and A = 1 "
          f"differ by {worst} x (atol {MB_ATOL} + rtol {MB_RTOL})")
    g8, g1 = grads[cfg.microbatches], grads[1]
    check(set(g8) == set(g1) == set(p1),
          f"[train] (c) gradients of {sorted(set(g8) ^ set(g1))} missing")
    rel = {n: float((g8[n] - g1[n]).abs().max() /
                    g1[n].abs().max().clamp(min=1e-30)) for n in g1}
    leaf = max(rel, key=rel.get)
    check(rel[leaf] <= MB_GRAD_REL and abs(n8 - n1) <= MB_NORM_RTOL * n1,
          f"[train] (c) gradients at A = 8 against A = 1: grad norm {n8} / "
          f"{n1}, {leaf} differs by {rel[leaf]} of its max |g| (bar "
          f"{MB_GRAD_REL})")
    print(f"[train] (c) A = 8 against A = 1: loss {l8:.6f} / {l1:.6f} (rtol "
          f"{MB_LOSS_RTOL}), parameters within {worst:.4f} of the bar "
          f"(rtol {MB_RTOL}, atol {MB_ATOL}); grad norm {n8:.6f} / "
          f"{n1:.6f} (rtol {MB_NORM_RTOL}); worst gradient leaf {leaf} at "
          f"{rel[leaf]:.3e} of its max |g| over {len(rel)} leaves (bar "
          f"{MB_GRAD_REL}); card: {card}")


def train_part_d(torch, card):
    """Part (d): one step of qwen2-moe-a2.7b cut to 2 layers and of
    zamba2-2.7b cut to 2 groups, at full width: the loss, the router aux,
    a non-zero gradient for every parameter, and the MoE's routing under
    remat's recompute."""
    import dataclasses
    from repro_torch.configs.base import ShapeSpec, get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.launch.steps import train_step_bundle
    from repro_torch.models import moe
    from repro_torch.models.model import build_model
    from repro_torch.optim import adamw
    for arch, cut in ((MOE_TRAIN_ARCH, lambda c: 2),
                      (HYBRID_TRAIN_ARCH, lambda c: 2 * c.shared_attn_every)):
        cfg = get_config(arch)
        cfg = dataclasses.replace(cfg, n_layers=cut(cfg))
        shape = ShapeSpec("one", ONE_SEQ, ONE_B, "train")
        bundle = train_step_bundle(cfg, shape,
                                   opt_cfg=adamw.AdamWConfig(**TRAIN_OPT))
        model = build_model(cfg, torch.Generator(device="cuda").manual_seed(4),
                            "cuda")
        opt = adamw.init(dict(model.params.named_parameters()))
        batch = SyntheticLM(cfg, DataConfig(seed=6, global_batch=ONE_B,
                                            seq_len=ONE_SEQ),
                            "cuda").batch_at(0)
        routes, gmax = [], {}
        route = moe._route

        def recorded(logits, c):
            gate, idx, aux = route(logits, c)
            routes.append(idx.clone())
            return gate, idx, aux

        def keep(grads):
            names = list(grads)
            amax = torch.stack([grads[n].abs().max() for n in names]).cpu()
            gmax.update(zip(names, amax.tolist()))
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        moe._route = recorded
        try:
            with SpyUpdate(keep):
                t0 = time.perf_counter()
                model, opt, m = bundle.fn(model, opt, batch)
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) * 1e3
        finally:
            moe._route = route
        peak = torch.cuda.max_memory_allocated() - base
        loss, aux = float(m["loss"]), float(m["aux"])
        check(math.isfinite(loss) and math.isfinite(aux),
              f"[train] (d) {arch}: loss {loss}, aux {aux}")
        zero = [n for n, v in gmax.items() if not v > 0]
        check(not zero and len(gmax) == len(list(model.parameters())),
              f"[train] (d) {arch}: no gradient for {zero}")
        line = (f"[train] (d) {cfg.name} cut to {cfg.n_layers} layers, batch "
                f"{ONE_B} x {ONE_SEQ}: {ms:.1f} ms, loss {loss:.6f}, aux "
                f"{aux:.6f}, every one of {len(gmax)} parameters has a "
                f"non-zero gradient (smallest max |g| "
                f"{min(gmax.values()):.3e}")
        if cfg.family == "moe":
            n = cfg.n_layers
            check(aux > 0, f"[train] (d) {arch}: router aux {aux}")
            check(len(routes) == 2 * n and all(
                torch.equal(a, b) for a, b in zip(routes[:n],
                                                  reversed(routes[n:]))),
                f"[train] (d) {arch}: {len(routes)} routings; the recompute "
                f"under remat routed some token otherwise")
            line += (f"; the recompute of all {n} groups routed every one of "
                     f"{routes[0].numel()} (token, choice) pairs a layer as "
                     f"the forward did")
        else:
            shared = [v for n, v in gmax.items()
                      if n.startswith("shared_block.")]
            line += (f"; the shared block's {len(shared)} parameters take "
                     f"their gradient summed over the "
                     f"{len(model.params.groups)} groups")
        print(f"{line}), peak {peak} bytes ({train_gib(peak):.2f} GiB); "
              f"card: {card}")
        del model, opt, bundle, m
        torch.cuda.empty_cache()


def train_part_e(torch, card):
    """Part (e): one train_step_bundle step of the reduced qwen3,
    falcon-mamba (8 micro-batches) and qwen2-moe on the card and on the
    CPU, the same parameters and batch, f32 compute."""
    import copy
    from repro_torch.configs.base import ShapeSpec, get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.launch.steps import train_step_bundle
    from repro_torch.models.model import build_model
    from repro_torch.optim import adamw
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False  # the conv's f32 too
    try:
        for arch in CPU_ARCHS:
            cfg = get_config(arch).reduced()
            shape = ShapeSpec("cpu", CPU_SEQ, CPU_B, "train")
            cpu = build_model(cfg, torch.Generator().manual_seed(7), "cpu",
                              torch.float32)
            card_model = copy.deepcopy(cpu).to("cuda")
            batch = SyntheticLM(cfg, DataConfig(seed=8, global_batch=CPU_B,
                                                seq_len=CPU_SEQ),
                                "cpu").batch_at(0)
            got = {}
            for where, model in (("cpu", cpu), ("cuda", card_model)):
                bundle = train_step_bundle(
                    cfg, shape, opt_cfg=adamw.AdamWConfig(**TRAIN_OPT))
                opt = adamw.init(dict(model.params.named_parameters()))
                grads = {}
                with SpyUpdate(lambda g: grads.update(
                        {n: t.detach().cpu().clone() for n, t in g.items()})):
                    _, _, m = bundle.fn(model, opt, {
                        k: v.to(where) for k, v in batch.items()})
                got[where] = (float(m["loss"]), grads)
            (lc, gc), (lg, gg) = got["cpu"], got["cuda"]
            check(abs(lg - lc) <= CPU_LOSS_RTOL * abs(lc),
                  f"[train] (e) {arch}: loss {lg} on the card, {lc} on the "
                  f"CPU")
            rel = {n: float((gg[n] - gc[n]).abs().max() /
                            gc[n].abs().max().clamp(min=1e-30)) for n in gc}
            bad = {n: r for n, r in rel.items() if r > CPU_GRAD_REL}
            check(not bad and set(gg) == set(gc),
                  f"[train] (e) {arch}: gradients beyond {CPU_GRAD_REL} of "
                  f"their max: {bad}")
            print(f"[train] (e) {cfg.name} (A = {max(1, cfg.microbatches)}), "
                  f"batch {CPU_B} x {CPU_SEQ}, f32: loss {lg:.7f} on the "
                  f"card, {lc:.7f} on the CPU; worst gradient leaf "
                  f"{max(rel.values()):.2e} of its max |g| over {len(rel)} "
                  f"leaves (bar {CPU_GRAD_REL}); card: {card}")
    finally:
        torch.backends.cudnn.allow_tf32 = tf32


def train_part_f(torch, ops, pipeline, card):
    """Part (f): one of (a)'s curation pools through a selector with
    use_kernel=True (the same spec, dense engine, and the fused engine,
    whose sweep is coverage_accept): the plain route's ids."""
    import dataclasses
    from repro_torch.core.selector import DistributedSelector
    from repro_torch.data.pipeline import doc_embeddings, step_generator
    d = pipeline.base.data
    step = 0
    pools = [pipeline.base.batch_at(step * d.pool_factor + i + 10_000)
             for i in range(d.pool_factor)]
    cat = {k: torch.cat([p[k] for p in pools]) for k in pools[0]}
    emb = doc_embeddings(cat, pipeline.emb_dim)
    plain = pipeline.selector
    check(not plain.spec.use_kernel, "[train] (f) the pipeline's selector "
          "runs the kernel route")

    def select(sel):
        return sel.select(emb, sel.opt_upper_bound(emb),
                          generator=step_generator(d.seed + 77, step, "cuda"))
    want = select(plain).sol_ids
    for engine in ("dense", "fused"):
        spec = dataclasses.replace(plain.spec, use_kernel=True, engine=engine)
        sel = DistributedSelector(spec, n_total=pipeline.pool,
                                  feat_dim=pipeline.emb_dim, device="cuda")
        ops.reset_launch_counts()
        got = select(sel).sol_ids
        torch.cuda.synchronize()
        counts = {k: v for k, v in read_counts(ops).items()
                  if v and "@" not in k}
        check(torch.equal(got, want),
              f"[train] (f) {engine}: kernel route ids {got.tolist()}, plain "
              f"{want.tolist()}")
        need = ("coverage_marginals",) + (
            ("coverage_accept",) if engine == "fused" else ())
        check(all(counts.get(k, 0) > 0 for k in need),
              f"[train] (f) {engine}: launches {counts}")
        print(f"[train] (f) the step-{step} curation pool ({pipeline.pool} "
              f"documents of {d.seq_len} tokens, {pipeline.emb_dim} hash "
              f"features) on the {engine} engine's kernel route: ids "
              f"{got.tolist()} = the plain route's; launches {counts}; "
              f"card: {card}")


def train_part_g(card):
    """Part (g): the training CLI at full width on the card."""
    import os
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    cmd = [sys.executable, "-m", "repro_torch.launch.train", *TRAIN_CLI]
    t0 = time.perf_counter()
    p = subprocess.run(cmd, env=env, cwd=ROOT, capture_output=True,
                       text=True, timeout=LM_CLI_TIMEOUT_S)
    lines = [ln for ln in p.stdout.splitlines() if ln.startswith("[train]")]
    check(p.returncode == 0 and lines
          and lines[-1].startswith(
              f"[train] done: steps={TRAIN_CLI_STEPS} loss "),
          f"[train] (g) train exited {p.returncode}:\n{p.stdout[-2000:]}\n"
          f"{p.stderr[-3000:]}")
    for ln in lines:
        print(f"[train] (g) {ln}; card: {card}")
    print(f"[train] (g) python -m repro_torch.launch.train "
          f"{' '.join(TRAIN_CLI)} took {time.perf_counter() - t0:.3f} s; "
          f"card: {card}")


def train_phase(torch, ops):
    """Phase 12: LM training on the card, parts (a)-(g).  The training
    path reaches none of the fifteen kernels (its curation runs the plain
    route, as the JAX package's); (f) runs the curation's kernel route."""
    from repro_torch.roofline import analysis
    card = smi()
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    print(f"[train] phase 12 starts with {torch.cuda.memory_allocated()} "
          f"bytes allocated on the card; card: {card}")
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    pipeline = train_part_a(torch, analysis, card)
    torch.cuda.empty_cache()
    counts = read_counts(ops)
    print(f"[train] part (a) took {time.perf_counter() - t0:.3f} s; kernel "
          f"launches on the training path: "
          f"{ {k: v for k, v in counts.items() if v and '@' not in k} } "
          f"(the LM stack reaches no pallas_call in the JAX package, and the "
          f"curation's selector runs the plain route, use_kernel=False, as "
          f"the JAX package's); card: {card}")
    for label, part in (
            ("(b)", lambda: train_part_b(torch, card)),
            ("(c)", lambda: train_part_c(torch, card)),
            ("(d)", lambda: train_part_d(torch, card)),
            ("(e)", lambda: train_part_e(torch, card)),
            ("(f)", lambda: train_part_f(torch, ops, pipeline, card)),
            ("(g)", lambda: train_part_g(card))):
        t0 = time.perf_counter()
        part()
        torch.cuda.empty_cache()
        print(f"[train] part {label} took {time.perf_counter() - t0:.3f} s; "
              f"card: {card}")
    print(f"[train] phase 12 took {time.perf_counter() - t_phase:.3f} s; "
          f"card: {card}")


# ---------------------------------------------------------------------------
# phase 13: LM serving on a (data, model) mesh of gloo ranks sharing the one
# card (models/sharding.py, models/collectives.py, the sharded layers, the
# MoE's ep / tp / all-to-all modes, the bundles on a mesh)
# ---------------------------------------------------------------------------

LMM_GROUP_TIMEOUT_S = 600    # a process group's collectives give up after
LMM_JOB_TIMEOUT_S = 600      # a spawned job's limit
LMM_B, LMM_PROMPT, LMM_GEN = 4, 64, 8
LMM_A_LAYERS = 4             # qwen3-1.7b's 28 layers cut to 4 (full
#                              depth before phase 14, for the time budget)
LMM_MOE8_LAYERS = 1          # (c): qwen2-moe on (1, 8), 1 layer (2 before
#                              phase 14, for the time budget)
LMM_F32_LAYERS = 2
LMM_LONG = 1024              # the B = 1 prefill: the seq_shard branch
LMM_MOE_LAYERS = 2           # llama4: 2 layers (global_attn_every 2: one
#                              chunked-local + one global); 4 layers hold
#                              21 GB a rank, 84 GB for four ranks
LMM_F32_TOL = 1e-4
LMM_CARD_BYTES = 80 * 10 ** 9   # an H100's memory, for the depth a rank holds
#: part -> (mesh (data, model), architecture, layers, compute dtype name,
#: capacity raised to E / k, B, prompt, seed)
LMM_PARTS = {
    "(a)": ((2, 2), "qwen3-1.7b", LMM_A_LAYERS, "bfloat16", False, LMM_B,
            LMM_PROMPT, 130),
    "(a) f32": ((2, 2), "qwen3-1.7b", LMM_F32_LAYERS, "float32", False,
                LMM_B, LMM_PROMPT, 131),
    "(a) long": ((2, 2), "qwen3-1.7b", LMM_F32_LAYERS, "float32", False, 1,
                 LMM_LONG, 131),
    "(b)": ((2, 2), "llama4-scout-17b-a16e", LMM_MOE_LAYERS, "float32", True,
            LMM_B, LMM_PROMPT, 132),
    "(c)": ((1, 8), "qwen2-moe-a2.7b", LMM_MOE8_LAYERS, "float32", True,
            LMM_B, LMM_PROMPT, 133),
}


def lmm_config(name, layers, raised):
    import dataclasses
    from repro_torch.configs.base import get_config
    cfg = get_config(name)
    over = dict(n_layers=layers)
    if cfg.global_attn_every:
        over["global_attn_every"] = layers
    if raised:
        over["capacity_factor"] = cfg.n_experts / cfg.experts_per_token
    return dataclasses.replace(cfg, **over)


def lmm_serve(torch, steps, model, cfg, mesh, B, prompt, gen, tokens, forced):
    """Serve ``tokens`` through the bundles on ``mesh`` (None: one rank),
    feeding ``forced`` ids (B, gen) to the decode steps when given (else
    the greedy ids).  Returns (full-batch greedy ids (B, gen) on the host,
    each step's logits block on the host, prefill ms, decode ms by step,
    the collectives by kind of the prefill and of each decode step, the
    prefill's policy)."""
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.models import collectives as C
    pre = steps.prefill_bundle(cfg, ShapeSpec("mesh", prompt, B, "prefill"),
                               mesh)
    dec = steps.decode_step_bundle(cfg, ShapeSpec("mesh", prompt + gen, B,
                                                  "decode"), mesh)
    sync = (lambda: torch.distributed.barrier()) if mesh is not None \
        else torch.cuda.synchronize
    torch.cuda.synchronize()
    sync()
    C.reset_counts()
    t0 = time.perf_counter()
    logits, caches = pre.fn(model, {"tokens": tokens},
                            cache_len=prompt + gen)
    torch.cuda.synchronize()
    sync()
    t_pre = (time.perf_counter() - t0) * 1e3
    counts = [C.counts()]
    out, ids, t_dec = [logits.float().cpu()], [], []
    tok = model.greedy(logits, pre.policy)
    ids.append(tok.cpu())
    for i in range(gen - 1):
        feed = tok if forced is None else forced[:, i:i + 1]
        pos = torch.full((B, 1), prompt + i, dtype=torch.int32,
                         device="cuda")
        C.reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, caches = dec.fn(model, caches, feed, pos)
        tok = model.greedy(logits, dec.policy)
        torch.cuda.synchronize()
        t_dec.append((time.perf_counter() - t0) * 1e3)
        counts.append(C.counts())
        out.append(logits.float().cpu())
        ids.append(tok.cpu())
    return torch.cat(ids, 1), out, t_pre, t_dec, counts, pre.policy


def lmm_tokens(torch, cfg, B, prompt, seed):
    return torch.randint(0, cfg.vocab_size, (B, prompt), device="cuda",
                         dtype=torch.int32,
                         generator=torch.Generator(device="cuda")
                         .manual_seed(seed))


def lmm_reference(torch, steps, label, out_dir):
    """The one-rank serving of a part on the card: writes the prompts, the
    greedy ids and every step's whole logits to ``out_dir``."""
    import pickle
    from repro_torch.models.model import build_model
    shape, name, layers, dt, raised, B, prompt, seed = LMM_PARTS[label]
    cfg = lmm_config(name, layers, raised)
    dtype = getattr(torch, dt)
    model = build_model(cfg, torch.Generator(device="cuda").manual_seed(seed),
                        "cuda", dtype)
    gen = LMM_GEN if prompt == LMM_PROMPT else 1
    toks = lmm_tokens(torch, cfg, B, prompt, seed + 1000)
    torch.cuda.reset_peak_memory_stats()
    ids, logits, t_pre, t_dec, _, _ = lmm_serve(
        torch, steps, model, cfg, None, B, prompt, gen, toks, None)
    peak = torch.cuda.max_memory_allocated()
    with open(Path(out_dir) / f"ref{label}.pkl", "wb") as f:
        pickle.dump(dict(tokens=toks.cpu(), ids=ids, logits=logits), f)
    print(f"[lmmesh] {label} one rank: {cfg.name}, {cfg.n_layers} layers, "
          f"{dt}, B={B} prompt={prompt} gen={gen}: prefill {t_pre:.3f} ms, "
          f"decode {[round(t, 3) for t in t_dec]} ms; peak "
          f"{peak / 2 ** 30:.3f} GiB; ids {ids[0].tolist()}")
    del model
    torch.cuda.empty_cache()


def lmm_compare(got, want, spec, mesh, tol):
    """This rank's logits blocks against the one-rank run's whole logits:
    (max |diff| beyond rtol = atol ``tol``, max |diff|)."""
    from repro_torch.models.sharding import block
    excess = worst = 0.0
    for g, w in zip(got, want):
        w = w[block(w.shape, spec, mesh.shape, mesh.coords)]
        diff = (g - w).abs()
        excess = max(excess, (diff - tol * w.abs()).max().item())
        worst = max(worst, diff.max().item())
    return excess, worst


def lmm_rank(rank, world, store, out_dir, labels):
    """A rank of phase 13's spawned job: joins the gloo job on the one
    card and serves every part of ``labels`` on its mesh, against the
    one-rank run's results in ``out_dir``; writes its findings there."""
    import datetime
    import pickle
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    import torch.distributed as dist
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch import steps
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_mesh_for
    from repro_torch.models.model import build_model
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group(
        "gloo", init_method=f"file://{store}", rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=LMM_GROUP_TIMEOUT_S))
    results, meshes = {}, {}
    for label in labels:
        shape, name, layers, dt, raised, B, prompt, seed = LMM_PARTS[label]
        t_part = time.perf_counter()
        if shape not in meshes:
            meshes[shape] = make_mesh_for(world, model_parallel=shape[1])
        mesh = meshes[shape]
        cfg = lmm_config(name, layers, raised)
        dtype = getattr(torch, dt)
        with open(Path(out_dir) / f"ref{label}.pkl", "rb") as f:
            ref = pickle.load(f)
        gen = ref["ids"].shape[1]
        dec = steps.decode_step_bundle(
            cfg, ShapeSpec("mesh", prompt + gen, B, "decode"), mesh)
        # the ranks draw their blocks one after another: a rank holds a
        # whole sublayer while it draws
        t0 = time.perf_counter()
        for r in range(world):
            if r == rank:
                model = build_model(
                    cfg, torch.Generator(device="cuda").manual_seed(seed),
                    "cuda", dtype, policy=dec.policy)
                torch.cuda.synchronize()
                torch.cuda.empty_cache()
            dist.barrier()
        t_build = time.perf_counter() - t0
        n_bytes = sum(p.numel() * p.element_size()
                      for p in model.params.parameters())
        # the layers' share of it, a layer (every layer's blocks have the
        # same shapes): what a deeper model adds a rank
        layer_bytes = sum(p.numel() * p.element_size() for n, p in
                          model.params.named_parameters()
                          if n.startswith("groups.")) // cfg.n_layers
        torch.cuda.reset_peak_memory_stats()
        toks = ref["tokens"].cuda()
        forced = ref["ids"].cuda() if gen > 1 else None
        # this rank's kernel launches on the mesh serving path itself
        ops.reset_launch_counts()
        ids, logits, t_pre, t_dec, counts, pol = lmm_serve(
            torch, steps, model, cfg, mesh, B, prompt, gen, toks, forced)
        launches = {k: v for k, v in read_counts(ops).items() if v}
        peak = torch.cuda.max_memory_allocated()
        spec = pol.logits_spec((B, 1, cfg.padded_vocab))
        dspec = dec.policy.logits_spec((B, 1, cfg.padded_vocab))
        tol = LMM_F32_TOL if dtype == torch.float32 else LM_TOL
        ex0, w0 = lmm_compare(logits[:1], ref["logits"][:1], spec, mesh,
                              tol)
        ex1, w1 = lmm_compare(logits[1:], ref["logits"][1:], dspec, mesh,
                              tol)
        # argmax: the greedy ids against the one-rank logits' argmax, over
        # every row and over the rows whose top-2 gap exceeds the bar (in
        # bf16 a gap within it is a near-tie either run may round apart)
        ref_top = torch.stack([w[:, -1, :cfg.vocab_size].topk(2, -1).values
                               for w in ref["logits"]], 1)
        wide = (ref_top[..., 0] - ref_top[..., 1]) > tol
        same = ids == ref["ids"]
        results[label] = dict(
            ids=ids, ref_ids=ref["ids"], excess=max(ex0, ex1),
            agree=(int(same.sum()), same.numel(), int((same & wide).sum()),
                   int(wide.sum())),
            worst=max(w0, w1), tol=tol, t_pre=t_pre, t_dec=t_dec,
            counts=counts, launches=launches, peak=peak,
            param_bytes=n_bytes, layer_bytes=layer_bytes, build_s=t_build,
            batch_axes=pol.batch_axes, seq_shard=pol.seq_shard,
            dec_batch_axes=dec.policy.batch_axes,
            seconds=time.perf_counter() - t_part)
        del model, logits
        torch.cuda.empty_cache()
        dist.barrier()
    dist.destroy_process_group()
    with open(Path(out_dir) / f"rank{rank}.pkl", "wb") as f:
        pickle.dump(results, f)


def lmm_spawn(world, labels, out_dir):
    """Start ``world`` ranks of ``lmm_rank`` (spawn start method) and wait;
    a rank that raises, or a job past LMM_JOB_TIMEOUT_S, fails the phase,
    and every rank is gone when this returns.  Returns each rank's
    results."""
    import pickle
    import torch.multiprocessing as mp
    store = Path(out_dir) / f"store{world}"
    ctx = mp.start_processes(lmm_rank,
                             args=(world, str(store), out_dir, labels),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + LMM_JOB_TIMEOUT_S
    try:
        while not ctx.join(timeout=5):
            check(time.monotonic() < deadline,
                  f"[lmmesh] the {world}-rank job outlived "
                  f"{LMM_JOB_TIMEOUT_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join()
    out = []
    for r in range(world):
        with open(Path(out_dir) / f"rank{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out


def lmm_report(label, res, card):
    """Hold a part's ranks to its bar and print what they measured."""
    from repro_torch.configs.base import get_config
    r0 = res[0][label]
    shape, name, layers, dt, raised, B, prompt, _ = LMM_PARTS[label]
    for r, rr in enumerate(res):
        x = rr[label]
        check(bool((x["ids"] == r0["ids"]).all()),
              f"[lmmesh] {label}: rank {r}'s ids {x['ids'].tolist()} are "
              f"not rank 0's {r0['ids'].tolist()}")
        check(x["excess"] <= x["tol"],
              f"[lmmesh] {label}: rank {r}'s logits differ from the one-rank "
              f"run's by {x['excess']} beyond rtol = atol {x['tol']} (max "
              f"|diff| {x['worst']})")
        # the LM stack reaches no pallas_call in the JAX package: a kernel
        # of the table launched here would be a path the reference lacks
        check(not x["launches"],
              f"[lmmesh] {label}: rank {r} launched kernels {x['launches']}")
    want, test = LMM_BRANCHES[label]
    for key, val in want.items():
        check(r0[key] == val, f"[lmmesh] {label}: {key} {r0[key]}, the "
              f"branch wants {val}")
    check(test is None or test(r0["counts"][0], r0["counts"][1], layers),
          f"[lmmesh] {label}: collectives {r0['counts'][:2]}")
    agree, rows, kept_agree, kept = r0["agree"]
    check(agree == rows if dt == "float32" else
          kept_agree >= LM_ARGMAX * kept,
          f"[lmmesh] {label}: greedy ids {r0['ids'].tolist()} against the "
          f"one-rank run's {r0['ref_ids'].tolist()}: {agree}/{rows} equal, "
          f"{kept_agree}/{kept} where the top-2 gap exceeds the bar")
    kinds = {s: {f"{k[0]} {'/'.join(k[1])}": v
                 for k, v in sorted(c.items())}
             for s, c in (("prefill", r0["counts"][0]),
                          ("decode step", r0["counts"][1]
                           if len(r0["counts"]) > 1 else {}))}
    print(f"[lmmesh] {label} {name}, {layers} layers, {dt}, mesh "
          f"(data, model) = {shape}, B={B} prompt={prompt}"
          f"{' capacity E / k' if raised else ''}: prefill batch axes "
          f"{r0['batch_axes']} seq_shard {r0['seq_shard']}, decode batch "
          f"axes {r0['dec_batch_axes']}; max |logit diff| to one rank "
          f"{max(x[label]['worst'] for x in res)} (bar rtol = atol "
          f"{r0['tol']}), argmax = one rank's in {agree}/{rows}, "
          f"{kept_agree}/{kept} where the top-2 gap exceeds the bar (every "
          f"rank's ids the same); card: {card}")
    full = get_config(name).n_layers
    fixed = r0["param_bytes"] - layers * r0["layer_bytes"]
    print(f"[lmmesh] {label} resident parameter bytes a rank: "
          f"{r0['layer_bytes']} a layer beside {fixed} outside the layers, "
          f"so {fixed + full * r0['layer_bytes']} at the full {full} layers "
          f"on this mesh; at most {(LMM_CARD_BYTES - fixed) // r0['layer_bytes']} "
          f"layers fit a rank's {LMM_CARD_BYTES} B card with these "
          f"resident weights, before any activation or cache; card: {card}")
    print(f"[lmmesh] {label} prefill ms by rank "
          f"{[round(x[label]['t_pre'], 3) for x in res]}; decode ms a step "
          f"(rank 0) {[round(t, 3) for t in r0['t_dec']]}; parameter bytes a "
          f"rank {[x[label]['param_bytes'] for x in res]}; peak GiB by rank "
          f"{[round(x[label]['peak'] / 2 ** 30, 3) for x in res]}; drawn in "
          f"{r0['build_s']:.3f} s; collectives (calls, operand bytes) by "
          f"kind, rank 0: {kinds}; kernel launches on the mesh serving "
          f"path by rank {[x[label]['launches'] for x in res]} (it reaches "
          f"no pallas_call in the JAX package); took {r0['seconds']:.3f} s; "
          f"card: {card}")


#: what each part's prefill and decode policies must be, and a test of its
#: collectives (kind, axes) -> (calls, bytes) of the prefill and of a decode
#: step: the branches the parts are there to take
LMM_BRANCHES = {
    "(a)": (dict(batch_axes=("data", "model"), seq_shard=None,
                 dec_batch_axes=("data",)), None),
    "(a) f32": (dict(batch_axes=("data", "model"), seq_shard=None), None),
    "(a) long": (dict(batch_axes=(), seq_shard="model"), None),
    # prefill: the all-to-all dispatch, two a layer; decode: ep's
    # all_gather over the model axis a layer, the router's a layer (its
    # (D, E) leaf is split over (data, model)) and greedy's two
    "(b)": (dict(batch_axes=("data", "model"), dec_batch_axes=("data",)),
            lambda pre, dec, L: pre[("all_to_all", ("model",))][0] == 2 * L
            and dec[("all_gather", ("model",))][0] == 2 * L + 2),
    # prefill: ZeRO without EP (no all_to_all), B = 4 does not fill the
    # 8 ranks, so the sequence is sharded over "model"; decode: tp's
    # all_reduce over the model axis a layer, beside attention's two (the
    # scores over head_dim, wo's partial sums), the shared expert's and
    # the vocab-parallel lookup's
    "(c)": (dict(batch_axes=("data",), seq_shard="model",
                 dec_batch_axes=("data",)),
            lambda pre, dec, L: not any(k[0] == "all_to_all" for k in pre)
            and dec[("all_reduce", ("model",))][0] == 4 * L + 1),
}


def lm_mesh_phase(torch):
    """Phase 13: the dense and moe families served on a (data, model) mesh
    of gloo ranks sharing the one card, against the one-rank serving of
    the same weights (drawn from the same seeded generator) on the same
    card: (a) qwen3-1.7b on (2, 2) in bf16, then 2 layers in f32 and a B =
    1 prefill of 1024 tokens (the seq_shard branch); (b)
    llama4-scout-17b-a16e on (2, 2) in f32 with capacity E / k (prefill's
    all-to-all dispatch, decode's ep); (c) qwen2-moe-a2.7b on (1, 8) in
    f32 with capacity E / k (prefill's ZeRO without EP, decode's tp).  The
    decode steps take the one-rank run's ids, so each step compares the
    same inputs.  The path reaches no kernel of the table."""
    import tempfile
    from repro_torch.launch import steps
    card = smi()
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        for label in LMM_PARTS:
            lmm_reference(torch, steps, label, tmp)
        print(f"[lmmesh] the one-rank runs took {time.perf_counter() - t0:.3f}"
              f" s; card: {card}")
        for world, labels in ((4, ("(a)", "(a) f32", "(a) long", "(b)")),
                              (8, ("(c)",))):
            t0 = time.perf_counter()
            res = lmm_spawn(world, labels, tmp)
            for label in labels:
                lmm_report(label, res, card)
            print(f"[lmmesh] the {world}-rank job took "
                  f"{time.perf_counter() - t0:.3f} s; card: {card}")
    print(f"[lmmesh] phase 13 took {time.perf_counter() - t_phase:.3f} s; "
          f"card: {card}")


# ---------------------------------------------------------------------------
# phase 14: LM training on a (data, model) mesh of gloo ranks sharing the one
# card (the ZeRO-3 train step with the collectives' backward, the
# vocab-parallel CE, AdamW over shards, the mesh-independent checkpoint, the
# curation on the training mesh)
# ---------------------------------------------------------------------------

TM_ARCH, TM_LAYERS = "qwen3-1.7b", 2   # 28 layers cut to 2
TM_B, TM_SEQ = 4, 4096          # train_4k's length, its batch 256 cut to 4
TM_STEPS, TM_SELECT_EVERY = 3, 2
TM_SEQ_B = 2                    # (b): 2 rows cannot fill 4 ranks: seq_shard
TM_MOE_ARCH, TM_MOE_LAYERS = "qwen2-moe-a2.7b", 2   # 24 layers cut to 2
TM_MOE_B, TM_MOE_SEQ = 4, 1024
TM_OPT = dict(lr=1e-3, warmup_steps=1)
TM_RTOL, TM_LEAF = 1e-5, 1e-4   # the f32 bars: metrics; a leaf's max |.|
TM_GROUP_TIMEOUT_S = 600
TM_JOB_TIMEOUT_S = 900
#: reference -> (architecture, layers, compute dtype name, capacity raised
#: to E / k, batch, sequence, the leaves kept for the ranks' comparison)
TM_REFS = {
    "(a) f32": (TM_ARCH, TM_LAYERS, "float32", False, TM_B, TM_SEQ,
                ("grads", "params", "m", "v")),
    "(a) bf16": (TM_ARCH, TM_LAYERS, "bfloat16", False, TM_B, TM_SEQ,
                 ("grads", "params")),
    "(b)": (TM_ARCH, TM_LAYERS, "float32", False, TM_SEQ_B, TM_SEQ,
            ("grads", "params")),
    "(c)": (TM_MOE_ARCH, TM_MOE_LAYERS, "float32", True, TM_MOE_B,
            TM_MOE_SEQ, ("grads",)),
}


def tm_config(name, layers, raised):
    """``lmm_config``'s cut; with capacity raised, the router aux loss's
    coefficient 0 too: on a mesh the aux is the mean over the token blocks
    of each block's aux (the JAX package's ``shard_map``), not one rank's
    aux of the whole batch, so the comparison keeps it out of the
    gradients."""
    cfg = lmm_config(name, layers, raised)
    if raised:
        import dataclasses
        cfg = dataclasses.replace(cfg, router_aux_coef=0.0)
    return cfg


def tm_batch(torch, cfg, B, S, step=0):
    """The global batch of ``step`` (every rank draws the same one)."""
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    return SyntheticLM(cfg, DataConfig(seed=14, global_batch=B, seq_len=S),
                       "cuda").batch_at(step)


def tm_model(torch, cfg, dtype, policy=None):
    """The parameters drawn on the card from the train seed 0 (the
    Trainer's), placed by ``policy`` on a mesh."""
    from repro_torch.models.model import build_model
    return build_model(cfg, torch.Generator(device="cuda").manual_seed(0),
                       "cuda", dtype, policy=policy)


def tm_step(torch, cfg, B, S, model, mesh=None, batch_step=0):
    """One train step of ``model`` on ``mesh`` (None: one rank) from a
    fresh opt state: (metrics, {"grads", "params", "m", "v"} by name, ms,
    the collectives of the step)."""
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch.steps import train_step_bundle
    from repro_torch.models import collectives as C
    from repro_torch.optim import adamw
    bundle = train_step_bundle(cfg, ShapeSpec("tm", S, B, "train"), mesh,
                               adamw.AdamWConfig(**TM_OPT))
    opt = adamw.init(dict(model.params.named_parameters()))
    batch = tm_batch(torch, cfg, B, S, batch_step)
    grads = {}
    sync = torch.distributed.barrier if mesh is not None else (lambda: None)
    torch.cuda.synchronize()
    sync()
    C.reset_counts()
    with SpyUpdate(grads.update):
        t0 = time.perf_counter()
        model, opt, m = bundle.fn(model, opt, batch)
        torch.cuda.synchronize()
        sync()
        ms = (time.perf_counter() - t0) * 1e3
    counts = C.counts()
    state = {"grads": grads,
             "params": {n: p.detach() for n, p in
                        model.params.named_parameters()},
             "m": opt.m, "v": opt.v}
    return {k: float(v) for k, v in m.items()}, state, ms, counts


def tm_reference(torch, label):
    """The one-rank step of a reference on the card: its metrics, each
    kept leaf's max |.|, and the kept leaves themselves, left on the card
    for the spawned ranks (torch.multiprocessing hands them CUDA tensors
    by IPC handle, so a rank reads its blocks where they lie)."""
    name, layers, dt, raised, B, S, kinds = TM_REFS[label]
    cfg = tm_config(name, layers, raised)
    model = tm_model(torch, cfg, getattr(torch, dt))
    # the kept leaves' memory is taken before the step, so the step's
    # freed activations leave no segment reserved around them
    kept = {kind: {n: torch.empty(p.shape, dtype=torch.float32,
                                  device="cuda")
                   for n, p in model.params.named_parameters()}
            for kind in kinds}
    torch.cuda.reset_peak_memory_stats()
    metrics, state, ms, _ = tm_step(torch, cfg, B, S, model)
    peak = torch.cuda.max_memory_allocated()
    for kind, leaves in kept.items():
        for n, t in leaves.items():
            t.copy_(state[kind][n])
    del model, state
    torch.cuda.empty_cache()
    scale = {(kind, n): t.abs().max().item()
             for kind, leaves in kept.items() for n, t in leaves.items()}
    print(f"[trainmesh] {label} one rank: {cfg.name}, {layers} layers, {dt}, "
          f"batch {B} x {S}: {ms:.1f} ms, loss {metrics['loss']:.6f}, "
          f"grad_norm {metrics['grad_norm']:.6f}; peak "
          f"{peak / 2 ** 30:.3f} GiB")
    return dict(metrics=metrics, scale=scale, ms=ms, leaves=kept)


def tm_compare(torch, ref, label, state, specs, mesh, bf16=False,
               kinds=None):
    """This rank's blocks against the one-rank reference's leaves: per kind
    (the worst leaf's value, the leaf): the gradients' and moments' max
    |diff| over the leaf's max |.|; the parameters' max |diff| in f32 (the
    bar is 2 lr), in bf16 the worst |diff| / (atol + rtol |p|).  ``kinds``:
    the kinds kept (default: the reference's ``TM_REFS`` entry)."""
    from repro_torch.models.sharding import block
    worst = {}
    for kind in kinds or TM_REFS[label][6]:
        for n, t in state[kind].items():
            full = ref["leaves"][kind][n]
            want = full[block(full.shape, specs[n], mesh.shape, mesh.coords)]
            diff = (t.float() - want).abs()
            if kind != "params":
                r = diff.max().item() / max(ref["scale"][(kind, n)], 1e-30)
            elif bf16:
                r = (diff / (MB_ATOL + MB_RTOL * want.abs())).max().item()
            else:
                r = diff.max().item()
            if r >= worst.get(kind, (-1.0, ""))[0]:
                worst[kind] = (r, n)
    return worst


def tm_blocks_ok(label, worst, bf16, lr):
    bars = {"grads": MB_GRAD_REL if bf16 else TM_LEAF,
            "params": 1.0 if bf16 else 2 * lr, "m": TM_LEAF, "v": TM_LEAF}
    for kind, (r, n) in worst.items():
        check(r <= bars[kind], f"[trainmesh] {label}: {kind} leaf {n} at {r} "
              f"(bar {bars[kind]})")


def tm_metrics_ok(label, got, want, bf16, moe=False):
    if bf16:
        check(abs(got["loss"] - want["loss"]) <= MB_LOSS_RTOL *
              abs(want["loss"]) and abs(got["grad_norm"] - want["grad_norm"])
              <= MB_NORM_RTOL * want["grad_norm"],
              f"[trainmesh] {label}: {got} against one rank's {want}")
        return
    for k in ("loss", "ce", "lr", "grad_norm") + (() if moe else ("aux",)):
        check(abs(got[k] - want[k]) <= TM_RTOL * abs(want[k]) + 1e-12,
              f"[trainmesh] {label}: {k} {got[k]} against one rank's "
              f"{want[k]} (rtol {TM_RTOL})")


def tm_bytes(model, opt):
    return (sum(p.numel() * p.element_size() for p in model.parameters()),
            sum(t.numel() * t.element_size()
                for t in list(opt.m.values()) + list(opt.v.values())))


def tm_part_a(torch, mesh, refs, ops):
    """Part (a) on this rank: the Trainer, bf16, 3 steps curated every 2;
    then one bf16 step against one rank's."""
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.models import collectives as C
    from repro_torch.runtime.trainer import TrainConfig, Trainer
    from repro_torch.optim.adamw import AdamWConfig
    cfg = tm_config(TM_ARCH, TM_LAYERS, False)
    torch.cuda.reset_peak_memory_stats()
    t = Trainer(cfg, ShapeSpec("tm", TM_SEQ, TM_B, "train"), mesh,
                data=DataConfig(global_batch=TM_B, seq_len=TM_SEQ,
                                select_every=TM_SELECT_EVERY),
                train=TrainConfig(steps=TM_STEPS, log_every=100),
                opt=AdamWConfig(**TM_OPT), select=True, device="cuda")
    seen, step = [], t._step_fn

    def spied(model, opt, batch):
        torch.cuda.synchronize()
        torch.distributed.barrier()
        C.reset_counts()
        t0 = time.perf_counter()
        model, opt, m = step(model, opt, batch)
        torch.cuda.synchronize()
        torch.distributed.barrier()
        seen.append(dict({k: float(v) for k, v in m.items()},
                         ms=(time.perf_counter() - t0) * 1e3,
                         counts=C.counts()))
        return model, opt, m
    t._step_fn = spied
    ops.reset_launch_counts()
    model, opt = t.run()
    launches = {k: v for k, v in read_counts(ops).items() if v}
    peak = torch.cuda.max_memory_allocated()
    p_bytes, m_bytes = tm_bytes(model, opt)
    sel = t.pipeline._last_sel
    out = dict(steps=seen, peak=peak, param_bytes=p_bytes,
               moment_bytes=m_bytes, launches=launches,
               batch_axes=t.policy.batch_axes, seq_shard=t.policy.seq_shard,
               curated=int(sel.sol_size), ids=sel.sol_ids.cpu(),
               pool=t.pipeline.pool)
    pipeline = t.pipeline
    del model, opt, t
    torch.cuda.empty_cache()
    model = tm_model(torch, cfg, torch.bfloat16, pipeline.policy)
    metrics, state, ms, counts = tm_step(torch, cfg, TM_B, TM_SEQ, model,
                                         mesh)
    specs = {n: p.spec for n, p in model.params.named_parameters()}
    ref = refs["(a) bf16"]
    worst = tm_compare(torch, ref, "(a) bf16", state, specs, mesh, bf16=True)
    out["bf16"] = dict(metrics=metrics, ref=ref["metrics"], worst=worst,
                       ms=ms, ref_ms=ref["ms"])
    del model, state
    torch.cuda.empty_cache()
    return out, pipeline


def tm_part_ad(torch, mesh, remesh, refs, out_dir):
    """Parts (a) f32 and (d) on this rank: step 1 against one rank's, a
    save, step 2; step 2 again after a restore on the same mesh (bit for
    bit) and after ``elastic_remesh`` to ``remesh`` (within the bars)."""
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.models import collectives as C
    from repro_torch.models.sharding import place
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.optim.adamw import init as adamw_init
    from repro_torch.runtime.trainer import TrainConfig, Trainer, \
        elastic_remesh
    cfg = tm_config(TM_ARCH, TM_LAYERS, False)
    ck = Path(out_dir) / "ck"

    def f32(t):
        # the Trainer's state in f32: its fresh state and a restore's
        # template alike come from init_state
        def init_state():
            model = tm_model(torch, cfg, torch.float32, t.policy)
            model.requires_grad_(True)
            return model, adamw_init(dict(model.params.named_parameters())), 0
        t.init_state = init_state
        return t

    def trainer(where, on):
        return f32(Trainer(cfg, ShapeSpec("tm", TM_SEQ, TM_B, "train"), on,
                           data=DataConfig(seed=14, global_batch=TM_B,
                                           seq_len=TM_SEQ),
                           train=TrainConfig(steps=2, ckpt_dir=str(where),
                                             ckpt_async=False,
                                             log_every=100),
                           opt=AdamWConfig(**TM_OPT), device="cuda"))

    def step(t, model, opt, s):
        grads = {}
        torch.cuda.synchronize()
        torch.distributed.barrier()
        C.reset_counts()
        with SpyUpdate(grads.update):
            t0 = time.perf_counter()
            model, opt, m = t._step_fn(model, opt, t.pipeline.batch_at(s))
            torch.cuda.synchronize()
            torch.distributed.barrier()
        ms = (time.perf_counter() - t0) * 1e3
        return {k: float(v) for k, v in m.items()}, grads, ms, C.counts()

    t = trainer(ck / "a", mesh)
    model, opt, _ = t.init_state()
    specs = {n: p.spec for n, p in model.params.named_parameters()}
    m1, grads, ms1, counts1 = step(t, model, opt, 0)
    state = {"grads": grads, "params": {n: p.detach() for n, p in
                                        model.params.named_parameters()},
             "m": opt.m, "v": opt.v}
    ref = refs["(a) f32"]
    worst = tm_compare(torch, ref, "(a) f32", state, specs, mesh)
    del grads, state
    p_bytes, m_bytes = tm_bytes(model, opt)
    t0 = time.perf_counter()
    t.save(model, opt, 1, blocking=True)
    torch.distributed.barrier()
    save_s = time.perf_counter() - t0
    m2, _, ms2, counts2 = step(t, model, opt, 1)
    straight = {n: p.detach().clone() for n, p in
                model.params.named_parameters()}
    straight_m = {n: v.clone() for n, v in opt.m.items()}
    del model, opt
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    tr = trainer(ck / "a", mesh)
    model, opt, cursor = tr.restore_or_init()
    restore_s = time.perf_counter() - t0
    check(cursor == 1, f"[trainmesh] (d) restored cursor {cursor}")
    mr, _, _, _ = step(tr, model, opt, 1)
    differ = [n for n, p in model.params.named_parameters()
              if not torch.equal(p.detach(), straight[n])]
    differ += [f"m/{n}" for n, v in opt.m.items()
               if not torch.equal(v, straight_m[n])]
    del model, opt
    torch.cuda.empty_cache()
    # the same checkpoint: the resumed runs write none
    t14 = f32(elastic_remesh(trainer(ck / "a", mesh), remesh))
    model, opt, cursor14 = t14.restore_or_init()
    check(cursor14 == 1, f"[trainmesh] (d) re-meshed cursor {cursor14}")
    m14, _, _, _ = step(t14, model, opt, 1)
    # the straight run's leaves, gathered whole, cut to the (1, 4) blocks
    from repro_torch.models import collectives as coll
    lr = m2["lr"]
    p_worst = m_worst = 0.0
    for n, p in model.params.named_parameters():
        whole = coll.reshard(straight[n], mesh, specs[n], ())
        want = place(whole, p.spec, remesh)
        p_worst = max(p_worst, (p.detach() - want).abs().max().item())
        whole = coll.reshard(straight_m[n], mesh, specs[n], ())
        want = place(whole, p.spec, remesh)
        m_worst = max(m_worst, (opt.m[n] - want).abs().max().item() /
                      max(whole.abs().max().item(), 1e-30))
        del whole, want
    out = dict(metrics=m1, ref=ref["metrics"], worst=worst, ms=[ms1, ms2],
               ref_ms=ref["ms"], counts=counts1, param_bytes=p_bytes,
               moment_bytes=m_bytes, save_s=save_s, restore_s=restore_s,
               m2=m2, resumed=mr, differ=differ, remeshed=m14,
               remesh_p=p_worst, remesh_m=m_worst, lr2=lr,
               remesh_shape=dict(remesh.shape))
    del model, opt, straight, straight_m
    torch.cuda.empty_cache()
    return out


def tm_part_bc(torch, label, mesh):
    """Parts (b) and (c) on this rank: one step on ``mesh`` against one
    rank's."""
    name, layers, dt, raised, B, S, _ = TM_REFS[label]
    cfg = tm_config(name, layers, raised)
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch.steps import train_step_bundle
    policy = train_step_bundle(cfg, ShapeSpec("tm", S, B, "train"),
                               mesh).policy
    torch.cuda.reset_peak_memory_stats()
    model = tm_model(torch, cfg, getattr(torch, dt), policy)
    metrics, state, ms, counts = tm_step(torch, cfg, B, S, model, mesh)
    peak = torch.cuda.max_memory_allocated()
    return cfg, model, metrics, state, ms, counts, peak, policy


def tm_part_e(torch, ops, pipeline):
    """Part (e) on this rank: (a)'s step-0 curation pool through the
    selector on the training mesh with use_kernel=True, dense and fused
    engines, against the plain route's ids."""
    import dataclasses
    from repro_torch.core.selector import DistributedSelector
    from repro_torch.data.pipeline import doc_embeddings, step_generator
    d = pipeline.base.data
    pools = [pipeline.base.batch_at(i + 10_000) for i in range(d.pool_factor)]
    cat = {k: torch.cat([p[k] for p in pools]) for k in pools[0]}
    emb = doc_embeddings(cat, pipeline.emb_dim)

    def select(sel):
        return sel.select(sel.data_sharding(emb), sel.opt_upper_bound(emb),
                          generator=step_generator(d.seed + 77, 0, "cuda"))
    plain = pipeline.selector
    want = select(plain).sol_ids.cpu()
    out = dict(want=want, tp=plain.tp)
    for engine in ("dense", "fused"):
        spec = dataclasses.replace(plain.spec, use_kernel=True, engine=engine)
        sel = DistributedSelector(spec, n_total=pipeline.pool,
                                  feat_dim=pipeline.emb_dim, device="cuda",
                                  mesh=pipeline.policy.mesh,
                                  axes=("pod", "data"))
        ops.reset_launch_counts()
        got = select(sel).sol_ids.cpu()
        torch.cuda.synchronize()
        out[engine] = (got, {k: v for k, v in read_counts(ops).items()
                             if v and "@" not in k})
    return out


def tm_rank(rank, world, store, out_dir, refs):
    """A rank of phase 14's spawned job: joins the gloo job on the one card
    and runs parts (a)-(e), writing its findings to ``out_dir``."""
    import datetime
    import pickle
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    import torch.distributed as dist
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_mesh_for
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group(
        "gloo", init_method=f"file://{store}", rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=TM_GROUP_TIMEOUT_S))
    mesh22 = make_mesh_for(world, model_parallel=2)
    mesh14 = make_mesh_for(world, model_parallel=4)
    res, seconds = {}, {}
    # whether gloo sums bf16 CUDA tensors in reduce_scatter_tensor (the
    # weights' gradients are summed in f32 whatever the answer)
    x = torch.full((4, 8), rank + 1.0, dtype=torch.bfloat16, device="cuda")
    y = torch.empty((2, 8), dtype=torch.bfloat16, device="cuda")
    try:
        dist.reduce_scatter_tensor(y, x, group=mesh22.group(("model",)))
        res["bf16_reduce_scatter"] = f"supported, sum {y[0, 0].item()}"
    except Exception as e:      # noqa: BLE001  (the probe's answer)
        res["bf16_reduce_scatter"] = f"{type(e).__name__}: {e}"[:200]
    t0 = time.perf_counter()
    res["(a)"], pipeline = tm_part_a(torch, mesh22, refs, ops)
    seconds["(a) bf16"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    res["(a) f32 + (d)"] = tm_part_ad(torch, mesh22, mesh14, refs, out_dir)
    seconds["(a) f32 + (d)"] = time.perf_counter() - t0
    for label, mesh in (("(b)", mesh22), ("(c)", mesh14)):
        t0 = time.perf_counter()
        cfg, model, metrics, state, ms, counts, peak, pol = tm_part_bc(
            torch, label, mesh)
        specs = {n: p.spec for n, p in model.params.named_parameters()}
        ref = refs[label]
        worst = tm_compare(torch, ref, label, state, specs, mesh)
        p_bytes = sum(p.numel() * p.element_size()
                      for p in model.parameters())
        res[label] = dict(metrics=metrics, ref=ref["metrics"], worst=worst,
                          ms=ms, ref_ms=ref["ms"], counts=counts, peak=peak,
                          param_bytes=p_bytes, batch_axes=pol.batch_axes,
                          seq_shard=pol.seq_shard)
        del model, state
        torch.cuda.empty_cache()
        seconds[label] = time.perf_counter() - t0
    t0 = time.perf_counter()
    res["(e)"] = tm_part_e(torch, ops, pipeline)
    seconds["(e)"] = time.perf_counter() - t0
    res["seconds"] = seconds
    res["coords"] = dict(mesh22.coords)
    # release the references' CUDA IPC handles before the process ends, so
    # the parent may free them
    refs.clear()
    dist.destroy_process_group()
    with open(Path(out_dir) / f"rank{rank}.pkl", "wb") as f:
        pickle.dump(res, f)


def tm_kinds(counts):
    return {f"{k[0]} {'/'.join(k[1])}": v for k, v in sorted(counts.items())}


def tm_mb(counts):
    """Collective MB (operand bytes / 1e6) a step by kind."""
    out = {}
    for (kind, _), (_, b) in counts.items():
        out[kind] = out.get(kind, 0.0) + b / 1e6
    return {k: round(v, 3) for k, v in sorted(out.items())}


def tm_report(torch, res, card):
    """Hold every rank to the bars and print what the parts measured."""
    r0 = res[0]

    def metrics(x):
        return [s for s in x["(a)"]["steps"]] + [
            x[k]["metrics"] for k in ("(a) f32 + (d)", "(b)", "(c)")] + [
            x["(a)"]["bf16"]["metrics"]]
    for r, x in enumerate(res):
        for got, want in zip(metrics(x), metrics(r0)):
            check(got["loss"] == want["loss"] and
                  got["grad_norm"] == want["grad_norm"],
                  f"[trainmesh] rank {r}'s loss {got} is not rank 0's {want}")
    a = r0["(a)"]
    check(a["batch_axes"] == ("data", "model") and a["seq_shard"] is None,
          f"[trainmesh] (a) batch axes {a['batch_axes']}")
    check(len(a["steps"]) == TM_STEPS and a["curated"] == TM_B,
          f"[trainmesh] (a) {len(a['steps'])} steps, curated {a['curated']}")
    for r, x in enumerate(res):
        check(torch.equal(x["(a)"]["ids"], a["ids"]),
              f"[trainmesh] (a) rank {r} curated {x['(a)']['ids'].tolist()}")
        # the LM stack reaches no pallas_call in the JAX package; the
        # curation's selector runs the plain route, as the JAX package's
        check(not x["(a)"]["launches"],
              f"[trainmesh] (a) rank {r} launched {x['(a)']['launches']}")
    for i, s in enumerate(a["steps"]):
        check(all(map(math.isfinite, (s["loss"], s["grad_norm"]))),
              f"[trainmesh] (a) step {i}: {s}")
        print(f"[trainmesh] (a) {TM_ARCH} at full width, {TM_LAYERS} layers, "
              f"mesh (data, model) = (2, 2), ZeRO-3, bf16, batch {TM_B} x "
              f"{TM_SEQ} (train_4k's 256 cut to {TM_B}), curated every "
              f"{TM_SELECT_EVERY}: step {i} {s['ms']:.1f} ms, "
              f"{TM_B * TM_SEQ / s['ms'] * 1e3:.0f} tokens/s, loss "
              f"{s['loss']:.6f}, grad_norm {s['grad_norm']:.6f}; collective "
              f"MB by kind (rank 0) {tm_mb(s['counts'])}; card: {card}")
    print(f"[trainmesh] (a) step 1's collectives (calls, operand bytes), "
          f"rank 0: {tm_kinds(a['steps'][1]['counts'])}; card: {card}")
    state_bytes = [(x["(a)"]["param_bytes"], x["(a)"]["moment_bytes"])
                   for x in res]
    print(f"[trainmesh] (a) peak GiB by rank "
          f"{[round(x['(a)']['peak'] / 2 ** 30, 3) for x in res]}; parameter "
          f"+ moment bytes by rank {state_bytes}; curated {a['curated']} of "
          f"{a['pool']} ids {a['ids'].tolist()} on every rank; card: {card}")
    b = a["bf16"]
    tm_metrics_ok("(a) bf16", b["metrics"], b["ref"], True)
    for r, x in enumerate(res):
        tm_blocks_ok(f"(a) bf16 rank {r}", x["(a)"]["bf16"]["worst"], True,
                     b["metrics"]["lr"])
    print(f"[trainmesh] (a) bf16 step against one rank's (same weights and "
          f"batch, same card): loss {b['metrics']['loss']:.6f} / "
          f"{b['ref']['loss']:.6f} (rtol {MB_LOSS_RTOL}), grad_norm "
          f"{b['metrics']['grad_norm']:.6f} / {b['ref']['grad_norm']:.6f} "
          f"(rtol {MB_NORM_RTOL}); worst leaves by rank "
          f"{[x['(a)']['bf16']['worst'] for x in res]} (gradients' bar "
          f"{MB_GRAD_REL} of the max, parameters' atol {MB_ATOL} + rtol "
          f"{MB_RTOL}); {b['ms']:.1f} ms (one rank {b['ref_ms']:.1f}); "
          f"card: {card}")
    f = r0["(a) f32 + (d)"]
    tm_metrics_ok("(a) f32", f["metrics"], f["ref"], False)
    for r, x in enumerate(res):
        tm_blocks_ok(f"(a) f32 rank {r}", x["(a) f32 + (d)"]["worst"], False,
                     f["metrics"]["lr"])
    print(f"[trainmesh] (a) f32 step against one rank's: metrics "
          f"{f['metrics']} / {f['ref']} (rtol {TM_RTOL}); worst leaves by "
          f"rank {[x['(a) f32 + (d)']['worst'] for x in res]} (gradients "
          f"and moments' bar {TM_LEAF} of the leaf's max; parameters' max "
          f"|diff| bar 2 lr = {2 * f['metrics']['lr']:.3e}); steps "
          f"{f['ms']} ms (one rank {f['ref_ms']:.1f}); collectives of step "
          f"1 (calls, operand "
          f"bytes), rank 0: {tm_kinds(f['counts'])}; parameter + moment "
          f"bytes a rank {f['param_bytes']} + {f['moment_bytes']}; card: "
          f"{card}")
    check(not f["differ"], f"[trainmesh] (d) resumed on (2, 2): "
          f"{f['differ']} differ from the straight run")
    check(f["resumed"] == f["m2"], f"[trainmesh] (d) resumed metrics "
          f"{f['resumed']}, straight {f['m2']}")
    tm_metrics_ok("(d) re-meshed", f["remeshed"], f["m2"], False)
    check(f["remesh_p"] <= 2 * f["lr2"] and f["remesh_m"] <= TM_LEAF,
          f"[trainmesh] (d) re-meshed parameters {f['remesh_p']} (bar "
          f"{2 * f['lr2']}), moments {f['remesh_m']} (bar {TM_LEAF})")
    print(f"[trainmesh] (d) saved after step 1 in {f['save_s']:.3f} s "
          f"(every rank's blocks gathered to rank 0, which writes the whole "
          f"leaves), restored in {f['restore_s']:.3f} s (rank 0 reads, "
          f"scatters the blocks): step 2 resumed on (2, 2) bit-equal to "
          f"the straight run (every parameter and m), metrics {f['resumed']};"
          f" re-meshed to {f['remesh_shape']}: metrics {f['remeshed']} "
          f"(straight {f['m2']}, rtol {TM_RTOL}), parameters within "
          f"{f['remesh_p']:.3e} (bar 2 lr = {2 * f['lr2']:.3e}), m within "
          f"{f['remesh_m']:.3e} of its max (bar {TM_LEAF}); card: {card}")
    for label, want in (("(b)", (("data",), "model")),
                        ("(c)", (("data", "model"), None))):
        x = r0[label]
        check((x["batch_axes"], x["seq_shard"]) == want,
              f"[trainmesh] {label}: batch axes {x['batch_axes']}, seq_shard "
              f"{x['seq_shard']}")
        tm_metrics_ok(label, x["metrics"], x["ref"], False,
                      moe=label == "(c)")
        for r, y in enumerate(res):
            tm_blocks_ok(f"{label} rank {r}", y[label]["worst"], False,
                         x["metrics"]["lr"])
        name, layers, dt, _, B, S, _ = TM_REFS[label]
        shape = "(2, 2)" if label == "(b)" else "(1, 4)"
        print(f"[trainmesh] {label} {name} at full width, {layers} layers, "
              f"{dt}, batch {B} x {S}, mesh {shape}, batch axes "
              f"{x['batch_axes']}, seq_shard {x['seq_shard']}: "
              f"{x['ms']:.1f} ms (one rank {x['ref_ms']:.1f}), "
              f"{B * S / x['ms'] * 1e3:.0f} tokens/s; metrics {x['metrics']} "
              f"/ {x['ref']} (rtol {TM_RTOL}); worst leaves by rank "
              f"{[y[label]['worst'] for y in res]}; collectives (calls, "
              f"operand bytes), rank 0: {tm_kinds(x['counts'])}; MB by kind "
              f"{tm_mb(x['counts'])}; parameter bytes by rank "
              f"{[y[label]['param_bytes'] for y in res]}; peak GiB by rank "
              f"{[round(y[label]['peak'] / 2 ** 30, 3) for y in res]}; card: "
              f"{card}")
    c = r0["(c)"]["counts"]
    check(c.get(("all_to_all", ("model",)), (0, 0))[0] ==
          6 * TM_MOE_LAYERS,
          f"[trainmesh] (c) all_to_all calls {c}: the dispatch and return "
          f"a layer in forward, remat and backward")
    for r, x in enumerate(res):
        e = x["(e)"]
        for engine in ("dense", "fused"):
            got, launches = e[engine]
            check(torch.equal(got, e["want"]) and
                  torch.equal(got, r0["(e)"]["want"]),
                  f"[trainmesh] (e) rank {r} {engine}: ids {got.tolist()}, "
                  f"plain {e['want'].tolist()}")
            # the tensor-parallel oracle's fused engine scans a chunk's
            # rows with one all_reduce a row (TPOracle.chunk_accept), not
            # the coverage_accept sweep
            need = ("coverage_marginals",) + (
                ("coverage_accept",) if engine == "fused" and not e["tp"]
                else ())
            check(all(launches.get(k, 0) > 0 for k in need),
                  f"[trainmesh] (e) rank {r} {engine}: launches {launches}")
    print(f"[trainmesh] (e) (a)'s step-0 pool on the training mesh (2 "
          f"machines over \"data\", the features over \"model\": tensor-"
          f"parallel oracle {r0['(e)']['tp']}), kernel route: ids "
          f"{r0['(e)']['want'].tolist()} = the plain route's on every rank; "
          f"launches by rank and engine "
          f"{[{e: x['(e)'][e][1] for e in ('dense', 'fused')} for x in res]}"
          f"; card: {card}")
    print(f"[trainmesh] gloo reduce_scatter_tensor of bf16 CUDA tensors "
          f"over \"model\": {r0['bf16_reduce_scatter']}; card: {card}")
    print(f"[trainmesh] seconds by part, rank 0: "
          f"{ {k: round(v, 3) for k, v in r0['seconds'].items()} }; card: "
          f"{card}")


def tm_spawn(world, out_dir, refs):
    import torch.multiprocessing as mp
    import pickle
    store = Path(out_dir) / "store"
    ctx = mp.start_processes(tm_rank,
                             args=(world, str(store), out_dir, refs),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + TM_JOB_TIMEOUT_S
    try:
        while not ctx.join(timeout=5):
            check(time.monotonic() < deadline,
                  f"[trainmesh] the {world}-rank job outlived "
                  f"{TM_JOB_TIMEOUT_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join()
    out = []
    for r in range(world):
        with open(Path(out_dir) / f"rank{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out


def train_mesh_phase(torch):
    """Phase 14: the dense and moe families trained on a (data, model) mesh
    of four gloo ranks sharing the one card (ZeRO-3), against the one-rank
    step of the same seeded weights and batch on the same card: (a)
    qwen3-1.7b on (2, 2), the Trainer in bf16 with curation, one bf16 and
    one f32 step against one rank's; (b) B = 2 (seq_shard); (c)
    qwen2-moe-a2.7b on (1, 4) (the all-to-all dispatch); (d) save, resume
    on (2, 2) and re-mesh to (1, 4); (e) the curation's kernel route on the
    training mesh."""
    import tempfile
    card = smi()
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        refs = {label: tm_reference(torch, label) for label in TM_REFS}
        print(f"[trainmesh] the one-rank references took "
              f"{time.perf_counter() - t0:.3f} s; they hold "
              f"{torch.cuda.memory_allocated() / 2 ** 30:.3f} GiB on the "
              f"card for the ranks "
              f"({torch.cuda.memory_reserved() / 2 ** 30:.3f} GiB "
              f"reserved); card: {card}")
        t0 = time.perf_counter()
        res = tm_spawn(4, tmp, refs)
        del refs
        torch.cuda.ipc_collect()
        torch.cuda.empty_cache()
        print(f"[trainmesh] the 4-rank job took {time.perf_counter() - t0:.3f}"
              f" s; card: {card}")
        tm_report(torch, res, card)
    print(f"[trainmesh] phase 14 took {time.perf_counter() - t_phase:.3f} s; "
          f"card: {card}")


# ---------------------------------------------------------------------------
# phase 15: the ssm and hybrid families on a (data, model) mesh of gloo
# ranks sharing the one card: the Mamba1 / Mamba2 blocks split over d_inner
# (TP) or gathered whole (ZeRO-3), the hybrid's shared block on the mesh,
# the Mamba caches handed to the decode layout, and a train step under the
# tensor-parallel policy falcon-mamba-7b uses
# ---------------------------------------------------------------------------

SM_GROUP_TIMEOUT_S = 600
SM_JOB_TIMEOUT_S = 600
SM_FALCON, SM_FALCON_LAYERS = "falcon-mamba-7b", 2   # 64 layers cut to 2
SM_ZAMBA, SM_ZAMBA_LAYERS = "zamba2-2.7b", 6   # 9 groups cut to 1: 6 Mamba2
#                                                layers and the shared block
SM_TOL = 1e-4                   # the f32 bar of phases 13 and 14
#: serving part -> (architecture, layers, compute dtype name, B, prompt,
#: decode steps, seed)
SM_SERVE = {
    "(a) bf16": (SM_FALCON, SM_FALCON_LAYERS, "bfloat16", 4, 64, 8, 150),
    "(a) f32": (SM_FALCON, SM_FALCON_LAYERS, "float32", 4, 64, 8, 150),
    "(b)": (SM_ZAMBA, SM_ZAMBA_LAYERS, "float32", 4, HYBRID_PROMPT, 8, 151),
    "(b) long": (SM_ZAMBA, SM_ZAMBA_LAYERS, "float32", 1, LMM_LONG, 0, 151),
}
#: train part -> (architecture, layers, batch, sequence, leaves compared):
#: falcon-mamba's 8 micro-batches of 2 rows (one a data rank), TP; zamba2
#: under ZeRO-3
SM_TRAIN = {
    "(a) train": (SM_FALCON, SM_FALCON_LAYERS, 16, 256, ("grads", "m")),
    "(b) train": (SM_ZAMBA, SM_ZAMBA_LAYERS, 4, 1024, ("grads", "m")),
}
#: what each serving part's prefill and decode policies must be
SM_BRANCHES = {
    "(a) bf16": dict(batch_axes=("data",), seq_shard=None,
                     dec_batch_axes=("data",)),
    "(a) f32": dict(batch_axes=("data",), seq_shard=None,
                    dec_batch_axes=("data",)),
    "(b)": dict(batch_axes=("data", "model"), seq_shard=None,
                dec_batch_axes=("data",)),
    "(b) long": dict(batch_axes=(), seq_shard="model"),
}


def sm_config(name, layers):
    import dataclasses
    from repro_torch.configs.base import get_config
    return dataclasses.replace(get_config(name), n_layers=layers)


def sm_serve_reference(torch, steps, label, out_dir):
    """A serving part's one-rank run on the card: writes the prompts, the
    greedy ids and every step's whole logits to ``out_dir``."""
    import pickle
    from repro_torch.models.model import build_model
    name, layers, dt, B, prompt, dec, seed = SM_SERVE[label]
    cfg = sm_config(name, layers)
    model = build_model(cfg, torch.Generator(device="cuda").manual_seed(seed),
                        "cuda", getattr(torch, dt))
    toks = lmm_tokens(torch, cfg, B, prompt, seed + 1000)
    torch.cuda.reset_peak_memory_stats()
    ids, logits, t_pre, t_dec, _, _ = lmm_serve(
        torch, steps, model, cfg, None, B, prompt, dec + 1, toks, None)
    peak = torch.cuda.max_memory_allocated()
    with open(Path(out_dir) / f"sm{label}.pkl", "wb") as f:
        pickle.dump(dict(tokens=toks.cpu(), ids=ids, logits=logits,
                         t_pre=t_pre, t_dec=t_dec), f)
    print(f"[ssmmesh] {label} one rank: {cfg.name}, {layers} layers, {dt}, "
          f"B={B} prompt={prompt}, {dec} decode steps: prefill "
          f"{t_pre:.3f} ms, decode {[round(t, 3) for t in t_dec]} ms; peak "
          f"{peak / 2 ** 30:.3f} GiB")
    del model
    torch.cuda.empty_cache()


def sm_train_reference(torch, label):
    """A train part's one-rank step on the card (``tm_reference``'s): the
    metrics, the kept leaves left on the card for the ranks (CUDA IPC) and
    their max |.|."""
    name, layers, B, S, kinds = SM_TRAIN[label]
    cfg = sm_config(name, layers)
    model = tm_model(torch, cfg, torch.float32)
    kept = {kind: {n: torch.empty(p.shape, dtype=torch.float32,
                                  device="cuda")
                   for n, p in model.params.named_parameters()}
            for kind in kinds}
    torch.cuda.reset_peak_memory_stats()
    metrics, state, ms, _ = tm_step(torch, cfg, B, S, model)
    peak = torch.cuda.max_memory_allocated()
    for kind, leaves in kept.items():
        for n, t in leaves.items():
            t.copy_(state[kind][n])
    del model, state
    torch.cuda.empty_cache()
    scale = {(kind, n): t.abs().max().item()
             for kind, leaves in kept.items() for n, t in leaves.items()}
    print(f"[ssmmesh] {label} one rank: {cfg.name}, {layers} layers, f32, "
          f"batch {B} x {S} in {cfg.microbatches} micro-batches: {ms:.1f} "
          f"ms, loss {metrics['loss']:.6f}, grad_norm "
          f"{metrics['grad_norm']:.6f}; peak {peak / 2 ** 30:.3f} GiB")
    return dict(metrics=metrics, scale=scale, ms=ms, leaves=kept)


def sm_build(torch, cfg, dtype, policy, seed, rank, world):
    """This rank's model placed by ``policy``: the ranks draw their blocks
    one after another (a rank holds a whole sublayer while it draws)."""
    import torch.distributed as dist
    from repro_torch.models.model import build_model
    model = None
    for r in range(world):
        if r == rank:
            model = build_model(
                cfg, torch.Generator(device="cuda").manual_seed(seed),
                "cuda", dtype, policy=policy)
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
        dist.barrier()
    return model


def sm_rank(rank, world, store, out_dir, refs):
    """A rank of phase 15's spawned job: serves and trains every part on
    the (2, 2) mesh against the one-rank runs; writes its findings to
    ``out_dir``."""
    import datetime
    import pickle
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    import torch.distributed as dist
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.kernels import ops
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_mesh_for
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group(
        "gloo", init_method=f"file://{store}", rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=SM_GROUP_TIMEOUT_S))
    mesh = make_mesh_for(world, model_parallel=2)
    res = {}
    for label, (name, layers, dt, B, prompt, dec, seed) in SM_SERVE.items():
        t_part = time.perf_counter()
        cfg = sm_config(name, layers)
        dtype = getattr(torch, dt)
        with open(Path(out_dir) / f"sm{label}.pkl", "rb") as f:
            ref = pickle.load(f)
        gen = dec + 1
        dpol = steps.decode_step_bundle(
            cfg, ShapeSpec("sm", prompt + gen, B, "decode"), mesh).policy
        model = sm_build(torch, cfg, dtype, dpol, seed, rank, world)
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        ids, logits, t_pre, t_dec, counts, pol = lmm_serve(
            torch, steps, model, cfg, mesh, B, prompt, gen,
            ref["tokens"].cuda(), ref["ids"].cuda() if dec else None)
        launches = {k: v for k, v in read_counts(ops).items() if v}
        tol = SM_TOL if dtype == torch.float32 else LM_TOL
        spec = pol.logits_spec((B, 1, cfg.padded_vocab))
        dspec = dpol.logits_spec((B, 1, cfg.padded_vocab))
        ex0, w0 = lmm_compare(logits[:1], ref["logits"][:1], spec, mesh, tol)
        ex1, w1 = lmm_compare(logits[1:], ref["logits"][1:], dspec, mesh,
                              tol)
        ref_top = torch.stack([w[:, -1, :cfg.vocab_size].topk(2, -1).values
                               for w in ref["logits"]], 1)
        wide = (ref_top[..., 0] - ref_top[..., 1]) > tol
        same = ids == ref["ids"]
        res[label] = dict(
            ids=ids, ref_ids=ref["ids"], excess=max(ex0, ex1),
            worst=max(w0, w1), tol=tol,
            agree=(int(same.sum()), same.numel(), int((same & wide).sum()),
                   int(wide.sum())),
            t_pre=t_pre, t_dec=t_dec, ref_pre=ref["t_pre"],
            ref_dec=ref["t_dec"], counts=counts, launches=launches,
            peak=torch.cuda.max_memory_allocated(),
            param_bytes=sum(p.numel() * p.element_size()
                            for p in model.params.parameters()),
            batch_axes=pol.batch_axes, seq_shard=pol.seq_shard,
            dec_batch_axes=dpol.batch_axes,
            specs={n: p.spec for n, p in model.params.named_parameters()},
            seconds=time.perf_counter() - t_part)
        del model, logits
        torch.cuda.empty_cache()
        dist.barrier()
    for label, (name, layers, B, S, kinds) in SM_TRAIN.items():
        t_part = time.perf_counter()
        cfg = sm_config(name, layers)
        policy = steps.train_step_bundle(
            cfg, ShapeSpec("sm", S, B, "train"), mesh).policy
        model = sm_build(torch, cfg, torch.float32, policy, 0, rank, world)
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        metrics, state, ms, counts = tm_step(torch, cfg, B, S, model, mesh)
        launches = {k: v for k, v in read_counts(ops).items() if v}
        specs = {n: p.spec for n, p in model.params.named_parameters()}
        ref = refs[label]
        worst = tm_compare(torch, ref, label, state, specs, mesh,
                           kinds=kinds)
        res[label] = dict(
            metrics=metrics, ref=ref["metrics"], worst=worst, ms=ms,
            ref_ms=ref["ms"], counts=counts, launches=launches,
            peak=torch.cuda.max_memory_allocated(),
            param_bytes=sum(p.numel() * p.element_size()
                            for p in model.params.parameters()),
            batch_axes=policy.batch_axes, seq_shard=policy.seq_shard,
            pure_fsdp=policy.pure_fsdp,
            seconds=time.perf_counter() - t_part)
        del model, state
        torch.cuda.empty_cache()
        dist.barrier()
    refs.clear()
    dist.destroy_process_group()
    with open(Path(out_dir) / f"rank{rank}.pkl", "wb") as f:
        pickle.dump(res, f)


def sm_spawn(world, out_dir, refs):
    import pickle
    import torch.multiprocessing as mp
    store = Path(out_dir) / "store"
    ctx = mp.start_processes(sm_rank, args=(world, str(store), out_dir, refs),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + SM_JOB_TIMEOUT_S
    try:
        while not ctx.join(timeout=5):
            check(time.monotonic() < deadline,
                  f"[ssmmesh] the {world}-rank job outlived "
                  f"{SM_JOB_TIMEOUT_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join()
    out = []
    for r in range(world):
        with open(Path(out_dir) / f"rank{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out


def sm_split(specs, version):
    """The SSM leaves the rule table splits over "model", as placed: each
    must name the axis (``_fit`` kept it at full width)."""
    leaves = ("in_proj", "conv_w", "out_proj", "dt_bias", "D_skip") + (
        ("x_proj", "dt_proj", "A_log") if version == 1 else ())
    return {n: s for n, s in specs.items()
            if n.split(".")[-1] in leaves and ".ssm." in n and
            "model" not in s}


def sm_report(torch, res, card):
    """Hold every rank to the bars and print what the parts measured."""
    from repro_torch.configs.base import get_config
    r0 = res[0]
    for label, (name, layers, dt, B, prompt, dec, _) in SM_SERVE.items():
        x0 = r0[label]
        for r, rr in enumerate(res):
            x = rr[label]
            check(bool((x["ids"] == x0["ids"]).all()),
                  f"[ssmmesh] {label}: rank {r}'s ids {x['ids'].tolist()} "
                  f"are not rank 0's {x0['ids'].tolist()}")
            check(x["excess"] <= x["tol"],
                  f"[ssmmesh] {label}: rank {r}'s logits differ from the "
                  f"one-rank run's by {x['excess']} beyond rtol = atol "
                  f"{x['tol']} (max |diff| {x['worst']})")
            check(not x["launches"],
                  f"[ssmmesh] {label}: rank {r} launched {x['launches']}")
        for key, val in SM_BRANCHES[label].items():
            check(x0[key] == val, f"[ssmmesh] {label}: {key} {x0[key]}, "
                  f"the branch wants {val}")
        bad = sm_split(x0["specs"], get_config(name).ssm_version)
        check(not bad, f"[ssmmesh] {label}: leaves not split over the model "
              f"axis: {bad}")
        agree, rows, kept_agree, kept = x0["agree"]
        check(agree == rows if dt == "float32" else
              kept_agree >= LM_ARGMAX * kept,
              f"[ssmmesh] {label}: greedy ids {x0['ids'].tolist()} against "
              f"the one-rank run's {x0['ref_ids'].tolist()}")
        kinds = {s: tm_kinds(c) for s, c in (
            ("prefill", x0["counts"][0]),
            ("decode step", x0["counts"][1] if dec else {}))}
        print(f"[ssmmesh] {label} {name} at full width, {layers} layers, "
              f"{dt}, mesh (data, model) = (2, 2), B={B} prompt={prompt}, "
              f"{dec} decode steps: prefill batch axes {x0['batch_axes']} "
              f"seq_shard {x0['seq_shard']}; max |logit diff| to one rank "
              f"{max(x[label]['worst'] for x in res)} (bar rtol = atol "
              f"{x0['tol']}), argmax = one rank's in {agree}/{rows}, "
              f"{kept_agree}/{kept} where the top-2 gap exceeds the bar "
              f"(every rank's ids the same); card: {card}")
        print(f"[ssmmesh] {label} prefill ms by rank "
              f"{[round(x[label]['t_pre'], 3) for x in res]} (one rank "
              f"{x0['ref_pre']:.3f}); decode ms a step (rank 0) "
              f"{[round(t, 3) for t in x0['t_dec']]} (one rank "
              f"{[round(t, 3) for t in x0['ref_dec']]}); parameter bytes by "
              f"rank {[x[label]['param_bytes'] for x in res]}; peak GiB by "
              f"rank {[round(x[label]['peak'] / 2 ** 30, 3) for x in res]}; "
              f"collectives (calls, operand bytes) by kind, rank 0: {kinds}; "
              f"MB prefill {tm_mb(x0['counts'][0])}, a decode step "
              f"{tm_mb(x0['counts'][1]) if dec else {}}; took "
              f"{x0['seconds']:.3f} s; card: {card}")
    for label, (name, layers, B, S, _) in SM_TRAIN.items():
        x0 = r0[label]
        for r, rr in enumerate(res):
            x = rr[label]
            check(x["metrics"]["loss"] == x0["metrics"]["loss"] and
                  x["metrics"]["grad_norm"] == x0["metrics"]["grad_norm"],
                  f"[ssmmesh] {label}: rank {r}'s metrics {x['metrics']} are "
                  f"not rank 0's {x0['metrics']}")
            tm_blocks_ok(f"{label} rank {r}", x["worst"], False,
                         x0["metrics"]["lr"])
            check(not x["launches"],
                  f"[ssmmesh] {label}: rank {r} launched {x['launches']}")
        tm_metrics_ok(label, x0["metrics"], x0["ref"], False)
        tp = label == "(a) train"
        check(x0["pure_fsdp"] != tp and x0["batch_axes"] ==
              (("data",) if tp else ("data", "model")),
              f"[ssmmesh] {label}: pure_fsdp {x0['pure_fsdp']}, batch axes "
              f"{x0['batch_axes']}")
        check(not tp or x0["counts"].get(("replicate", ("model",)),
                                         (0, 0))[0] > 0,
              f"[ssmmesh] {label}: no replicate over the model axis "
              f"{x0['counts']}")
        cfg = get_config(name)
        print(f"[ssmmesh] {label} {name} at full width, {layers} layers, f32, "
              f"mesh (2, 2), {'TP + FSDP' if tp else 'ZeRO-3'}, batch {B} x "
              f"{S} in {cfg.microbatches} micro-batches, batch axes "
              f"{x0['batch_axes']}: {x0['ms']:.1f} ms (one rank "
              f"{x0['ref_ms']:.1f}), {B * S / x0['ms'] * 1e3:.0f} tokens/s; "
              f"metrics {x0['metrics']} / {x0['ref']} (rtol {TM_RTOL}); worst "
              f"leaves by rank {[x[label]['worst'] for x in res]} (bar "
              f"{TM_LEAF} of the leaf's max); collectives (calls, operand "
              f"bytes), rank 0: {tm_kinds(x0['counts'])}; MB by kind "
              f"{tm_mb(x0['counts'])}; parameter bytes by rank "
              f"{[x[label]['param_bytes'] for x in res]}; peak GiB by rank "
              f"{[round(x[label]['peak'] / 2 ** 30, 3) for x in res]}; took "
              f"{x0['seconds']:.3f} s; card: {card}")


def ssm_mesh_phase(torch):
    """Phase 15: the ssm and hybrid families on a (2, 2) mesh of four gloo
    ranks sharing the one card, at full width, against one rank on the
    same seeded weights, batch and card: (a) falcon-mamba-7b, 2 of 64
    layers, served under TP (B = 4, prompt 64, 8 decode steps) in bf16 and
    f32, and one TP train step in f32 of 8 micro-batches of 2 x 256; (b)
    zamba2-2.7b, one of 9 groups, a ZeRO-3 prefill (B = 4, prompt 200) and
    8 TP decode steps, a B = 1 prefill of 1024 tokens (``seq_shard``), and
    one ZeRO-3 train step in f32 of 4 x 1024.  The decode steps take the
    one-rank run's ids.  The path reaches no kernel of the table."""
    import tempfile
    from repro_torch.launch import steps
    card = smi()
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        for label in SM_SERVE:
            sm_serve_reference(torch, steps, label, tmp)
        refs = {label: sm_train_reference(torch, label) for label in SM_TRAIN}
        print(f"[ssmmesh] the one-rank runs took "
              f"{time.perf_counter() - t0:.3f} s; card: {card}")
        t0 = time.perf_counter()
        res = sm_spawn(4, tmp, refs)
        del refs
        torch.cuda.ipc_collect()
        torch.cuda.empty_cache()
        print(f"[ssmmesh] the 4-rank job took {time.perf_counter() - t0:.3f} "
              f"s; card: {card}")
        sm_report(torch, res, card)
    print(f"[ssmmesh] phase 15 took {time.perf_counter() - t_phase:.3f} s; "
          f"card: {card}")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this test runs only on the card",
              file=sys.stderr)
        return 1
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch not found beside chip_smoke.py; "
              "run it from a checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core import functions as tF
    from repro_torch.core import mapreduce as tmr
    from repro_torch.core import selector as tsel
    from repro_torch.core import sequential as tseq
    from repro_torch.kernels import _build, _wrap, ops, ref
    from repro_torch.kernels import coverage_accept as ca
    from repro_torch.kernels import coverage_marginals as cm
    from repro_torch.kernels import exemplar_accept as ea
    from repro_torch.kernels import exemplar_marginals as em
    from repro_torch.kernels import facility_accept as fa
    from repro_torch.kernels import facility_marginals as fm
    from repro_torch.kernels import graph_cut_accept as ga
    from repro_torch.kernels import graph_cut_marginals as gm
    from repro_torch.kernels import logdet_accept as la
    from repro_torch.kernels import logdet_marginals as lm
    from repro_torch.kernels import saturated_coverage_accept as sa
    from repro_torch.kernels import saturated_coverage_marginals as sm
    from repro_torch.kernels import weighted_coverage_accept as wa
    from repro_torch.kernels import weighted_coverage_marginals as wm

    card = smi()
    print(f"[build] python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    # the plain versions' products must be full f32, like the CPU reference
    check(torch.backends.cuda.matmul.allow_tf32 is False,
          "TF32 matmul is on; the plain versions need full f32 products")
    print(f"[build] float32 matmul precision: "
          f"{torch.get_float32_matmul_precision()}")
    t0 = time.perf_counter()
    _build.build_all()
    print(f"[build] {len(_build.SOURCES)} kernel sources built in "
          f"{time.perf_counter() - t0:.3f} s; card: {card}")
    print_tile_resources(_build)

    rows = phase_coverage_kernels(torch, ref, cm, ca)
    rows.update(phase_facility_kernels(torch, ref, fm, fa))
    rows.update(phase_weighted_saturated_kernels(torch, ref, wm, wa, sm, sa))
    phase_filter_shapes(torch, ref, cm, sm, rows)
    rows.update(phase_graph_cut_logdet_kernels(torch, ref, gm, ga, lm, la))
    rows.update(phase_exemplar_kernels(torch, ref, em, ea))
    phase_marginals_ragged(torch, ref, fm, em)
    sweeps = {"coverage_accept": ca, "weighted_coverage_accept": wa,
              "saturated_coverage_accept": sa, "graph_cut_accept": ga,
              "facility_accept": fa, "exemplar_accept": ea,
              "logdet_accept": la}
    phase_cost_sweeps(torch, ref, sweeps, rows)
    phase_wide_sweeps(torch, ref, sweeps, _wrap, la, rows)

    gen = torch.Generator(device="cuda").manual_seed(0)
    X = torch.rand((N, D), generator=gen, device="cuda") ** 2
    reference = torch.rand((R, D), generator=gen, device="cuda")
    # the constraints' per-element data, drawn after the reference from the
    # same generator, as the JAX CLI draws it
    costs = 0.5 + 1.5 * torch.rand(N, generator=gen, device="cuda")
    parts = torch.randint(0, N_PARTS, (N,), generator=gen, device="cuda")
    # every oracle's main path; by[oracle] receives each select's (result,
    # value) by label, gvals[oracle] sequential greedy's value (<= OPT)
    by = {oracle: {} for oracle, *_ in ORACLES}
    gvals = {}
    launches = {}

    def path(oracle, kernels, accept_kernel, **kw):
        got, gvals[oracle] = main_path(torch, tsel, tseq, ops, X, oracle,
                                       kernels, accept_kernel,
                                       results=by[oracle], **kw)
        for name, n in got.items():
            launches[name] = launches.get(name, 0) + n

    path("feature_coverage", ("coverage_marginals", "coverage_accept"),
         "coverage_accept")
    path("facility_location",
         ("facility_marginals", "rectified_residual_sum", "facility_accept"),
         "facility_accept", reference=reference)
    path("weighted_coverage",
         ("weighted_coverage_marginals", "weighted_coverage_accept"),
         "weighted_coverage_accept")
    # the ground set's feature sum, f32 from the f32 corpus, as the JAX
    # CLI computes it
    total = X.sum(0)
    path("saturated_coverage",
         ("saturated_coverage_marginals", "saturated_coverage_accept"),
         "saturated_coverage_accept", total=total)
    add_launches(launches, saturating_select(torch, tsel, tseq, ops, X, total),
                 ("saturated_coverage_marginals", "saturated_coverage_accept"))

    # GraphCut with the same total and the JAX default lam = 0.5, then
    # LogDetDiversity at alpha = 1 and MutualInformationGaussian at noise 1
    # (k_max = k for both): the same selects, so MI must give log-det's ids
    # and exactly half its value (the 0.5 scale is a power of two)
    path("graph_cut", ("graph_cut_marginals", "graph_cut_accept"),
         "graph_cut_accept", total=total)
    ld_kernels = ("logdet_marginals", "logdet_accept")
    path("log_det", ld_kernels, "logdet_accept")
    path("mutual_information", ld_kernels, "logdet_accept")
    by_ld, by_mi = by["log_det"], by["mutual_information"]
    for label, (res, value) in by_ld.items():
        res_mi, value_mi = by_mi[label]
        check(torch.equal(res_mi.sol_ids, res.sol_ids)
              and value_mi == 0.5 * value,
              f"{label}: mutual information {value_mi} with ids "
              f"{res_mi.sol_ids.tolist()} is not half of log-det {value} "
              f"with ids {res.sol_ids.tolist()}")
    print(f"[main] mutual_information at noise 1 = 0.5 x log_det, same ids, "
          f"in all {len(by_ld)} selects")

    # ExemplarClustering over the same corpus and the same 256-row reference
    # set as FacilityLocation
    path("exemplar", ("exemplar_marginals", "exemplar_accept"),
         "exemplar_accept", reference=reference)

    # constrained selection: knapsack on every oracle, the partition matroid
    # on FeatureCoverage
    stats = dict(reference=reference, total=total)
    plane_split(torch, X, costs)
    for name, n in knapsack_selects(
            torch, tsel, ops, X, stats, costs,
            by["feature_coverage"]["two_round fused kernel"][0]).items():
        launches[name] = launches.get(name, 0) + n
    for name, n in partition_select(torch, tsel, ops, X, parts).items():
        launches[name] = launches.get(name, 0) + n

    # the known-OPT algorithms, the query axis and the Theorem-4 instance;
    # their launches stay out of the kernel table's
    known_opt_selects(torch, tsel, ops, X, stats, gvals, costs)
    batch_selects(torch, tsel, tmr, ops, X, stats, by)
    theorem4_selects(torch, tF, tmr)

    # the wide shapes: selects whose sweeps run their wide instances
    del X, costs, parts
    torch.cuda.empty_cache()
    for name, n in wide_selects(torch, tsel, ops, _wrap, la).items():
        launches[name] = launches.get(name, 0) + n

    # the mesh substrate; its launches go on a line of their own, not into
    # the kernel table
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    mesh_launches = mesh_phase(
        torch, tsel, tmr, ops, gvals["feature_coverage"],
        by["feature_coverage"]["two_round fused kernel"][1])
    for name in (kernel for _, kernels, _, _ in ORACLES for kernel in kernels):
        check(mesh_launches.get(name, 0) > 0,
              f"[mesh] {name} never launched on the mesh path")
    print(f"[mesh] launches on the mesh path by kernel: "
          f"{ {k: v for k, v in mesh_launches.items() if '@' not in k} }")
    print(f"[mesh] phase 8 took {time.perf_counter() - t0:.3f} s")

    # the streaming path; its launches go on a line of their own too
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    stream_launches = stream_phase(
        torch, tsel, ops, gvals,
        by["feature_coverage"]["two_round fused kernel"][1])
    for name in (kernel for _, kernels, _, _ in ORACLES for kernel in kernels):
        check(stream_launches.get(name, 0) > 0,
              f"[stream] {name} never launched on the streaming path")
    print(f"[stream] launches on the streaming path by kernel: "
          f"{ {k: v for k, v in stream_launches.items() if '@' not in k} }")
    print(f"[stream] phase 9 took {time.perf_counter() - t0:.3f} s")

    # the LM serving path and exclude_ids at the batch's shape
    torch.cuda.empty_cache()
    lm_phase(torch, tsel, tmr, ops)

    # the moe, ssm and hybrid families at full width
    families_phase(torch, ops)

    # LM training at full width
    train_phase(torch, ops)

    # LM serving on a mesh of ranks sharing the card (each rank counts its
    # own launches around its serving)
    torch.cuda.empty_cache()
    lm_mesh_phase(torch)

    # LM training on a mesh of ranks sharing the card
    torch.cuda.empty_cache()
    train_mesh_phase(torch)

    # the ssm and hybrid families on a mesh of ranks sharing the card
    torch.cuda.empty_cache()
    ssm_mesh_phase(torch)

    check(SHAPES == _wrap.SHAPES, f"shape classes {_wrap.SHAPES}")
    table = []
    for name, src, replaces in (
            ("coverage_marginals",
             "src/repro_torch/kernels/csrc/coverage_marginals.cu",
             "src/repro/kernels/coverage_marginals.py:49"),
            ("coverage_accept",
             "src/repro_torch/kernels/csrc/coverage_accept.cu",
             "src/repro/kernels/coverage_accept.py:32"),
            ("facility_marginals",
             "src/repro_torch/kernels/csrc/facility_marginals.cu",
             "src/repro/kernels/facility_marginals.py:59"),
            ("rectified_residual_sum",
             "src/repro_torch/kernels/csrc/facility_marginals.cu",
             "src/repro/kernels/facility_marginals.py:107"),
            ("facility_accept",
             "src/repro_torch/kernels/csrc/facility_accept.cu",
             "src/repro/kernels/facility_accept.py:64"),
            ("weighted_coverage_marginals",
             "src/repro_torch/kernels/csrc/weighted_coverage_marginals.cu",
             "src/repro/kernels/weighted_coverage_marginals.py:49"),
            ("weighted_coverage_accept",
             "src/repro_torch/kernels/csrc/weighted_coverage_accept.cu",
             "src/repro/kernels/weighted_coverage_accept.py:28"),
            ("saturated_coverage_marginals",
             "src/repro_torch/kernels/csrc/saturated_coverage_marginals.cu",
             "src/repro/kernels/saturated_coverage_marginals.py:49"),
            ("saturated_coverage_accept",
             "src/repro_torch/kernels/csrc/saturated_coverage_accept.cu",
             "src/repro/kernels/saturated_coverage_accept.py:27"),
            ("graph_cut_marginals",
             "src/repro_torch/kernels/csrc/graph_cut_marginals.cu",
             "src/repro/kernels/graph_cut_marginals.py:50"),
            ("graph_cut_accept",
             "src/repro_torch/kernels/csrc/graph_cut_accept.cu",
             "src/repro/kernels/graph_cut_accept.py:29"),
            ("logdet_marginals",
             "src/repro_torch/kernels/csrc/logdet_marginals.cu",
             "src/repro/kernels/logdet_marginals.py:52"),
            ("logdet_accept",
             "src/repro_torch/kernels/csrc/logdet_accept.cu",
             "src/repro/kernels/logdet_accept.py:133"),
            ("exemplar_marginals",
             "src/repro_torch/kernels/csrc/exemplar_marginals.cu",
             "src/repro/kernels/exemplar_marginals.py:55"),
            ("exemplar_accept",
             "src/repro_torch/kernels/csrc/exemplar_accept.cu",
             "src/repro/kernels/exemplar_accept.py:69")):
        check(launches[name] > 0, f"{name} never launched on the main path")
        by_shape = {shape: launches[f"{name}@{shape}"] for shape in SHAPES}
        check(sum(by_shape.values()) == launches[name],
              f"{name}: launches by shape {by_shape} do not sum to "
              f"{launches[name]}")
        print(f"[main] {name} launches on the main path by rows a lane: "
              f"{by_shape} (filter: more than a chunk of {CHUNK}; chunk: up "
              f"to {CHUNK}; row: one row)")
        r = rows[name]
        prefix = f"{name}@filter/"
        filter_split = {key[len(prefix):]: n for key, n in launches.items()
                        if key.startswith(prefix) and n}
        if name in FILTER_SPLIT_KERNELS:
            check(sum(filter_split.values()) == by_shape["filter"],
                  f"{name}: filter launches split {filter_split} do not sum "
                  f"to {by_shape['filter']}")
            print(f"[main] {name} filter launches by lanes, x and rows: "
                  f"{filter_split}")
            r["launches_filter_split"] = filter_split
        table.append({"name": name, "route": "cuda", "source": src,
                      "replaces": replaces, "launches": launches[name],
                      "launches_by_shape": by_shape,
                      "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                      "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                      "bound_by": r["bound_by"],
                      # one PyTorch call that computes the same function,
                      # where there is one (None: there is none)
                      "library_ms": r.get("library_ms"),
                      # the accept sweeps' knapsack cost mode and their
                      # wide instance at the widest shape of WIDE_SWEEPS;
                      # log-det's bound and library call over every row of
                      # U, the rows past each lane's size too
                      **{key: r[key] for key in (
                          "cost_ms", "wide_ms", "bound_all_rows_ms",
                          "library_all_rows_ms", "all_accept_ms",
                          "launches_filter_split", "filter_shapes_ms")
                         if key in r}})
    print(json.dumps({"kernels": table}))
    print(smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
