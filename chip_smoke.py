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
6. Three selects whose fused engine runs a wide instance, each on a
   1 GiB corpus, against the lazy plain route (the same ids, values within
   rtol 1e-3): FeatureCoverage on 65,536 x 4096, LogDetDiversity (k = 64)
   on 262,144 x 1024, FacilityLocation with 8192 reference rows on
   262,144 x 256.
7. Print the kernel table as one JSON line, the card's name and power
   limit, and last the result line.

Exits non-zero, printing no result, without a CUDA card or outside a
checkout.  Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import json
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

    def gc_states(Lk, t):
        frac = torch.rand((Lk, 1), generator=g, device=dev) * 1.2
        return (t * frac / (2 * lam)).contiguous()

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


def drive(torch, tsel, ops, X, label, reference=None, total=None,
          sel_kw=None, **spec_kw):
    """One select through the public entry point, with the launch counts
    set to 0 just before and read just after.  ``sel_kw`` are the
    selector's per-element constraint data.  Returns (result, value, wall
    ms, launch counts by kernel, with each sweep's cost-mode launches under
    "<name>[cost]" and each kernel's split by shape under "<name>@<shape>")."""
    spec = tsel.SelectorSpec(k=K, eps=EPS, chunk=CHUNK, **spec_kw)
    n, d = X.shape
    sel = tsel.DistributedSelector(spec, n_total=n, feat_dim=d, n_machines=M,
                                   device="cuda", reference=reference,
                                   total=total, **(sel_kw or {}))
    gen = torch.Generator(device="cuda").manual_seed(1)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res = sel.select(X, generator=gen)
    value = float(res.value)  # waits for the device
    wall = (time.perf_counter() - t0) * 1e3
    counts = ops.launch_counts()
    counts.update({f"{name}[cost]": n
                   for name, n in ops.cost_launch_counts().items()})
    counts.update({f"{name}@{shape}": n
                   for name, split in ops.shape_launch_counts().items()
                   for shape, n in split.items()})
    counts.update({f"{name}@filter/{key}": n
                   for name, split in ops.filter_launch_counts().items()
                   for key, n in split.items()})
    size = int(res.sol_size)
    ids = res.sol_ids.cpu()[:size]
    # facility location over all-positive similarities, weighted coverage
    # (whose remaining weight decays geometrically), saturated coverage at a
    # binding cap and exemplar clustering saturate after a few picks, and a
    # knapsack or partition budget stops a lane early, so those lanes may
    # stop short of k
    full = (spec.oracle == "feature_coverage"
            and spec.constraint == "cardinality")
    check(res.sol_ids.shape == (K,) and (size == K if full else 1 <= size <= K),
          f"{label}: got size {size}")
    check(len(set(ids.tolist())) == size and int(ids.min()) >= 0
          and int(ids.max()) < n, f"{label}: ids not {size} distinct rows")
    check(value == value and value > 0 and value != float("inf"),
          f"{label}: value {value}")
    nonzero = {k: v for k, v in counts.items() if v and "@" not in k}
    # the chosen ids in order, as one checksum, to set a run beside another
    ids_crc = zlib.crc32(ids.to(torch.int64).numpy().tobytes())
    print(f"[main] {label}: value={value} |S|={size} ids_crc32={ids_crc} "
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
    over the kernel-route selects; ``results``, when given, receives each
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
    return launches


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
    by_fc = {}
    launches = main_path(torch, tsel, tseq, ops, X, "feature_coverage",
                         ("coverage_marginals", "coverage_accept"),
                         "coverage_accept", results=by_fc)
    launches.update(main_path(
        torch, tsel, tseq, ops, X, "facility_location",
        ("facility_marginals", "rectified_residual_sum", "facility_accept"),
        "facility_accept", reference=reference))
    launches.update(main_path(
        torch, tsel, tseq, ops, X, "weighted_coverage",
        ("weighted_coverage_marginals", "weighted_coverage_accept"),
        "weighted_coverage_accept"))
    # the ground set's feature sum, f32 from the f32 corpus, as the JAX
    # CLI computes it
    total = X.sum(0)
    launches.update(main_path(
        torch, tsel, tseq, ops, X, "saturated_coverage",
        ("saturated_coverage_marginals", "saturated_coverage_accept"),
        "saturated_coverage_accept", total=total))
    add_launches(launches, saturating_select(torch, tsel, tseq, ops, X, total),
                 ("saturated_coverage_marginals", "saturated_coverage_accept"))

    # GraphCut with the same total and the JAX default lam = 0.5, then
    # LogDetDiversity at alpha = 1 and MutualInformationGaussian at noise 1
    # (k_max = k for both): the same selects, so MI must give log-det's ids
    # and exactly half its value (the 0.5 scale is a power of two)
    launches.update(main_path(
        torch, tsel, tseq, ops, X, "graph_cut",
        ("graph_cut_marginals", "graph_cut_accept"), "graph_cut_accept",
        total=total))
    ld_kernels = ("logdet_marginals", "logdet_accept")
    by_ld, by_mi = {}, {}
    launches.update(main_path(torch, tsel, tseq, ops, X, "log_det",
                              ld_kernels, "logdet_accept", results=by_ld))
    for name, n in main_path(torch, tsel, tseq, ops, X, "mutual_information",
                             ld_kernels, "logdet_accept",
                             results=by_mi).items():
        launches[name] = launches.get(name, 0) + n
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
    launches.update(main_path(
        torch, tsel, tseq, ops, X, "exemplar",
        ("exemplar_marginals", "exemplar_accept"), "exemplar_accept",
        reference=reference))

    # constrained selection: knapsack on every oracle, the partition matroid
    # on FeatureCoverage
    plane_split(torch, X, costs)
    for name, n in knapsack_selects(
            torch, tsel, ops, X, dict(reference=reference, total=total),
            costs, by_fc["two_round fused kernel"][0]).items():
        launches[name] = launches.get(name, 0) + n
    for name, n in partition_select(torch, tsel, ops, X, parts).items():
        launches[name] = launches.get(name, 0) + n

    # the wide shapes: selects whose sweeps run their wide instances
    del X, costs, parts
    torch.cuda.empty_cache()
    for name, n in wide_selects(torch, tsel, ops, _wrap, la).items():
        launches[name] = launches.get(name, 0) + n

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
