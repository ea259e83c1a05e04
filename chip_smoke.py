#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py        (from the root of a checkout)

Phases, each printing its lines; any failure raises and exits non-zero:

1. Build the CUDA kernels from src/repro_torch/kernels/csrc with nvcc (one
   process per source, all at once).
2. Hold each kernel against its plain PyTorch version on the card at the
   main paths' shapes, and time both with CUDA events:
   coverage_marginals and coverage_accept (f32 and bf16 x, weighted and
   unweighted); facility_marginals, rectified_residual_sum and
   facility_accept (f32 and bf16, every lane mode, an odd shape at L = 1
   and L = 100, and a bitwise repeat of each).
3. Drive the FeatureCoverage main path at full width:
   DistributedSelector.select with the two_round driver, n = 1,048,576
   rows of d = 256 (a 1 GiB f32 corpus on the card), k = 64, m = 16
   simulated machines, eps = 0.15, once per engine on the kernel route and
   once on the plain route, then multi_epoch (E = 2) and bf16 storage on
   the fused engine.  Checks agreement between the routes and engines, the
   (1/2 - eps) guarantee against sequential greedy, and that every kernel
   of the path launched.
4. The same for FacilityLocation over the same corpus with a 256-row
   reference set.
5. Hold the WeightedCoverage and SaturatedCoverage kernels against their
   plain versions (every lane mode, f32 and bf16, the main path's shapes
   and odd ones: d = 45 and 70, L = 1 and 130; saturated states that
   straddle the cap; a bitwise repeat of each), and time
   weighted_coverage_marginals' yardstick torch.matmul.
6. The main path for both over the same corpus (saturated coverage with
   total = X.sum(0) and the default alpha = 0.25), then one more
   SaturatedCoverage select at alpha = 2^-16, where the cap binds.
7. Hold the GraphCut and log-det kernels against their plain versions
   (every lane mode, f32 and bf16, the main path's shapes and odd ones:
   d = 45 and 70, L = 1 and 130, k_max = 1, 7 and 100; GraphCut states
   whose redundancy term cancels the linear one; bases empty, partial and
   full, and sweeps whose appends run into k_max; a bitwise repeat of
   each), and time the products alone as torch.matmul / mv / bmm.
8. The main path for GraphCut (total = X.sum(0), lam = 0.5),
   LogDetDiversity (alpha = 1) and MutualInformationGaussian (noise = 1;
   k_max = k for both) over the same corpus; mutual information must give
   log-det's ids and exactly half its value in every select.
9. Print the kernel table as one JSON line, the card's name and power
   limit, and last the result line.

Exits non-zero, printing no result, without a CUDA card or outside a
checkout.  Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
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


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


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
    is within ``near_tol[l]`` of tau; the gains are then compared up to
    that row.  Returns (near-tau ties, max abs err)."""
    km, ks, kg = got
    pm, ps, pg = want
    ties, err = 0, 0.0
    for l in range(km.shape[0]):
        diff = (km[l] != pm[l]).nonzero()
        upto = km.shape[1]
        if len(diff):
            i = int(diff[0])
            check(abs(float(pg[l, i]) - float(tau[l])) <= float(near_tol[l]),
                  f"{name} lane {l} row {i}: masks differ away from tau "
                  f"(gain {float(pg[l, i])}, tau {float(tau[l])})")
            ties, upto = ties + 1, i + 1
        else:
            check(close(l, ks[l], ps[l], "state"),
                  f"{name} lane {l}: states differ")
            err = max(err, (ks[l] - ps[l]).abs().max().item())
        check(close(l, kg[l, :upto], pg[l, :upto], "gains"),
              f"{name} lane {l}: gains differ")
        err = max(err, (kg[l, :upto] - pg[l, :upto]).abs().max().item())
    return ties, err


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

    # -- facility_marginals: shared at the filter shape, per-lane at the
    #    lazy chunk shape, two odd shapes, and a grid wider than one CTA's
    #    lane group (two groups)
    worst = 0.0
    for label, Lk, C, r, d in (("shared", L, N, R, D), ("per-lane", L, B, R, D),
                               ("odd shared", 100, 1000, 45, 70),
                               ("odd per-lane", 1, 65, 45, 70),
                               ("odd shared", 130, 1000, 45, 70)):
        per_lane = label.endswith("per-lane")
        for dtype in (torch.float32, torch.bfloat16):
            if label.startswith("odd") and dtype == torch.bfloat16:
                continue
            shape = (Lk, C, d) if per_lane else (C, d)
            cand = (torch.rand(shape, generator=g, device=dev) ** 2).to(dtype)
            Rm = torch.rand((r, d), generator=g, device=dev)
            state = torch.rand((Lk, r), generator=g, device=dev) * d / 4
            if per_lane or C <= TILE:
                plain = lambda: ref.facility_marginals(cand, Rm, state)  # noqa: E731
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
                         tol if per_lane else tol.expand(Lk, C))
            repeat("facility_marginals", lambda: fm.facility_marginals(
                cand, Rm, state), got)
            worst = max(worst, err)
            ms = cuda_ms(lambda: fm.facility_marginals(cand, Rm, state), 10)
            pms = cuda_ms(plain, 1)
            rows_c = Lk * C if per_lane else C
            b_ms, b_by = bound_ms(cand.numel() * cand.element_size()
                                  + r * d * 4 + Lk * r * 4 + Lk * C * 4,
                                  2 * rows_c * r * d + 3 * Lk * C * r)
            print(f"[kernels] facility_marginals {label} cand{tuple(shape)} "
                  f"ref({r}, {d}) L={Lk} {str(dtype)[6:]}: max_abs_err={err} "
                  f"tol_max={tol.max().item()} kernel_ms={ms} plain_ms={pms} "
                  f"bound_ms={b_ms} ({b_by}) repeat=bitwise")
            if label == "shared" and dtype == torch.float32:
                rows["facility_marginals"] = dict(ms=ms, plain_ms=pms,
                                                  bound_ms=b_ms, bound_by=b_by)
                Xs, Rs = cand, Rm
    rows["facility_marginals"]["max_abs_err"] = worst
    mm = cuda_ms(lambda: torch.matmul(Xs, Rs.T), 10)
    print(f"[kernels] yardstick: torch.matmul ({N}, {D}) x ({D}, {R}) f32 "
          f"alone: {mm} ms (allow_tf32="
          f"{torch.backends.cuda.matmul.allow_tf32})")

    # -- rectified_residual_sum: unbatched over the corpus (local_top), the
    #    shared sample with 37 lanes (dense phase 1), per-lane survivors
    #    (dense phase 2), two odd shapes
    worst = 0.0
    for label, Lk, C, r in (("unbatched", 1, N, R), ("shared", L, S_ROWS, R),
                            ("per-lane", L, F_ROWS, R),
                            ("odd shared", 100, 1000, 45),
                            ("odd per-lane", 1, 65, 45)):
        per_lane = label.endswith("per-lane")
        aux = torch.rand((Lk, C, r) if per_lane else (C, r), generator=g,
                         device=dev) * 40
        state = torch.rand((r,) if label == "unbatched" else (Lk, r),
                           generator=g, device=dev) * 40
        if per_lane or label == "unbatched":
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
        print(f"[kernels] rectified_residual_sum {label} aux{tuple(aux.shape)} "
              f"L={Lk}: max_abs_err={err} kernel_ms={ms} plain_ms={pms} "
              f"bound_ms={b_ms} ({b_by}) repeat=bitwise")
        if label == "unbatched":
            rows["rectified_residual_sum"] = dict(ms=ms, plain_ms=pms,
                                                  bound_ms=b_ms, bound_by=b_by)
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
                rows["facility_accept"] = dict(ms=ms, plain_ms=pms,
                                               bound_ms=b_ms, bound_by=b_by)
    rows["facility_accept"]["max_abs_err"] = worst
    return rows


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

    # -- logdet_marginals: shared at the filter shape, unbatched over the
    #    corpus, per-lane at the lazy chunk shape; odd shapes with k = 1, 7
    #    and 100 (more than one 64-column tile per lane); scale 1 and 0.5
    worst = 0.0
    for label, Lk, C, d, k in (("shared", L, N, D, K), ("unbatched", 1, N, D, K),
                               ("per-lane", L, B, D, K),
                               ("odd shared", 130, 1000, 70, 7),
                               ("odd shared", 130, 1000, 45, 1),
                               ("odd shared", 5, 1000, 70, 100),
                               ("odd per-lane", 3, 65, 45, 7),
                               ("odd unbatched", 1, 1000, 45, 1)):
        per_lane = label.endswith("per-lane")
        for dtype in (torch.float32, torch.bfloat16):
            scale = 1.0 if dtype == torch.float32 else 0.5
            shape = (Lk, C, d) if per_lane else (C, d)
            x = (torch.rand(shape, generator=g, device=dev) ** 2).to(dtype)
            nb = 2 if label.endswith("unbatched") else Lk
            U, _, _ = logdet_bases(torch, ref, g, nb, k, d,
                                   lane_sizes(nb, k), alpha, dtype)
            if label.endswith("unbatched"):
                U = U[1].contiguous()   # a full basis
            if label == "shared":
                # one lane at a time: the plain version's (L, C, k)
                # projection would take 10 GB
                plain = lambda: torch.stack([  # noqa: E731
                    ref.logdet_marginals(x, U[l], alpha, scale=scale)
                    for l in range(Lk)])
            else:
                plain = lambda: ref.logdet_marginals(  # noqa: E731
                    x, U, alpha, scale=scale)
            got = lm.logdet_marginals(x, U, alpha, scale)
            want = plain()
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            check(ld_close(got, want), f"logdet_marginals {label} k={k} "
                  f"{dtype}: max abs err {err}")
            check(torch.equal(lm.logdet_marginals(x, U, alpha, scale), got),
                  f"logdet_marginals {label}: a repeated launch differs")
            worst = max(worst, err)
            line = (f"[kernels] logdet_marginals {label} x{tuple(shape)} "
                    f"L={Lk} k={k} {str(dtype)[6:]} scale={scale}: "
                    f"max_abs_err={err} gains=[{want.min().item()}, "
                    f"{want.max().item()}] repeat=bitwise")
            if not label.startswith("odd"):
                ms = cuda_ms(lambda: lm.logdet_marginals(x, U, alpha, scale),
                             5)
                pms = cuda_ms(plain, 2)
                rows_c = Lk * C if per_lane or U.dim() == 3 else C
                b_ms, b_by = bound_ms(
                    x.numel() * x.element_size() + U.numel() * 4
                    + got.numel() * 4,
                    2 * rows_c * d * k + 2 * (Lk if per_lane else 1) * C * d
                    + 2 * rows_c * k + 6 * rows_c)
                xf = x.float()
                lib = {"shared": lambda: torch.matmul(
                           xf, U.reshape(-1, d).T),
                       "unbatched": lambda: torch.matmul(xf, U.T),
                       "per-lane": lambda: torch.bmm(
                           xf, U.transpose(1, 2))}[label]
                lib_ms = cuda_ms(lib, 5)
                line += (f" kernel_ms={ms} plain_ms={pms} bound_ms={b_ms} "
                         f"({b_by}) library_ms={lib_ms}")
                if label == "shared" and dtype == torch.float32:
                    rows["logdet_marginals"] = dict(
                        ms=ms, plain_ms=pms, bound_ms=b_ms, bound_by=b_by,
                        library_ms=lib_ms)
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
    rows["logdet_accept"]["max_abs_err"] = worst
    return rows


def drive(torch, tsel, ops, X, label, reference=None, total=None, **spec_kw):
    """One select through the public entry point, with the launch counts
    set to 0 just before and read just after.  Returns (result, value,
    wall ms, launch counts by kernel)."""
    spec = tsel.SelectorSpec(k=K, eps=EPS, chunk=CHUNK, **spec_kw)
    sel = tsel.DistributedSelector(spec, n_total=N, feat_dim=D, n_machines=M,
                                   device="cuda", reference=reference,
                                   total=total)
    gen = torch.Generator(device="cuda").manual_seed(1)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res = sel.select(X, generator=gen)
    value = float(res.value)  # waits for the device
    wall = (time.perf_counter() - t0) * 1e3
    counts = ops.launch_counts()
    size = int(res.sol_size)
    ids = res.sol_ids.cpu()[:size]
    # facility location over all-positive similarities, weighted coverage
    # (whose remaining weight decays geometrically) and saturated coverage
    # at a binding cap saturate after a few picks, so their lanes may stop
    # short of k
    full = spec.oracle == "feature_coverage"
    check(res.sol_ids.shape == (K,) and (size == K if full else 1 <= size <= K),
          f"{label}: got size {size}")
    check(len(set(ids.tolist())) == size and int(ids.min()) >= 0
          and int(ids.max()) < N, f"{label}: ids not {size} distinct rows")
    check(value == value and value > 0 and value != float("inf"),
          f"{label}: value {value}")
    nonzero = {k: v for k, v in counts.items() if v}
    print(f"[main] {label}: value={value} |S|={size} "
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
    launches = dict.fromkeys(kernels, 0)
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
            launches[name] += counts[name]
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
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.kernels import coverage_accept as ca
    from repro_torch.kernels import coverage_marginals as cm
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

    rows = phase_coverage_kernels(torch, ref, cm, ca)
    rows.update(phase_facility_kernels(torch, ref, fm, fa))
    rows.update(phase_weighted_saturated_kernels(torch, ref, wm, wa, sm, sa))
    rows.update(phase_graph_cut_logdet_kernels(torch, ref, gm, ga, lm, la))

    gen = torch.Generator(device="cuda").manual_seed(0)
    X = torch.rand((N, D), generator=gen, device="cuda") ** 2
    reference = torch.rand((R, D), generator=gen, device="cuda")
    launches = main_path(torch, tsel, tseq, ops, X, "feature_coverage",
                         ("coverage_marginals", "coverage_accept"),
                         "coverage_accept")
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
    for name, n in saturating_select(torch, tsel, tseq, ops, X,
                                     total).items():
        if name.startswith("saturated"):
            launches[name] += n

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
        launches[name] += n
    for label, (res, value) in by_ld.items():
        res_mi, value_mi = by_mi[label]
        check(torch.equal(res_mi.sol_ids, res.sol_ids)
              and value_mi == 0.5 * value,
              f"{label}: mutual information {value_mi} with ids "
              f"{res_mi.sol_ids.tolist()} is not half of log-det {value} "
              f"with ids {res.sol_ids.tolist()}")
    print(f"[main] mutual_information at noise 1 = 0.5 x log_det, same ids, "
          f"in all {len(by_ld)} selects")

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
             "src/repro/kernels/logdet_accept.py:133")):
        check(launches[name] > 0, f"{name} never launched on the main path")
        r = rows[name]
        table.append({"name": name, "route": "cuda", "source": src,
                      "replaces": replaces, "launches": launches[name],
                      "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                      "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                      "bound_by": r["bound_by"],
                      # one PyTorch call that computes the same function,
                      # where there is one (None: there is none)
                      "library_ms": r.get("library_ms")})
    print(json.dumps({"kernels": table}))
    print(smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
