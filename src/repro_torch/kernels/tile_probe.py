#!/usr/bin/env python3
"""What holds back the tiled kernels on a card: the facility / exemplar /
log-det product of csrc/marginals_tile.cuh, the skinny tile of graph cut
and weighted coverage (csrc/skinny_tile.cuh), the log-det accept sweep's
narrow instance, the facility and exemplar accept sweeps, the lane walk
of coverage and saturated coverage (csrc/lane_rows.cuh), and the four
feature sweeps (csrc/feature_sweep.cuh).

    PYTHONPATH=src python3 -m repro_torch.kernels.tile_probe
        [--only lane_walk | --only feature_sweeps] [--sass-dir DIR]
        [OTHER_CSRC]
                    (from the root of a checkout, on a machine with a
                     CUDA card and nvcc)

``--only lane_walk`` / ``--only feature_sweeps`` runs that probe alone;
``--sass-dir`` writes the lane walk kernels' SASS there, and the narrow
feature sweeps' at 2 features a thread, f32.

Builds facility_marginals.cu three times from patched copies of the
kernel sources, in a temporary directory:

* ``shipped``: the sources as they are;
* ``no_epilogue``: the residual loop runs over no column, so the kernel is
  the product, the value tile and the state slice alone;
* ``half_lds``: every other k step reuses the last step's fragments, so
  the product loop issues half its shared-memory loads (its sums are
  wrong: it is a probe of the loop's speed, not a kernel);

and times each (CUDA events over back-to-back launches) at the filter shape
(L = 37 lanes, C = 2^20 rows, d = r = 256, f32), one lane over the corpus,
and the per-lane chunk (37, 128, 256).  Then it builds
graph_cut_marginals.cu and weighted_coverage_marginals.cu three times each
from patched copies of skinny_tile.cuh:

* ``shipped``;
* ``no_fma``: the product loop runs over no feature, so the kernel
  streams x through its ring (graph cut: sums the norms) and stores the
  gains;
* ``no_copy``: no cp.async is started, so the product runs on whatever the
  ring holds (wrong sums: the arithmetic's time without the loads);

and times each at the filter shape, f32 and bf16.  Then it builds
logdet_accept.cu six times:

* ``shipped``;
* ``no_loads``: neither U nor the rows are staged;
* ``no_phase1``: no projection onto the basis at the block's start is
  formed;
* ``no_catch_up``: a window's rows meet none of the rows appended since;
* ``no_append``: an accepted row's append sums no basis row;
* ``no_later_dots``: the new basis row's dots with the window's later
  rows are taken as 0 (their fold and scoring still run);

and times each at the fused engine's chunk (L = 37, B = 128, d = 256,
k = 64, f32, lane sizes 0 .. 64 as chip_smoke.py's path case) with tau =
-inf and budget k: every eligible row is accepted whatever the gains, so
every variant takes the same decisions (and each lane's appends run until
its size reaches k) even where its sums are wrong.  Then it times
``torch.matmul`` of the facility and exemplar sweeps' product at the
fused engine's chunk (L = 37, B = 128, d = r = 256) and builds
facility_accept.cu and exemplar_accept.cu of this tree (and of
OTHER_CSRC, the ``csrc`` directory of another checkout) as they are, with clock64
laps of their phases (REFTILE_LAPS: the patch whose anchors the tree's
reference_tile.cuh holds) and, for the product-and-walk design, with
either launch alone (the product also at 33 lanes, two CTAs an SM); it times each at chip_smoke.py's path case and at tau = -inf
with the budget B, and prints the laps of the slowest lane and their
mean and the accepts per lane.  Then it builds coverage_marginals.cu and
saturated_coverage_marginals.cu of each tree as they are (``shipped``),
with coverage's term without its square root (``no_sqrt``), with the term
x alone (``x_only``: the walk's loads, loop and reductions) and with
clock64 laps (LANE_ROWS_LAPS, by the design the tree's lane_rows.cuh
holds: staging cycles a CTA, term-loop and reduction cycles of each warp
tile or row), prints ptxas's registers and spills and the SASS mix of the
walk's kernels, and times each at LANE_WALK_SHAPES (the corpus filter, the
sample, one lane, the survivors, a chunk, one row; f32).  Then it builds
the four feature sweeps of each tree as they are, with clock64 laps
(FEATURE_LAPS, by the design the tree's feature_sweep.cuh holds: a row's
term loop, butterfly, barrier and warp sums, eligibility / cost loads and
decision, accept and stores for the row loop; a pass's x loads and
shares, reduce-scatter, barrier and warp sums, decision, stores and
accept, and the row loop, for the windowed walk; each sweep at
feature_sweep_per's instance, so a tree with the walk probes the walk
even where the wrapper keeps the row loop, _wrap.FEATURE_SWEEP_LOOPS) and
with the design's variants (the row loop without the next row's x loads;
the walk with other constants), prints the order of the loads, shuffles and barrier in
each narrow kernel's SASS, and times each at chip_smoke.py's path case
(L = 37, B = 128, d = 256, f32 and bf16) in three rules: the path taus,
the knapsack cost mode and tau = -inf with the budget B.  Last it runs
the shipped facility kernel
at the filter shape for three seconds while sampling the SM clock, power
draw and throttle reasons with nvidia-smi, and prints the card's name and
power limit.  Imports nothing of JAX.
"""

from __future__ import annotations

import ctypes
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import torch

from repro_torch.kernels import _build, _wrap, ref

#: (name, [(text, replacement)]) patches of marginals_tile.cuh
TILE_VARIANTS = (
    ("shipped", []),
    ("no_epilogue", [("for (int c0 = part * part_cols; c0 < c_end; c0 += 4)",
                      "for (int c0 = part * part_cols; c0 < 0; c0 += 4)")]),
    ("half_lds", [("      fragments(buf, kk, fa, fb);",
                   "      if ((kk & 1) == 0) fragments(buf, kk, fa, fb);")]),
)
#: (name, [(text, replacement)]) patches of skinny_tile.cuh
SKINNY_VARIANTS = (
    ("shipped", []),
    ("no_fma", [("    for (int kk = 0; kk < kDepth; kk += 4) {\n"
                 "      const int off =",
                 "    for (int kk = 0; kk < 0; kk += 4) {\n"
                 "      const int off =")]),
    ("no_copy", [("        cp_async16(to, ok ? x + row * d + k : x, "
                  "ok ? 16 : 0);", "        (void)ok;")]),
)

#: (name, [(text, replacement)]) patches of logdet_accept.cu
LA_VARIANTS = (
    ("shipped", []),
    ("no_loads", [("  stage_rows(Us, U_in + u0, k, d, dp, vec_u);",
                   "  (void)vec_u;"),
                  ("    stage_rows(xs, xl + (long long)b0 * d, nb, d, dp, "
                   "vec_x);", "    (void)vec_x;")]),
    ("no_phase1", [("    project(0, nb, 0, live0);\n", "")]),
    ("no_catch_up", [("          project(upto, next, live0, live);\n",
                      "")]),
    ("no_append", [("        for (; j + 4 <= live; j += 4) {",
                    "        for (; j + 4 <= 0; j += 4) {"),
                   ("        for (; j < live; ++j) s = fmaf(",
                    "        for (; j < 0; ++j) s = fmaf(")]),
    ("no_later_dots", [("          dot_chains<1, 1>(xr, ur, m, d, v);",
                        "          v[0][0] = v[0][1] = v[0][2] = v[0][3] = "
                        "0.0f;")]),
)


def build(tmp: Path, source: str, patched, variants,
          csrc: Path = _build.CSRC, logs: dict | None = None) -> dict:
    """{variant: its ``source``_launch}, each built from a copy of the
    sources of ``csrc`` with the file ``patched`` (or each (text,
    replacement) applied to the one of a tuple of files that holds the
    text) patched, all in parallel.  ``logs``, when given, receives each
    variant's ``ptxas -v`` report; the loaded library is the launch
    function's ``lib``."""
    files = (patched,) if isinstance(patched, str) else tuple(patched)
    procs = {}
    for name, patch in variants:
        src = tmp / f"{source}_{name}"
        shutil.copytree(csrc, src)
        texts = {f: (src / f).read_text() for f in files}
        for old, new in patch:
            holders = [f for f in files if old in texts[f]]
            if not holders:
                raise RuntimeError(f"{name}: {', '.join(files)} no longer "
                                   f"has {old!r}")
            texts[holders[0]] = texts[holders[0]].replace(old, new)
        for f, text in texts.items():
            (src / f).write_text(text)
        cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
               str(src / "lib.so"), str(src / f"{source}.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    fns = {}
    argtypes = _build.SIGNATURES[source][f"{source}_launch"]
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc {name} failed:\n{log}")
        if logs is not None:
            logs[name] = log
        lib = ctypes.CDLL(str(tmp / f"{source}_{name}" / "lib.so"))
        fn = getattr(lib, f"{source}_launch")
        fn.argtypes, fn.restype = list(argtypes), ctypes.c_int
        fn.lib = lib
        fns[name] = fn
    return fns


def cuda_ms(fn, iters):
    """Mean device milliseconds of ``fn`` over back-to-back launches."""
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


def smi(query):
    return subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()


#: the phases the ``laps`` build of logdet_accept.cu times with clock64 on
#: thread 0 of each CTA (it writes its sums over U_out[l, 0, :8])
LAPS = ("stage", "phase 1", "catch-up", "score", "pass", "append",
        "later dots", "decide")
LAPS_PATCH = [
    ("  int par = 0;  // which set of ballots the walk writes next\n",
     "  int par = 0;  // which set of ballots the walk writes next\n"
     "  long long tp[8] = {0, 0, 0, 0, 0, 0, 0, 0};\n"
     "  long long tc = clock64();\n"
     "#define LAP(i) { const long long t_ = clock64(); tp[i] += t_ - tc; "
     "tc = t_; }\n"),
    ("    __syncthreads();  // U and the rows staged\n",
     "    __syncthreads();  // U and the rows staged\n    LAP(0)\n"),
    ("    extend(0, nb, 0, live0);\n", "    extend(0, nb, 0, live0);\n"
     "    LAP(1)\n"),
    ("          extend(upto, next, live0, live);\n",
     "          extend(upto, next, live0, live);\n          LAP(2)\n"),
    ("        __syncthreads();\n      }\n      if (full) {",
     "        __syncthreads();\n      }\n      LAP(3)\n      if (full) {"),
    ("        }\n        break;\n", "        }\n        LAP(4)\n"
     "        break;\n"),
    ("      if (first >= upto) {", "      LAP(7)\n      if (first >= upto) {"),
    ("      __syncthreads();\n      // the new basis row against the window's",
     "      __syncthreads();\n      LAP(5)\n"
     "      // the new basis row against the window's"),
    ("        __syncthreads();\n        scored = true;\n",
     "        __syncthreads();\n        LAP(6)\n        scored = true;\n"),
    ("  if (tid == 0) {\n    logdet_out[l] = ld;",
     "  __syncthreads();\n  if (tid == 0)\n    for (int i = 0; i < 8; ++i) "
     "U_out[u0 + i] = (float)tp[i];\n  if (tid == 0) {\n"
     "    logdet_out[l] = ld;"),
]


def probe_logdet_accept(fns, g, dev, stream):
    """Time each variant of the log-det sweep at the fused engine's chunk
    with tau = -inf (the decisions depend on eligibility alone); then run
    the ``laps`` build there and at chip_smoke.py's path case (quantile
    taus, every third lane at size k - 2 with tau = 0, budget 3 in every
    fifth) and print the phase cycles of the slowest lane and the mean."""
    L, B, D, K = 37, 128, 256, 64
    lanes = torch.arange(L, device=dev)
    x = torch.rand((L, B, D), generator=g, device=dev) ** 2
    sizes = (lanes * 13) % (K + 1)
    sizes[:2] = torch.tensor([0, K], device=dev)
    rows = torch.stack([torch.rand((L, D), generator=g, device=dev) ** 2
                        for _ in range(K)])
    U, ld, sz = ref.logdet_basis(rows, sizes.to(torch.int32))
    elig = torch.rand((L, B), generator=g, device=dev) < 0.9
    tau = torch.full((L,), float("-inf"), device=dev)
    budget = torch.full((L,), K, dtype=torch.int32, device=dev)
    outs = (torch.empty((L, B), dtype=torch.bool, device=dev),
            torch.empty((L, K, D), device=dev), torch.empty(L, device=dev),
            torch.empty(L, dtype=torch.int32, device=dev),
            torch.empty((L, B), device=dev))

    def call(fn, U, ld, sz, tau, budget):
        return lambda: fn(x.data_ptr(), 0, U.data_ptr(), ld.data_ptr(),
                          sz.data_ptr(), elig.data_ptr(), tau.data_ptr(),
                          budget.data_ptr(), None, None,
                          *(o.data_ptr() for o in outs), L, B, K, D, 1.0,
                          1.0, ref.LOGDET_EPS, 0, stream)

    def laps(label):
        cyc = outs[1][:, 0, :len(LAPS)].double()
        slow = int(cyc.sum(-1).argmax())
        for who, row in ((f"slowest lane {slow}", cyc[slow]),
                         ("mean over lanes", cyc.mean(0))):
            parts = ", ".join(f"{n} {float(c):.0f}" for n, c in zip(LAPS, row))
            print(f"[probe] logdet_accept laps {label} {who}: cycles "
                  f"{float(row.sum()):.0f} ({parts}); accepted "
                  f"{int(outs[0][slow].sum())}, size {int(sz[slow])} -> "
                  f"{int(outs[3][slow])}")

    for name, fn in fns.items():
        ms = cuda_ms(call(fn, U, ld, sz, tau, budget), 50)
        appends = int((outs[3].clamp(max=K) - sz).sum())
        print(f"[probe] logdet_accept x({L}, {B}, {D}) k={K} tau=-inf "
              f"{name}: {ms} ms (accepted {int(outs[0].sum())}, appends "
              f"{appends})")
    laps("tau=-inf")
    sizes[2::3] = K - 2
    U, ld, sz = ref.logdet_basis(rows, sizes.to(torch.int32))
    gains0 = ref.logdet_marginals(x, U, 1.0, size=sz)
    q = torch.linspace(0.05, 0.95, L, device=dev)
    tau = torch.stack([gains0[l].quantile(q[l]) for l in range(L)])
    tau[2::3] = 0.0
    budget = torch.where(lanes % 5 == 0, 3, K).to(torch.int32)
    for name in ("shipped", "laps"):
        ms = cuda_ms(call(fns[name], U, ld, sz, tau, budget), 50)
        print(f"[probe] logdet_accept x({L}, {B}, {D}) k={K} path taus "
              f"{name}: {ms} ms (accepted {int(outs[0].sum())})")
    laps("path taus")


#: clock64 laps of the reference sweeps (facility_accept.cu and
#: exemplar_accept.cu on reference_tile.cuh): (design, [(text,
#: replacement)]) for each design of the sweep, and the names of its laps.
#: Thread 0 of each CTA writes its laps' cycles over gains[l, :n], so the
#: laps build's gains are not the sweep's.  The probe takes the patch whose
#: anchors the tree's reference_tile.cuh holds.
REFTILE_LAPS = (
    # one CTA a lane: the lane's product, then the row chain
    ("row loop", ("phase 1 (product)", "phase 2 (rows)"), [
        ("  const int l = blockIdx.x;\n",
         "  const int l = blockIdx.x;\n  const long long lap0 = clock64();\n"),
        ("  __syncthreads();   // the block is visible to every thread of "
         "the CTA\n",
         "  __syncthreads();   // the block is visible to every thread of "
         "the CTA\n  const long long lap1 = clock64();\n"),
        ("\n}\n\ntemplate <class Rule, typename TC, int kPer>\n"
         "cudaError_t launch_sweep_per(",
         "\n  __syncthreads();\n  if (threadIdx.x == 0) {\n"
         "    gains[(long long)l * B] = (float)(lap1 - lap0);\n"
         "    gains[(long long)l * B + 1] = (float)(clock64() - lap1);\n"
         "  }\n}\n\ntemplate <class Rule, typename TC, int kPer>\n"
         "cudaError_t launch_sweep_per("),
    ], ()),
    # the product over the whole card, then the windowed walk: the walk's
    # wide passes and row loop (cycles, then passes and rows) and the rest of it
    # (state in and out); "product only" and "walk only" drop the other
    # launch (the walk then reads the block the last launch left)
    ("walk", ("wide passes", "row loop", "wide pass count",
              "row loop rows", "prologue and epilogue"), [
        ("  const long long l = blockIdx.x;\n  W walk;\n",
         "  const long long l = blockIdx.x;\n  W walk;\n"
         "  const long long lap0 = clock64();\n"
         "  long long lw = 0, ln = 0, nw = 0, nn = 0;\n"),
        ("    if (f < kCloseRows) cur = walk.rows(cur);\n",
         "    if (f < kCloseRows) {\n      const long long t_ = clock64();\n"
         "      const int c0_ = cur;\n      cur = walk.rows(cur);\n"
         "      ln += clock64() - t_;\n      nn += cur - c0_;\n    }\n"),
        ("    const int f = walk.template pass<kWide>(cur);\n",
         "    const long long t_ = clock64();\n"
         "    const int f = walk.template pass<kWide>(cur);\n"
         "    lw += clock64() - t_;\n    ++nw;\n"),
        ("    if (c < r) state_out[l * r + c] = walk.s[j];\n  }\n}\n",
         "    if (c < r) state_out[l * r + c] = walk.s[j];\n  }\n"
         "  if (threadIdx.x == 0) {\n    gains[l * B] = (float)lw;\n"
         "    gains[l * B + 1] = (float)ln;\n    gains[l * B + 2] = (float)nw;\n"
         "    gains[l * B + 3] = (float)nn;\n"
         "    gains[l * B + 4] = (float)(clock64() - lap0 - lw - ln);\n  }\n}\n"),
    ], (("product only", [("  switch (per) {\n    REPRO_WALK_CASE(0)",
                           "  if (per >= 0) return cudaSuccess;\n"
                           "  switch (per) {\n    REPRO_WALK_CASE(0)")]),
        ("walk only", [("  if (tiles > 0) {\n", "  if (tiles < 0) {\n")]))),
)


def reference_sweep_laps(tmp: Path, csrc: Path):
    """(design, lap names, {source: {variant: launch fn}}) for the tree
    ``csrc``: facility_accept and exemplar_accept built as they are
    (``shipped``) and with the design's clock64 laps (``laps``)."""
    text = (csrc / "reference_tile.cuh").read_text()
    for design, names, patch, others in REFTILE_LAPS:
        if all(old in text for old, _ in patch):
            break
    else:
        raise RuntimeError(f"{csrc}: no laps patch fits reference_tile.cuh")
    fns = {}
    for source in ("facility_accept", "exemplar_accept"):
        sub = tmp / f"{csrc.name}_{design.replace(' ', '_')}_{source}"
        sub.mkdir(parents=True)
        fns[source] = build(sub, source, "reference_tile.cuh",
                            (("shipped", []), ("laps", patch), *others), csrc)
    return design, names, fns


def probe_reference_sweeps(tmp: Path, trees: dict, g, dev, stream):
    """Time facility_accept and exemplar_accept of each tree ({label: csrc})
    at chip_smoke.py's path case (L = 37, B = 128, r = d = 256, f32,
    quantile taus, budget 3 in every fifth lane) and with tau = -inf and
    budget B (every eligible row accepted), and print each laps build's
    cycles per phase (slowest lane and mean) and the accepts per lane."""
    L, B, R, D = 37, 128, 256, 256
    lanes = torch.arange(L, device=dev)
    cand = torch.rand((L, B, D), generator=g, device=dev) ** 2
    Rm = torch.rand((R, D), generator=g, device=dev)
    refsq = (Rm * Rm).sum(-1)
    elig = torch.rand((L, B), generator=g, device=dev) < 0.9
    states = {"facility_accept": torch.rand((L, R), generator=g, device=dev)
              * D / 4,
              "exemplar_accept": refsq * torch.rand((L, R), generator=g,
                                                    device=dev)}
    marg = {"facility_accept": ref.facility_marginals,
            "exemplar_accept": ref.exemplar_marginals}
    q = torch.linspace(0.05, 0.95, L, device=dev)
    mask = torch.empty((L, B), dtype=torch.bool, device=dev)
    st_out = torch.empty((L, R), device=dev)
    gains = torch.empty((L, B), device=dev)
    work = torch.empty((L, B, R), device=dev)
    bmm = cuda_ms(lambda: torch.matmul(cand, Rm.T), 50)
    print(f"[probe] torch.matmul of the sweeps' product ({L}, {B}, {D}) x "
          f"({D}, {R}): {bmm} ms", flush=True)
    for label, csrc in trees.items():
        design, names, fns = reference_sweep_laps(tmp, csrc)
        for source, variants in fns.items():
            state = states[source].contiguous()
            g0 = marg[source](cand, Rm, state)
            cases = (("path taus", torch.stack(
                         [g0[l].quantile(q[l]) for l in range(L)]),
                      torch.where(lanes % 5 == 0, 3, 64)),
                     ("tau=-inf", torch.full((L,), float("-inf"),
                                             device=dev),
                      torch.full((L,), B)))
            for case, tau, budget in cases:
                tau = tau.contiguous()
                budget = budget.to(device=dev, dtype=torch.int32)
                extra = ((refsq.data_ptr(),) if source == "exemplar_accept"
                         else ())

                def call(fn):
                    return lambda: fn(
                        cand.data_ptr(), 0, Rm.data_ptr(), *extra,
                        state.data_ptr(), elig.data_ptr(), tau.data_ptr(),
                        budget.data_ptr(), None, None, mask.data_ptr(),
                        st_out.data_ptr(), gains.data_ptr(), work.data_ptr(),
                        L, B, R, D, 1, stream)

                ms = {v: cuda_ms(call(fn), 50) for v, fn in variants.items()}
                call(variants["laps"])()  # decides as shipped
                torch.cuda.synchronize()
                acc = mask.sum(-1)
                cyc = gains[:, :len(names)].double()
                slow = int(cyc.sum(-1).argmax())
                laps = "; ".join(
                    f"{who}: " + ", ".join(f"{n} {float(c):.0f}"
                                           for n, c in zip(names, row))
                    for who, row in ((f"slowest lane {slow}", cyc[slow]),
                                     ("mean", cyc.mean(0))))
                times = ", ".join(f"{v} {t} ms" for v, t in ms.items())
                if "product only" in variants and case == "path taus":
                    # 264 CTAs: two on every SM of the card
                    n = 33
                    lanes_ms = cuda_ms(lambda: variants["product only"](
                        cand[:n].data_ptr(), 0, Rm.data_ptr(), *extra,
                        state.data_ptr(), elig.data_ptr(), tau.data_ptr(),
                        budget.data_ptr(), None, None, mask.data_ptr(),
                        st_out.data_ptr(), gains.data_ptr(),
                        work.data_ptr(), n, B, R, D, 1, stream), 50)
                    times += f", product only at L={n} {lanes_ms} ms"
                print(f"[probe] {label} ({design}) {source} x({L}, {B}, {D}) "
                      f"r={R} {case}: {times}; accepts per lane min "
                      f"{int(acc.min())} mean {float(acc.float().mean()):.2f}"
                      f" max {int(acc.max())}; cycles {laps}", flush=True)


#: clock64 laps of the lane walk (lane_rows.cuh), the walk of
#: coverage_marginals.cu and saturated_coverage_marginals.cu: (design, lap
#: names, [(text, replacement)]) for each design of the walk; the probe
#: takes the patch whose anchors the tree's lane_rows.cuh holds.  Thread 0
#: of each CTA adds its staging cycles and a count of CTAs, lane 0 of each
#: warp its term-loop and reduction cycles and its count of rows (row walk)
#: or of 32-output tiles (register tile), into ``lane_rows::laps`` with
#: atomics; the laps build exports ``lane_rows_laps(dst, reset)``, which
#: copies the five sums out and, when ``reset``, clears them.
LANE_LAPS_GETTER = (
    "}  // namespace lane_rows\n",
    "}  // namespace lane_rows\n\n"
    "extern \"C\" int lane_rows_laps(unsigned long long* dst, int reset) {\n"
    "  cudaError_t e = cudaMemcpyFromSymbol(dst, lane_rows::laps,\n"
    "                                       sizeof(lane_rows::laps));\n"
    "  if (e == cudaSuccess && reset) {\n"
    "    unsigned long long z[5] = {0, 0, 0, 0, 0};\n"
    "    e = cudaMemcpyToSymbol(lane_rows::laps, z, sizeof(z));\n"
    "  }\n  return (int)e;\n}\n")
#: the register tile's CTA-end: its shared lap sums into ``laps``
LAPS_OUT = ("  __syncthreads();\n  if (threadIdx.x == 0)\n"
            "    for (int i = 0; i < 3; ++i) atomicAdd(&laps[2 + i], "
            "lap_sm[i]);\n")
LANE_ROWS_LAPS = (
    # one warp a row against every lane of its CTA's block, a butterfly
    # per lane (the first port's walk)
    ("row walk", [
        ("namespace lane_rows {\n",
         "namespace lane_rows {\n\n__device__ unsigned long long laps[5];\n"),
        ("  extern __shared__ float smem[];\n",
         "  extern __shared__ float smem[];\n"
         "  const long long lap0 = clock64();\n"
         "  long long lt = 0, lr = 0, nrow = 0;\n"),
        ("  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;\n",
         "  if (threadIdx.x == 0) {\n"
         "    atomicAdd(&laps[0], (unsigned long long)(clock64() - lap0));\n"
         "    atomicAdd(&laps[1], 1ull);\n  }\n"
         "  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;\n"),
        ("      float acc[kMaxLanes];\n",
         "      const long long t0_ = clock64();\n"
         "      float acc[kMaxLanes];\n"),
        ("#pragma unroll\n      for (int j = 0; j < kMaxLanes; ++j) {\n"
         "        float v = acc[j];\n",
         "      const long long t1_ = clock64();\n      lt += t1_ - t0_;\n"
         "#pragma unroll\n      for (int j = 0; j < kMaxLanes; ++j) {\n"
         "        float v = acc[j];\n"),
        ("        if (lane == 0 && j < nl) out[(long long)(l0 + j) * C + row]"
         " = v;\n      }\n",
         "        if (lane == 0 && j < nl) out[(long long)(l0 + j) * C + row]"
         " = v;\n      }\n      lr += clock64() - t1_;\n      ++nrow;\n"),
        ("    }\n  }\n}\n\n// Launch the walk",
         "    }\n  }\n  if (lane == 0) {\n"
         "    atomicAdd(&laps[2], (unsigned long long)lt);\n"
         "    atomicAdd(&laps[3], (unsigned long long)lr);\n"
         "    atomicAdd(&laps[4], (unsigned long long)nrow);\n  }\n}\n\n"
         "// Launch the walk"),
        LANE_LAPS_GETTER,
    ]),
    # a warp's register tile of 32 outputs, one reduce-scatter:
    # laps summed in shared memory, added to ``laps`` once a CTA
    ("register tile", [
        ("namespace lane_rows {\n",
         "namespace lane_rows {\n\n__device__ unsigned long long laps[5];\n"
         "__shared__ unsigned long long lap_sm[3];\n"),
        ("  float acc[N];  // acc[j * R + r]\n",
         "  const long long t0_ = clock64();\n"
         "  float acc[N];  // acc[j * R + r]\n"),
        ("  const float v = Scatter<N, 16>::run(acc, lane);\n",
         "  const long long t1_ = clock64();\n"
         "  const float v = Scatter<N, 16>::run(acc, lane);\n"),
        ("    if (r >= first) ob[j * C + r] = v;\n  }\n}\n",
         "    if (r >= first) ob[j * C + r] = v;\n  }\n"
         "  if (lane == 0) {\n"
         "    atomicAdd(&lap_sm[0], (unsigned long long)(t1_ - t0_));\n"
         "    atomicAdd(&lap_sm[1], (unsigned long long)(clock64() - t1_));\n"
         "    atomicAdd(&lap_sm[2], 1ull);\n  }\n}\n"),
        ("  stage(state, rule, l0, nl, d, sp, op);\n",
         "  const long long lap0 = clock64();\n"
         "  if (threadIdx.x == 0) lap_sm[0] = lap_sm[1] = lap_sm[2] = 0;\n"
         "  stage(state, rule, l0, nl, d, sp, op);\n"
         "  if (threadIdx.x == 0) {\n"
         "    atomicAdd(&laps[0], (unsigned long long)(clock64() - lap0));\n"
         "    atomicAdd(&laps[1], 1ull);\n  }\n"),
        ("  stage(state, rule, l, 1, d, sp, op);\n",
         "  const long long lap0 = clock64();\n"
         "  if (threadIdx.x == 0) lap_sm[0] = lap_sm[1] = lap_sm[2] = 0;\n"
         "  stage(state, rule, l, 1, d, sp, op);\n"
         "  if (threadIdx.x == 0) {\n"
         "    atomicAdd(&laps[0], (unsigned long long)(clock64() - lap0));\n"
         "    atomicAdd(&laps[1], 1ull);\n  }\n"),
        ("      default: tile<32, 1, T, Rule>(xb, first, spl, op, d, lane, ob, "
         "C);\n    }\n  }\n}\n",
         "      default: tile<32, 1, T, Rule>(xb, first, spl, op, d, lane, ob, "
         "C);\n    }\n  }\n" + LAPS_OUT + "}\n"),
        ("                        out + (long long)l * C + start, C);\n  }\n}\n",
         "                        out + (long long)l * C + start, C);\n  }\n"
         + LAPS_OUT + "}\n"),
        LANE_LAPS_GETTER,
    ]),
)
#: patches of each design: the Coverage term without its square root (what
#: the SFU and the IEEE fix-up cost), and a term that is x alone (the
#: walk's x loads, loop and reductions, no state or operand loads), for
#: {design: (no_sqrt, {source: x_only})}
WALK_PROBES = {
    "row walk": (
        [("    return (sqrtf(s + x) - pre) * ops[0];",
          "    return ((s + x) - pre) * ops[0];")],
        {"coverage_marginals": [("    return (sqrtf(s + x) - pre) * ops[0];",
                                 "    return x;")],
         "saturated_coverage_marginals": [
             ("    return (fminf(s + x, ops[0]) - pre) * ops[1];",
              "    return x;")]}),
    "register tile": (
        [("      sqrt_rn<N>(q);\n", "")],
        dict.fromkeys(
            ("coverage_marginals", "saturated_coverage_marginals"),
            [("          acc[j * R + r] += Rule::root_term(q[j * R + r], "
              "p[j].y, ops);", "          acc[j * R + r] += xv[r];"),
             ("          acc[j * R + r] += Rule::term(p[j].x, p[j].y, xv[r], "
              "ops);", "          acc[j * R + r] += xv[r];")])),
}
#: (label, lanes, rows a lane, per-lane x) of the lane walk's launches on
#: the main path: chip_smoke.py's FILTER_SHAPES, the corpus filter and the
#: partition matroid's one-row scan
LANE_WALK_SHAPES = (("filter", 37, 1 << 20, False),
                    ("sample", 37, 98_560, False),
                    ("one lane", 1, 1 << 20, False),
                    ("survivors", 37, 34_048, True),
                    ("chunk", 37, 128, True),
                    ("one row", 37, 1, True))
#: SASS opcodes counted in the lane walk's kernels
SASS_OPS = ("FADD", "FFMA", "FMUL", "FMNMX", "MUFU", "LDS", "LDG", "STG",
            "SHFL", "SEL", "FSEL", "IMAD", "IADD3", "ISETP", "BRA", "CALL")


def sass_functions(lib_path: Path, marker: str) -> dict:
    """{kernel name: its SASS} of the kernels of a library whose mangled
    name holds ``marker`` (empty without cuobjdump)."""
    cuobjdump = Path(_build.nvcc_path()).with_name("cuobjdump")
    if not cuobjdump.exists():
        return {}
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib_path)],
                          capture_output=True, text=True).stdout
    return {fn.split(None, 1)[0]: fn for fn in sass.split("Function : ")[1:]
            if marker in fn.split(None, 1)[0]}


def sass_mix(fn_sass: str) -> dict:
    """Counts of SASS_OPS (by the opcode before its first dot) in one
    kernel's SASS, and the total under "all"."""
    ops = [[t for t in ln.split(";")[0].split()[1:]
            if not t.startswith("@")][0].split(".")[0]
           for ln in fn_sass.splitlines()
           if ln.strip().startswith("/*") and ";" in ln]
    return {"all": len(ops), **{op: ops.count(op) for op in SASS_OPS}}


def under_load(what, launch, seconds=3.0):
    """Run ``launch`` back to back for ``seconds`` while sampling the SM
    clock, power draw and throttle reasons with nvidia-smi; print them."""
    samples, stop = [], threading.Event()

    def sample():
        while not stop.is_set():
            samples.append(smi("clocks.sm,power.draw,"
                               "clocks_throttle_reasons.active"))
            time.sleep(0.25)

    thread = threading.Thread(target=sample)
    thread.start()
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        for _ in range(20):
            launch()
        torch.cuda.synchronize()
    stop.set()
    thread.join()
    for s in samples[2:-1]:
        print(f"[probe] under {what}: sm clock, power, throttle reasons = "
              f"{s}", flush=True)


def probe_lane_walk(tmp: Path, trees: dict, g, dev, stream,
                    sass_dir: Path | None = None):
    """Time coverage_marginals and saturated_coverage_marginals of each
    tree ({label: csrc}) at LANE_WALK_SHAPES (f32), as built (``shipped``),
    without coverage's square root (``no_sqrt``), with the term x alone
    (``x_only``) and with clock64 laps (``laps``: staging cycles a CTA,
    term-loop and reduction cycles a row or tile of each warp); print each
    build's registers and spills (ptxas) and the lane walk kernels' SASS
    mix, and write their SASS under ``sass_dir`` when given."""
    N = max(C for _, _, C, per in LANE_WALK_SHAPES if not per)
    F = max(C for _, _, C, per in LANE_WALK_SHAPES if per)
    Lmax = max(lanes for _, lanes, _, _ in LANE_WALK_SHAPES)
    D = 256
    X = torch.rand((N, D), generator=g, device=dev) ** 2
    Xs = torch.rand((Lmax, F, D), generator=g, device=dev) ** 2
    cap = torch.rand(D, generator=g, device=dev) * 2 + 0.25
    frac = torch.tensor([0.0, 0.5, 0.9, 1.0, 1.5], device=dev)
    laps = (ctypes.c_ulonglong * 5)()
    for label, csrc in trees.items():
        text = (csrc / "lane_rows.cuh").read_text()
        for design, patch in LANE_ROWS_LAPS:
            if all(old in text for old, _ in patch):
                break
        else:
            raise RuntimeError(f"{csrc}: no laps patch fits lane_rows.cuh")
        for source in ("coverage_marginals", "saturated_coverage_marginals"):
            no_sqrt, x_only = WALK_PROBES[design]
            variants = [("shipped", []), ("x_only", x_only[source]),
                        ("laps", patch)]
            if source == "coverage_marginals":
                variants.insert(1, ("no_sqrt", no_sqrt))
            sub = tmp / f"lane_{label.replace(' ', '_')}_{source}"
            sub.mkdir(parents=True)
            logs = {}
            fns = build(sub, source, ("lane_rows.cuh", "feature_rules.cuh"),
                        variants, csrc, logs)
            entry = None
            for line in logs["shipped"].splitlines():
                if "Compiling entry function" in line:
                    entry = line.split("'")[1]
                elif "Used" in line and entry and "lane_rows" in entry:
                    print(f"[probe] {label} ({design}) {source} ptxas "
                          f"{entry}: {line.split(':', 1)[1].strip()}")
                elif "spill" in line and entry and "lane_rows" in entry:
                    print(f"[probe] {label} {source} ptxas {entry}: "
                          f"{line.strip()}")
            lib_path = sub / f"{source}_shipped" / "lib.so"
            for name, fn_sass in sass_functions(lib_path,
                                                "lane_rows").items():
                print(f"[probe] {label} {source} sass {name}: "
                      f"{sass_mix(fn_sass)}")
                if sass_dir is not None:
                    sass_dir.mkdir(parents=True, exist_ok=True)
                    tag = label.replace(" ", "_")
                    with (sass_dir / f"{tag}_{source}.sass").open("a") as f:
                        f.write("Function : " + fn_sass)
            get = fns["laps"].lib.lane_rows_laps
            get.argtypes, get.restype = [ctypes.c_void_p, ctypes.c_int], \
                ctypes.c_int
            for shape, lanes, C, per_lane in LANE_WALK_SHAPES:
                x = Xs[:lanes, :C].contiguous() if per_lane else X[:C]
                if source == "coverage_marginals":
                    st = torch.rand((lanes, D), generator=g, device=dev) * 4
                    extra = ()
                else:
                    st = frac[torch.randint(0, 5, (lanes, D), generator=g,
                                            device=dev)] * cap
                    extra = (cap.data_ptr(),)
                st = st.contiguous()
                out = torch.empty((lanes, C), device=dev)

                def call(fn):
                    return lambda: fn(x.data_ptr(), 0, int(per_lane),
                                      st.data_ptr(), *extra, None,
                                      out.data_ptr(), lanes, C, D, stream)

                iters = 10 if lanes * C > 1 << 20 else 50
                ms = {v: cuda_ms(call(fn), iters) for v, fn in fns.items()}
                if shape == "filter" and label == "this tree":
                    under_load(f"the {source} filter launches",
                               call(fns["shipped"]), 2.0)
                get(ctypes.addressof(laps), 1)
                call(fns["laps"])()
                torch.cuda.synchronize()
                get(ctypes.addressof(laps), 1)
                stage, ctas, term, red, items = (int(v) for v in laps)
                times = ", ".join(f"{v} {t} ms" for v, t in ms.items())
                print(f"[probe] {label} ({design}) {source} {shape} "
                      f"x{tuple(x.shape)} L={lanes}: {times}; laps: staging "
                      f"{stage / max(ctas, 1):.0f} cycles a CTA ({ctas} "
                      f"CTAs), term loop {term / max(items, 1):.0f} and "
                      f"reductions and stores {red / max(items, 1):.0f} "
                      f"cycles an item ({items} items; term loop "
                      f"{100 * term / max(term + red, 1):.1f} % of the "
                      f"warps' cycles)", flush=True)
                del out
    del X, Xs



#: the four feature sweeps (csrc/feature_sweep.cuh), by source
FEATURE_SWEEPS = ("coverage_accept", "weighted_coverage_accept",
                  "saturated_coverage_accept", "graph_cut_accept")
#: the feature sweeps' main path: chip_smoke.py's path case
FEATURE_PATH = (37, 128, 256)


def feature_sweep_case(name, L, B, d, dtype, g, dev, weighted=False):
    """(x, state, operands, gains0) of feature sweep ``name`` at (L, B, d)
    on chip_smoke.py's data (rows U[0, 1)^2; coverage states U[0, 4),
    weighted U[0, 2), saturated states at 0, 0.5, 0.9, 1 and 1.5 times a cap
    U[0.25, 2.25), graph cut a total U[0, 2^20 / 3) and states up to 1.2
    t / (2 lam), lam 0.5); ``operands`` are the launch's arguments between
    the state and ``eligible`` (weights with ``weighted``), gains0 every
    row's gain against the state (plain version)."""
    x = (torch.rand((L, B, d), generator=g, device=dev) ** 2).to(dtype)
    w = (torch.rand(d, generator=g, device=dev) + 0.5) if weighted else None
    if name == "coverage_accept":
        st = torch.rand((L, d), generator=g, device=dev) * 4
        ops, g0 = (w,), ref.coverage_marginals(x, st, w)
    elif name == "weighted_coverage_accept":
        st = torch.rand((L, d), generator=g, device=dev) * 2
        ops, g0 = (), ref.weighted_coverage_marginals(x, st)
    elif name == "saturated_coverage_accept":
        cap = torch.rand(d, generator=g, device=dev) * 2 + 0.25
        frac = torch.tensor([0.0, 0.5, 0.9, 1.0, 1.5], device=dev)
        st = frac[torch.randint(0, 5, (L, d), generator=g, device=dev)] * cap
        ops, g0 = (cap, w), ref.saturated_coverage_marginals(x, st, cap, w)
    else:
        t = torch.rand(d, generator=g, device=dev) * (1 << 20) / 3
        st = t * torch.rand((L, 1), generator=g, device=dev) * 1.2
        ops, g0 = (t, 0.5), ref.graph_cut_marginals(x, t, st, 0.5)
    return x, st.contiguous(), ops, g0


def feature_sweep_rules(L, B, g0, g, dev):
    """[(rule, tau, budget, cost, cost_budget)] of the feature sweeps'
    three rules: chip_smoke.py's path taus (each lane's quantile 0.05 ..
    0.95 of its first gains, budget 3 in every fifth lane, else 64), the
    knapsack cost mode (costs U[0.5, 2), tau over the mean cost, a cost
    budget of 2 in even lanes) and tau = -inf with the budget B (every
    eligible row accepted)."""
    lanes = torch.arange(L, device=dev)
    q = torch.linspace(0.05, 0.95, L, device=dev)

    def taus(gains):
        return torch.stack([gains[l].quantile(q[l])
                            for l in range(L)]).contiguous()

    path_budget = torch.where(lanes % 5 == 0, 3, 64).to(torch.int32)
    cost = (0.5 + 1.5 * torch.rand((L, B), generator=g, device=dev)
            ).contiguous()
    cb = torch.where(lanes % 2 == 0, 2.0, 1e9).to(torch.float32).contiguous()
    return [("path taus", taus(g0), path_budget, None, None),
            ("cost", taus(g0 / cost.mean()), path_budget, cost, cb),
            ("tau=-inf", torch.full((L,), float("-inf"), device=dev),
             torch.full((L,), B, dtype=torch.int32, device=dev), None, None)]


def feature_sweep_call(fn, x, st, ops, elig, tau, budget, cost, cb, outs,
                       stream, per=None):
    """A launch of a feature sweep's entry point ``fn`` (ctypes) on these
    operands into ``outs`` (mask, state, gains), at instance ``per`` (see
    _wrap.feature_sweep_instance; by default feature_sweep_per(d): the walk
    or the wide instance)."""
    L, B, d = x.shape
    per = _wrap.feature_sweep_per(d) if per is None else per
    args = [o if isinstance(o, float) else
            (None if o is None else o.data_ptr()) for o in ops]
    return lambda: fn(x.data_ptr(), int(x.dtype == torch.bfloat16),
                      st.data_ptr(), *args, elig.data_ptr(), tau.data_ptr(),
                      budget.data_ptr(),
                      None if cost is None else cost.data_ptr(),
                      None if cb is None else cb.data_ptr(),
                      *(o.data_ptr() for o in outs), L, B, d, per, stream)


#: clock64 laps of the feature sweeps' narrow instance: (design, lap names,
#: [(text, replacement)], the other variants) for each design; the probe
#: takes the patch whose anchors the tree's accept_sweep.cuh and
#: feature_sweep.cuh hold.  Every thread keeps its laps; thread 0 of each
#: CTA writes its sums over gains[l, :n] at the end, so the laps build's
#: gains are not the sweep's.  ``x resident`` drops the load of each next
#: row (every row is scored as row 0, in registers): the term-loop lap of
#: the two builds differs by the x-load stall.
FEATURE_LAPS = (
    # run_sweep's row loop, one butterfly and one barrier a row
    ("row loop", ("term loop", "butterfly", "barrier and warp sums",
                  "eligible / cost loads and decision", "accept",
                  "thread 0's stores"), [
        ("  int n_acc = 0;\n  float spent = 0.0f;\n"
         "  for (int i = 0; i < B; ++i) {\n    float p = step.partial(i);\n",
         "  int n_acc = 0;\n  float spent = 0.0f;\n"
         "  long long lp_[6] = {0, 0, 0, 0, 0, 0};\n"
         "  long long tc_ = clock64();\n"
         "#define REPRO_LAP(k) { const long long t_ = clock64(); "
         "lp_[k] += t_ - tc_; tc_ = t_; }\n"
         "  for (int i = 0; i < B; ++i) {\n    float p = step.partial(i);\n"
         "    REPRO_LAP(0)\n"),
        ("    if (lane == 0) partials[i & 1][warp] = p;\n",
         "    REPRO_LAP(1)\n    if (lane == 0) partials[i & 1][warp] = p;\n"),
        ("    bool acc;\n    if constexpr (kCost) {\n      const float c = "
         "cost[i];\n",
         "    REPRO_LAP(2)\n    bool acc;\n    if constexpr (kCost) {\n"
         "      const float c = cost[i];\n"),
        ("    if (acc) {\n      step.accept();\n",
         "    REPRO_LAP(3)\n    if (acc) {\n      step.accept();\n"),
        ("    if (threadIdx.x == 0) {\n      mask_out[i] = acc ? 1 : 0;\n"
         "      gains_out[i] = gain;\n    }\n  }\n}\n",
         "    REPRO_LAP(4)\n    if (threadIdx.x == 0) {\n"
         "      mask_out[i] = acc ? 1 : 0;\n      gains_out[i] = gain;\n    }\n"
         "    REPRO_LAP(5)\n  }\n  if (threadIdx.x == 0)\n"
         "    for (int k = 0; k < 6; ++k) gains_out[k] = (float)lp_[k];\n"
         "#undef REPRO_LAP\n}\n"),
    ], {"x resident": [("    load_row(i + 1, next);\n", "")]}),
    # the windowed walk: a pass's phases (cycles, summed over the passes
    # of both kinds), the row loop (cycles, and its rows), the passes, and
    # the rest (state in and out); the other variants move its constants
    ("walk", ("pass: x loads and shares", "pass: reduce-scatter",
              "pass: barrier and warp sums",
              "pass: decision, stores and accept", "row loop",
              "passes (count)", "row loop rows (count)",
              "prologue and epilogue"), [
        ("  int par = 0;\n",
         "  int par = 0;\n  long long lp_[4] = {0, 0, 0, 0};\n"
         "#define REPRO_LAP(k) { const long long t_ = clock64(); "
         "lp_[k] += t_ - tc_; tc_ = t_; }\n"),
        ("    const int ra = lane >> kShift, row = cur + ra;\n",
         "    long long tc_ = clock64();\n"
         "    const int ra = lane >> kShift, row = cur + ra;\n"),
        ("    shares<kRows>(s, pre, v, p);\n",
         "    shares<kRows>(s, pre, v, p);\n    REPRO_LAP(0)\n"),
        ("                      ? r[0][j] : Rule::pre(hs[j], ops[j]);\n"
         "        }\n    }\n",
         "                      ? r[0][j] : Rule::pre(hs[j], ops[j]);\n"
         "        }\n    }\n    REPRO_LAP(0)\n"),
        ("    part[par][warp][ra] = Scatter<kRows, 16>::run(p, lane);\n",
         "    part[par][warp][ra] = Scatter<kRows, 16>::run(p, lane);\n"
         "    REPRO_LAP(1)\n"),
        ("    const bool acc = e && mode.passes(gain, op) && mode.fits(op);\n"
         "    const unsigned bal",
         "    REPRO_LAP(2)\n"
         "    const bool acc = e && mode.passes(gain, op) && mode.fits(op);\n"
         "    const unsigned bal"),
        ("    const bool hoped_in = fit >> ra & 1;\n",
         "    REPRO_LAP(2)\n    const bool hoped_in = fit >> ra & 1;\n"),
        ("    return first;\n  }\n",
         "    REPRO_LAP(3)\n    return first;\n  }\n"),
        ("    return surprise;\n  }\n",
         "    REPRO_LAP(3)\n    return surprise;\n  }\n"),
        ("  for (int cur = 0, width = kWide; cur < B;) {\n",
         "  const long long lap0 = clock64();\n"
         "  long long ln = 0, nw = 0, nn = 0;\n"
         "  for (int cur = 0, width = kWide; cur < B;) {\n"),
        ("    cur += f < width ? f + 1 : width;\n",
         "    ++nw;\n    cur += f < width ? f + 1 : width;\n"),
        ("      cur = walk.row_loop(cur, took, hits);\n",
         "      const long long t_ = clock64();\n      const int c0_ = cur;\n"
         "      cur = walk.row_loop(cur, took, hits);\n"
         "      ln += clock64() - t_;\n      nn += cur - c0_;\n"),
        ("    if (walk.owns(j)) state_out[l * d + threadIdx.x + j * kThreads] = "
         "walk.s[j];\n}\n",
         "    if (walk.owns(j)) state_out[l * d + threadIdx.x + j * kThreads] = "
         "walk.s[j];\n"
         "  if (threadIdx.x == 0) {\n    long long lw = 0;\n"
         "    for (int k = 0; k < 4; ++k) {\n"
         "      gains[l * B + k] = (float)walk.lp_[k];\n"
         "      lw += walk.lp_[k];\n    }\n"
         "    gains[l * B + 4] = (float)ln;\n"
         "    gains[l * B + 5] = (float)nw;\n"
         "    gains[l * B + 6] = (float)nn;\n"
         "    gains[l * B + 7] = (float)(clock64() - lap0 - lw - ln);\n"
         "  }\n}\n"),
    ], {"close 4": [("constexpr int kCloseRows = 8;",
                     "constexpr int kCloseRows = 4;")],
        "hits 4": [("constexpr int kHits = 6;", "constexpr int kHits = 4;")],
        "hits 8": [("constexpr int kHits = 6;", "constexpr int kHits = 8;")],
        "dense misses 8": [("constexpr int kMissesDense = 16;",
                            "constexpr int kMissesDense = 8;")],
        "never hopeful": [("constexpr int kHits = 6;",
                           "constexpr int kHits = 1 << 30;")],
        "tree 1": [("  return kPer <= 8 ? 2 : 1;", "  return 1;")],
        # bf16 reads predicated as the f32 ones
        "bf16 predicated": [("      if constexpr (std::is_same<T, float>::"
                             "value) {\n        v[j] =",
                             "      if constexpr (true) {\n        v[j] ="),
                            ("        if constexpr (std::is_same<T, float>::"
                             "value) {\n#pragma unroll",
                             "        if constexpr (true) {\n#pragma unroll")]}),
)


def feature_sweep_laps(tmp: Path, label: str, csrc: Path):
    """(design, lap names, {source: {variant: launch fn}}) for the tree
    ``csrc``: the four feature sweeps as they are (``shipped``), with the
    design's clock64 laps (``laps``), and each other variant of the design
    alone and with the laps."""
    texts = "".join((csrc / f).read_text()
                    for f in ("accept_sweep.cuh", "feature_sweep.cuh"))
    # the newest design first: the walk's tree keeps run_sweep for the
    # wide instance
    for design, names, patch, others in reversed(FEATURE_LAPS):
        if all(old in texts for old, _ in patch):
            break
    else:
        raise RuntimeError(f"{csrc}: no laps patch fits feature_sweep.cuh")
    variants = [("shipped", []), ("laps", patch)]
    for name, other in others.items():
        variants.append((name, other))
        if design == "row loop":
            variants.append((f"laps, {name}", patch + other))
    fns = {}
    for source in FEATURE_SWEEPS:
        sub = tmp / f"feature_{label.replace(' ', '_')}_{source}"
        sub.mkdir(parents=True)
        fns[source] = build(sub, source,
                            ("accept_sweep.cuh", "feature_sweep.cuh"),
                            [(v.replace(" ", "_").replace(",", ""), p)
                             for v, p in variants], csrc)
    return design, names, fns


#: the SASS opcodes whose order feature_sweep_order prints
ORDER_OPS = ("LDG", "BAR", "SHFL", "LDS", "STS", "STG", "MUFU", "VOTE", "BRA")


def feature_sweep_order(lib_path: Path) -> dict:
    """{kernel: the order of ORDER_OPS in its SASS, run-length coded} for
    the narrow f32 kernels at 2 features a thread (the path case's
    instance) of a feature sweep library: where the x and eligibility
    loads sit against the barrier and the shuffles."""
    out = {}
    for name, fn_sass in sass_functions(lib_path, "feature_sweep").items():
        if "IfLi2E" not in name or "wide" in name:
            continue
        seq = []
        for ln in fn_sass.splitlines():
            if not (ln.strip().startswith("/*") and ";" in ln):
                continue
            op = [tok for tok in ln.split(";")[0].split()[1:]
                  if not tok.startswith("@")][0].split(".")[0]
            if op not in ORDER_OPS:
                continue
            if seq and seq[-1][0] == op:
                seq[-1][1] += 1
            else:
                seq.append([op, 1])
        out[name] = " ".join(op if n == 1 else f"{op}x{n}" for op, n in seq)
    return out


def probe_feature_sweeps(tmp: Path, trees: dict, g, dev, stream,
                         sass_dir: Path | None = None):
    """Time the four feature sweeps of each tree ({label: csrc}) at
    chip_smoke.py's path case (FEATURE_PATH, f32, and the same rows in
    bf16) in their three rules (feature_sweep_rules) as built and as each
    variant of the design, and
    print each laps build's cycles a row by phase (slowest lane and the
    mean over lanes) and the accepts per lane."""
    L, B, D = FEATURE_PATH
    elig = torch.rand((L, B), generator=g, device=dev) < 0.9
    outs = (torch.empty((L, B), dtype=torch.bool, device=dev),
            torch.empty((L, D), device=dev), torch.empty((L, B), device=dev))
    cases = {}
    for source in FEATURE_SWEEPS:
        x, st, ops, g0 = feature_sweep_case(source, L, B, D, torch.float32,
                                            g, dev)
        cases[source] = (x, st, ops, feature_sweep_rules(L, B, g0, g, dev))
    for label, csrc in trees.items():
        design, names, fns = feature_sweep_laps(tmp, label, csrc)
        for source, variants in fns.items():
            lib_path = Path(variants["shipped"].lib._name)
            for kernel, order in feature_sweep_order(lib_path).items():
                print(f"[probe] {label} ({design}) {source} sass order "
                      f"{kernel}: {order}", flush=True)
            if sass_dir is not None:
                sass_dir.mkdir(parents=True, exist_ok=True)
                tag = label.replace(" ", "_")
                with (sass_dir / f"{tag}_{source}.sass").open("w") as f:
                    for name, fn_sass in sass_functions(
                            lib_path, "feature_sweep").items():
                        if "IfLi2E" in name and "wide" not in name:
                            f.write("Function : " + fn_sass)
            x32, st, ops, rules = cases[source]
            for (rule, tau, budget, cost, cb), (x, tag) in (
                    (r, xt) for xt in ((x32, ""),
                                       (x32.to(torch.bfloat16), " bf16"))
                    for r in rules):
                rule += tag

                def call(fn):
                    return feature_sweep_call(fn, x, st, ops, elig, tau,
                                              budget, cost, cb, outs, stream)

                ms = {v: cuda_ms(call(fn), 50) for v, fn in variants.items()}
                call(variants["shipped"])()
                torch.cuda.synchronize()
                acc = outs[0].sum(-1)
                times = ", ".join(f"{v} {t} ms" for v, t in ms.items())
                print(f"[probe] {label} ({design}) {source} x({L}, {B}, {D}) "
                      f"{rule}: {times}; accepts per lane min "
                      f"{int(acc.min())} mean {float(acc.float().mean()):.2f}"
                      f" max {int(acc.max())}", flush=True)
                for v in variants:
                    if not v.startswith("laps"):
                        continue
                    call(variants[v])()  # decides as shipped, but x resident
                    torch.cuda.synchronize()
                    cyc = outs[2][:, :len(names)].double()
                    count = torch.tensor(["count" in n for n in names],
                                         device=dev)
                    total = torch.where(count, 0.0, cyc).sum(-1)
                    slow = int(total.argmax())
                    laps = "; ".join(
                        f"{who}: {float(tot) / B:.0f} cycles a row ("
                        + ", ".join(f"{n} {float(c) if k else float(c) / B:.1f}"
                                    for n, c, k in zip(names, row, count))
                        + ")"
                        for who, row, tot in (
                            (f"slowest lane {slow}", cyc[slow], total[slow]),
                            ("mean", cyc.mean(0), total.mean())))
                    print(f"[probe] {label} ({design}) {source} {rule} {v}: "
                          f"cycles {laps}", flush=True)


def main() -> int:
    args, only, sass_dir = sys.argv[1:], None, None
    while args[:1] in (["--only"], ["--sass-dir"]) and len(args) >= 2:
        if args[0] == "--only":
            only = args[1]
        else:
            sass_dir = Path(args[1])
        args = args[2:]
    if len(args) > 1 or (args and not Path(args[0]).is_dir()) or \
            only not in (None, "lane_walk", "feature_sweeps"):
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("tile_probe: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    trees = {"this tree": _build.CSRC}
    if args:
        trees = {"base": Path(args[0]), **trees}
    if only is not None:
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
        with tempfile.TemporaryDirectory() as tmp:
            if only == "lane_walk":
                probe_lane_walk(Path(tmp), trees, g, dev, stream, sass_dir)
            else:
                probe_feature_sweeps(Path(tmp), trees, g, dev, stream,
                                     sass_dir)
        print(smi("name,power.limit"))
        return 0
    N, D, R, L = 1 << 20, 256, 256, 37
    X = torch.rand((N, D), generator=g, device=dev) ** 2
    Xp = torch.rand((L, 128, D), generator=g, device=dev) ** 2
    Rm = torch.rand((R, D), generator=g, device=dev)
    with tempfile.TemporaryDirectory() as tmp:
        fns = build(Path(tmp), "facility_marginals", "marginals_tile.cuh",
                    TILE_VARIANTS)
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
        shapes = (("filter", X, 0, L), ("one lane", X, 0, 1),
                  ("per-lane chunk", Xp, 1, L))
        for label, cand, per_lane, lanes in shapes:
            C = cand.shape[-2]
            st = (torch.rand((lanes, R), generator=g, device=dev) * D / 4
                  ).contiguous()
            out = torch.empty((lanes, C), device=dev)
            for name, fn in fns.items():
                call = lambda: fn(cand.data_ptr(), 0, per_lane,  # noqa: E731
                                  Rm.data_ptr(), st.data_ptr(),
                                  out.data_ptr(), lanes, C, R, D, stream)
                ms = cuda_ms(call, 50 if per_lane else 10)
                print(f"[probe] {label} cand{tuple(cand.shape)} L={lanes} "
                      f"{name}: {ms} ms")
        gc_fns = build(Path(tmp), "graph_cut_marginals", "skinny_tile.cuh",
                       SKINNY_VARIANTS)
        wc_fns = build(Path(tmp), "weighted_coverage_marginals",
                       "skinny_tile.cuh", SKINNY_VARIANTS)
        t = X.sum(0)
        st = (t * torch.rand((L, 1), generator=g, device=dev)).contiguous()
        st_wc = torch.rand((L, D), generator=g, device=dev) * 2
        out = torch.empty((L, N), device=dev)
        for dtype in (torch.float32, torch.bfloat16):
            Xd = X.to(dtype)
            bf = int(dtype == torch.bfloat16)
            for name, fn in gc_fns.items():
                call = lambda: fn(Xd.data_ptr(), bf, 0,  # noqa: E731
                                  st.data_ptr(), t.data_ptr(), 0.5,
                                  out.data_ptr(), L, N, D, stream)
                ms = cuda_ms(call, 10)
                print(f"[probe] graph_cut filter x{tuple(Xd.shape)} "
                      f"{str(dtype)[6:]} L={L} {name}: {ms} ms")
            for name, fn in wc_fns.items():
                call = lambda: fn(Xd.data_ptr(), bf, 0,  # noqa: E731
                                  st_wc.data_ptr(), out.data_ptr(), L, N, D,
                                  stream)
                ms = cuda_ms(call, 10)
                print(f"[probe] weighted_coverage filter x{tuple(Xd.shape)} "
                      f"{str(dtype)[6:]} L={L} {name}: {ms} ms")
            del Xd
        probe_logdet_accept(build(Path(tmp), "logdet_accept",
                                  "logdet_accept.cu",
                                  LA_VARIANTS + (("laps", LAPS_PATCH),)),
                            g, dev, stream)
        probe_reference_sweeps(Path(tmp), trees, g, dev, stream)
        probe_feature_sweeps(Path(tmp), trees, g, dev, stream)
        probe_lane_walk(Path(tmp), trees, g, dev, stream, sass_dir)
        st = (torch.rand((L, R), generator=g, device=dev) * D / 4).contiguous()
        shipped = fns["shipped"]
        under_load("the facility filter launches", lambda: shipped(
            X.data_ptr(), 0, 0, Rm.data_ptr(), st.data_ptr(),
            out.data_ptr(), L, N, R, D, stream))
    print(smi("name,power.limit"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
