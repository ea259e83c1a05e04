#!/usr/bin/env python3
"""Compare two builds of the redesigned kernels on one card.

    PYTHONPATH=src python3 -m repro_torch.kernels.ab_compare
        [--only lane_walk | --only feature_sweeps] [--log FILE] BASE_CSRC
                    (from the root of a checkout, on a machine with a
                     CUDA card and nvcc)

BASE_CSRC is the ``src/repro_torch/kernels/csrc`` directory of another
checkout (for example the parent commit, unpacked with ``git archive``
into a directory that ``.gitignore`` lists).  The script builds
facility_marginals.cu, exemplar_marginals.cu, logdet_marginals.cu,
graph_cut_marginals.cu, weighted_coverage_marginals.cu, logdet_accept.cu,
facility_accept.cu, exemplar_accept.cu, coverage_marginals.cu,
saturated_coverage_marginals.cu and the four feature sweeps
(coverage_accept.cu, weighted_coverage_accept.cu,
saturated_coverage_accept.cu, graph_cut_accept.cu) from both trees
(``--only lane_walk``: the four kernels of the lane walk; ``--only
feature_sweeps``: the four feature sweeps, and the reference sweeps and
the lane walk's kernels for their SASS), in parallel, in a temporary
directory, and
runs both builds on the same inputs at the filter shape (L = 37 lanes,
C = 2^20 rows, d = r = 256, k_max = 64, f32 and bf16) and, for the
sweeps, at the fused engine's chunk (B = 128):

* facility and exemplar marginals, and log-det at the lane sizes
  chip_smoke.py uses (974 of 2368 basis rows live), with all 64 rows live,
  and unbatched at size 0 (the singleton passes): the two builds must give
  the same bits (a log-det build that takes sizes is run with them and
  without them, both must give the base's bits);
* graph cut and weighted coverage on their skinny tile: the same bits;
* logdet_accept at chip_smoke.py's path case (lane sizes 0 .. k, every
  third lane at k - 2 with tau = 0 so its appends run into k_max, tau a
  quantile of each lane's first gains from 0.05 to 0.95, budget 3 in
  every fifth lane), in the cardinality mode and in the knapsack cost
  mode (costs U[0.5, 2), tau over the mean cost, even lanes' budgets half
  the unbounded spend): mask, basis, logdet, size and gains, the same
  bits;
* facility_accept and exemplar_accept at chip_smoke.py's path case, at
  r = 1024, 4097 and 8192 (the wide instance) and at chip_smoke.py's odd
  shapes, f32 and bf16, with chip_smoke.py's taus, in the knapsack cost
  mode and at tau = -inf: mask, state and gains the same bits (a
  difference raises);
* the lane walk (csrc/lane_rows.cuh): coverage and saturated coverage
  marginals at every main-path shape (the corpus filter, the sample, one
  lane, the survivors, a chunk, the partition matroid's one row) and at
  every combination of d = 3, 45, 257, 2049, C = 1, 31, 33 and L = 1, 2,
  9, 130, both x modes, f32 and bf16, with weights and without, saturated
  states straddling the cap; weighted coverage and graph cut on the same
  shapes where they take the walk (one lane, per-lane x): the same bits,
  a repeated launch the same bits again (a difference raises); and
  rules::sqrt_rn against sqrtf on all 2^32 floats (a difference
  raises);
* the four feature sweeps (csrc/feature_sweep.cuh) at chip_smoke.py's
  path case (L = 37, B = 128, d = 256), its odd shapes (L = 1, B = 70,
  d = 45; L = 130, d = 70) and d = 1, 127, 129, 512, 1000 and 2048, f32
  and bf16, coverage and saturated coverage with weights and without, in
  four rules: the path taus, the knapsack cost mode, tau = -inf with the
  budget B, and budgets 0, 1 and 3 with every fourth lane ineligible; the
  new build at the instance the wrapper picks and at the other narrow one
  (the walk or the row loop): mask, state and gains the same bits, a
  repeated launch the same bits again (a difference raises), and the
  cases where the new build is more than 5 % slower than the base build.
``--log FILE`` sends every lane-walk and feature-sweep case's line there,
and stdout keeps the main shapes, the odd shapes where the new build was
slower and a count.

Each case is timed in turns, base, new, new, base (CUDA events over
back-to-back launches; the feature sweeps base, new, other, other, new,
base), so the builds meet the same clock and power state.  Where
cuobjdump is at hand it also says whether the two builds of the kernels
of SASS_KEPT (the facility and exemplar tile, the skinny tile of graph cut
and weighted coverage, the reference sweeps' walk and the lane walk) and
SASS_RENAMED (the feature sweeps' row loop against the base build's
narrow kernel) compiled to the same SASS, compared by body.  Last it prints
the card's name and power limit.  Imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import ctypes
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

from repro_torch.kernels import _build, _wrap, ref
from repro_torch.kernels.tile_probe import (
    FEATURE_PATH, FEATURE_SWEEPS, cuda_ms, feature_sweep_call,
    feature_sweep_case, feature_sweep_rules, smi)

NAMES = ("facility_marginals", "exemplar_marginals", "logdet_marginals",
         "graph_cut_marginals", "weighted_coverage_marginals",
         "logdet_accept", "facility_accept", "exemplar_accept",
         "coverage_marginals", "saturated_coverage_marginals",
         *FEATURE_SWEEPS)
#: (library, marker) of the kernels whose SASS the two builds must share:
#: the facility / exemplar tile and the skinny tile, and the walks that
#: take their warp sums from warp_scatter.cuh (the reference sweeps' walk,
#: the lane walk)
SASS_KEPT = (("facility_marginals", "5mtile"),
             ("exemplar_marginals", "5mtile"),
             ("graph_cut_marginals", "lanes_tile_kernel"),
             ("weighted_coverage_marginals", "lanes_tile_kernel"),
             ("facility_accept", "walk_kernel"),
             ("exemplar_accept", "walk_kernel"),
             ("coverage_marginals", "lane_rows"),
             ("saturated_coverage_marginals", "lane_rows"),
             ("weighted_coverage_marginals", "lane_rows"),
             ("graph_cut_marginals", "lane_rows"))
#: (library, base marker, new marker) of kernels kept under a new name: the
#: feature sweeps' row loop, the first port's narrow instance
SASS_RENAMED = tuple((name, "13feature_sweep6kernel",
                      "13feature_sweep11loop_kernel")
                     for name in FEATURE_SWEEPS)
#: the log-det entry point before it took sizes: no ``size`` pointer
LOGDET_NO_SIZE = tuple(a for i, a in enumerate(
    _build.SIGNATURES["logdet_marginals"]["logdet_marginals_launch"])
    if i != 4)


def build(tmp: Path, trees: dict, names=NAMES) -> dict:
    """{(tree, name): the loaded library}, every nvcc started at once."""
    procs = {}
    for tree, csrc in trees.items():
        src = tmp / tree
        shutil.copytree(csrc, src)
        for name in names:
            cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o",
                   str(src / f"lib{name}.so"), str(src / f"{name}.cu")]
            procs[tree, name] = subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)
    libs = {}
    for (tree, name), proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc {tree} {name} failed:\n{log}")
        lib = ctypes.CDLL(str(tmp / tree / f"lib{name}.so"))
        for fn_name, argtypes in _build.SIGNATURES[name].items():
            fn = getattr(lib, fn_name)
            sized = "const void* size" in (tmp / tree / f"{name}.cu").read_text()
            fn.argtypes = list(argtypes if name != "logdet_marginals" or sized
                               else LOGDET_NO_SIZE)
            fn.restype = ctypes.c_int
            fn.sized = sized
        libs[tree, name] = lib
    return libs


def tile_sass(lib_path: Path, marker: str) -> dict:
    """{kernel name: its SASS body, one line an instruction or encoding
    with cuobjdump's column padding dropped} of the kernels of a library
    whose mangled name holds ``marker`` (empty without cuobjdump).  The
    padding follows the longest instruction anywhere in the library, so it
    moves when another kernel of the library changes."""
    cuobjdump = Path(_build.nvcc_path()).with_name("cuobjdump")
    if not cuobjdump.exists():
        return {}
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib_path)],
                          capture_output=True, text=True).stdout
    return {fn.split(None, 1)[0]: "\n".join(
                " ".join(line.split())
                for line in fn.split("\n", 1)[1].splitlines())
            for fn in sass.split("Function : ")[1:]
            if marker in fn.split(None, 1)[0]}


def lane_sizes(L, k, dev):
    s = (torch.arange(L, device=dev) * 13) % (k + 1)
    s[:2] = torch.tensor([0, k], device=dev)
    return s.to(torch.int32)


def main() -> int:
    args, only, log_path = sys.argv[1:], None, None
    while args[:1] in (["--only"], ["--log"]) and len(args) >= 2:
        if args[0] == "--only":
            only = args[1]
        else:
            log_path = args[1]
        args = args[2:]
    if len(args) != 1 or not Path(args[0]).is_dir() or \
            only not in (None, "lane_walk", "feature_sweeps"):
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("ab_compare: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    with tempfile.TemporaryDirectory() as tmp:
        names = {None: NAMES, "lane_walk": LANE_WALK_KERNELS,
                 "feature_sweeps": FEATURE_SWEEPS + tuple(
                     dict.fromkeys(n for n, _ in SASS_KEPT[4:]))}[only]
        libs = build(Path(tmp), {"base": Path(args[0]), "new": _build.CSRC},
                     names)
        for name, marker, new_marker in (
                *((n, m, m) for n, m in SASS_KEPT), *SASS_RENAMED):
            if (("base", name)) not in libs:
                continue
            base, new = (tile_sass(Path(tmp) / tree / f"lib{name}.so", m)
                         for tree, m in (("base", marker),
                                         ("new", new_marker)))
            if base:
                moved = sum(a != b for x, y in zip(sorted(base.values()),
                                                   sorted(new.values()))
                            for a, b in zip(x.splitlines(), y.splitlines()))
                print(f"[ab] {name}: {len(base)} {new_marker} kernels, SASS "
                      f"of the two builds identical: "
                      f"{sorted(base.values()) == sorted(new.values())} "
                      f"({moved} lines differ)", flush=True)
        bad = check_roots(Path(tmp) / "new", dev)
        print(f"[ab] rules::sqrt_rn against sqrtf on all 2^32 floats: "
              f"{bad} differ", flush=True)
        check_same(bad == 0, "sqrt_rn is not sqrtf")
        if only is None:
            compare_marginals(libs, g, dev, stream)
            compare_logdet_accept(libs, g, dev, stream)
            compare_reference_sweeps(libs, g, dev, stream)
        with (open(log_path, "w") if log_path
              else contextlib.nullcontext(sys.stdout)) as log:
            differ = []
            if only != "feature_sweeps":
                differ += compare_lane_walk(libs, g, dev, stream, log)
            if only != "lane_walk":
                differ += compare_feature_sweeps(libs, g, dev, stream, log)
    print(smi("name,power.limit"))
    check_same(not differ, "; ".join(differ))
    return 0


def compare_marginals(libs, g, dev, stream):
    """Both builds of the tiled marginals at the filter shape (and log-det
    at its lane sizes, full and unbatched at size 0), f32 and bf16: the
    same bits, timed in turns."""
    N, D, R, L, K = 1 << 20, 256, 256, 37, 64
    X32 = torch.rand((N, D), generator=g, device=dev) ** 2
    Rm = torch.rand((R, D), generator=g, device=dev)
    refsq = (Rm * Rm).sum(-1)
    out = torch.empty((L, N), device=dev)
    rows = torch.stack([torch.rand((L, D), generator=g, device=dev) ** 2
                        for _ in range(K)])
    U_lanes, _, sz_lanes = ref.logdet_basis(rows, lane_sizes(L, K, dev))
    U_full, _, sz_full = ref.logdet_basis(
        rows, torch.full((L,), K, dtype=torch.int32, device=dev))
    U_empty = torch.zeros((K, D), device=dev)
    sz_empty = torch.zeros((), dtype=torch.int32, device=dev)
    t = X32.sum(0)
    st_gc = (t * torch.rand((L, 1), generator=g, device=dev) * 1.2).contiguous()
    st_fl = (torch.rand((L, R), generator=g, device=dev) * D / 4).contiguous()
    st_ex = (refsq * torch.rand((L, R), generator=g, device=dev)).contiguous()
    st_wc = torch.rand((L, D), generator=g, device=dev) * 2
    for dtype in (torch.float32, torch.bfloat16):
        X = X32.to(dtype)
        bf = int(dtype == torch.bfloat16)
        tag = str(dtype)[6:]

        def fl(tree):
            return lambda: libs[tree, "facility_marginals"].\
                facility_marginals_launch(
                    X.data_ptr(), bf, 0, Rm.data_ptr(), st_fl.data_ptr(),
                    out.data_ptr(), L, N, R, D, stream)

        def ex(tree):
            return lambda: libs[tree, "exemplar_marginals"].\
                exemplar_marginals_launch(
                    X.data_ptr(), bf, 0, Rm.data_ptr(), refsq.data_ptr(),
                    st_ex.data_ptr(), out.data_ptr(), L, N, R, D, stream)

        def ld(tree, U, size, use_size=True):
            fn = libs[tree, "logdet_marginals"].logdet_marginals_launch
            lanes = U.shape[0] if U.dim() == 3 else 1
            head = (X.data_ptr(), bf, 0, U.data_ptr())
            tail = (out.data_ptr(), lanes, K, N, D, 1.0, 1.0, 1.0, 1e-12,
                    stream)
            if fn.sized:
                sp = size.data_ptr() if use_size else None
                return lambda: fn(*head, sp, *tail)
            return lambda: fn(*head, *tail)

        def gc(tree):
            return lambda: libs[tree, "graph_cut_marginals"].\
                graph_cut_marginals_launch(
                    X.data_ptr(), bf, 0, st_gc.data_ptr(), t.data_ptr(),
                    0.5, out.data_ptr(), L, N, D, stream)

        def wc(tree):
            return lambda: libs[tree, "weighted_coverage_marginals"].\
                weighted_coverage_marginals_launch(
                    X.data_ptr(), bf, 0, st_wc.data_ptr(), out.data_ptr(),
                    L, N, D, stream)

        cases = (("facility_marginals", fl("base"), fl("new"), (), 10),
                 ("exemplar_marginals", ex("base"), ex("new"), (), 10),
                 ("logdet_marginals lane sizes",
                  ld("base", U_lanes, sz_lanes),
                  ld("new", U_lanes, sz_lanes),
                  (ld("new", U_lanes, sz_lanes, False),), 5),
                 ("logdet_marginals full", ld("base", U_full, sz_full),
                  ld("new", U_full, sz_full),
                  (ld("new", U_full, sz_full, False),), 3),
                 ("logdet_marginals unbatched size 0",
                  ld("base", U_empty, sz_empty),
                  ld("new", U_empty, sz_empty),
                  (ld("new", U_empty, sz_empty, False),), 10),
                 ("graph_cut_marginals", gc("base"), gc("new"), (), 10),
                 ("weighted_coverage_marginals", wc("base"), wc("new"),
                  (), 10))
        for label, base, new, others, iters in cases:
            results = []
            for fn in (base, new, *others):
                out.fill_(float("nan"))
                check(fn())
                torch.cuda.synchronize()
                results.append(out.clone())
            rows_ = 1 if "unbatched" in label else L
            same = "bits equal to base: " + " ".join(
                str(torch.equal(r[:rows_], results[0][:rows_]))
                for r in results[1:])
            times = [cuda_ms(fn, iters) for fn in (base, new, new, base)]
            print(f"[ab] {label} {tag}: {same}; ms base {times[0]} new "
                  f"{times[1]} new {times[2]} base {times[3]}",
                  flush=True)


#: the lane walk's (lane_rows.cuh) main-path launches: (label, L, C, d,
#: per-lane x): the corpus filter, chip_smoke.py's FILTER_SHAPES and the
#: partition matroid's one-row scan
LANE_WALK_MAIN = (("filter", 37, 1 << 20, 256, False),
                  ("sample", 37, 98_560, 256, False),
                  ("one lane", 1, 1 << 20, 256, False),
                  ("survivors", 37, 34_048, 256, True),
                  ("chunk", 37, 128, 256, True),
                  ("one row", 37, 1, 256, True))
#: the odd shapes, every combination of these, both x modes
LANE_WALK_ODD = {"d": (3, 45, 257, 2049), "C": (1, 31, 33),
                 "L": (1, 2, 9, 130)}
#: the kernels that run the lane walk: coverage and saturated coverage on
#: every route, weighted coverage and graph cut on the walk's routes (one
#: lane, per-lane x)
LANE_WALK_KERNELS = ("coverage_marginals", "saturated_coverage_marginals",
                     "weighted_coverage_marginals", "graph_cut_marginals")


def compare_lane_walk(libs, g, dev, stream, log):
    """Both builds of the lane walk's kernels at LANE_WALK_MAIN and every
    odd shape of LANE_WALK_ODD, f32 and bf16, coverage and saturated
    coverage with weights and without (saturated states straddle the cap:
    0, below it, at it, above it): the same bits, and a repeated launch of
    the new build the same bits again; each case timed in turns.  Lines go
    to ``log`` (a file, or stdout); stdout gets the main shapes, every odd
    shape where the new build is slower, and a count.  Returns the cases
    that differ."""
    cases = [(label, L, C, d, per) for label, L, C, d, per in LANE_WALK_MAIN]
    for d in LANE_WALK_ODD["d"]:
        for C in LANE_WALK_ODD["C"]:
            for L in LANE_WALK_ODD["L"]:
                for per in (False, True):
                    cases.append(("odd", L, C, d, per))
    frac = torch.tensor([0.0, 0.5, 0.9, 1.0, 1.5], device=dev)
    big = {}
    differ, slower, n = [], [], 0
    for label, L, C, d, per in cases:
        x_shape = (L, C, d) if per else (C, d)
        key = (x_shape, d)
        if label != "odd":
            if key not in big:
                big.clear()
                big[key] = torch.rand(x_shape, generator=g, device=dev) ** 2
            x32 = big[key]
        else:
            x32 = torch.rand(x_shape, generator=g, device=dev) ** 2
        for dtype in (torch.float32, torch.bfloat16):
            x = x32.to(dtype)
            bf = int(dtype == torch.bfloat16)
            for name in LANE_WALK_KERNELS:
                lane_route = per or L == 1
                if name in LANE_WALK_KERNELS[2:] and not lane_route:
                    continue
                for weighted in ((False, True) if name in
                                 LANE_WALK_KERNELS[:2] else (False,)):
                    w = (torch.rand(d, generator=g, device=dev) + 0.5
                         if weighted else None)
                    if name == "coverage_marginals":
                        st = torch.rand((L, d), generator=g, device=dev) * 4
                        st[:, ::7] = 0.0
                        ops = (_wrap.ptr(w),)
                    elif name == "saturated_coverage_marginals":
                        cap = torch.rand(d, generator=g, device=dev) * 2 + 0.25
                        st = frac[torch.randint(0, 5, (L, d), generator=g,
                                                device=dev)] * cap
                        ops = (cap.data_ptr(), _wrap.ptr(w))
                    elif name == "weighted_coverage_marginals":
                        st = torch.rand((L, d), generator=g, device=dev) * 2
                        ops = ()
                    else:
                        t = torch.rand(d, generator=g, device=dev) * C / 3
                        st = (t * torch.rand((L, 1), generator=g, device=dev)
                              * 1.2)
                        ops = (t.data_ptr(), 0.5)
                    st = st.contiguous()
                    outs = {tree: torch.full((L, C), float("nan"), device=dev)
                            for tree in ("base", "new", "again")}

                    def walk(tree, into):
                        fn = getattr(libs[tree, name], f"{name}_launch")
                        o = outs[into]
                        return lambda: fn(x.data_ptr(), bf, int(per),
                                          st.data_ptr(), *ops, o.data_ptr(),
                                          L, C, d, stream)

                    base, new = walk("base", "base"), walk("new", "new")
                    for fn in (base, new, walk("new", "again")):
                        check(fn())
                    torch.cuda.synchronize()
                    same = (torch.equal(outs["base"], outs["new"])
                            and torch.equal(outs["new"], outs["again"]))
                    n += 1
                    iters = 10 if L * C * d >= 1 << 28 else 50
                    times = [cuda_ms(fn, iters) for fn in (base, new, new,
                                                           base)]
                    what = (f"{name} {label} x{tuple(x_shape)} L={L} "
                            f"{str(dtype)[6:]} weighted={weighted}")
                    line = (f"[ab] {what}: bits equal to base and repeat "
                            f"bitwise: {same}; ms base {times[0]} new "
                            f"{times[1]} new {times[2]} base {times[3]}")
                    print(line, file=log, flush=True)
                    is_slower = min(times[1:3]) > max(times[0], times[3])
                    if log is not sys.stdout and (label != "odd"
                                                  or is_slower or not same):
                        print(line, flush=True)
                    if not same:
                        differ.append(what)
                    if is_slower:
                        slower.append(what)
    print(f"[ab] lane walk: {n} cases, {n - len(differ)} bit for bit the "
          f"base build (repeat bitwise), {len(slower)} where the new build "
          f"was slower in both turns", flush=True)
    return differ


#: the feature sweeps' comparison: (label, L, B, d): the path case,
#: chip_smoke.py's odd shapes, and d across the narrow instances (kPer = 1,
#: 2, 4, 8, 16) and their edges
FEATURE_SHAPES = (("path", *FEATURE_PATH), ("odd L=1", 1, 70, 45),
                  ("odd L=130", 130, 128, 70), ("d=1", 37, 128, 1),
                  ("d=127", 37, 128, 127), ("d=129", 37, 128, 129),
                  ("d=512", 37, 128, 512), ("d=1000", 37, 128, 1000),
                  ("d=2048", 37, 128, 2048))
#: how much slower than the base build a case may be
FEATURE_SLACK = 1.05


def compare_feature_sweeps(libs, g, dev, stream, log):
    """Both builds of the four feature sweeps at FEATURE_SHAPES, f32 and
    bf16, coverage and saturated coverage with weights and without, in the
    three rules of feature_sweep_rules and a fourth (the path taus with
    budgets 0, 1 and 3 in turn and every fourth lane ineligible throughout):
    mask, state and gains the same bits, and a repeated launch of the new
    build the same bits again.  The new build runs the instance the wrapper
    picks (_wrap.feature_sweep_instance: the walk or the row loop) and, as
    ``other``, the other of the two, which must give the same bits too.
    Each case is timed in turns, base, new, other, other, new, base.  Lines
    go to ``log``; stdout gets the path case, every case where the new
    build is more than FEATURE_SLACK slower than the base build or differs,
    and counts.  Returns the cases that differ."""
    differ, slower, better, n = [], [], [], 0
    for name in FEATURE_SWEEPS:
        for label, L, B, d in FEATURE_SHAPES:
            lanes = torch.arange(L, device=dev)
            elig = torch.rand((L, B), generator=g, device=dev) < 0.9
            for dtype in (torch.float32, torch.bfloat16):
                per = _wrap.feature_sweep_instance(name, dtype, d)
                route = "row loop" if per < 0 else "walk"
                for weighted in ((False, True) if name in FEATURE_SWEEPS[::2]
                                 else (False,)):
                    x, st, ops, g0 = feature_sweep_case(name, L, B, d, dtype,
                                                        g, dev, weighted)
                    rules = feature_sweep_rules(L, B, g0, g, dev)
                    off = elig & (lanes % 4 != 3)[:, None]
                    rules.append(("budgets 0/1/3, ineligible lanes",
                                  rules[0][1], (lanes % 3 + lanes % 3 // 2
                                                ).to(torch.int32), None,
                                  None))
                    for i, (rule, tau, budget, cost, cb) in enumerate(rules):
                        el = off if i == 3 else elig
                        trees = ("base", "new", "again", "other")
                        outs = {tree: (torch.empty((L, B), dtype=torch.bool,
                                                   device=dev),
                                       torch.empty((L, d), device=dev),
                                       torch.empty((L, B), device=dev))
                                for tree in trees}

                        def sweep(tree, into, at):
                            fn = getattr(libs[tree, name], f"{name}_launch")
                            return feature_sweep_call(fn, x, st, ops, el, tau,
                                                      budget, cost, cb,
                                                      outs[into], stream, at)

                        base = sweep("base", "base",
                                     _wrap.feature_sweep_per(d))
                        new = sweep("new", "new", per)
                        other = sweep("new", "other", -per)
                        for tree, fn in (("base", base), ("new", new),
                                         ("again", sweep("new", "again", per)),
                                         ("other", other)):
                            for o in outs[tree]:
                                o.zero_()
                            check(fn())
                        torch.cuda.synchronize()
                        same = all(torch.equal(a, b) and torch.equal(b, c)
                                   and torch.equal(b, e)
                                   for a, b, c, e in zip(
                                       *(outs[tree] for tree in trees)))
                        n += 1
                        acc = outs["new"][0].sum(-1)
                        times = [cuda_ms(fn, 50) for fn in
                                 (base, new, other, other, new, base)]
                        t_base = (times[0] + times[5]) / 2
                        t_new = (times[1] + times[4]) / 2
                        t_other = (times[2] + times[3]) / 2
                        what = (f"{name} {label} x({L}, {B}, {d}) "
                                f"{str(dtype)[6:]} weighted={weighted} "
                                f"{rule}")
                        line = (f"[ab] {what}: {route}; accepts per lane min "
                                f"{int(acc.min())} max {int(acc.max())}; "
                                f"mask, state and gains equal to base, "
                                f"repeat and other bitwise: {same}; ms base "
                                f"{times[0]} new {times[1]} other {times[2]} "
                                f"other {times[3]} new {times[4]} base "
                                f"{times[5]}; new/base {t_new / t_base:.3f} "
                                f"other/base {t_other / t_base:.3f}")
                        print(line, file=log, flush=True)
                        is_slower = t_new > FEATURE_SLACK * t_base
                        if log is not sys.stdout and (
                                label == "path" or is_slower or not same):
                            print(line, flush=True)
                        if not same:
                            differ.append(what)
                        if is_slower:
                            slower.append(what)
                        if t_other * FEATURE_SLACK < t_new:
                            better.append(what)
    print(f"[ab] feature sweeps: {n} cases, {n - len(differ)} bit for bit "
          f"the base build (repeat and other route bitwise), {len(slower)} "
          f"where the new build was more than {FEATURE_SLACK} times the "
          f"base build's ms, {len(better)} where the other route was more "
          f"than {FEATURE_SLACK} times faster than the route taken"
          + "".join(f"\n[ab]   other route faster: {w}" for w in better),
          flush=True)
    return differ


#: a kernel that holds rules::sqrt_rn against sqrtf on every float
ROOTS_CHECK = r"""
#include "feature_rules.cuh"
__global__ void roots_check(unsigned long long* bad) {
  unsigned long long n = 0;
  for (unsigned long long i = blockIdx.x * (unsigned long long)blockDim.x
           + threadIdx.x; i < (1ull << 32);
       i += (unsigned long long)gridDim.x * blockDim.x) {
    float q[1] = {__uint_as_float((unsigned)i)};
    const float want = sqrtf(q[0]);
    rules::sqrt_rn<1>(q);
    n += __float_as_uint(q[0]) != __float_as_uint(want);
  }
  atomicAdd(bad, n);
}
extern "C" int roots_check_launch(void* bad) {
  roots_check<<<4096, 256>>>(static_cast<unsigned long long*>(bad));
  return (int)cudaGetLastError();
}
"""


def check_roots(csrc: Path, dev) -> int:
    """Build ROOTS_CHECK against rules::sqrt_rn in ``csrc`` and run it
    over all 2^32 bit patterns: the floats where sqrt_rn and sqrtf
    differ."""
    src = csrc / "roots_check.cu"
    src.write_text(ROOTS_CHECK)
    lib = csrc / "libroots_check.so"
    subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(lib),
                    str(src)], check=True, capture_output=True)
    fn = ctypes.CDLL(str(lib)).roots_check_launch
    fn.argtypes, fn.restype = [ctypes.c_void_p], ctypes.c_int
    bad = torch.zeros(1, dtype=torch.int64, device=dev)
    check(fn(bad.data_ptr()))
    torch.cuda.synchronize()
    return int(bad.item())


def lane_taus(gains):
    """Per-lane thresholds from "accept most rows" to "accept few" (the
    quantiles of chip_smoke.py's sweeps)."""
    q = torch.linspace(0.05, 0.95, gains.shape[0], device=gains.device)
    return torch.stack([gains[l].quantile(q[l])
                        for l in range(gains.shape[0])]).contiguous()


def compare_logdet_accept(libs, g, dev, stream):
    """Both builds of logdet_accept at chip_smoke.py's path case, both
    modes, f32 and bf16: the same bits in every output, timed in turns."""
    L, B, D, K = 37, 128, 256, 64
    lanes = torch.arange(L, device=dev)
    for dtype in (torch.float32, torch.bfloat16):
        x = (torch.rand((L, B, D), generator=g, device=dev) ** 2).to(dtype)
        sizes = lane_sizes(L, K, dev)
        sizes[2::3] = K - 2
        rows = torch.stack([(torch.rand((L, D), generator=g, device=dev) ** 2
                             ).to(dtype).float() for _ in range(K)])
        U, ld, sz = ref.logdet_basis(rows, sizes)
        elig = torch.rand((L, B), generator=g, device=dev) < 0.9
        gains0 = ref.logdet_marginals(x, U, 1.0, size=sz)
        budget = torch.where(lanes % 5 == 0, 3, K).to(torch.int32)
        for mode in ("cardinality", "cost"):
            cost = cb = None
            if mode == "cardinality":
                tau = lane_taus(gains0)
            else:
                cost = (0.5 + 1.5 * torch.rand((L, B), generator=g,
                                               device=dev)).contiguous()
                tau = lane_taus(gains0 / cost.mean())
            tau[2::3] = 0.0
            if cost is not None:
                free = ref.logdet_accept(x, U, ld, sz, elig, tau, budget,
                                         1.0, cost=cost, cost_budget=1e9)
                spent = torch.where(free[0], cost, 0.0).sum(-1)
                cb = torch.where(lanes % 2 == 0, 0.5 * spent,
                                 1e9).contiguous()
            outs = {tree: (torch.empty((L, B), dtype=torch.bool, device=dev),
                           torch.empty((L, K, D), device=dev),
                           torch.empty(L, device=dev),
                           torch.empty(L, dtype=torch.int32, device=dev),
                           torch.empty((L, B), device=dev))
                    for tree in ("base", "new")}

            def la(tree):
                fn = libs[tree, "logdet_accept"].logdet_accept_launch
                o = outs[tree]
                return lambda: fn(
                    x.data_ptr(), int(dtype == torch.bfloat16), U.data_ptr(),
                    ld.data_ptr(), sz.data_ptr(), elig.data_ptr(),
                    tau.data_ptr(), budget.data_ptr(),
                    None if cost is None else cost.data_ptr(),
                    None if cb is None else cb.data_ptr(),
                    *(t.data_ptr() for t in o), L, B, K, D, 1.0, 1.0,
                    ref.LOGDET_EPS, 0, stream)

            base, new = la("base"), la("new")
            for tree, fn in (("base", base), ("new", new)):
                for t in outs[tree]:
                    t.zero_()
                check(fn())
            torch.cuda.synchronize()
            same = all(torch.equal(a, b)
                       for a, b in zip(outs["base"], outs["new"]))
            accepted = int(outs["new"][0].sum())
            times = [cuda_ms(fn, 50) for fn in (base, new, new, base)]
            print(f"[ab] logdet_accept {mode} {str(dtype)[6:]} x({L}, {B}, "
                  f"{D}) k={K} accepted={accepted}: mask, U, logdet, size "
                  f"and gains equal to base: {same}; ms base {times[0]} new "
                  f"{times[1]} new {times[2]} base {times[3]}", flush=True)


#: (label, L, B, r, d, dtypes) of the reference sweeps' comparison: the
#: path case, r = 1024, the wide instance and chip_smoke.py's odd shapes
REFERENCE_SHAPES = {
    "facility_accept": (("path", 37, 128, 256, 256, ("f32", "bf16")),
                        ("r=1024", 37, 128, 1024, 256, ("f32", "bf16")),
                        ("wide r=4097", 37, 128, 4097, 256, ("f32",)),
                        ("wide r=8192", 37, 128, 8192, 256, ("f32",)),
                        ("odd L=1", 1, 70, 45, 70, ("f32",)),
                        ("odd L=100", 100, 128, 45, 70, ("f32",))),
    "exemplar_accept": (("path", 37, 128, 256, 256, ("f32", "bf16")),
                        ("r=1024", 37, 128, 1024, 256, ("f32", "bf16")),
                        ("wide r=4097", 37, 128, 4097, 256, ("f32",)),
                        ("wide r=8192", 37, 128, 8192, 256, ("f32",)),
                        ("odd L=1", 1, 70, 100, 70, ("f32",)),
                        ("odd L=100", 100, 128, 300, 45, ("f32",))),
}


def compare_reference_sweeps(libs, g, dev, stream):
    """Both builds of facility_accept and exemplar_accept at the shapes of
    REFERENCE_SHAPES, f32 and bf16, each in three rules: chip_smoke.py's
    taus (quantiles of each lane's first gains, budget 3 in every fifth
    lane), the knapsack cost mode (costs U[0.5, 2), tau over the mean cost,
    a cost budget of 2 in even lanes) and tau = -inf with the budget B
    (every eligible row accepted): mask, state and gains the same bits,
    timed in turns."""
    for name, shapes in REFERENCE_SHAPES.items():
        marginals = getattr(ref, name.replace("accept", "marginals"))
        for label, L, B, r, d, dtypes in shapes:
            lanes = torch.arange(L, device=dev)
            Rm = torch.rand((r, d), generator=g, device=dev)
            refsq = (Rm * Rm).sum(-1)
            if name == "facility_accept":
                state = torch.rand((L, r), generator=g, device=dev) * d / 4
            else:
                state = refsq * torch.rand((L, r), generator=g, device=dev)
            elig = torch.rand((L, B), generator=g, device=dev) < 0.9
            cost = (0.5 + 1.5 * torch.rand((L, B), generator=g, device=dev)
                    ).contiguous()
            for tag in dtypes:
                dtype = torch.float32 if tag == "f32" else torch.bfloat16
                cand = (torch.rand((L, B, d), generator=g, device=dev) ** 2
                        ).to(dtype)
                gains0 = marginals(cand, Rm, state)
                for rule in ("path taus", "cost", "tau=-inf"):
                    cost_p = cb = None
                    budget = torch.where(lanes % 5 == 0, 3, 64)
                    if rule == "path taus":
                        tau = lane_taus(gains0)
                    elif rule == "cost":
                        tau = lane_taus(gains0 / cost.mean())
                        cost_p = cost
                        cb = torch.where(lanes % 2 == 0, 2.0, 1e9)
                        cb = cb.to(torch.float32).contiguous()
                    else:
                        tau = torch.full((L,), float("-inf"), device=dev)
                        budget = torch.full((L,), B, device=dev)
                    budget = budget.to(torch.int32).contiguous()
                    outs = {tree: (torch.empty((L, B), dtype=torch.bool,
                                               device=dev),
                                   torch.empty((L, r), device=dev),
                                   torch.empty((L, B), device=dev),
                                   torch.empty((L, B, r), device=dev))
                            for tree in ("base", "new")}
                    extra = (refsq.data_ptr(),) if name == "exemplar_accept" \
                        else ()

                    def sweep(tree):
                        fn = getattr(libs[tree, name], f"{name}_launch")
                        o = outs[tree]
                        return lambda: fn(
                            cand.data_ptr(), int(dtype == torch.bfloat16),
                            Rm.data_ptr(), *extra, state.data_ptr(),
                            elig.data_ptr(), tau.data_ptr(),
                            budget.data_ptr(),
                            None if cost_p is None else cost_p.data_ptr(),
                            None if cb is None else cb.data_ptr(),
                            *(t.data_ptr() for t in o), L, B, r, d,
                            _wrap.reference_sweep_per(r), stream)

                    base, new = sweep("base"), sweep("new")
                    for tree, fn in (("base", base), ("new", new)):
                        for t in outs[tree]:
                            t.zero_()
                        check(fn())
                    torch.cuda.synchronize()
                    same = all(torch.equal(a, b) for a, b in
                               zip(outs["base"][:3], outs["new"][:3]))
                    check_same(same, f"{name} {label} {tag} {rule}")
                    acc = outs["new"][0].sum(-1)
                    iters = 50 if r <= 1024 else 5
                    times = [cuda_ms(fn, iters)
                             for fn in (base, new, new, base)]
                    print(f"[ab] {name} {label} x({L}, {B}, {d}) r={r} {tag} "
                          f"{rule}: accepts per lane min {int(acc.min())} "
                          f"max {int(acc.max())}; mask, state and gains "
                          f"equal to base: {same}; ms base {times[0]} new "
                          f"{times[1]} new {times[2]} base {times[3]}",
                          flush=True)


def check_same(same, what):
    if not same:
        raise RuntimeError(f"ab_compare: {what}: the two builds differ")


def check(err):
    if err != 0:
        raise RuntimeError(f"CUDA error {err} at launch")


if __name__ == "__main__":
    sys.exit(main())
