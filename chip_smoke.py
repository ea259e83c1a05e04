#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py        (from the root of a checkout)

Phases, each printing its lines; any failure raises and exits non-zero:

1. Build the CUDA kernels from src/repro_torch/kernels/csrc with nvcc.
2. Hold each kernel against its plain PyTorch version on the card at the
   main path's shapes (f32 and bf16 x, weighted and unweighted), and time
   both with CUDA events.
3. Drive the main path at full width: DistributedSelector.select with the
   two_round driver and FeatureCoverage, n = 1,048,576 rows of d = 256
   (a 1 GiB f32 corpus on the card), k = 64, m = 16 simulated machines,
   eps = 0.15, once per engine on the kernel route and once on the plain
   route, then multi_epoch (E = 2) and bf16 storage on the fused engine.
   Checks agreement between the routes and engines, the (1/2 - eps)
   guarantee against sequential greedy, and that every kernel of the path
   launched.
4. Print the kernel table as one JSON line, the card's name and power
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
GREEDY_ROWS = 1 << 16  # rows of the sequential greedy yardstick
RTOL = ATOL = 1e-5


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
    with CUDA events around the whole run."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
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


def phase_kernels(torch, ref, cm, ca):
    """Kernel vs plain version on the card; returns the JSON rows."""
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
            g0 = ref.coverage_marginals(x, state, w)
            # lanes from "accept most rows" to "accept few"
            q = torch.linspace(0.05, 0.95, L, device=dev)
            tau = torch.stack([g0[l].quantile(q[l]) for l in range(L)])
            tau = tau.contiguous()
            budget = torch.where(torch.arange(L, device=dev) % 5 == 0, 3,
                                 K).to(torch.int32)
            km, ks, kg = ca.coverage_accept(x, state, w, elig, tau, budget)
            pm, ps, pg = ref.coverage_accept(x, state, w, elig, tau, budget)
            torch.cuda.synchronize()
            ties, err = 0, 0.0
            for l in range(L):
                diff = (km[l] != pm[l]).nonzero()
                upto = B
                if len(diff):
                    i = int(diff[0])
                    near = abs(float(pg[l, i]) - float(tau[l])) \
                        <= 1e-5 * abs(float(tau[l]))
                    check(near, f"coverage_accept lane {l} row {i}: masks "
                          f"differ away from tau (gain {float(pg[l, i])}, "
                          f"tau {float(tau[l])})")
                    ties, upto = ties + 1, i + 1
                else:
                    check(torch.allclose(ks[l], ps[l], rtol=RTOL, atol=ATOL),
                          f"coverage_accept lane {l}: states differ")
                    err = max(err, (ks[l] - ps[l]).abs().max().item())
                check(torch.allclose(kg[l, :upto], pg[l, :upto], rtol=RTOL,
                                     atol=ATOL),
                      f"coverage_accept lane {l}: gains differ")
                err = max(err, (kg[l, :upto] - pg[l, :upto]).abs().max().item())
            worst = max(worst, err)
            n_acc = int(pm.sum())
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


def drive(torch, tsel, cm, ca, X, label, **spec_kw):
    """One select through the public entry point, with the launch counts
    set to 0 just before and read just after.  Returns (result, wall ms,
    (marginals launches, accept launches), selector)."""
    spec = tsel.SelectorSpec(k=K, eps=EPS, chunk=CHUNK, **spec_kw)
    sel = tsel.DistributedSelector(spec, n_total=N, feat_dim=D, n_machines=M,
                                   device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(1)
    torch.cuda.synchronize()
    cm.launches = ca.launches = 0
    t0 = time.perf_counter()
    res = sel.select(X, generator=gen)
    value = float(res.value)  # waits for the device
    wall = (time.perf_counter() - t0) * 1e3
    counts = (cm.launches, ca.launches)
    ids = res.sol_ids.cpu()
    check(res.sol_ids.shape == (K,) and int(res.sol_size) == K,
          f"{label}: expected {K} ids, got size {int(res.sol_size)}")
    check(len(set(ids.tolist())) == K and int(ids.min()) >= 0
          and int(ids.max()) < N, f"{label}: ids not {K} distinct rows")
    check(value == value and value > 0 and value != float("inf"),
          f"{label}: value {value}")
    print(f"[main] {label}: value={value} |S|={int(res.sol_size)} "
          f"n_dropped={int(res.n_dropped)} tau_fallback={int(res.tau_fallback)} "
          f"wall_ms={wall} launches(coverage_marginals, coverage_accept)="
          f"{counts}")
    print(sel.round_log.summary())
    return res, value, wall, counts


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
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels import coverage_accept as ca
    from repro_torch.kernels import coverage_marginals as cm

    card = smi()
    print(f"[build] python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    _build.build_all()
    print(f"[build] kernels built in {time.perf_counter() - t0:.3f} s; "
          f"card: {card}")

    rows = phase_kernels(torch, ref, cm, ca)

    gen = torch.Generator(device="cuda").manual_seed(0)
    X = torch.rand((N, D), generator=gen, device="cuda") ** 2
    runs, launches = {}, {"coverage_marginals": 0, "coverage_accept": 0}
    for engine in ("dense", "lazy", "fused"):
        res, value, wall, counts = drive(torch, tsel, cm, ca, X,
                                         f"two_round {engine} kernel",
                                         engine=engine, use_kernel=True)
        check(counts[0] > 0, f"{engine}: coverage_marginals never launched")
        check((counts[1] > 0) == (engine == "fused"),
              f"{engine}: coverage_accept launched {counts[1]} times")
        launches["coverage_marginals"] += counts[0]
        launches["coverage_accept"] += counts[1]
        runs[engine] = (res, value)
    res_p, value_p, _, counts = drive(torch, tsel, cm, ca, X,
                                      "two_round lazy plain", engine="lazy",
                                      use_kernel=False)
    check(counts == (0, 0), f"plain route launched kernels {counts}")
    for engine, (res, value) in runs.items():
        check(abs(value - value_p) <= 1e-3 * abs(value_p),
              f"{engine} value {value} vs plain {value_p}")
        overlap = len(set(res.sol_ids.tolist()) & set(res_p.sol_ids.tolist()))
        print(f"[main] {engine} vs plain: rel_diff="
              f"{abs(value - value_p) / value_p} id_overlap={overlap}/{K}")

    oracle = tsel.make_oracle(tsel.SelectorSpec(k=K), D, "cuda")
    _, _, gval = tseq.greedy(oracle, X[:GREEDY_ROWS],
                             torch.ones(GREEDY_ROWS, dtype=torch.bool,
                                        device="cuda"), K)
    gval = float(gval)
    for engine, (_, value) in runs.items():
        check(value >= (0.5 - EPS) * gval,
              f"{engine}: value {value} below (1/2 - eps) x greedy {gval}")
    print(f"[main] greedy on the first {GREEDY_ROWS} rows: value={gval}; "
          f"two_round/greedy = "
          f"{ {e: v / gval for e, (_, v) in runs.items()} }")

    _, v_me, _, counts = drive(torch, tsel, cm, ca, X,
                               "multi_epoch E=2 fused kernel",
                               algorithm="multi_epoch", epochs=2,
                               engine="fused", use_kernel=True)
    check(counts[0] > 0 and counts[1] > 0, f"multi_epoch launches {counts}")
    launches["coverage_marginals"] += counts[0]
    launches["coverage_accept"] += counts[1]
    check(v_me >= (0.5 - EPS) * gval, f"multi_epoch value {v_me}")
    _, v_bf, _, counts = drive(torch, tsel, cm, ca, X,
                               "two_round fused kernel bf16", engine="fused",
                               use_kernel=True, precision="bf16")
    check(counts[0] > 0 and counts[1] > 0, f"bf16 launches {counts}")
    launches["coverage_marginals"] += counts[0]
    launches["coverage_accept"] += counts[1]
    v_f32 = runs["fused"][1]
    check(v_bf >= 0.99 * v_f32, f"bf16 value {v_bf} < 0.99 x f32 {v_f32}")
    print(f"[main] bf16/f32 fused value ratio = {v_bf / v_f32}")

    table = []
    for name, src, replaces in (
            ("coverage_marginals",
             "src/repro_torch/kernels/csrc/coverage_marginals.cu",
             "src/repro/kernels/coverage_marginals.py:49"),
            ("coverage_accept",
             "src/repro_torch/kernels/csrc/coverage_accept.cu",
             "src/repro/kernels/coverage_accept.py:32")):
        check(launches[name] > 0, f"{name} never launched on the main path")
        r = rows[name]
        table.append({"name": name, "route": "cuda", "source": src,
                      "replaces": replaces, "launches": launches[name],
                      "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                      "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                      "bound_by": r["bound_by"], "library_ms": None})
    print(json.dumps({"kernels": table}))
    print(smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
