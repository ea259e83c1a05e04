#!/usr/bin/env python3
"""Where one fused select's time goes on the card: a ``torch.profiler``
trace of fused selects at full width, and the accepts each of their sweep
launches made.

    python3 src/repro_torch/launch/trace_select.py [--src DIR]
        [--oracles NAME,...] [--modes f32,bf16,knapsack]
                    (from the root of a checkout, on a machine with a
                     CUDA card and nvcc)

``--src`` is the ``src`` directory whose ``repro_torch`` is imported
(default: the one this file lies in), so one command can trace two trees,
for example the parent commit unpacked with ``git archive`` into a
directory that ``.gitignore`` lists, and this one.  ``--oracles`` names
the oracles (default ``facility_location,exemplar``; any of ORACLES),
``--modes`` the selects of each (default ``f32``): f32 storage, bf16
storage, and the knapsack constraint (costs U[0.5, 2), budget 40) on f32.

Each select is the fused two_round select of ``chip_smoke.py``'s main path:
n = 1,048,576 rows of d = 256 (U[0,1)^2, generator seed 0), a 256-row
reference set and the knapsack's costs drawn after them, the ground set's
feature sum as saturated coverage's and graph cut's total, k = 64, m = 16
simulated machines, eps = 0.15, chunk 128, on the kernel route.  Per
oracle and mode it prints:

* the select's wall ms (host clock around a select that ends in a device
  sync), three runs after a warm-up, without the profiler, its value and a
  checksum of its ids in order;
* from one traced run: the device's busy share of the select's host span
  (the union of the kernel, memcpy and memset intervals), its idle share,
  the device ms by kernel for the top ones, and the device ms and share of
  the oracle's accept sweep (every kernel whose name holds the sweep's
  marker in ORACLES);
* from one more run with the sweep's wrapper wrapped: its launches, lanes
  swept, rows, eligible rows and accepts, and a histogram of the accepts
  per lane and launch.

Last it prints the card's name and power limit.  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import collections
import inspect
import json
import subprocess
import sys
import tempfile
import time
import zlib
from pathlib import Path

N, D, K, M, EPS, CHUNK, R = 1 << 20, 256, 64, 16, 0.15, 128, 256
KNAP_BUDGET = K * 1.25 / 2  # the knapsack's budget (the JAX CLI's): 40
#: oracle: (its accept sweep's module, a marker its kernels' names hold)
ORACLES = {"facility_location": ("facility_accept", "reftile"),
           "exemplar": ("exemplar_accept", "reftile"),
           "feature_coverage": ("coverage_accept", "feature_sweep"),
           "weighted_coverage": ("weighted_coverage_accept", "feature_sweep"),
           "saturated_coverage": ("saturated_coverage_accept",
                                  "feature_sweep"),
           "graph_cut": ("graph_cut_accept", "feature_sweep")}
#: mode: the SelectorSpec fields of its select
MODES = {"f32": {}, "bf16": {"precision": "bf16"},
         "knapsack": {"constraint": "knapsack",
                      "knapsack_budget": KNAP_BUDGET}}
#: upper edges of the accepts-per-lane histogram's bins
BINS = (0, 1, 2, 4, 8, 16, 32, 64, 128)


def smi():
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()


def device_share(trace_path, span_name):
    """From a chrome trace: (span ms, busy ms, {kernel: device ms}) of the
    device activity inside the host span named ``span_name``."""
    events = json.loads(Path(trace_path).read_text())["traceEvents"]
    span = [e for e in events if e.get("name") == span_name
            and e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    t0, t1 = span[0]["ts"], span[0]["ts"] + span[0]["dur"]
    spans, by_kernel = [], collections.Counter()
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in ("kernel", "gpu_memcpy",
                                                     "gpu_memset"):
            continue
        a, b = max(e["ts"], t0), min(e["ts"] + e["dur"], t1)
        if b > a:
            spans.append((a, b))
            by_kernel[e["name"]] += (b - a) / 1e3
    busy, end = 0.0, t0
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    return (t1 - t0) / 1e3, busy / 1e3, by_kernel


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[2]))
    ap.add_argument("--oracles", default="facility_location,exemplar")
    ap.add_argument("--modes", default="f32")
    args = ap.parse_args(argv)
    oracles, modes = args.oracles.split(","), args.modes.split(",")
    if not set(oracles) <= set(ORACLES) or not set(modes) <= set(MODES):
        ap.error(f"--oracles from {sorted(ORACLES)}, --modes from "
                 f"{sorted(MODES)}")
    import torch
    if not torch.cuda.is_available():
        print("trace_select: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(args.src).resolve()))
    from repro_torch.core import selector as tsel
    from repro_torch.kernels import ops
    import repro_torch
    label = str(Path(repro_torch.__file__).parent)
    print(f"[trace] repro_torch from {label}", flush=True)

    gen = torch.Generator(device="cuda").manual_seed(0)
    X = torch.rand((N, D), generator=gen, device="cuda") ** 2
    reference = torch.rand((R, D), generator=gen, device="cuda")
    costs = 0.5 + 1.5 * torch.rand(N, generator=gen, device="cuda")
    total = X.sum(0)
    for oracle, mode in ((o, m) for o in oracles for m in modes):
        sweep, marker = ORACLES[oracle]
        spec = tsel.SelectorSpec(k=K, eps=EPS, chunk=CHUNK, oracle=oracle,
                                 engine="fused", use_kernel=True,
                                 **MODES[mode])
        sel = tsel.DistributedSelector(
            spec, n_total=N, feat_dim=D, n_machines=M, device="cuda",
            reference=reference, total=total,
            element_costs=costs if mode == "knapsack" else None)
        what = f"{label} {oracle} fused {mode}"

        def select():
            g = torch.Generator(device="cuda").manual_seed(1)
            torch.cuda.synchronize()
            t = time.perf_counter()
            res = sel.select(X, generator=g)
            value = float(res.value)  # waits for the device
            return res, value, (time.perf_counter() - t) * 1e3

        res, value, _ = select()  # warm-up: builds and loads the kernels
        walls = [select()[2] for _ in range(3)]
        ids = res.sol_ids.cpu()[:int(res.sol_size)].to(torch.int64)
        print(f"[trace] {what}: value={value} |S|={len(ids)} "
              f"ids_crc32={zlib.crc32(ids.numpy().tobytes())} "
              f"wall_ms={walls}", flush=True)

        from torch.profiler import ProfilerActivity, profile, record_function
        with tempfile.TemporaryDirectory() as tmp:
            path = Path(tmp) / "trace.json"
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                with record_function("select"):
                    _, _, wall = select()
            prof.export_chrome_trace(str(path))
            span, busy, by_kernel = device_share(path, "select")
        sweep_ms = sum(ms for name, ms in by_kernel.items()
                       if marker in name)
        dev_ms = sum(by_kernel.values())
        print(f"[trace] {what} traced: wall_ms={wall} "
              f"span_ms={span} device_busy_ms={busy} busy_share="
              f"{busy / span} idle_share={1 - busy / span} device_ms="
              f"{dev_ms} sweep_ms={sweep_ms} sweep_share_of_device="
              f"{sweep_ms / dev_ms}", flush=True)
        for name, ms in by_kernel.most_common(8):
            print(f"[trace]   {ms:10.3f} ms  {name[:110]}")

        mod = getattr(__import__("repro_torch.kernels", fromlist=[sweep]),
                      sweep)
        shipped, stats = getattr(mod, sweep), collections.Counter()
        hist = collections.Counter()
        signature = inspect.signature(shipped)

        def counted(*a, **kw):
            out = shipped(*a, **kw)
            eligible = signature.bind(*a, **kw).arguments["eligible"]
            per_lane = out[0].reshape(-1, out[0].shape[-1]).sum(-1).tolist()
            stats["launches"] += 1
            stats["lanes"] += len(per_lane)
            stats["rows"] += eligible.numel()
            stats["eligible"] += int(eligible.sum())
            stats["accepts"] += sum(per_lane)
            for n in per_lane:
                hist[next(b for b in BINS if n <= b)] += 1
            return out

        setattr(mod, sweep, counted)
        try:
            select()
        finally:
            setattr(mod, sweep, shipped)
        print(f"[trace] {what} {sweep}: {dict(stats)}; sweep device ms a "
              f"launch {sweep_ms / max(stats['launches'], 1)}; lanes by "
              f"accepts (<= bin): "
              f"{ {b: hist[b] for b in BINS if hist[b]} }", flush=True)
        del sel
        ops.reset_launch_counts()
    print(smi())
    return 0


if __name__ == "__main__":
    sys.exit(main())
