#!/usr/bin/env python3
"""What holds back the marginals tile (csrc/marginals_tile.cuh) on a card.

    PYTHONPATH=src python3 -m repro_torch.kernels.tile_probe
                    (from the root of a checkout, on a machine with a
                     CUDA card and nvcc)

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
and the per-lane chunk (37, 128, 256).  Then it runs the shipped kernel at
the filter shape for three seconds while sampling the SM clock, power
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

from repro_torch.kernels import _build

#: (name, [(text, replacement)]) patches of marginals_tile.cuh
VARIANTS = (
    ("shipped", []),
    ("no_epilogue", [("for (int c0 = part * part_cols; c0 < c_end; c0 += 4)",
                      "for (int c0 = part * part_cols; c0 < 0; c0 += 4)")]),
    ("half_lds", [("      fragments(buf, kk, fa, fb);",
                   "      if ((kk & 1) == 0) fragments(buf, kk, fa, fb);")]),
)


def build(tmp: Path):
    """{variant: its facility_marginals_launch}, built in parallel."""
    procs = {}
    for name, patch in VARIANTS:
        src = tmp / name
        shutil.copytree(_build.CSRC, src)
        tile = src / "marginals_tile.cuh"
        text = tile.read_text()
        for old, new in patch:
            if old not in text:
                raise RuntimeError(f"{name}: the tile no longer has {old!r}")
            text = text.replace(old, new)
        tile.write_text(text)
        cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o",
               str(src / "lib.so"), str(src / "facility_marginals.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    fns = {}
    argtypes = _build.SIGNATURES["facility_marginals"]["facility_marginals_launch"]
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc {name} failed:\n{log}")
        fn = ctypes.CDLL(str(tmp / name / "lib.so")).facility_marginals_launch
        fn.argtypes, fn.restype = list(argtypes), ctypes.c_int
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


def main() -> int:
    if not torch.cuda.is_available():
        print("tile_probe: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    N, D, R, L = 1 << 20, 256, 256, 37
    X = torch.rand((N, D), generator=g, device=dev) ** 2
    Xp = torch.rand((L, 128, D), generator=g, device=dev) ** 2
    Rm = torch.rand((R, D), generator=g, device=dev)
    with tempfile.TemporaryDirectory() as tmp:
        fns = build(Path(tmp))
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
        st = (torch.rand((L, R), generator=g, device=dev) * D / 4).contiguous()
        out = torch.empty((L, N), device=dev)
        shipped = fns["shipped"]
        samples, stop = [], threading.Event()

        def sample():
            while not stop.is_set():
                samples.append(smi("clocks.sm,power.draw,"
                                   "clocks_throttle_reasons.active"))
                time.sleep(0.25)

        thread = threading.Thread(target=sample)
        thread.start()
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < 3.0:
            for _ in range(20):
                shipped(X.data_ptr(), 0, 0, Rm.data_ptr(), st.data_ptr(),
                        out.data_ptr(), L, N, R, D, stream)
            torch.cuda.synchronize()
        stop.set()
        thread.join()
        for s in samples[2:-1]:
            print(f"[probe] under the filter launches: sm clock, power, "
                  f"throttle reasons = {s}")
    print(smi("name,power.limit"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
