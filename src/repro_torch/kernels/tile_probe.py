#!/usr/bin/env python3
"""What holds back the marginals tiles on a card: the facility / exemplar /
log-det product of csrc/marginals_tile.cuh and graph cut's skinny tile.

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
and the per-lane chunk (37, 128, 256).  Then it builds
graph_cut_marginals.cu three times the same way:

* ``shipped``;
* ``no_fma``: the product loop runs over no feature, so the kernel
  streams x through its ring, sums the norms and stores the gains;
* ``no_copy``: no cp.async is started, so the product runs on whatever the
  ring holds (wrong sums: the arithmetic's time without the loads);

and times each at the filter shape, f32 and bf16.  Last it runs the
shipped facility kernel at the filter shape for three seconds while
sampling the SM clock, power draw and throttle reasons with nvidia-smi,
and prints the card's name and power limit.  Imports nothing of JAX.
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
TILE_VARIANTS = (
    ("shipped", []),
    ("no_epilogue", [("for (int c0 = part * part_cols; c0 < c_end; c0 += 4)",
                      "for (int c0 = part * part_cols; c0 < 0; c0 += 4)")]),
    ("half_lds", [("      fragments(buf, kk, fa, fb);",
                   "      if ((kk & 1) == 0) fragments(buf, kk, fa, fb);")]),
)
#: (name, [(text, replacement)]) patches of graph_cut_marginals.cu
GC_VARIANTS = (
    ("shipped", []),
    ("no_fma", [("    for (int kk = 0; kk < kDepth; kk += 4) {\n"
                 "      const int off =",
                 "    for (int kk = 0; kk < 0; kk += 4) {\n"
                 "      const int off =")]),
    ("no_copy", [("        cp_async16(to, ok ? x + row * d + k : x, "
                  "ok ? 16 : 0);", "        (void)ok;")]),
)


def build(tmp: Path, source: str, patched: str, variants) -> dict:
    """{variant: its ``source``_launch}, each built from a copy of the
    sources with ``patched`` patched, all in parallel."""
    procs = {}
    for name, patch in variants:
        src = tmp / f"{source}_{name}"
        shutil.copytree(_build.CSRC, src)
        target = src / patched
        text = target.read_text()
        for old, new in patch:
            if old not in text:
                raise RuntimeError(f"{name}: {patched} no longer has "
                                   f"{old!r}")
            text = text.replace(old, new)
        target.write_text(text)
        cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o",
               str(src / "lib.so"), str(src / f"{source}.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    fns = {}
    argtypes = _build.SIGNATURES[source][f"{source}_launch"]
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc {name} failed:\n{log}")
        lib = ctypes.CDLL(str(tmp / f"{source}_{name}" / "lib.so"))
        fn = getattr(lib, f"{source}_launch")
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
        gc_fns = build(Path(tmp), "graph_cut_marginals",
                       "graph_cut_marginals.cu", GC_VARIANTS)
        t = X.sum(0)
        st = (t * torch.rand((L, 1), generator=g, device=dev)).contiguous()
        out = torch.empty((L, N), device=dev)
        for dtype in (torch.float32, torch.bfloat16):
            Xd = X.to(dtype)
            for name, fn in gc_fns.items():
                call = lambda: fn(Xd.data_ptr(),  # noqa: E731
                                  int(dtype == torch.bfloat16), 0,
                                  st.data_ptr(), t.data_ptr(), 0.5,
                                  out.data_ptr(), L, N, D, stream)
                ms = cuda_ms(call, 10)
                print(f"[probe] graph_cut filter x{tuple(Xd.shape)} "
                      f"{str(dtype)[6:]} L={L} {name}: {ms} ms")
        st = (torch.rand((L, R), generator=g, device=dev) * D / 4).contiguous()
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
