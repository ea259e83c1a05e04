"""Build the CUDA kernels with ``nvcc`` at first use and load them with ctypes.

Each ``csrc/*.cu`` file becomes its own shared library with a plain C
interface (no PyTorch headers, so a build takes seconds), compiled for
``sm_90a``.  Libraries land in ``build/repro_torch/<hash>/`` at the root of
the checkout, keyed on a hash of every source and header plus the flags, so
an edited source rebuilds and an unchanged one loads at once.  All sources
build in parallel, one ``nvcc`` each.  ``ptxas -v`` reports every kernel's
registers, shared memory and spills; its output is kept beside each
library (``ptxas_report``).

``--use_fast_math`` is deliberately absent: it turns ``sqrtf`` and ``logf``
into approximations, and the kernels must match their plain versions.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")
SOURCES = ("coverage_marginals", "coverage_accept", "facility_marginals",
           "facility_accept", "weighted_coverage_marginals",
           "weighted_coverage_accept", "saturated_coverage_marginals",
           "saturated_coverage_accept", "graph_cut_marginals",
           "graph_cut_accept", "logdet_marginals", "logdet_accept",
           "exemplar_marginals", "exemplar_accept")

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_F = ctypes.c_float
#: the accept sweeps' operands of the knapsack cost mode: the (L, B) row
#: costs and the (L,) remaining budgets, or two null pointers
_COST = (_P, _P)
#: C signature of every entry point: (argtypes, restype = cudaError_t)
SIGNATURES = {
    "coverage_marginals": {
        "coverage_marginals_launch": (_P, _I, _I, _P, _P, _P, _I, _LL, _I, _P),
    },
    "coverage_accept": {
        "coverage_accept_launch": (_P, _I, _P, _P, _P, _P, _P, *_COST, _P,
                                   _P, _P, _I, _I, _I, _I, _P),
    },
    "facility_marginals": {
        "facility_marginals_launch": (_P, _I, _I, _P, _P, _P, _I, _LL, _I, _I,
                                      _P),
        "rectified_residual_sum_launch": (_P, _I, _P, _P, _I, _LL, _I, _P),
    },
    "facility_accept": {
        "facility_accept_launch": (_P, _I, _P, _P, _P, _P, _P, *_COST, _P, _P,
                                   _P, _P, _I, _I, _I, _I, _I, _P),
    },
    "weighted_coverage_marginals": {
        "weighted_coverage_marginals_launch": (_P, _I, _I, _P, _P, _I, _LL, _I,
                                               _P),
    },
    "weighted_coverage_accept": {
        "weighted_coverage_accept_launch": (_P, _I, _P, _P, _P, _P, *_COST,
                                            _P, _P, _P, _I, _I, _I, _I, _P),
    },
    "saturated_coverage_marginals": {
        "saturated_coverage_marginals_launch": (_P, _I, _I, _P, _P, _P, _P, _I,
                                                _LL, _I, _P),
    },
    "saturated_coverage_accept": {
        "saturated_coverage_accept_launch": (_P, _I, _P, _P, _P, _P, _P, _P,
                                             *_COST, _P, _P, _P, _I, _I, _I,
                                             _I, _P),
    },
    "graph_cut_marginals": {
        "graph_cut_marginals_launch": (_P, _I, _I, _P, _P, _F, _P, _I, _LL,
                                       _I, _P),
    },
    "graph_cut_accept": {
        "graph_cut_accept_launch": (_P, _I, _P, _P, _F, _P, _P, _P, *_COST,
                                    _P, _P, _P, _I, _I, _I, _I, _P),
    },
    "logdet_marginals": {
        "logdet_marginals_launch": (_P, _I, _I, _P, _P, _P, _I, _I, _LL, _I,
                                    _F, _F, _F, _F, _P),
    },
    "logdet_accept": {
        "logdet_accept_launch": (_P, _I, _P, _P, _P, _P, _P, _P, *_COST, _P,
                                 _P, _P, _P, _P, _I, _I, _I, _I, _F, _F, _F,
                                 _I, _P),
    },
    "exemplar_marginals": {
        "exemplar_marginals_launch": (_P, _I, _I, _P, _P, _P, _P, _I, _LL, _I,
                                      _I, _P),
    },
    "exemplar_accept": {
        "exemplar_accept_launch": (_P, _I, _P, _P, _P, _P, _P, _P, *_COST, _P,
                                   _P, _P, _P, _I, _I, _I, _I, _I, _P),
    },
}


def nvcc_path() -> str:
    """The toolkit's nvcc: ``$CUDA_HOME/bin/nvcc``, else the one on PATH,
    else the default toolkit location."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    return shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.iterdir()):
        if p.suffix in (".cu", ".cuh"):
            h.update(p.name.encode())
            h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build_all() -> dict:
    """Compile every source that has no library yet (in parallel) and
    return {name: path of its .so}.  Raises RuntimeError with nvcc's
    output when a compile fails."""
    nvcc = nvcc_path()
    if not Path(nvcc).exists():
        raise RuntimeError(f"nvcc not found (looked for {nvcc}); the CUDA "
                           f"kernels build only where the CUDA toolkit is")
    out_dir = BUILD_ROOT / source_hash()
    out_dir.mkdir(parents=True, exist_ok=True)
    libs = {name: out_dir / f"lib{name}.so" for name in SOURCES}
    procs = {}
    for name, lib in libs.items():
        if lib.exists():
            continue
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp)
    failed = []
    for name, (proc, tmp) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"nvcc {name}.cu failed ({proc.returncode}):\n{log}")
            continue
        libs[name].with_suffix(".ptxas.txt").write_text(log)
        os.replace(tmp, libs[name])
    if failed:
        raise RuntimeError("\n".join(failed))
    return libs


def ptxas_report(name: str) -> str:
    """What ``ptxas -v`` said when source ``name`` was built: per kernel,
    its registers, shared memory, stack frame and spills."""
    log = build_all()[name].with_suffix(".ptxas.txt")
    return log.read_text() if log.exists() else ""


@functools.lru_cache(maxsize=None)
def library(name: str) -> ctypes.CDLL:
    """The loaded library of source ``name``, built on first use, with
    every entry point's argtypes and restype declared."""
    lib = ctypes.CDLL(str(build_all()[name]))
    for fn_name, argtypes in SIGNATURES[name].items():
        fn = getattr(lib, fn_name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return lib
