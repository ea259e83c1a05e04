"""The rank side of the port's multi-process mesh tests.

``spawn(world, cases)`` starts ``world`` Python processes that join one
gloo job (a ``file://`` store in a temporary directory, and a timeout on
every process group) and run every case on a mesh; it returns each rank's
results, or raises when a rank fails or the job outlives its time.  A
case is a plain dict of numpy arrays and numbers (see ``run_case``), so
the children import only torch, numpy and repro_torch, never JAX.

``one_rank()`` is the same job with one rank in the calling process.
"""

from __future__ import annotations

import contextlib
import datetime
import os
import pickle
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import faults as tfaults
from repro_torch.core import mapreduce as tmr
from repro_torch.core import selector as tsel
from repro_torch.launch.mesh import make_mesh_for
from repro_torch.streaming import distributed_sieve as tds
from repro_torch.streaming import sieve as tsieve

#: a process group's collectives give up after this long
GROUP_TIMEOUT_S = 60

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(os.path.dirname(_HERE), "src")


def _init(rank: int, world: int, store: str) -> None:
    dist.init_process_group(
        "gloo", init_method="file://" + store, rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))


@contextlib.contextmanager
def one_rank():
    """A gloo job of one rank in this process, torn down on exit."""
    with tempfile.TemporaryDirectory() as tmp:
        _init(0, 1, os.path.join(tmp, "store"))
        try:
            yield
        finally:
            dist.destroy_process_group()


def spawn(world: int, cases, timeout: float = 240.0,
          module: str = "_torch_mesh_ranks"):
    """Run ``cases`` on ``world`` ranks; returns [rank][case] results.
    ``module`` is the rank side (its ``main`` runs the cases)."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "cases.pkl")
        with open(path, "wb") as f:
            pickle.dump(cases, f)
        env = dict(os.environ, OMP_NUM_THREADS="1",
                   PYTHONPATH=os.pathsep.join(
                       [_SRC, _HERE, os.environ.get("PYTHONPATH", "")]))
        logs = [open(os.path.join(tmp, f"log{r}"), "w+b")
                for r in range(world)]
        procs = [subprocess.Popen(
            [sys.executable, "-m", module, str(r), str(world),
             os.path.join(tmp, "store"), path, os.path.join(tmp, f"out{r}")],
            env=env, cwd=tmp, stdout=logs[r], stderr=subprocess.STDOUT)
            for r in range(world)]
        deadline = time.monotonic() + timeout
        try:
            for p in procs:
                p.wait(timeout=max(1.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            raise RuntimeError(f"the {world}-rank job outlived {timeout} s")
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            for f in logs:
                f.close()
        bad = [r for r, p in enumerate(procs) if p.returncode != 0]
        if bad:
            with open(os.path.join(tmp, f"log{bad[0]}"), "rb") as f:
                tail = f.read().decode(errors="replace")[-3000:]
            raise RuntimeError(f"ranks {bad} of {world} failed:\n{tail}")
        out = []
        for r in range(world):
            with open(os.path.join(tmp, f"out{r}"), "rb") as f:
                out.append(pickle.load(f))
        return out


def _plan(d):
    return None if d is None else tfaults.FaultPlan(**d)


def run_case(case, meshes):
    """One selection on a mesh, as a dict of numpy results.

    ``case``: ``mesh`` (data, model); ``spec`` SelectorSpec knobs (with
    ``faults`` a FaultPlan's fields, or None); ``X`` the global (n, d)
    corpus, and ``reference`` / ``total`` where the oracle takes them;
    ``uniforms`` the (E, m, n/m) draws or None, then ``seed`` seeds a
    generator; ``opt`` for the known-OPT algorithms; ``batch`` (k, lam,
    alpha) for select_batch.  A case with ``sieve`` (SieveSpec knobs) runs
    sieve_and_merge_mesh instead (``run_sieve``)."""
    if case["mesh"] not in meshes:
        meshes[case["mesh"]] = make_mesh_for(int(np.prod(case["mesh"])),
                                             model_parallel=case["mesh"][1])
    mesh = meshes[case["mesh"]]
    if case.get("sieve") is not None:
        return run_sieve(case, mesh)
    knobs = dict(case["spec"])
    knobs["faults"] = _plan(knobs.get("faults"))
    spec = tsel.SelectorSpec(**knobs)
    X = case["X"]
    sel = tsel.DistributedSelector(
        spec, n_total=X.shape[0], feat_dim=X.shape[1], device="cpu",
        reference=case.get("reference"), total=case.get("total"), mesh=mesh)
    u = case.get("uniforms")
    draws = (dict(uniforms=torch.from_numpy(u)) if u is not None else
             dict(generator=torch.Generator().manual_seed(case["seed"])))
    shard = sel.data_sharding(X)
    if case.get("batch") is not None:
        k, lam, alpha = case["batch"]
        res = sel.select_batch(
            shard, tmr.make_query_batch(k, lam, alpha, device="cpu"), **draws)
        log = sel.round_log_batch
    else:
        res = sel.select(shard, opt_estimate=case.get("opt"), **draws)
        log = sel.round_log
    return dict(
        ids=res.sol_ids.numpy(), size=np.asarray(res.sol_size),
        value=res.value.numpy(), n_dropped=np.asarray(res.n_dropped),
        tau_fallback=np.asarray(res.tau_fallback),
        degraded=int(res.degraded), haircut=float(res.haircut),
        records=[dataclass_tuple(r) for r in log.records],
        faults=[dataclass_tuple(r) for r in log.faults],
        events=sel.runtime_events(), tp=sel.tp)


def run_sieve(case, mesh):
    """sieve_and_merge_mesh on ``mesh``: ``sieve`` the SieveSpec knobs,
    ``spec`` the SelectorSpec knobs of the oracle, ``X`` the global corpus
    (this rank streams its machine's rows), ``chunk_elems``, ``pool_cap``
    and ``faults`` (a FaultPlan's fields, or None)."""
    X = case["X"]
    n, d = X.shape
    oracle = tsel.make_oracle(tsel.SelectorSpec(**case["spec"]), d, "cpu",
                              reference=case.get("reference"),
                              total=case.get("total"))
    run, log = tds.sieve_and_merge_mesh(
        oracle, tsieve.SieveSpec(**case["sieve"]), mesh,
        chunk_elems=case["chunk_elems"], pool_cap=case.get("pool_cap"),
        faults=_plan(case.get("faults")))
    m = mesh.size(("data",))
    c = mesh.index(("data",))
    rows = slice(c * n // m, (c + 1) * n // m)
    res = run(torch.from_numpy(X[rows]),
              torch.arange(n, dtype=torch.int32)[rows])
    return sieve_result(res, log)


def sieve_result(res, log):
    return dict(
        ids=res.sol_ids.numpy(), size=int(res.sol_size),
        value=res.value.numpy(), n_dropped=int(res.n_dropped),
        tau_fallback=int(res.tau_fallback), degraded=int(res.degraded),
        haircut=float(res.haircut),
        records=[dataclass_tuple(r) for r in log.records],
        faults=[dataclass_tuple(r) for r in log.faults])


def dataclass_tuple(rec):
    return tuple(getattr(rec, f) for f in rec.__dataclass_fields__)


def main(argv) -> None:
    rank, world, store, cases, out = argv
    torch.set_num_threads(1)
    _init(int(rank), int(world), store)
    with open(cases, "rb") as f:
        cases = pickle.load(f)
    meshes = {}
    results = [run_case(c, meshes) for c in cases]
    dist.destroy_process_group()
    with open(out, "wb") as f:
        pickle.dump(results, f)


if __name__ == "__main__":
    main(sys.argv[1:])
