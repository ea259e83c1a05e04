"""The JAX package's selector on a mesh of several host devices, for the
port's multi-process mesh tests.  Run as a script in a process of its own,
whose XLA_FLAGS ask for the devices before JAX starts:

    XLA_FLAGS=--xla_force_host_platform_device_count=4 \\
        python tests/_jax_mesh_reference.py CASES OUT

CASES is a pickle of the cases of ``_torch_mesh_ranks.run_case``, each
with ``key``, the seed of its PRNG key; OUT receives, per case, the JAX
result and its RoundLog's records and fault records.
"""

import pickle
import sys

import jax
import jax.numpy as jnp
import numpy as np

from repro.core import faults as jfaults
from repro.core import mapreduce as jmr
from repro.core import selector as jsel
from repro.launch.mesh import make_mesh_for


def run(case):
    data, model = case["mesh"]
    mesh = make_mesh_for(data * model, model_parallel=model)
    knobs = dict(case["spec"])
    if knobs.get("faults") is not None:
        knobs["faults"] = jfaults.FaultPlan(**knobs["faults"])
    knobs.pop("use_kernel", None)
    spec = jsel.SelectorSpec(**knobs)
    X = jnp.asarray(case["X"])
    n, d = X.shape
    opt = lambda a: None if a is None else jnp.asarray(a)  # noqa: E731
    sel = jsel.DistributedSelector(
        spec, mesh, n_total=n, feat_dim=d,
        reference=opt(case.get("reference")), total=opt(case.get("total")))
    key = jax.random.PRNGKey(case["key"])
    if case.get("batch") is not None:
        res = sel.select_batch(X, jmr.make_query_batch(*case["batch"]),
                               key=key)
        log = sel.round_log_batch
    else:
        o = case.get("opt")
        res = sel.select(X, None if o is None else jnp.float32(o), key=key)
        log = sel.round_log
    return dict(
        ids=np.asarray(res.sol_ids), size=np.asarray(res.sol_size),
        value=np.asarray(res.value), n_dropped=np.asarray(res.n_dropped),
        tau_fallback=np.asarray(res.tau_fallback),
        degraded=int(res.degraded), haircut=float(res.haircut),
        records=[(r.name, r.bytes_per_machine, r.bytes_total, r.detail)
                 for r in log.records],
        faults=[tuple(getattr(r, f) for f in r.__dataclass_fields__)
                for r in log.faults])


def main(argv):
    jax.config.update("jax_platform_name", "cpu")
    with open(argv[0], "rb") as f:
        cases = pickle.load(f)
    out = [run(c) for c in cases]
    with open(argv[1], "wb") as f:
        pickle.dump(out, f)


if __name__ == "__main__":
    main(sys.argv[1:])
