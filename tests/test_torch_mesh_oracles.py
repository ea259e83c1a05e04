"""The port's mesh drivers for FacilityLocation, and its selector on a
mesh for the other six oracles, against the JAX package on the CPU, on one
rank (a gloo job of one process, in the test process) and the 1-device
JAX mesh.  The harness is test_torch_mesh.py's: the JAX mesh's draws
injected into the port; ids, sizes and counts equal, values within rtol
1e-5, RoundLogs equal record for record.  FacilityLocation runs on dyadic
data (X = (a/8)^2, R = b/8), where every similarity is exact; the other
oracles on the data of their sim tests (dyadic, binary, or Gaussian rows
for the log-det oracles).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_mapreduce import jax_mesh_uniforms
from test_torch_mesh import (DRIVERS, ENGINES, D, K, N, _drivers, _dyadic,
                             _records, assert_same, mesh1)

from repro.core import FacilityLocation as JFacilityLocation
from repro.core import selector as jsel
from repro.launch.mesh import make_mesh_for as j_make_mesh_for
from repro_torch import interop
from repro_torch.core import selector as tsel
from repro_torch.core.sequential import greedy

torch.set_num_threads(2)
jax.config.update("jax_platform_name", "cpu")

__all__ = ["mesh1"]  # the one-rank job, a module-scoped fixture


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("driver", DRIVERS)
def test_one_rank_facility_drivers_match_the_jax_mesh(mesh1, driver, engine):
    X, R = _dyadic(6), _dyadic(7, n=24, square=False)
    to = interop.facility_location(X.shape[1], R, use_kernel=True)
    opt = 0.9 * float(greedy(to, torch.from_numpy(X),
                             torch.ones(N, dtype=torch.bool), K)[2])
    knobs = dict(k=K, n_total=N, n_machines=1, engine=engine, chunk=16)
    jres, jrec, tres, trec = _drivers(
        driver, JFacilityLocation(feat_dim=X.shape[1],
                                  reference=jnp.asarray(R)),
        to, knobs, mesh1, X, jax.random.PRNGKey(8), opt)
    assert_same(jres, tres)
    assert trec == jrec
    assert int(tres.sol_size.max()) > 0


def _oracle_data(name):
    """The corpus and the selector's arguments for ``name``."""
    kw, spec = {}, {}
    if name == "weighted_coverage":
        X = (np.random.default_rng(2).random((N, D)) < 0.3).astype(np.float32)
    elif name in ("saturated_coverage", "graph_cut"):
        X = _dyadic(3, square=name == "saturated_coverage")
        kw["total"] = X.sum(0)
    elif name == "exemplar":
        X = _dyadic(4, square=False)
        kw["reference"] = _dyadic(5, n=24, square=False)
    else:   # the log-det oracles: Gaussian rows
        X = (np.random.default_rng(40).standard_normal((N, 16)) * 0.5
             ).astype(np.float32)
        if name == "mutual_information":
            spec["mi_noise"] = 0.7
    return X, kw, spec


@pytest.mark.parametrize("name", ("weighted_coverage", "saturated_coverage",
                                  "graph_cut", "log_det", "exemplar",
                                  "mutual_information"))
def test_one_rank_oracles_match_the_jax_selector(mesh1, name):
    """The selector on a one-rank mesh against the JAX selector on the
    1-device mesh: two_round, fused engine, the port's kernel route."""
    X, kw, spec = _oracle_data(name)
    n, d = X.shape
    key = jax.random.PRNGKey(11)
    jsel_ = jsel.DistributedSelector(
        jsel.SelectorSpec(k=K, oracle=name, engine="fused", chunk=16, **spec),
        j_make_mesh_for(1, model_parallel=1), n_total=n, feat_dim=d,
        **{a: jnp.asarray(v) for a, v in kw.items()})
    jres = jsel_.select(jnp.asarray(X), key=key)
    sel = tsel.DistributedSelector(
        tsel.SelectorSpec(k=K, oracle=name, engine="fused", chunk=16,
                          use_kernel=True, **spec),
        n_total=n, feat_dim=d, device="cpu", mesh=mesh1, **kw)
    res = sel.select(X, uniforms=jax_mesh_uniforms([key], 1, n))
    assert_same(jres, res)
    assert _records(sel.round_log) == _records(jsel_.round_log)
    assert int(res.sol_size) > 0


