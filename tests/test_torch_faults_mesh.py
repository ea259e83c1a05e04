"""The port's fault layer against the JAX package, on the CPU, continued
from test_torch_faults.py (whose harness this is):

* a chaos plan on Algorithm 5 and the split and batched sim drivers,
  against the JAX sim drivers;
* a spawned four-rank mesh (``_torch_mesh_ranks``) under a plan against
  the port's sim at m = 4 under the same plan, both drawing from a
  generator of the same seed: the same ids, records and fault records,
  and the values' bits on every rank;
* ``runtime_events`` of the selector on a one-rank mesh against the JAX
  selector on the 1-device mesh under the same plan;
* the per-query batch's order of gathers under a plan, the JAX mesh
  driver's on both substrates.
"""

import _torch_mesh_ranks as ranks
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_faults import (D, K, N, OPT, PLANS, _assert_faults_same,
                               _both, _corpus, _fault_tuples)
from test_torch_mapreduce import jax_mesh_uniforms
from test_torch_mesh import _records, assert_same

from repro.core import GraphCut as JGraphCut
from repro.core import MRConfig as JMRConfig
from repro.core import faults as jfaults
from repro.core import mapreduce as jmr
from repro.core import selector as jsel
from repro.launch.mesh import make_mesh_for as j_make_mesh_for
from repro_torch import interop
from repro_torch.core import faults as tfaults
from repro_torch.core import mapreduce as tmr
from repro_torch.core import selector as tsel
from repro_torch.launch import mesh as tmesh

torch.set_num_threads(2)
jax.config.update("jax_platform_name", "cpu")


@pytest.mark.parametrize("driver", ["multi_threshold", "sparse", "dense",
                                    "batch"])
def test_the_other_drivers_under_chaos_match_the_jax_sim(driver):
    jres, jlog, tres, tlog = _both(driver, PLANS["chaos"])
    _assert_faults_same(jres, jlog, tres, tlog)



# ---------------------------------------------------------------------------
# the mesh under a plan, and the selector's runtime events
# ---------------------------------------------------------------------------

MESH_CASES = {
    "two_round_chaos": dict(spec=dict(faults=PLANS["chaos"])),
    "multi_epoch_loss": dict(spec=dict(algorithm="multi_epoch", epochs=2,
                                       faults=PLANS["shard_loss"])),
    "known_opt_drop": dict(spec=dict(algorithm="two_round_known_opt",
                                     faults=PLANS["msg_drop"]), opt=OPT),
    "batch_chaos": dict(spec=dict(faults=PLANS["chaos"]),
                        batch=([6, 3, 1], None, None)),
}


@pytest.fixture(scope="module")
def mesh_under_plans():
    X = _corpus(4, m=4)[0]
    cases = []
    for i, (name, c) in enumerate(MESH_CASES.items()):
        spec = dict(k=K, engine="fused", chunk=16, use_kernel=True,
                    **c["spec"])
        cases.append(dict(c, mesh=(4, 1), spec=spec, X=X, seed=40 + i))
    return cases, ranks.spawn(4, cases)


@pytest.mark.parametrize("name", list(MESH_CASES))
def test_the_mesh_under_a_plan_is_the_sim_under_it(mesh_under_plans, name):
    cases, port = mesh_under_plans
    i = list(MESH_CASES).index(name)
    c = cases[i]
    spec = dict(c["spec"], faults=tfaults.FaultPlan(**c["spec"]["faults"]))
    sel = tsel.DistributedSelector(tsel.SelectorSpec(**spec), n_total=N,
                                   feat_dim=D, n_machines=4, device="cpu")
    gen = torch.Generator().manual_seed(c["seed"])
    if c.get("batch") is not None:
        res = sel.select_batch(c["X"], tmr.make_query_batch(
            *c["batch"], device="cpu"), generator=gen)
        log = sel.round_log_batch
    else:
        res = sel.select(c["X"], opt_estimate=c.get("opt"), generator=gen)
        log = sel.round_log
    for r in range(4):
        got = port[r][i]
        assert_same(res, got, bits=True)
        assert [tuple(x) for x in got["records"]] == _records(log)
        assert got["faults"] == _fault_tuples(log)
        assert got["degraded"] == int(res.degraded) == 1
        assert got["haircut"] == float(res.haircut)
        assert got["events"] == sel.runtime_events()


def test_runtime_events_match_the_jax_selector():
    """Two selects and a select_batch under a plan, on a one-rank mesh and
    on the JAX package's 1-device mesh: the same runtime_events (counters
    and fault_* keys)."""
    X = _corpus(5, n=256, m=1)[0]
    plan = dict(drop_rate=0.5, corrupt_rate=0.5, seed=3)
    jsel_ = jsel.DistributedSelector(
        jsel.SelectorSpec(k=K, engine="fused", chunk=16,
                          faults=jfaults.FaultPlan(**plan)),
        j_make_mesh_for(1, model_parallel=1), n_total=256, feat_dim=D)
    with ranks.one_rank():
        sel = tsel.DistributedSelector(
            tsel.SelectorSpec(k=K, engine="fused", chunk=16,
                              faults=tfaults.FaultPlan(**plan)),
            n_total=256, feat_dim=D, device="cpu",
            mesh=tmesh.make_mesh_for(1, model_parallel=1))
        for s in (1, 2):
            key = jax.random.PRNGKey(s)
            jres = jsel_.select(jnp.asarray(X), key=key)
            res = sel.select(X, uniforms=jax_mesh_uniforms([key], 1, 256))
            assert_same(jres, res)
            assert int(res.degraded) == int(jres.degraded)
        key = jax.random.PRNGKey(3)
        jsel_.select_batch(jnp.asarray(X), jmr.make_query_batch([6, 2]),
                           key=key)
        sel.select_batch(X, tmr.make_query_batch([6, 2], device="cpu"),
                         uniforms=jax_mesh_uniforms([key], 1, 256))
    events = sel.runtime_events()
    assert events == jsel_.runtime_events()
    assert events["degraded_selects"] >= 1


def test_per_query_batch_degrades_tops_before_survivors():
    """GraphCut's select_batch (one oracle a query) under a plan that drops
    the only machine's second gather (seed 4 at m = 1): the port gathers
    the sample, then the queries' stacked top-singleton messages, then
    their survivors, on the sim as on the mesh, and so gives the JAX mesh
    driver's result.  The JAX sim driver gathers each query's survivors
    before its tops (inside its vmapped query body), so the drop lands on
    its survivors and its result differs (ROADMAP queue 3)."""
    import numpy as np

    from repro.core import GraphCut as JGraphCut
    from repro.core import MRConfig as JMRConfig
    from repro_torch import interop

    n = 256
    rng = np.random.default_rng(13)
    X = (rng.integers(0, 9, (n, D)) / 8.0).astype(np.float32)
    ids = np.arange(n, dtype=np.int32)
    ks, lams = [6, 3], [0.5, 0.25]
    plan = dict(drop_rate=0.5, seed=4)
    knobs = dict(k=K, n_total=n, n_machines=1, engine="fused", chunk=16)
    jo = JGraphCut(feat_dim=D, total=jnp.asarray(X.sum(0)), lam=0.5)
    jcfg = JMRConfig(**knobs, faults=jfaults.FaultPlan(**plan))
    key = jax.random.PRNGKey(12)
    run, round_log = jmr.two_round_batch_mesh(
        jo, jcfg, j_make_mesh_for(1, model_parallel=1))
    jres = jax.jit(run)(jnp.asarray(X), jnp.asarray(ids),
                        jmr.make_query_batch(ks, lams), key)
    jsim, _ = jmr.two_round_batch_sim(
        jo, jnp.asarray(X)[None], jnp.asarray(ids)[None],
        jnp.ones((1, n), bool), jmr.make_query_batch(ks, lams), jcfg, key)
    tres, tlog = tmr.two_round_batch_sim(
        interop.graph_cut(D, X.sum(0), 0.5, use_kernel=True),
        *interop.shard(X[None], ids[None], np.ones((1, n), bool)),
        tmr.make_query_batch(ks, lams, device="cpu"),
        tmr.MRConfig(**knobs, faults=tfaults.FaultPlan(**plan)),
        uniforms=jax_mesh_uniforms([key], 1, n))
    assert_same(jres, tres)
    assert _fault_tuples(tlog) == _fault_tuples(round_log(2))
    assert [r.round_index for r in tlog.faults] == [1]
    assert not np.array_equal(np.asarray(jsim.sol_ids),
                              np.asarray(jres.sol_ids))
