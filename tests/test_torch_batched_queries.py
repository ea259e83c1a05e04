"""The port's query axis against the JAX package, on the CPU: per-lane
budgets (``k_dyn``) in every engine, ``threshold_greedy_batch``,
``bind_query``, ``two_round_batch_sim`` with its RoundLog, and
``DistributedSelector.select_batch``.

The batched driver's sample round is two_round_sim's, so the harness
injects the JAX key's draws (``jax_uniforms``).  ``sol_ids``, ``sol_size``,
``n_dropped`` and ``tau_fallback`` must be equal for every query,
``value`` within rtol 1e-5, and the RoundLogs equal record for record.
FacilityLocation runs on dyadic data (X = (a/8)^2, R = b/8) and GraphCut
on a/8 rows with dyadic lam, where every gain is exact; FeatureCoverage on
U[0,1)^2 rows and the log-det oracles on Gaussian rows, where gains agree
to rounding and the ids must still be equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_mapreduce import jax_uniforms

from repro.core import FacilityLocation as JFacilityLocation
from repro.core import FeatureCoverage as JFeatureCoverage
from repro.core import GraphCut as JGraphCut
from repro.core import LogDetDiversity as JLogDet
from repro.core import MRConfig as JMRConfig
from repro.core import MutualInformationGaussian as JMI
from repro.core import functions as jF
from repro.core import mapreduce as jmr
from repro.core import threshold as jth
from repro_torch import interop
from repro_torch.core import functions as tF
from repro_torch.core import mapreduce as tmr
from repro_torch.core import selector as tsel
from repro_torch.core import threshold as tth

torch.set_num_threads(2)
jax.config.update("jax_platform_name", "cpu")

N, D, M, K = 1024, 12, 8, 8


def _data(name, seed):
    """(rows (N, D), the JAX oracle, the port's oracle with use_kernel)."""
    rng = np.random.default_rng(seed)
    if name == "facility_location":
        X = ((rng.integers(0, 8, (N, D)) / 8.0) ** 2).astype(np.float32)
        ref = (rng.integers(0, 8, (24, D)) / 8.0).astype(np.float32)
        return X, JFacilityLocation(feat_dim=D, reference=jnp.asarray(ref)), \
            interop.facility_location(D, ref, use_kernel=True)
    if name == "graph_cut":
        X = (rng.integers(0, 9, (N, D)) / 8.0).astype(np.float32)
        total = X.sum(0)
        return X, JGraphCut(feat_dim=D, total=jnp.asarray(total), lam=0.5), \
            interop.graph_cut(D, total, 0.5, use_kernel=True)
    if name == "log_det":
        X = (rng.standard_normal((N, D)) * 0.5).astype(np.float32)
        return X, JLogDet(feat_dim=D, k_max=K, alpha=1.0), \
            interop.log_det(D, K, 1.0, use_kernel=True)
    if name == "mutual_information":
        X = (rng.standard_normal((N, D)) * 0.5).astype(np.float32)
        return X, JMI(feat_dim=D, k_max=K, noise=0.7), \
            interop.mutual_information(D, K, 0.7, use_kernel=True)
    X = (rng.random((N, D), dtype=np.float32)) ** 2
    return X, JFeatureCoverage(feat_dim=D), \
        interop.feature_coverage(D, use_kernel=True)


def _shards(X):
    return (X.reshape(M, N // M, D),
            np.arange(N, dtype=np.int32).reshape(M, -1),
            np.ones((M, N // M), bool))


def _same_batch(jres, tres, rtol=1e-5):
    np.testing.assert_array_equal(tres.sol_ids.numpy(),
                                  np.asarray(jres.sol_ids))
    np.testing.assert_array_equal(tres.sol_size.numpy(),
                                  np.asarray(jres.sol_size))
    np.testing.assert_array_equal(tres.n_dropped.numpy(),
                                  np.asarray(jres.n_dropped))
    np.testing.assert_array_equal(tres.tau_fallback.numpy(),
                                  np.asarray(jres.tau_fallback))
    np.testing.assert_allclose(tres.value.numpy(), np.asarray(jres.value),
                               rtol=rtol)


def _records(log):
    return [(r.name, r.bytes_per_machine, r.bytes_total, r.detail)
            for r in log.records]


# ---------------------------------------------------------------------------
# the engine layer: per-lane budgets and threshold_greedy_batch
# ---------------------------------------------------------------------------

def _block(name, seed=0, n=256):
    """A candidate block and a tau of half the max singleton over 2k."""
    X, jo, to = _data(name, seed)
    X = X[:n]
    st0 = to.init_state()
    tau = float(to.marginals(st0, to.prep(st0, torch.from_numpy(X))).max()) \
        / (2 * K)
    return X, jo, to, tau


@pytest.mark.parametrize("engine", ["dense", "lazy", "fused"])
@pytest.mark.parametrize("name", ["feature_coverage", "facility_location"])
def test_batch_engine_matches_jax(name, engine):
    """Q queries over one block, each with its tau and budget, against the
    JAX package's vmapped threshold_greedy_batch."""
    X, jo, to, tau = _block(name)
    n = X.shape[0]
    taus = np.asarray([tau, 2 * tau, tau / 2, tau], np.float32)
    kdyn = np.asarray([K, K, K // 2, 3], np.int32)
    Q = len(taus)
    js = jax.vmap(lambda _: jo.init_state())(jnp.arange(Q))
    jout = jth.threshold_greedy_batch(
        jo, js, jnp.full((Q, K), -1, jnp.int32), jnp.zeros((Q,), jnp.int32),
        jnp.asarray(X), jnp.arange(n, dtype=jnp.int32), jnp.ones((n,), bool),
        jnp.asarray(taus), K, k_dyn=jnp.asarray(kdyn), engine=engine,
        chunk=16)
    tout = tth.threshold_greedy_batch(
        to, to.init_state(Q), torch.full((Q, K), -1, dtype=torch.int32),
        torch.zeros(Q, dtype=torch.int32), torch.from_numpy(X),
        torch.arange(n, dtype=torch.int32), torch.ones(n, dtype=torch.bool),
        torch.from_numpy(taus), K, k_dyn=torch.from_numpy(kdyn),
        engine=engine, chunk=16)
    np.testing.assert_array_equal(tout[1].numpy(), np.asarray(jout[1]))
    np.testing.assert_array_equal(tout[2].numpy(), np.asarray(jout[2]))
    assert (tout[2].numpy() <= kdyn).all()


@pytest.mark.parametrize("engine", ["dense", "fused"])
def test_batch_engine_bind_matches_jax(engine):
    """``bind`` rebinds GraphCut's lam per query (dyadic rows and lam, so
    every gain is exact): each query is a one-lane call of its oracle."""
    X, jo, to, tau = _block("graph_cut", seed=1)
    n = X.shape[0]
    lams = np.asarray([0.5, 0.25, 0.125, 0.0], np.float32)
    kdyn = np.asarray([K, 5, K, 2], np.int32)
    Q = len(lams)
    taus = np.full(Q, tau, np.float32)
    jout = jth.threshold_greedy_batch(
        jo, jax.vmap(lambda _: jo.init_state())(jnp.arange(Q)),
        jnp.full((Q, K), -1, jnp.int32), jnp.zeros((Q,), jnp.int32),
        jnp.asarray(X), jnp.arange(n, dtype=jnp.int32), jnp.ones((n,), bool),
        jnp.asarray(taus), K, k_dyn=jnp.asarray(kdyn),
        bind=lambda o, lam: jF.bind_query(o, graph_cut_lam=lam),
        bind_params=jnp.asarray(lams), engine=engine, chunk=16)
    tout = tth.threshold_greedy_batch(
        to, to.init_state(Q), torch.full((Q, K), -1, dtype=torch.int32),
        torch.zeros(Q, dtype=torch.int32), torch.from_numpy(X),
        torch.arange(n, dtype=torch.int32), torch.ones(n, dtype=torch.bool),
        torch.from_numpy(taus), K, k_dyn=torch.from_numpy(kdyn),
        bind=lambda o, lam: tF.bind_query(o, graph_cut_lam=lam),
        bind_params=torch.from_numpy(lams), engine=engine, chunk=16,
        with_stats=True)
    np.testing.assert_array_equal(tout[1].numpy(), np.asarray(jout[1]))
    np.testing.assert_array_equal(tout[0].numpy(), np.asarray(jout[0]))
    assert tout[3].n_iters.shape == (Q,)


@pytest.mark.parametrize("engine", ["dense", "lazy", "fused"])
def test_dynamic_budget_is_a_prefix_and_zero_stays_empty(engine):
    """accept="first" with budget q accepts the first q elements of the
    budget-k run; lanes with budget 0 stay empty and are done at once."""
    X, _, to, tau = _block("feature_coverage", seed=5)
    n = X.shape[0]
    kdyn = torch.tensor([K, 0, 1, 4, 7, 0], dtype=torch.int32)
    L = kdyn.shape[0]
    args = (torch.from_numpy(X), torch.arange(n, dtype=torch.int32),
            torch.ones(n, dtype=torch.bool), torch.full((L,), tau), K)
    _, full, fsize = tth.threshold_greedy(
        to, to.init_state(L), torch.full((L, K), -1, dtype=torch.int32),
        torch.zeros(L, dtype=torch.int32), *args, engine=engine, chunk=16)
    _, sol, size, stats = tth.threshold_greedy(
        to, to.init_state(L), torch.full((L, K), -1, dtype=torch.int32),
        torch.zeros(L, dtype=torch.int32), *args, engine=engine, chunk=16,
        k_dyn=kdyn, with_stats=True)
    assert int(fsize[0]) == K
    np.testing.assert_array_equal(size.numpy(), kdyn.numpy())
    for lane in range(L):
        q = int(kdyn[lane])
        np.testing.assert_array_equal(sol[lane, :q].numpy(),
                                      full[lane, :q].numpy())
        assert (sol[lane, q:] == -1).all()
    zero = kdyn == 0
    assert (stats.n_iters[zero] == 0).all() and (stats.n_evals[zero] == 0).all()


def test_bind_query_and_consumes_query_params():
    X, _, gc, _ = _block("graph_cut")
    ld = interop.log_det(D, K, 1.0)
    mi = interop.mutual_information(D, K, 1.0)
    fc = interop.feature_coverage(D)
    assert tF.consumes_query_params(gc) and tF.consumes_query_params(ld)
    assert not tF.consumes_query_params(mi)
    assert not tF.consumes_query_params(fc)
    assert tF.bind_query(fc, 0.1, 0.1) is fc
    assert tF.bind_query(mi, 0.1, 0.3) is mi
    g = tF.bind_query(gc, torch.tensor(0.25), 3.0)
    assert g.lam == 0.25 and isinstance(g.lam, float) and g.use_kernel
    assert tF.bind_query(ld, 0.1, 0.5).alpha == 0.5


# ---------------------------------------------------------------------------
# the driver layer: two_round_batch_sim and select_batch
# ---------------------------------------------------------------------------

def _batch_both(name, seed, ks, lams=None, alphas=None, engine="fused",
                precision="f32"):
    X, jo, to = _data(name, seed)
    fm, ids, valid = _shards(X)
    key = jax.random.PRNGKey(seed)
    knobs = dict(k=K, n_total=N, n_machines=M, engine=engine, chunk=16,
                 precision=precision)
    jqb = jmr.make_query_batch(ks, lams, alphas)
    jres, jlog = jmr.two_round_batch_sim(
        jo, jnp.asarray(fm), jnp.asarray(ids), jnp.asarray(valid), jqb,
        JMRConfig(**knobs), key)
    u = interop.uniforms(jax_uniforms(key, 1, M, N // M))
    cfg = tmr.MRConfig(**knobs)
    tres, tlog = tmr.two_round_batch_sim(
        to, *interop.shard(fm, ids, valid), interop.query_batch(jqb), cfg,
        uniforms=u)
    return jres, jlog, tres, tlog, (to, fm, ids, valid, cfg, u)


@pytest.mark.parametrize("name,engine,precision,lams,alphas", [
    ("feature_coverage", "fused", "f32", None, None),
    ("feature_coverage", "dense", "bf16", None, None),
    ("facility_location", "lazy", "f32", None, None),
    ("graph_cut", "fused", "f32", [0.5, 0.25, 0.125, 0.0], None),
    ("log_det", "fused", "f32", None, [1.0, 0.5, 2.0, 0.25]),
    ("mutual_information", "dense", "f32", None, None)])
def test_two_round_batch_matches_jax(name, engine, precision, lams, alphas):
    """Q = 4 queries (budgets 8, 4, 2, 1) through both packages: every
    query's ids, sizes, counters and value, and the RoundLog; each query is
    also its own Q = 1 batch."""
    ks = [K, K // 2, 2, 1]
    jres, jlog, tres, tlog, (to, fm, ids, valid, cfg, u) = _batch_both(
        name, 21, ks, lams, alphas, engine, precision)
    _same_batch(jres, tres)
    assert _records(tlog) == _records(jlog)
    assert (tres.sol_size.numpy() <= np.asarray(ks)).all()
    for q in range(len(ks)):
        one = tmr.make_query_batch(
            ks[q:q + 1], None if lams is None else lams[q:q + 1],
            None if alphas is None else alphas[q:q + 1], device="cpu")
        r1, _ = tmr.two_round_batch_sim(to, *interop.shard(fm, ids, valid),
                                        one, cfg, uniforms=u)
        assert torch.equal(r1.sol_ids[0], tres.sol_ids[q])
        np.testing.assert_allclose(float(r1.value[0]), float(tres.value[q]),
                                   rtol=1e-5)


@pytest.mark.parametrize("name", ["feature_coverage", "graph_cut"])
def test_batch_q1_is_two_round(name):
    """A Q = 1 batch at k = cfg.k with the default hyper-parameters is
    two_round_sim: the same draws, ids and value."""
    X, _, to = _data(name, 22)
    shards = interop.shard(*_shards(X))
    cfg = tmr.MRConfig(k=K, n_total=N, n_machines=M, engine="fused", chunk=16)
    gen = torch.Generator().manual_seed(3)
    u = torch.rand((1, M, N // M), generator=gen)
    r2, _ = tmr.two_round_sim(to, *shards, cfg, uniforms=u)
    rb, _ = tmr.two_round_batch_sim(
        to, *shards, tmr.make_query_batch([K], device="cpu"), cfg,
        uniforms=u)
    assert torch.equal(rb.sol_ids[0], r2.sol_ids)
    assert float(rb.value[0]) == float(r2.value)
    assert int(rb.n_dropped[0]) == int(r2.n_dropped)


@pytest.mark.parametrize("name,lams,alphas", [
    ("graph_cut", [0.5, 0.25, 0.125, 0.0], None),
    ("log_det", None, [1.0, 0.5, 2.0, 0.25])])
def test_batch_hyperparams_equal_static_oracles(name, lams, alphas):
    """Query q at budget k with lam_q (alpha_q) is two_round_sim on the
    oracle built with that lam (alpha)."""
    X, _, to = _data(name, 23)
    shards = interop.shard(*_shards(X))
    cfg = tmr.MRConfig(k=K, n_total=N, n_machines=M, engine="fused", chunk=16)
    u = torch.rand((1, M, N // M), generator=torch.Generator().manual_seed(4))
    Q = len(lams or alphas)
    rb, _ = tmr.two_round_batch_sim(
        to, *shards, tmr.make_query_batch([K] * Q, lams, alphas,
                                          device="cpu"), cfg, uniforms=u)
    for q in range(Q):
        static = (interop.graph_cut(D, to.total.numpy(), lams[q],
                                    use_kernel=True) if lams
                  else interop.log_det(D, K, alphas[q], use_kernel=True))
        r2, _ = tmr.two_round_sim(static, *shards, cfg, uniforms=u)
        assert torch.equal(rb.sol_ids[q], r2.sol_ids)
        assert float(rb.value[q]) == float(r2.value)


@pytest.mark.parametrize("shared,precision", [(True, "f32"),
                                              (False, "bf16")])
def test_batch_round_log_matches_jax(shared, precision):
    for knobs in (dict(k=64, n_total=1 << 20, n_machines=16),
                  dict(k=8, n_total=1000, n_machines=4, eps=0.3)):
        knobs["precision"] = precision
        for Q in (1, 4):
            assert _records(tmr._batch_round_log(
                tmr.MRConfig(**knobs), knobs["n_machines"], 256, Q,
                shared)) == _records(jmr._batch_round_log(
                    JMRConfig(**knobs), knobs["n_machines"], 256, Q, shared))


def test_batch_refuses_a_constraint():
    X, _, to = _data("feature_coverage", 24)
    tc = interop.knapsack(np.ones(N, np.float32), 4.0)
    cfg = tmr.MRConfig(k=K, n_total=N, n_machines=M, constraint=tc)
    with pytest.raises(NotImplementedError, match="query-batched"):
        tmr.two_round_batch_sim(to, *interop.shard(*_shards(X)),
                                tmr.make_query_batch([K], device="cpu"), cfg)


def test_select_batch_matches_jax_driver():
    """DistributedSelector.select_batch is the JAX batched sim driver; its
    batch RoundLog is reused per Q, so its counters add up; a budget past
    spec.k and a known-OPT algorithm are refused."""
    X, jo, _ = _data("feature_coverage", 25)
    fm, ids, valid = _shards(X)
    key = jax.random.PRNGKey(25)
    jqb = jmr.make_query_batch([K, 3, 5])
    jres, jlog = jmr.two_round_batch_sim(
        jo, jnp.asarray(fm), jnp.asarray(ids), jnp.asarray(valid), jqb,
        JMRConfig(k=K, n_total=N, n_machines=M, engine="fused"), key)
    sel = tsel.DistributedSelector(
        tsel.SelectorSpec(k=K, engine="fused", use_kernel=True), n_total=N,
        feat_dim=D, n_machines=M, device="cpu")
    u = jax_uniforms(key, 1, M, N // M)
    qb = interop.query_batch(jqb)
    res = sel.select_batch(X, qb, uniforms=u)
    _same_batch(jres, res)
    log = sel.round_log_batch
    assert _records(log) == _records(jlog)
    sel.select_batch(X, qb, uniforms=u)
    assert sel.round_log_batch is log
    assert "n_dropped=0 tau_fallback=0" in log.summary()
    assert len(log.events["n_dropped"].shape) == 0
    with pytest.raises(ValueError, match="exceeds"):
        sel.select_batch(X, tmr.make_query_batch([K + 1], device="cpu"))
    known = tsel.DistributedSelector(
        tsel.SelectorSpec(k=K, algorithm="multi_threshold", t=2), n_total=N,
        feat_dim=D, n_machines=M, device="cpu")
    with pytest.raises(ValueError, match="OPT-free"):
        known.select_batch(X, qb)


def test_query_batch_follows_the_device_rule(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tmr.make_query_batch([4, 2])
    qb = tmr.make_query_batch([4, 2], graph_cut_lam=[0.1, 0.2], device="cpu")
    assert qb.n_queries == 2 and qb.k.dtype == torch.int32
    assert qb.logdet_alpha.tolist() == [1.0, 1.0]
