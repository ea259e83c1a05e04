"""The port's known-OPT and split drivers against the JAX package, on the
CPU: two_round_known_opt_sim (Algorithm 4), multi_threshold_sim
(Algorithm 5, with and without a schedule override), multi_epoch_sim with
``opt``, dense_two_round_sim (Algorithm 6) and sparse_two_round_sim
(Algorithm 7), the Theorem-4 instance, and the selector's known-OPT
select.

The JAX drivers draw their samples with ``jax.random``; the harness
computes those draws from the same keys (``draws``: one (m, n/m) block per
epoch key, split over the machines as ``SimRounds.sample`` splits it) and
injects them into the port.  ``sol_ids``, ``sol_size``, ``n_dropped`` and
``tau_fallback`` must be equal, ``value`` within rtol 1e-5, and the
RoundLogs equal record for record.  FacilityLocation runs on dyadic data
(X = (a/8)^2, R = b/8), where every similarity is exact; the constrained
runs on dyadic costs (multiples of 1/8), where every spend is exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_mapreduce import _assert_same

from repro.core import AdversarialThreshold as JAdversarialThreshold
from repro.core import FacilityLocation as JFacilityLocation
from repro.core import FeatureCoverage as JFeatureCoverage
from repro.core import MRConfig as JMRConfig
from repro.core import constraints as jcons
from repro.core import functions as jF
from repro.core import grids as jgrids
from repro.core import mapreduce as jmr
from repro.core import rounds as jrounds
from repro.core import selector as jsel
from repro_torch import interop
from repro_torch.core import functions as tF
from repro_torch.core import grids as tgrids
from repro_torch.core import mapreduce as tmr
from repro_torch.core import selector as tsel

torch.set_num_threads(2)
jax.config.update("jax_platform_name", "cpu")

N, D, M, K = 1024, 12, 8, 8
OPT = 26.0   # about sequential greedy's value on the corpora below


def draws(epoch_keys, m=M, n_local=N // M):
    """The (E, m, n/m) sample draws of JAX epoch keys: each key split over
    the m machines, one uniform vector each."""
    draw = jax.vmap(lambda kk: jax.random.uniform(kk, (n_local,)))
    return np.stack([np.asarray(draw(jax.random.split(ek, m)))
                     for ek in epoch_keys])


def _corpus(seed, facility=False):
    rng = np.random.default_rng(seed)
    if facility:
        X = ((rng.integers(0, 8, (N, D)) / 8.0) ** 2).astype(np.float32)
        ref = (rng.integers(0, 8, (24, D)) / 8.0).astype(np.float32)
    else:
        X, ref = (rng.random((N, D), dtype=np.float32)) ** 2, None
    return (X.reshape(M, N // M, D),
            np.arange(N, dtype=np.int32).reshape(M, -1),
            np.ones((M, N // M), bool), ref)


def _oracles(ref, use_kernel):
    if ref is None:
        return JFeatureCoverage(feat_dim=D), \
            interop.feature_coverage(D, use_kernel=use_kernel)
    return JFacilityLocation(feat_dim=D, reference=jnp.asarray(ref)), \
        interop.facility_location(D, ref, use_kernel=use_kernel)


def _run(driver, seed, engine="fused", precision="f32", use_kernel=True,
         facility=False, t=None, schedule=None, kind=None, jcon=None,
         tcon=None, opt=OPT):
    """One known-OPT or split driver through both packages."""
    fm, ids, valid, ref = _corpus(seed, facility)
    jo, to = _oracles(ref, use_kernel)
    key = jax.random.PRNGKey(seed)
    knobs = dict(k=K, n_total=N, n_machines=M, engine=engine, chunk=16,
                 precision=precision)
    jcfg = JMRConfig(**knobs, constraint=jcon)
    tcfg = tmr.MRConfig(**knobs, constraint=tcon)
    jargs = (jo, jnp.asarray(fm), jnp.asarray(ids), jnp.asarray(valid))
    targs = (to, *interop.shard(fm, ids, valid))
    if driver == "two_round_known_opt":
        jout = jmr.two_round_known_opt_sim(*jargs, opt, jcfg, key)
        tout = tmr.two_round_known_opt_sim(*targs, opt, tcfg,
                                           uniforms=draws([key]))
    elif driver == "multi_threshold":
        jout = jmr.multi_threshold_sim(*jargs, opt, t, jcfg, key,
                                       schedule=schedule)
        tout = tmr.multi_threshold_sim(
            *targs, opt, t, tcfg, uniforms=draws(jrounds.chain_keys(key, t)),
            schedule=schedule)
    elif driver == "multi_epoch":
        jout = jmr.multi_epoch_sim(*jargs, jcfg, key, epochs=t,
                                   schedule_kind=kind, opt=opt)
        tout = tmr.multi_epoch_sim(
            *targs, tcfg, uniforms=draws(jrounds.chain_keys(key, t)),
            epochs=t, schedule_kind=kind, opt=opt)
    elif driver == "dense":
        jout = jmr.dense_two_round_sim(*jargs, jcfg, key)
        tout = tmr.dense_two_round_sim(*targs, tcfg, uniforms=draws([key]))
    else:
        jout = jmr.sparse_two_round_sim(*jargs, jcfg, key)
        tout = tmr.sparse_two_round_sim(*targs, tcfg)
    return jout, tout


def _check(jout, tout):
    (jres, jlog), (tres, tlog) = jout, tout
    _assert_same(jres, jlog, tres, tlog)
    assert tres.sol_ids.shape == (K,)
    assert tres.sol_size.dim() == 0 and tres.value.dim() == 0
    return tres


def test_alg5_schedule_float32_bits():
    """The schedule's Python-float order, rounded to float32 once, is the
    JAX list's; the driver's threshold tensors carry those bits."""
    for opt, k, E in ((7.5, 8, 3), (1e3 / 3, 64, 7), (0.1, 5, 1),
                      (123.456, 120, 4)):
        got = tgrids.alg5_schedule(opt, k, E)
        want = jgrids.alg5_schedule(opt, k, E)
        assert got == want
        bits = np.asarray(got, np.float32).view(np.uint32)
        np.testing.assert_array_equal(
            bits, np.asarray(jnp.asarray(want, jnp.float32)).view(np.uint32))
        np.testing.assert_array_equal(
            torch.tensor(got, dtype=torch.float32).numpy().view(np.uint32),
            bits)


@pytest.mark.parametrize("engine,precision,use_kernel,facility", [
    ("dense", "f32", False, False), ("lazy", "bf16", True, False),
    ("fused", "f32", True, False), ("fused", "bf16", True, True),
    ("dense", "f32", True, True)])
def test_two_round_known_opt_matches_jax(engine, precision, use_kernel,
                                         facility):
    tres = _check(*_run("two_round_known_opt", 1, engine, precision,
                        use_kernel, facility, opt=78.0 if facility
                        else OPT))
    assert int(tres.sol_size) >= 1 and int(tres.tau_fallback) == 0


@pytest.mark.parametrize("t,engine,precision", [
    (1, "fused", "f32"), (2, "dense", "bf16"), (3, "lazy", "f32"),
    (3, "fused", "bf16")])
def test_multi_threshold_matches_jax(t, engine, precision):
    tres = _check(*_run("multi_threshold", 2 + t, engine, precision, t=t))
    assert int(tres.sol_size) >= 1


def test_multi_threshold_schedule_override_matches_jax():
    _check(*_run("multi_threshold", 6, "fused", t=3,
                 schedule=[0.9, 0.45, 0.2]))


@pytest.mark.parametrize("kind,engine", [("paper", "fused"),
                                         ("geometric", "lazy")])
def test_multi_epoch_with_opt_matches_jax(kind, engine):
    """Algorithm 5's schedule ("paper") or epoch_schedule(opt/2k)
    ("geometric"), with multi_threshold's key chain; the paper schedule is
    multi_threshold's run bit for bit."""
    tres = _check(*_run("multi_epoch", 7, engine, t=3, kind=kind))
    if kind == "paper":
        (_, _), (tmt, _) = _run("multi_threshold", 7, engine, t=3)
        assert torch.equal(tmt.sol_ids, tres.sol_ids)
        assert float(tmt.value) == float(tres.value)


@pytest.mark.parametrize("driver,engine,facility", [
    ("dense", "dense", False), ("dense", "fused", True),
    ("sparse", "lazy", False), ("sparse", "fused", True)])
def test_split_drivers_match_jax(driver, engine, facility):
    tres = _check(*_run(driver, 8, engine, facility=facility))
    assert int(tres.sol_size) >= 1


def _constraint(kind, seed):
    rng = np.random.default_rng(seed)
    if kind == "knapsack":
        costs = ((4 + rng.integers(0, 12, N)) / 8.0).astype(np.float32)
        return (jcons.Knapsack(budget=5.0, costs=jnp.asarray(costs)),
                interop.knapsack(costs, 5.0))
    parts = rng.integers(0, 4, N).astype(np.int32)
    caps = np.full(4, 2, np.int32)
    return (jcons.PartitionMatroid(capacities=jnp.asarray(caps),
                                   parts=jnp.asarray(parts)),
            interop.partition_matroid(parts, caps))


@pytest.mark.parametrize("kind", ["knapsack", "partition"])
@pytest.mark.parametrize("driver,engine", [("multi_threshold", "fused"),
                                           ("two_round_known_opt", "dense")])
def test_constrained_known_opt_matches_jax(kind, driver, engine):
    """The constraint rides the one lane: ids, RoundLogs (width d + 1) and
    values of the JAX drivers, within the budget or the caps."""
    jc, tc = _constraint(kind, 9)
    tres = _check(*_run(driver, 9, engine, t=2, jcon=jc, tcon=tc))
    picked = tres.sol_ids[:int(tres.sol_size)].long()
    if kind == "knapsack":
        assert float(tc.costs[picked].double().sum()) <= 5.0
    else:
        assert (torch.bincount(tc.parts[picked].long(), minlength=4)
                <= 2).all()


def test_adversarial_oracle_closed_form_matches_jax():
    """Marginals, add and value of AdversarialThreshold, shared and
    per-lane blocks, unbatched and lane-batched states."""
    rng = np.random.default_rng(10)
    k, vstar = 12, 1.5
    rows = np.stack([rng.random(30), rng.random(30) < 0.4], 1) \
        .astype(np.float32)
    jo = JAdversarialThreshold(feat_dim=2, k=k, vstar=vstar)
    to = interop.adversarial(k, vstar)
    sums = (rng.random(5) * 6).astype(np.float32)
    n_o = rng.integers(0, k, 5).astype(np.float32)
    st = (torch.from_numpy(sums), torch.from_numpy(n_o))
    got = to.marginals(st, torch.from_numpy(rows)).numpy()
    per_lane = to.marginals(st, torch.from_numpy(np.stack([rows] * 5)))
    for lane in range(5):
        jst = (jnp.asarray(sums[lane]), jnp.asarray(n_o[lane]))
        want = np.asarray(jo.marginals(jst, jnp.asarray(rows)))
        np.testing.assert_array_equal(got[lane], want)
        np.testing.assert_array_equal(per_lane[lane].numpy(), want)
        one = to.marginals((st[0][lane], st[1][lane]),
                           torch.from_numpy(rows)).numpy()
        np.testing.assert_array_equal(one, want)
        for i in (0, 1, 7):
            jn = jo.add(jst, jnp.asarray(rows[i]))
            tn = to.add(st, torch.from_numpy(np.stack([rows[i]] * 5)))
            assert float(tn[0][lane]) == float(jn[0])
            assert float(tn[1][lane]) == float(jn[1])
        assert float(to.value(st)[lane]) == float(jo.value(jst))
    s0 = to.init_state(3)
    assert s0[0].shape == (3,) and to.init_state()[0].shape == ()


@pytest.mark.parametrize("t", [1, 2, 4])
def test_theorem4_ratio_matches_jax_and_the_bound(t):
    """multi_threshold on the Theorem-4 instance (k = 120) with
    adversarial_schedule gives the JAX run's ids and value bit for bit, and
    reaches 1 - (t/(t+1))^t within the JAX test's 5e-3 (the decoys'
    margin of 2e-3 lifts the ratio 1.1e-3 above the bound at t = 2)."""
    k = 120
    alphas = [(1 - 1 / (t + 1)) ** ell for ell in range(1, t + 1)]
    feats, opt = tF.make_adversarial_instance(k, alphas)
    jfeats, jopt = jF.make_adversarial_instance(k, alphas)
    np.testing.assert_array_equal(feats, np.asarray(jfeats))
    assert opt == jopt
    assert tF.adversarial_schedule(alphas) == jF.adversarial_schedule(alphas)
    n = feats.shape[0]
    knobs = dict(k=k, n_total=n, n_machines=1, sample_cap=n, survivor_cap=n)
    key = jax.random.PRNGKey(0)
    jres, _ = jmr.multi_threshold_sim(
        JAdversarialThreshold(feat_dim=2, k=k, vstar=1.0),
        jnp.asarray(feats)[None], jnp.arange(n, dtype=jnp.int32)[None],
        jnp.ones((1, n), bool), opt, t, JMRConfig(**knobs), key,
        schedule=jF.adversarial_schedule(alphas))
    tres, _ = tmr.multi_threshold_sim(
        interop.adversarial(k), *interop.shard(
            feats[None], np.arange(n, dtype=np.int32)[None],
            np.ones((1, n), bool)), opt, t, tmr.MRConfig(**knobs),
        uniforms=draws(jrounds.chain_keys(key, t), m=1, n_local=n),
        schedule=tF.adversarial_schedule(alphas))
    np.testing.assert_array_equal(tres.sol_ids.numpy(),
                                  np.asarray(jres.sol_ids))
    assert float(tres.value) == float(jres.value)
    bound = 1 - (t / (t + 1)) ** t
    assert abs(float(tres.value) / opt - bound) < 5e-3


def test_adversarial_instance_on_a_device():
    feats, opt = tF.make_adversarial_instance(6, [0.5], device="cpu")
    assert isinstance(feats, torch.Tensor) and feats.shape == (12, 2)
    assert opt == 6.0 and float(feats[:, 1].sum()) == 6.0


@pytest.mark.parametrize("algorithm,t", [("multi_threshold", 2),
                                         ("two_round_known_opt", 1)])
def test_selector_known_opt_matches_jax_driver(algorithm, t):
    """DistributedSelector.select(opt_estimate=...) is the sim driver; its
    round_log is the driver's; a missing estimate raises."""
    fm, ids, valid, _ = _corpus(11)
    X = fm.reshape(N, D)
    key = jax.random.PRNGKey(11)
    jcfg = JMRConfig(k=K, n_total=N, n_machines=M, engine="fused")
    jargs = (JFeatureCoverage(feat_dim=D), jnp.asarray(fm), jnp.asarray(ids),
             jnp.asarray(valid))
    if algorithm == "multi_threshold":
        jres, jlog = jmr.multi_threshold_sim(*jargs, OPT, t, jcfg, key)
        u = draws(jrounds.chain_keys(key, t))
    else:
        jres, jlog = jmr.two_round_known_opt_sim(*jargs, OPT, jcfg, key)
        u = draws([key])
    sel = tsel.DistributedSelector(
        tsel.SelectorSpec(k=K, algorithm=algorithm, t=t, engine="fused",
                          use_kernel=True),
        n_total=N, feat_dim=D, n_machines=M, device="cpu")
    res = sel.select(X, opt_estimate=OPT, uniforms=u)
    _assert_same(jres, jlog, res, sel.round_log)
    with pytest.raises(ValueError, match="OPT estimate"):
        sel.select(X)
    assert tsel.ALGORITHMS == jsel.ALGORITHMS
    assert tsel.OPT_FREE_ALGORITHMS == jsel.OPT_FREE_ALGORITHMS
