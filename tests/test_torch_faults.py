"""The port's fault layer against the JAX package, on the CPU.

* ``FaultPlan``'s masks, ``grid_pad`` and ``chaos_plan`` are the JAX
  package's numpy draws, bit for bit.
* A plan that realizes no fault leaves every driver bit-identical to the
  bare substrate.
* Every fault kind on two_round_sim, and a chaos plan (every kind at
  once) on multi_epoch_sim (E = 2) and two_round_known_opt_sim, against
  the JAX sim drivers, with the JAX keys' sample draws injected
  (``jax_uniforms``): the same ids, sizes and counts, values within rtol
  1e-5, the same FaultRecords, ``degraded`` and ``haircut``, equal
  RoundLog records.

The other drivers under a plan, the mesh under a plan and the selector's
runtime events are in test_torch_faults_mesh.py.

FeatureCoverage runs on dyadic rows (a/8)^2.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_known_opt import draws as jax_known_opt_draws
from test_torch_mapreduce import jax_uniforms
from test_torch_mesh import _records, assert_same

from repro.core import FeatureCoverage as JFeatureCoverage
from repro.core import MRConfig as JMRConfig
from repro.core import faults as jfaults
from repro.core import mapreduce as jmr
from repro.core import rounds as jrounds
from repro_torch import interop
from repro_torch.core import faults as tfaults
from repro_torch.core import mapreduce as tmr

torch.set_num_threads(2)
jax.config.update("jax_platform_name", "cpu")

N, D, M, K = 1024, 8, 8, 6
OPT = 9.0
PLANS = {
    "shard_loss": dict(loss_rate=0.4, seed=1),
    "msg_drop": dict(drop_rate=0.4, seed=2),
    "msg_corrupt": dict(corrupt_rate=0.4, seed=3),
    "straggler": dict(straggler_rate=0.4, seed=4),
    "chaos": dataclasses.asdict(jfaults.chaos_plan(0.3, seed=5)),
}


def _fault_tuples(log):
    return [tuple(getattr(r, f) for f in r.__dataclass_fields__)
            for r in log.faults]


def _corpus(seed=0, n=N, m=M):
    rng = np.random.default_rng(seed)
    X = ((rng.integers(0, 9, (n, D)) / 8.0) ** 2).astype(np.float32)
    return (X, X.reshape(m, n // m, D),
            np.arange(n, dtype=np.int32).reshape(m, -1),
            np.ones((m, n // m), bool))


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", sorted(PLANS))
def test_plan_draws_are_the_jax_draws(kind):
    jplan = jfaults.FaultPlan(**PLANS[kind])
    plan = interop.fault_plan(jplan)
    assert dataclasses.asdict(plan) == dataclasses.asdict(jplan)
    for m in (1, 3, 8, 64):
        for i in range(6):
            np.testing.assert_array_equal(plan.loss_mask(i, m),
                                          jplan.loss_mask(i, m))
            tm, jm = plan.round_masks(i, m), jplan.round_masks(i, m)
            assert tm.keys() == jm.keys()
            for name in tm:
                np.testing.assert_array_equal(tm[name], jm[name])
    for eps in (0.05, 0.15, 0.5):
        assert plan.grid_pad(eps) == jplan.grid_pad(eps)
    assert tfaults.FAULT_KINDS == jfaults.FAULT_KINDS
    assert tfaults.CORRUPT_CANARY == jfaults.CORRUPT_CANARY


@pytest.mark.parametrize("rate", [0.0, 0.1, 0.25, 0.9])
def test_chaos_plan_is_the_jax_profile(rate):
    j, t = jfaults.chaos_plan(rate, seed=7), tfaults.chaos_plan(rate, seed=7)
    assert (t is None) == (j is None)
    if t is not None:
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        cfg = dict(k=K, n_total=N, n_machines=M)
        assert (tmr.MRConfig(**cfg, faults=t).grid_size()
                == JMRConfig(**cfg, faults=j).grid_size())
    assert interop.fault_plan(None) is None


def test_plan_rejects_bad_rates_and_types():
    with pytest.raises(ValueError, match="loss_rate"):
        tfaults.FaultPlan(loss_rate=1.5)
    with pytest.raises(TypeError, match="FaultPlan"):
        tmr.MRConfig(k=K, n_total=N, n_machines=M, faults=0.5)


@pytest.mark.parametrize("driver", ["two_round", "multi_epoch",
                                    "two_round_known_opt", "batch"])
def test_a_plan_without_faults_is_the_bare_substrate(driver):
    """An all-zero plan wraps nothing: the same bits, no records, not
    degraded."""
    X, *shards = _corpus(1)
    to = interop.feature_coverage(D)
    out = []
    for plan in (None, tfaults.FaultPlan(seed=9)):
        cfg = tmr.MRConfig(k=K, n_total=N, n_machines=M, faults=plan)
        args = (to, *interop.shard(*shards))
        gen = torch.Generator().manual_seed(3)
        if driver == "two_round_known_opt":
            res, log = tmr.two_round_known_opt_sim(*args, OPT, cfg,
                                                   generator=gen)
        elif driver == "batch":
            res, log = tmr.two_round_batch_sim(
                *args, tmr.make_query_batch([6, 2], device="cpu"), cfg,
                generator=gen)
        else:
            res, log = tmr.multi_epoch_sim(
                *args, cfg, generator=gen,
                epochs=1 if driver == "two_round" else 2)
        out.append((res, log))
    (bare, blog), (wrapped, wlog) = out
    assert_same(bare, wrapped, bits=True)
    assert not wlog.faults and _records(blog) == _records(wlog)
    assert int(wrapped.degraded) == 0 and float(wrapped.haircut) == 1.0
    assert tfaults.with_faults("rr", None, wlog, M, N) == "rr"


# ---------------------------------------------------------------------------
# the sim drivers against the JAX sim drivers
# ---------------------------------------------------------------------------

def _both(driver, plan, seed=3):
    X, fm, ids, valid = _corpus(seed)
    key = jax.random.PRNGKey(seed)
    knobs = dict(k=K, n_total=N, n_machines=M, engine="fused", chunk=16)
    jcfg = JMRConfig(**knobs, faults=jfaults.FaultPlan(**plan))
    tcfg = tmr.MRConfig(**knobs, faults=tfaults.FaultPlan(**plan))
    jargs = (JFeatureCoverage(feat_dim=D), jnp.asarray(fm), jnp.asarray(ids),
             jnp.asarray(valid))
    targs = (interop.feature_coverage(D, use_kernel=True),
             *interop.shard(fm, ids, valid))
    if driver in ("two_round", "multi_epoch"):
        E = 1 if driver == "two_round" else 2
        jres, jlog = jmr.multi_epoch_sim(*jargs, jcfg, key, epochs=E)
        tres, tlog = tmr.multi_epoch_sim(
            *targs, tcfg, uniforms=jax_uniforms(key, E, M, N // M), epochs=E)
    elif driver == "two_round_known_opt":
        jres, jlog = jmr.two_round_known_opt_sim(*jargs, OPT, jcfg, key)
        tres, tlog = tmr.two_round_known_opt_sim(
            *targs, OPT, tcfg, uniforms=jax_known_opt_draws([key]))
    elif driver == "multi_threshold":
        jres, jlog = jmr.multi_threshold_sim(*jargs, OPT, 2, jcfg, key)
        tres, tlog = tmr.multi_threshold_sim(
            *targs, OPT, 2, tcfg,
            uniforms=jax_known_opt_draws(jrounds.chain_keys(key, 2)))
    elif driver == "sparse":
        jres, jlog = jmr.sparse_two_round_sim(*jargs, jcfg, key)
        tres, tlog = tmr.sparse_two_round_sim(*targs, tcfg)
    elif driver == "dense":
        jres, jlog = jmr.dense_two_round_sim(*jargs, jcfg, key)
        tres, tlog = tmr.dense_two_round_sim(
            *targs, tcfg, uniforms=jax_known_opt_draws([key]))
    else:
        ks = [6, 3, 1]
        jres, jlog = jmr.two_round_batch_sim(
            *jargs, jmr.make_query_batch(ks), jcfg, key)
        tres, tlog = tmr.two_round_batch_sim(
            *targs, tmr.make_query_batch(ks, device="cpu"), tcfg,
            uniforms=jax_uniforms(key, 1, M, N // M))
    return jres, jlog, tres, tlog


def _assert_faults_same(jres, jlog, tres, tlog):
    assert_same(jres, tres)
    assert _records(tlog) == _records(jlog)
    assert _fault_tuples(tlog) == _fault_tuples(jlog)
    assert int(tres.degraded) == int(jres.degraded)
    assert float(tres.haircut) == float(jres.haircut)
    assert tfaults.fault_summary(tlog) == jfaults.fault_summary(jlog)
    assert tlog.fault_events() == jlog.fault_events()


@pytest.mark.parametrize("kind", sorted(PLANS))
def test_every_fault_kind_matches_the_jax_sim(kind):
    jres, jlog, tres, tlog = _both("two_round", PLANS[kind])
    _assert_faults_same(jres, jlog, tres, tlog)
    assert int(tres.degraded) == 1, "the plan must realize a fault here"
    assert {r.kind for r in tlog.faults} <= {kind} | (
        set(tfaults.FAULT_KINDS) if kind == "chaos" else set())


@pytest.mark.parametrize("driver", ["multi_epoch", "two_round_known_opt"])
def test_multi_epoch_and_known_opt_under_chaos_match_the_jax_sim(driver):
    jres, jlog, tres, tlog = _both(driver, PLANS["chaos"])
    _assert_faults_same(jres, jlog, tres, tlog)
    assert int(tres.degraded) == 1


def test_degrade_gathered_wraps_only_a_faulty_substrate():
    """A gathered triple that a driver gathered itself: untouched on a bare
    substrate, degraded through a FaultyRounds (the only machine's message
    dropped at its first gather)."""
    trip = (torch.ones(4, 2), torch.arange(4, dtype=torch.int32),
            torch.ones(4, dtype=torch.bool))
    assert tfaults.degrade_gathered("bare", trip, 0) == (trip, 0)
    fr = tfaults.FaultyRounds(None, tfaults.FaultPlan(drop_rate=1.0),
                              tmr.RoundLog(), 1, 4)
    fr._epoch = 0
    (f, i, v), drops = tfaults.degrade_gathered(fr, trip, 0)
    assert drops == 0 and not v.any() and torch.equal(f, trip[0])
    assert [r.kind for r in fr.log.faults] == ["msg_drop"]


def test_corrupted_rows_carry_the_canary():
    """A corrupted machine's rows are the canary at the storage dtype, and
    invalid."""
    fr = tfaults.FaultyRounds(None, tfaults.FaultPlan(corrupt_rate=1.0),
                              tmr.RoundLog(), 2, 8)
    fr._epoch = 0
    f = torch.zeros(2, 4, 3, dtype=torch.bfloat16)
    (g, i, v), _ = fr.degrade((f, torch.zeros(2, 4, dtype=torch.int32),
                               torch.ones(2, 4, dtype=torch.bool)), 0)
    assert (g == torch.tensor(1e30, dtype=torch.bfloat16)).all()
    assert not v.any()
    assert [r.kind for r in fr.log.faults] == ["msg_corrupt"]
