"""The port's distributed sieve-and-merge against the JAX package, on the
CPU.

* ``sieve_and_merge_sim`` at m = 8 against JAX's on the four oracles of the
  JAX streaming tests (and the fused engine on FeatureCoverage): the same
  ids, sizes and overflow counts, values within rtol 1e-5, the same
  RoundLog (one ``gather-sieve-survivors`` record);
* a pool cap below the survivors' count: the overflow reported, as JAX's;
* ``chaos_plan`` on the one gather: JAX's FaultRecords, ``degraded``,
  ``haircut`` and ids, at seeds that realize a fault and at one that
  realizes none;
* ``FaultyRounds(None, ...)``, the shim of a one-gather driver, and its
  ``last_dead`` against JAX's;
* the mesh: one gloo rank in this process against the sim at m = 1, and
  four spawned ranks (``_torch_mesh_ranks``) against the sim at m = 4,
  bare and under a chaos plan: the sim's ids, value bits, records and
  fault records on every rank.

The data are dyadic (FeatureCoverage and SaturatedCoverage (a/8)^2,
GraphCut a/8 with lam 0.5, FacilityLocation (a/8)^2 against b/8).
"""

import dataclasses

import _torch_mesh_ranks as ranks
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_streaming import instance

from repro.core import faults as jfaults
from repro.core import rounds as jrounds
from repro.streaming import distributed_sieve as jds
from repro.streaming import sieve as jsieve
from repro_torch import interop
from repro_torch.core import faults as tfaults
from repro_torch.core import rounds as trounds
from repro_torch.streaming import distributed_sieve as tds

torch.set_num_threads(2)
jax.config.update("jax_platform_name", "cpu")

N, D, K, M, B = 512, 8, 8, 8, 32
EPS = 0.1


def _records(log):
    return [(r.name, r.bytes_per_machine, r.bytes_total, r.detail)
            for r in log.records]


def _faults(log):
    return [ranks.dataclass_tuple(r) for r in log.faults]


def _shards(X, m):
    n = X.shape[0]
    return (X.reshape(m, n // m, -1),
            np.arange(n, dtype=np.int32).reshape(m, -1),
            np.ones((m, n // m), bool))


def both(name, m=M, engine="dense", pool_cap=None, plan=None, seed=3):
    """sieve_and_merge_sim through both packages: (JAX result, JAX log,
    port result, port log)."""
    X, jo, to = instance(name, seed=seed, n=N, d=D, k=K)
    fm, im, vm = _shards(X, m)
    jspec = jsieve.SieveSpec(k=K, eps=EPS, engine=engine, chunk=16)
    jplan = None if plan is None else jfaults.FaultPlan(**plan)
    jres, jlog = jds.sieve_and_merge_sim(
        jo, jnp.asarray(fm), jnp.asarray(im), jnp.asarray(vm), jspec,
        chunk_elems=B, pool_cap=pool_cap, faults=jplan)
    tres, tlog = tds.sieve_and_merge_sim(
        to, *interop.shard(fm, im, vm), interop.sieve_spec(jspec),
        chunk_elems=B, pool_cap=pool_cap, faults=interop.fault_plan(jplan))
    return jres, jlog, tres, tlog


def assert_same(jres, jlog, tres, tlog, rtol=1e-5):
    np.testing.assert_array_equal(tres.sol_ids.numpy(), np.asarray(jres.sol_ids))
    assert int(tres.sol_size) == int(jres.sol_size)
    assert int(tres.n_dropped) == int(jres.n_dropped)
    assert int(tres.tau_fallback) == int(jres.tau_fallback)
    np.testing.assert_allclose(float(tres.value), float(jres.value), rtol=rtol)
    assert _records(tlog) == _records(jlog)
    assert _faults(tlog) == _faults(jlog)
    assert int(tres.degraded) == int(jres.degraded)
    np.testing.assert_allclose(float(tres.haircut), float(jres.haircut),
                               rtol=1e-6)


@pytest.mark.parametrize("name,engine", [
    ("feature_coverage", "dense"), ("feature_coverage", "fused"),
    ("saturated_coverage", "dense"), ("graph_cut", "lazy"),
    ("facility_location", "dense")])
def test_sim_matches_jax(name, engine):
    jres, jlog, tres, tlog = both(name, engine=engine)
    assert_same(jres, jlog, tres, tlog)
    assert tlog.n_rounds == 1 and int(tres.n_dropped) == 0
    assert tlog.records[0].name == "gather-sieve-survivors"


def test_pool_cap_overflow_is_reported_as_jax():
    jres, jlog, tres, tlog = both("feature_coverage", m=4, pool_cap=K)
    assert_same(jres, jlog, tres, tlog)
    assert int(tres.n_dropped) > 0 and int(tres.sol_size) > 0


def _realizes(seed, m=M):
    """Whether chaos_plan(0.25, seed) realizes a fault on the sieve's one
    gather (epoch 0's shard loss or gather 0's transient faults)."""
    plan = jfaults.chaos_plan(0.25, seed=seed)
    masks = plan.round_masks(0, m)
    return bool(plan.loss_mask(0, m).any()
                or any(masks[kind].any() for kind in masks))


CHAOS_SEEDS = [s for s in range(12) if _realizes(s)][:3] + \
    [next(s for s in range(12) if not _realizes(s))]


@pytest.mark.parametrize("seed", CHAOS_SEEDS)
def test_chaos_plan_matches_jax(seed):
    plan = dataclasses.asdict(jfaults.chaos_plan(0.25, seed=seed))
    jres, jlog, tres, tlog = both("feature_coverage", plan=plan)
    assert_same(jres, jlog, tres, tlog)
    # degraded exactly when the one gather realized a record
    assert int(tres.degraded) == int(bool(tlog.faults)) == int(_realizes(seed))


def test_faulty_rounds_shim_and_last_dead():
    """FaultyRounds(None, ...) delegates nothing; ``last_dead`` is the
    realized dead-machine mask of the last degrade, or None when it was
    clean, as JAX's."""
    m = 8
    cap = 3
    f = np.arange(m * cap * 2, dtype=np.float32).reshape(m * cap, 2)
    i = np.arange(m * cap, dtype=np.int32)
    v = np.ones(m * cap, bool)
    for seed in range(8):
        jplan = jfaults.chaos_plan(0.4, seed=seed)
        jlog, tlog = jrounds.RoundLog(), trounds.RoundLog()
        jw = jfaults.FaultyRounds(None, jplan, jlog, m, 1000)
        tw = tfaults.FaultyRounds(None, interop.fault_plan(jplan), tlog, m,
                                  1000)
        tw.begin_epoch(0)            # no inner substrate to tell
        jw.begin_epoch(0)
        for _ in range(3):
            (jf, ji, jv), _ = jw.degrade(
                (jnp.asarray(f), jnp.asarray(i), jnp.asarray(v)),
                jnp.zeros((), jnp.int32))
            (tf, ti, tv), _ = tw.degrade(
                (torch.from_numpy(f), torch.from_numpy(i),
                 torch.from_numpy(v)), torch.zeros((), dtype=torch.int32))
            if jw.last_dead is None:
                assert tw.last_dead is None
            else:
                np.testing.assert_array_equal(tw.last_dead, jw.last_dead)
            np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
            np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
        assert _faults(tlog) == _faults(jlog)
    # a clean plan: nothing realized, no mask
    tw = tfaults.FaultyRounds(None, None, trounds.RoundLog(), m, 1000)
    tw.degrade((torch.from_numpy(f), torch.from_numpy(i),
                torch.from_numpy(v)), torch.zeros((), dtype=torch.int32))
    assert tw.last_dead is None


# ---------------------------------------------------------------------------
# the mesh
# ---------------------------------------------------------------------------

def _sim_result(X, m, plan=None):
    _, _, to = instance("feature_coverage", seed=3, n=N, d=D, k=K)
    res, log = tds.sieve_and_merge_sim(
        to, *interop.shard(*_shards(X, m)),
        interop.sieve_spec(jsieve.SieveSpec(k=K, eps=EPS, chunk=16)),
        chunk_elems=B, faults=None if plan is None
        else tfaults.FaultPlan(**plan))
    return ranks.sieve_result(res, log)


def _assert_bits(got, want):
    for key in ("ids", "size", "n_dropped", "tau_fallback", "degraded",
                "haircut", "records", "faults"):
        np.testing.assert_equal(got[key], want[key], err_msg=key)
    assert got["value"].tobytes() == want["value"].tobytes()


def _case(X, mesh, plan=None):
    return dict(mesh=mesh, X=X, spec=dict(k=K),
                sieve=dict(k=K, eps=EPS, chunk=16), chunk_elems=B,
                faults=plan)


def test_one_rank_mesh_is_the_sim_at_m1():
    X, _, _ = instance("feature_coverage", seed=3, n=N, d=D, k=K)
    with ranks.one_rank():
        meshes = {}
        got = ranks.run_case(_case(X, (1, 1)), meshes)
        assert meshes[(1, 1)].shape == {"data": 1, "model": 1}
    _assert_bits(got, _sim_result(X, 1))
    assert got["records"][0][0] == "gather-sieve-survivors"


def test_four_ranks_are_the_sim_at_m4():
    X, _, _ = instance("feature_coverage", seed=3, n=N, d=D, k=K)
    seed = next(s for s in range(12) if _realizes(s, 4))
    plan = dataclasses.asdict(tfaults.chaos_plan(0.25, seed=seed))
    out = ranks.spawn(4, [_case(X, (4, 1)), _case(X, (4, 1), plan)])
    for want, r in ((_sim_result(X, 4), 0), (_sim_result(X, 4, plan), 1)):
        for rank in range(4):
            _assert_bits(out[rank][r], want)
    assert out[0][1]["degraded"] == 1 and out[0][1]["faults"]
    # the mesh's machine count is the sim's: the same message accounting
    assert out[0][0]["records"] == _sim_result(X, 4)["records"]
