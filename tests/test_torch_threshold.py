"""The port's ThresholdGreedy engines, filter, packing and sequential
baselines against the JAX package, on the CPU.

The port writes each engine with a leading lane axis; the JAX reference is
``jax.vmap`` of its single-threshold engine over the same lanes.  Ids must
be equal for accept="first" (every engine picks the same sequence) and
values equal within rtol 1e-5 for accept="best" (ties may break apart).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import functions as jF
from repro.core import sequential as jseq
from repro.core import threshold as jth
from repro_torch import interop
from repro_torch.core import sequential as tseq
from repro_torch.core import threshold as tth

torch.set_num_threads(2)
jax.config.update("jax_platform_name", "cpu")

C, D, K, L, CHUNK = 100, 10, 12, 4, 16   # C % CHUNK != 0: the frontier
#                                         crosses C - B


def _case(seed, per_lane, dtype="f32"):
    rng = np.random.default_rng(seed)
    shape = (L, C, D) if per_lane else (C, D)
    x = (rng.random(shape) ** 2).astype(np.float32)
    if dtype == "bf16":
        x = np.asarray(jnp.asarray(x, jnp.bfloat16))
    ids = (np.arange(C, dtype=np.int32) * 3 + 7)
    valid = rng.random(C) < 0.9
    if per_lane:
        ids = np.stack([np.roll(ids, lane) for lane in range(L)])
        valid = rng.random((L, C)) < 0.9
    # thresholds spread from "accept almost everything" to "accept little"
    g0 = np.sqrt(np.asarray(x, np.float32)).sum(-1)
    taus = (np.median(g0) * np.array([0.02, 0.1, 0.3, 0.9])).astype(np.float32)
    return x, ids, valid, taus


def _jax_lanes(x, ids, valid, taus, per_lane, engine, accept, use_kernel):
    oracle = jF.FeatureCoverage(feat_dim=D, use_kernel=use_kernel)

    def one(tau, xf, i, v):
        st, sol, size, stats = jth.threshold_greedy(
            oracle, oracle.init_state(), jnp.full((K,), -1, jnp.int32),
            jnp.zeros((), jnp.int32), xf, i, v, tau, K, accept=accept,
            engine=engine, chunk=CHUNK, with_stats=True)
        return st, sol, size, oracle.value(st), stats

    ax = 0 if per_lane else None
    return jax.vmap(one, in_axes=(0, ax, ax, ax))(
        jnp.asarray(taus), jnp.asarray(x), jnp.asarray(ids),
        jnp.asarray(valid))


def _torch_lanes(x, ids, valid, taus, engine, accept, use_kernel):
    oracle = interop.feature_coverage(D, use_kernel=use_kernel)
    st, sol, size, stats = tth.threshold_greedy(
        oracle, oracle.init_state(L), torch.full((L, K), -1, dtype=torch.int32),
        torch.zeros(L, dtype=torch.int32), interop.tensor(x),
        interop.tensor(ids), interop.tensor(valid), interop.tensor(taus), K,
        accept=accept, engine=engine, chunk=CHUNK, with_stats=True)
    return st, sol, size, oracle.value(st), stats


@pytest.mark.parametrize("engine", ["dense", "lazy", "fused"])
@pytest.mark.parametrize("per_lane", [False, True])
def test_threshold_greedy_first_matches_jax_ids(engine, per_lane):
    x, ids, valid, taus = _case(10 + per_lane, per_lane)
    j_st, j_sol, j_size, j_val, j_stats = _jax_lanes(
        x, ids, valid, taus, per_lane, engine, "first", False)
    for use_kernel in (False, True):
        st, sol, size, val, stats = _torch_lanes(x, ids, valid, taus, engine,
                                                 "first", use_kernel)
        np.testing.assert_array_equal(sol.numpy(), np.asarray(j_sol))
        np.testing.assert_array_equal(size.numpy(), np.asarray(j_size))
        np.testing.assert_allclose(val.numpy(), np.asarray(j_val), rtol=1e-5)
        np.testing.assert_allclose(st.numpy(), np.asarray(j_st), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_array_equal(stats.n_iters.numpy(),
                                      np.asarray(j_stats.n_iters))
        np.testing.assert_array_equal(stats.n_evals.numpy(),
                                      np.asarray(j_stats.n_evals))
        if engine == "fused":
            np.testing.assert_array_equal(stats.n_evals.numpy(),
                                          stats.n_iters.numpy() * CHUNK)
    # the lanes span the outcomes: a full buffer and an early exit
    assert int(size.max()) == K and int(size.min()) < K


@pytest.mark.parametrize("engine", ["dense", "lazy"])
def test_threshold_greedy_best_matches_jax_values(engine):
    x, ids, valid, taus = _case(12, False)
    j_val = _jax_lanes(x, ids, valid, taus, False, engine, "best", False)[3]
    val = _torch_lanes(x, ids, valid, taus, engine, "best", False)[3]
    np.testing.assert_allclose(val.numpy(), np.asarray(j_val), rtol=1e-5)


def test_threshold_greedy_bf16_storage_matches_jax():
    x, ids, valid, taus = _case(13, False, dtype="bf16")
    j_sol = _jax_lanes(x, ids, valid, taus, False, "fused", "first", True)[1]
    sol = _torch_lanes(x, ids, valid, taus, "fused", "first", True)[1]
    np.testing.assert_array_equal(sol.numpy(), np.asarray(j_sol))


def test_threshold_greedy_keeps_inputs_and_extends_partial_solutions():
    x, ids, valid, taus = _case(14, False)
    oracle = interop.feature_coverage(D)
    st0 = torch.rand(L, D, generator=torch.Generator().manual_seed(0))
    sol0 = torch.full((L, K), -1, dtype=torch.int32)
    sol0[:, 0] = 7
    size0 = torch.ones(L, dtype=torch.int32)
    keep = (st0.clone(), sol0.clone(), size0.clone())
    _, sol, size = tth.threshold_greedy(
        oracle, st0, sol0, size0, interop.tensor(x), interop.tensor(ids),
        interop.tensor(valid), interop.tensor(taus), K, engine="fused",
        chunk=CHUNK)
    assert all(torch.equal(a, b) for a, b in zip(keep, (st0, sol0, size0)))
    assert (sol[:, 0] == 7).all() and (size >= 1).all()
    jo = jF.FeatureCoverage(feat_dim=D)
    for lane in range(L):
        _, j_sol, _ = jth.threshold_greedy(
            jo, jnp.asarray(st0[lane].numpy()), jnp.asarray(sol0[lane].numpy()),
            jnp.asarray(1, jnp.int32), jnp.asarray(x), jnp.asarray(ids),
            jnp.asarray(valid), jnp.asarray(taus[lane]), K, engine="fused",
            chunk=CHUNK)
        np.testing.assert_array_equal(sol[lane].numpy(), np.asarray(j_sol))


@pytest.mark.parametrize("chunk", [None, 7])
def test_threshold_filter_matches_jax(chunk):
    x, _, valid, taus = _case(15, False)
    rng = np.random.default_rng(16)
    state = rng.random((L, D)).astype(np.float32)
    jo = jF.FeatureCoverage(feat_dim=D)
    want = jax.vmap(lambda st, tau: jth.threshold_filter(
        jo, st, jnp.asarray(x), jnp.asarray(valid), tau, chunk=chunk))(
            jnp.asarray(state), jnp.asarray(taus))
    got = tth.threshold_filter(interop.feature_coverage(D),
                               interop.tensor(state), interop.tensor(x),
                               interop.tensor(valid), interop.tensor(taus),
                               chunk=chunk)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    one = tth.threshold_filter(interop.feature_coverage(D),
                               interop.tensor(state[0]), interop.tensor(x),
                               interop.tensor(valid), float(taus[0]),
                               chunk=chunk)
    np.testing.assert_array_equal(one.numpy(), np.asarray(want[0]))


def test_exclude_ids_matches_jax():
    ids = np.arange(20, dtype=np.int32)
    valid = np.ones(20, bool)
    sol = np.array([[3, 5, -1], [19, 0, 3]], np.int32)
    got = tth.exclude_ids(interop.tensor(ids), interop.tensor(valid),
                          interop.tensor(sol))
    for lane in range(2):
        want = jth.exclude_ids(jnp.asarray(ids), jnp.asarray(valid),
                               jnp.asarray(sol[lane]))
        np.testing.assert_array_equal(got[lane].numpy(), np.asarray(want))


@pytest.mark.parametrize("with_priority", [False, True])
@pytest.mark.parametrize("cap", [5, 40])
def test_pack_by_mask_matches_jax(with_priority, cap):
    n, d = 24, 3
    rng = np.random.default_rng(17)
    feats = rng.random((n, d)).astype(np.float32)
    ids = np.arange(100, 100 + n, dtype=np.int32)
    mask = rng.random(n) < 0.7
    prio = None
    if with_priority:
        # duplicate priorities and +-inf ones, on masked and unmasked rows
        prio = rng.integers(0, 4, n).astype(np.float32)
        prio[[1, 5, 9]] = np.inf
        prio[[2, 6, 11]] = -np.inf
        mask[[1, 2, 3]] = True
    want = jth.pack_by_mask(jnp.asarray(feats), jnp.asarray(ids),
                            jnp.asarray(mask), cap,
                            None if prio is None else jnp.asarray(prio))
    got = tth.pack_by_mask(interop.tensor(feats), interop.tensor(ids),
                           interop.tensor(mask), cap,
                           None if prio is None else interop.tensor(prio))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_pack_by_mask_batches_over_lanes_and_machines():
    J, m, n, d = 3, 2, 10, 2
    rng = np.random.default_rng(18)
    feats = rng.random((m, n, d)).astype(np.float32)
    ids = np.arange(m * n, dtype=np.int32).reshape(m, n)
    mask = rng.random((J, m, n)) < 0.5
    got = tth.pack_by_mask(interop.tensor(feats), interop.tensor(ids),
                           interop.tensor(mask), 4)
    for j in range(J):
        for i in range(m):
            want = jth.pack_by_mask(jnp.asarray(feats[i]), jnp.asarray(ids[i]),
                                    jnp.asarray(mask[j, i]), 4)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g[j, i].numpy(), np.asarray(w))


def test_greedy_and_threshold_sequential_match_jax():
    x, _, valid, taus = _case(19, False)
    jo = jF.FeatureCoverage(feat_dim=D)
    to = interop.feature_coverage(D)
    j_sol, j_size, j_val = jseq.greedy(jo, jnp.asarray(x), jnp.asarray(valid),
                                       K)
    sol, size, val = tseq.greedy(to, interop.tensor(x), interop.tensor(valid),
                                 K)
    np.testing.assert_array_equal(sol.numpy(), np.asarray(j_sol))
    assert int(size) == int(j_size)
    np.testing.assert_allclose(float(val), float(j_val), rtol=1e-5)
    j_sol, j_size, j_val = jseq.threshold_sequential(
        jo, jnp.asarray(x), jnp.asarray(valid), K, jnp.asarray(taus[1]))
    sol, size, val = tseq.threshold_sequential(
        to, interop.tensor(x), interop.tensor(valid), K, float(taus[1]))
    np.testing.assert_array_equal(sol.numpy(), np.asarray(j_sol))
    np.testing.assert_allclose(float(val), float(j_val), rtol=1e-5)


def test_validate_engine_rejects_bad_knobs():
    with pytest.raises(ValueError, match="unknown engine"):
        tth.validate_engine("eager")
    with pytest.raises(ValueError, match="unknown accept"):
        tth.validate_engine("dense", "worst")
    with pytest.raises(ValueError, match="fused"):
        tth.validate_engine("fused", "best")
