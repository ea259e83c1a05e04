"""The WeightedCoverage and SaturatedCoverage slice of the port against the
JAX package, on the CPU.

On the CPU the port's kernel wrappers run their plain PyTorch versions
(repro_torch.kernels.ref); they are held here against the JAX reference
(repro.kernels.ref) and the Pallas kernels in interpret mode
(repro.kernels.ops), in f32 and bf16 and in every lane mode.

Tolerances.  On random floats the sums over features run in another order
in each package: rtol/atol 1e-5.  The id-equality tests draw exact data,
where every gain is exact in f32 in any summation order, so both packages
must pick the same ids:
- weighted coverage: binary incidence rows with dyadic item weights;
- saturated coverage: x = (a/8)^2 with a dyadic alpha, so the cap
  alpha * total is exact, and small enough that it binds.
The saturated kernels are also held at states that straddle the cap
(s < cap, s = cap, s > cap, and s + x crossing it).
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_mapreduce import jax_uniforms

from repro.core import MRConfig as JMRConfig
from repro.core import SaturatedCoverage as JSaturatedCoverage
from repro.core import WeightedCoverage as JWeightedCoverage
from repro.core import multi_epoch_sim as j_multi_epoch_sim
from repro.core import threshold as jth
from repro.core.selector import DistributedSelector as JDistributedSelector
from repro.core.selector import SelectorSpec as JSelectorSpec
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.launch.mesh import make_mesh_for
from repro_torch import interop
from repro_torch.core import mapreduce as tmr
from repro_torch.core import selector as tsel
from repro_torch.core import threshold as tth
from repro_torch.kernels import ops
from repro_torch.kernels import saturated_coverage_accept as tsa
from repro_torch.kernels import saturated_coverage_marginals as tsm
from repro_torch.kernels import weighted_coverage_accept as twa
from repro_torch.kernels import weighted_coverage_marginals as twm

torch.set_num_threads(2)
jax.config.update("jax_platform_name", "cpu")

REPO = Path(__file__).resolve().parents[1]
RTOL = ATOL = 1e-5
L, C, D = 4, 40, 16
ORACLES = ("weighted_coverage", "saturated_coverage")


def _bf16(a):
    return np.asarray(jnp.asarray(a, jnp.bfloat16))


def _t(a):
    return None if a is None else interop.tensor(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


def _rows(rng, shape, dtype):
    x = (rng.random(shape) ** 2).astype(np.float32)
    return _bf16(x) if dtype == "bf16" else x


def _straddling(rng, shape, cap):
    """States at 0, below, at and above the cap, and just below it (so that
    s + x crosses it)."""
    f = rng.choice(np.array([0.0, 0.5, 0.9, 1.0, 1.5], np.float32), shape)
    return (f * cap).astype(np.float32)


def _per_lane_calls(mode, x, state):
    """The (x, state) of each lane's unbatched call."""
    if mode == "unbatched":
        return [(x, state)]
    return [(x[lane] if mode == "per_lane" else x, state[lane])
            for lane in range(L)]


def _check_batched(got, calls, jax_fns):
    """``got`` (L, C) or (C,) against every JAX function called lane by
    lane."""
    got = np.asarray(got).reshape(len(calls), -1)
    for fn in jax_fns:
        want = np.stack([np.asarray(fn(*c)) for c in calls])
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------------------------
# kernel twins
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("mode", ["unbatched", "shared", "per_lane"])
def test_weighted_coverage_marginals_twin_matches_jax(mode, dtype):
    rng = np.random.default_rng(1)
    x = _rows(rng, (L, C, D) if mode == "per_lane" else (C, D), dtype)
    state = (rng.random(D if mode == "unbatched" else (L, D)) * 2
             ).astype(np.float32)
    got = ops.weighted_coverage_marginals(_t(x), _t(state)).numpy()
    calls = [(_j(a), _j(s)) for a, s in _per_lane_calls(mode, x, state)]
    _check_batched(got, calls, (jref.weighted_coverage_marginals,
                                jops.weighted_coverage_marginals))
    if mode != "unbatched":
        # each lane of a batched call equals the unbatched call
        for lane, (a, s) in enumerate(_per_lane_calls(mode, x, state)):
            one = ops.weighted_coverage_marginals(_t(a), _t(s))
            np.testing.assert_array_equal(got[lane], one.numpy())


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("mode", ["unbatched", "shared", "per_lane"])
def test_saturated_coverage_marginals_twin_matches_jax(mode, dtype, weighted):
    rng = np.random.default_rng(2)
    x = _rows(rng, (L, C, D) if mode == "per_lane" else (C, D), dtype)
    cap = (rng.random(D) * 2 + 0.25).astype(np.float32)
    state = _straddling(rng, D if mode == "unbatched" else (L, D), cap)
    w = (rng.random(D) + 0.5).astype(np.float32) if weighted else None
    got = ops.saturated_coverage_marginals(_t(x), _t(state), _t(cap),
                                           _t(w)).numpy()
    calls = [(_j(a), _j(s), _j(cap), _j(w))
             for a, s in _per_lane_calls(mode, x, state)]
    _check_batched(got, calls, (jref.saturated_coverage_marginals,
                                jops.saturated_coverage_marginals))
    # the cap binds somewhere: some gains fall short of the row sums
    unsat = ops.saturated_coverage_marginals(
        _t(x), _t(state), _t(np.full(D, 1e9, np.float32)), _t(w)).numpy()
    assert (got < unsat - 1e-3).any()


def _weighted_accept_case(seed, B, d, lanes=None, dtype="f32"):
    """Binary incidence rows and dyadic remaining weights: exact."""
    rng = np.random.default_rng(seed)
    shape = (B, d) if lanes is None else (lanes, B, d)
    x = (rng.random(shape) < 0.3).astype(np.float32)
    if dtype == "bf16":
        x = _bf16(x)
    state = (rng.integers(0, 16, d if lanes is None else (lanes, d)) / 8.0
             ).astype(np.float32)
    elig = rng.random(shape[:-1]) < 0.8
    return x, state, elig


def _saturated_accept_case(seed, B, d, lanes=None, dtype="f32"):
    """x = (a/8)^2, a dyadic cap and states straddling it: exact."""
    rng = np.random.default_rng(seed)
    shape = (B, d) if lanes is None else (lanes, B, d)
    x = ((rng.integers(0, 8, shape) / 8.0) ** 2).astype(np.float32)
    if dtype == "bf16":
        x = _bf16(x)
    cap = (rng.integers(4, 24, d) / 8.0).astype(np.float32)
    state = _straddling(rng, d if lanes is None else (lanes, d), cap)
    w = (rng.integers(1, 8, d) / 4.0).astype(np.float32)
    elig = rng.random(shape[:-1]) < 0.8
    return x, state, cap, w, elig


def _check_accept(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("budget", [64, 3])
def test_weighted_coverage_accept_twin_matches_jax(dtype, budget):
    x, state, elig = _weighted_accept_case(3, 24, 20, dtype=dtype)
    tau = np.float32(1.0)
    got = ops.weighted_coverage_accept(_t(x), _t(state), _t(elig),
                                       torch.tensor(tau),
                                       torch.tensor(budget, dtype=torch.int32))
    if budget == 3:
        assert int(got[0].sum()) == 3   # the budget cut the sweep
    args = (_j(x), _j(state), _j(elig), _j(tau),
            jnp.asarray(budget, jnp.int32))
    _check_accept(got, jref.weighted_coverage_accept(*args))
    _check_accept(got, jops.weighted_coverage_accept(*args))
    # an accepted binary row zeroes exactly the items it covers
    acc = got[0].numpy()
    assert acc.any()
    covered = np.asarray(x, np.float32)[acc].max(0) > 0
    np.testing.assert_array_equal(got[1].numpy()[covered], 0.0)
    np.testing.assert_array_equal(got[1].numpy()[~covered], state[~covered])


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("budget", [64, 3])
def test_saturated_coverage_accept_twin_matches_jax(dtype, budget, weighted):
    x, state, cap, w, elig = _saturated_accept_case(4, 24, 20, dtype=dtype)
    w = w if weighted else None
    tau = np.float32(0.5)
    got = ops.saturated_coverage_accept(
        _t(x), _t(state), _t(cap), _t(w), _t(elig), torch.tensor(tau),
        torch.tensor(budget, dtype=torch.int32))
    if budget == 3:
        assert int(got[0].sum()) == 3   # the budget cut the sweep
    args = (_j(x), _j(state), _j(cap), _j(w), _j(elig), _j(tau),
            jnp.asarray(budget, jnp.int32))
    _check_accept(got, jref.saturated_coverage_accept(*args))
    _check_accept(got, jops.saturated_coverage_accept(*args))


@pytest.mark.parametrize("oracle", ORACLES)
def test_accept_lanes_match_per_lane_loop(oracle):
    lanes, B, d = 4, 20, 12
    tau = np.array([0.25, 1.0, 2.0, 1e4], np.float32)
    bud = np.array([64, 2, 5, 64], np.int32)
    if oracle == "weighted_coverage":
        x, state, elig = _weighted_accept_case(5, B, d, lanes=lanes)
        got = ops.weighted_coverage_accept(_t(x), _t(state), _t(elig),
                                           _t(tau), _t(bud))
        want = [jref.weighted_coverage_accept(
            _j(x[i]), _j(state[i]), _j(elig[i]), _j(tau[i]), _j(bud[i]))
            for i in range(lanes)]
    else:
        x, state, cap, w, elig = _saturated_accept_case(5, B, d, lanes=lanes)
        got = ops.saturated_coverage_accept(_t(x), _t(state), _t(cap), _t(w),
                                            _t(elig), _t(tau), _t(bud))
        want = [jref.saturated_coverage_accept(
            _j(x[i]), _j(state[i]), _j(cap), _j(w), _j(elig[i]), _j(tau[i]),
            _j(bud[i])) for i in range(lanes)]
    assert not got[0][3].any() and got[0][0].any()
    for lane in range(lanes):
        _check_accept(tuple(g[lane] for g in got), want[lane])


def test_wrappers_refuse_cpu_and_count_nothing_on_cpu():
    ops.reset_launch_counts()
    x, st, cap = torch.rand(8, 4), torch.rand(4), torch.rand(4)
    elig = torch.ones(8, dtype=torch.bool)
    with pytest.raises(ValueError, match="CUDA"):
        twm.weighted_coverage_marginals(x, st)
    with pytest.raises(ValueError, match="CUDA"):
        twa.weighted_coverage_accept(x, st, elig, 0.1, 2)
    with pytest.raises(ValueError, match="CUDA"):
        tsm.saturated_coverage_marginals(x, st, cap)
    with pytest.raises(ValueError, match="CUDA"):
        tsa.saturated_coverage_accept(x, st, cap, None, elig, 0.1, 2)
    for oracle in (interop.weighted_coverage(4, use_kernel=True),
                   interop.saturated_coverage(4, cap.numpy() * 8,
                                              use_kernel=True)):
        s2 = oracle.init_state(2)
        oracle.marginals(s2, oracle.prep(s2, x))
        oracle.chunk_marginals(s2, x[None].expand(2, 8, 4))
        oracle.chunk_accept(s2, x[None].expand(2, 8, 4),
                            torch.ones(2, 8, dtype=torch.bool),
                            torch.tensor([0.1, 0.2]),
                            torch.tensor([4, 4], dtype=torch.int32))
    assert set(ops.launch_counts().values()) == {0}


# ---------------------------------------------------------------------------
# the oracles
# ---------------------------------------------------------------------------

def _oracles(name, rng, d, use_kernel, alpha=0.15):
    """The JAX oracle and the port's over the same numpy operands, and
    random rows for it."""
    w = (rng.random(d) + 0.5).astype(np.float32)
    if name == "weighted_coverage":
        x = (rng.random((C, d)) < 0.3).astype(np.float32)
        return (JWeightedCoverage(feat_dim=d, weights=jnp.asarray(w)),
                interop.weighted_coverage(d, w, use_kernel=use_kernel), x)
    x = (rng.random((C, d)) ** 2).astype(np.float32)
    total = x.sum(0)
    return (JSaturatedCoverage(feat_dim=d, total=jnp.asarray(total),
                               alpha=alpha, weights=jnp.asarray(w)),
            interop.saturated_coverage(d, total, alpha, w,
                                       use_kernel=use_kernel), x)


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("name", ORACLES)
def test_oracle_matches_jax(name, use_kernel):
    rng = np.random.default_rng(6)
    jo, to, x = _oracles(name, rng, D, use_kernel)
    s0 = np.asarray(jo.init_state())
    st = to.init_state(L)
    assert to.init_state().shape == (D,) and st.shape == (L, D)
    assert st.is_contiguous() and st.dtype == torch.float32
    np.testing.assert_array_equal(st.numpy(), np.broadcast_to(s0, (L, D)))
    if name == "weighted_coverage":
        # the state starts at the weights and never aliases them
        st[0, 0] = -1.0
        assert float(to.weights[0]) > 0 and float(to.init_state()[0]) > 0
    else:
        np.testing.assert_array_equal(to.cap.numpy(), np.asarray(jo._cap()))
    # a few lane states from accepted rows, then the oracle's calls
    states = []
    for lane in range(L):
        s = jo.init_state()
        for i in rng.choice(C, 2 + 2 * lane, replace=False):
            s = jo.add(s, jnp.asarray(x[i]))
        states.append(np.asarray(s))
    states = np.stack(states)
    for lane in range(L):
        for i in rng.choice(C, 2, replace=False):
            np.testing.assert_array_equal(
                to.add(_t(states[lane]), _t(x[i])).numpy(),
                np.asarray(jo.add(jnp.asarray(states[lane]),
                                  jnp.asarray(x[i]))))
    tst = _t(states)
    want = np.stack([np.asarray(jo.marginals(jnp.asarray(s), jnp.asarray(x)))
                     for s in states])
    np.testing.assert_allclose(to.marginals(tst, to.prep(tst, _t(x))).numpy(),
                               want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(to.chunk_marginals(tst, _t(x)).numpy(), want,
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(
        to.value(tst).numpy(),
        [float(jo.value(jnp.asarray(s))) for s in states], rtol=1e-6)


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("name", ORACLES)
def test_oracle_chunk_accept_matches_jax(name, use_kernel):
    """chunk_accept on exact data against the JAX oracle's sweep, lane by
    lane."""
    lanes, B, d = L, 16, 12
    tau = np.array([0.25, 1.0, 2.0, 4.0], np.float32)
    bud = np.array([64, 3, 64, 64], np.int32)
    if name == "weighted_coverage":
        x, state, elig = _weighted_accept_case(7, B, d, lanes=lanes)
        w = (np.arange(d) % 4 + 1).astype(np.float32) / 2
        state = np.minimum(state, w)
        jo = JWeightedCoverage(feat_dim=d, weights=jnp.asarray(w))
        to = interop.weighted_coverage(d, w, use_kernel=use_kernel)
    else:
        x, state, cap, w, elig = _saturated_accept_case(7, B, d, lanes=lanes)
        total = cap * 8   # alpha = 1/8 gives the same cap, exactly
        jo = JSaturatedCoverage(feat_dim=d, total=jnp.asarray(total),
                                alpha=0.125, weights=jnp.asarray(w))
        to = interop.saturated_coverage(d, total, 0.125, w,
                                        use_kernel=use_kernel)
    got = to.chunk_accept(_t(state), _t(x), _t(elig), _t(tau), _t(bud))
    for lane in range(lanes):
        want = jo.chunk_accept(jnp.asarray(state[lane]), jnp.asarray(x[lane]),
                               jnp.asarray(elig[lane]), tau[lane], bud[lane])
        _check_accept(tuple(g[lane] for g in got), want)


# ---------------------------------------------------------------------------
# engines and drivers (exact data: ids must be equal)
# ---------------------------------------------------------------------------

EC, ED, EK, ECHUNK = 90, 16, 10, 16   # EC % ECHUNK != 0


def _exact_corpus(name, rng, shape, d):
    """Exact data and the oracle operands: binary rows with dyadic weights,
    or (a/8)^2 rows whose total, times a dyadic alpha, binds."""
    if name == "weighted_coverage":
        x = (rng.random(shape + (d,)) < 0.25).astype(np.float32)
        w = (rng.integers(1, 8, d) / 4.0).astype(np.float32)
        return x, dict(weights=w)
    x = ((rng.integers(0, 8, shape + (d,)) / 8.0) ** 2).astype(np.float32)
    total = x.reshape(-1, d).sum(0).astype(np.float32)
    return x, dict(total=total, alpha=2.0 ** -6)


def _oracle_pair(name, d, kw, use_kernel):
    if name == "weighted_coverage":
        w = kw["weights"]
        return (JWeightedCoverage(feat_dim=d, weights=jnp.asarray(w)),
                interop.weighted_coverage(d, w, use_kernel=use_kernel))
    return (JSaturatedCoverage(feat_dim=d, total=jnp.asarray(kw["total"]),
                               alpha=kw["alpha"]),
            interop.saturated_coverage(d, kw["total"], kw["alpha"],
                                       use_kernel=use_kernel))


@pytest.mark.parametrize("engine", ["dense", "lazy", "fused"])
@pytest.mark.parametrize("name", ORACLES)
def test_engines_first_match_jax_ids(name, engine):
    """Every engine, both lane modes, both routes: the JAX ids, sizes,
    values and evaluation counts."""
    for per_lane in (False, True):
        rng = np.random.default_rng(20 + per_lane)
        x, kw = _exact_corpus(name, rng, (L, EC) if per_lane else (EC,), ED)
        ids = np.arange(EC, dtype=np.int32) * 3 + 7
        valid = rng.random(EC) < 0.9
        if per_lane:
            ids = np.stack([np.roll(ids, lane) for lane in range(L)])
            valid = rng.random((L, EC)) < 0.9
        jo, _ = _oracle_pair(name, ED, kw, False)
        g0 = np.asarray(jo.marginals(jo.init_state(),
                                     jnp.asarray(x.reshape(-1, ED))))
        # from "accept until full" (tau 0) to "accept the first pick only"
        taus = (np.median(g0) * np.array([0.0, 0.1, 0.5, 1.5])
                ).astype(np.float32)

        def one(tau, xf, i, v):
            st, sol, size, stats = jth.threshold_greedy(
                jo, jo.init_state(), jnp.full((EK,), -1, jnp.int32),
                jnp.zeros((), jnp.int32), xf, i, v, tau, EK, engine=engine,
                chunk=ECHUNK, with_stats=True)
            return sol, size, jo.value(st), stats

        ax = 0 if per_lane else None
        j_sol, j_size, j_val, j_stats = jax.vmap(one, in_axes=(0, ax, ax, ax))(
            jnp.asarray(taus), jnp.asarray(x), jnp.asarray(ids),
            jnp.asarray(valid))
        for use_kernel in (False, True):
            _, to = _oracle_pair(name, ED, kw, use_kernel)
            st, sol, size, stats = tth.threshold_greedy(
                to, to.init_state(L), torch.full((L, EK), -1,
                                                 dtype=torch.int32),
                torch.zeros(L, dtype=torch.int32), _t(x), _t(ids), _t(valid),
                _t(taus), EK, engine=engine, chunk=ECHUNK, with_stats=True)
            np.testing.assert_array_equal(sol.numpy(), np.asarray(j_sol))
            np.testing.assert_array_equal(size.numpy(), np.asarray(j_size))
            np.testing.assert_array_equal(to.value(st).numpy(),
                                          np.asarray(j_val))
            np.testing.assert_array_equal(stats.n_evals.numpy(),
                                          np.asarray(j_stats.n_evals))
            np.testing.assert_array_equal(stats.n_iters.numpy(),
                                          np.asarray(j_stats.n_iters))
        # the lanes span the outcomes: a full buffer and an early exit
        assert int(size.max()) == EK and int(size.min()) < EK


N, M, K, DD = 512, 4, 6, 16


@pytest.mark.parametrize("epochs,engine,precision", [
    (1, "dense", "f32"), (2, "fused", "bf16")])
@pytest.mark.parametrize("name", ORACLES)
def test_drivers_match_jax(name, epochs, engine, precision):
    """two_round (E = 1) and multi_epoch (E = 2) with the JAX keys' sample
    draws injected: equal ids, values within rtol 1e-5, equal RoundLogs."""
    rng = np.random.default_rng(30 + epochs)
    X, kw = _exact_corpus(name, rng, (N,), DD)
    fm = X.reshape(M, N // M, DD)
    ids = np.arange(N, dtype=np.int32).reshape(M, -1)
    valid = np.ones((M, N // M), bool)
    key = jax.random.PRNGKey(epochs)
    knobs = dict(k=K, n_total=N, n_machines=M, engine=engine, chunk=16,
                 precision=precision)
    jo, to = _oracle_pair(name, DD, kw, True)
    jres, jlog = j_multi_epoch_sim(
        jo, jnp.asarray(fm), jnp.asarray(ids), jnp.asarray(valid),
        JMRConfig(**knobs), key, epochs=epochs)
    tres, tlog = tmr.multi_epoch_sim(
        to, *interop.shard(fm, ids, valid), tmr.MRConfig(**knobs),
        uniforms=interop.uniforms(jax_uniforms(key, epochs, M, N // M)),
        epochs=epochs)
    np.testing.assert_array_equal(tres.sol_ids.numpy(),
                                  np.asarray(jres.sol_ids))
    assert int(tres.sol_size) == int(jres.sol_size) >= 1
    assert int(tres.n_dropped) == int(jres.n_dropped)
    assert int(tres.tau_fallback) == int(jres.tau_fallback)
    np.testing.assert_allclose(float(tres.value), float(jres.value),
                               rtol=1e-5)
    assert [(r.name, r.bytes_per_machine, r.bytes_total, r.detail)
            for r in tlog.records] == \
        [(r.name, r.bytes_per_machine, r.bytes_total, r.detail)
         for r in jlog.records]
    assert tlog.n_rounds == 2 * epochs
    if name == "saturated_coverage":
        # the cap binds: f(S) is below the unsaturated row sum of S
        picked = X[tres.sol_ids.numpy()[:int(tres.sol_size)]]
        assert float(tres.value) < picked.sum() - 1e-3


@pytest.mark.parametrize("name", ORACLES)
def test_selector_matches_jax_selector(name):
    """The port's DistributedSelector on the CPU against the JAX selector on
    a 1-device mesh (one machine, whose sample draws are the key folded in
    with machine index 0); weighted coverage with the selector's all-ones
    weights, saturated coverage with total = X.sum(0) at a dyadic alpha."""
    rng = np.random.default_rng(40)
    X, kw = _exact_corpus(name, rng, (N,), DD)
    total = kw.get("total")
    alpha = kw.get("alpha", 0.25)
    key = jax.random.PRNGKey(5)
    jspec = JSelectorSpec(k=K, oracle=name, engine="fused",
                          saturated_alpha=alpha)
    jsel = JDistributedSelector(jspec, make_mesh_for(1, model_parallel=1),
                                n_total=N, feat_dim=DD,
                                total=None if total is None
                                else jnp.asarray(total))
    jres = jsel.select(jnp.asarray(X), key=key)
    spec = tsel.SelectorSpec(k=K, oracle=name, engine="fused",
                             use_kernel=True, saturated_alpha=alpha)
    sel = tsel.DistributedSelector(spec, n_total=N, feat_dim=DD,
                                   device="cpu", total=total)
    draws = np.asarray(jax.random.uniform(jax.random.fold_in(key, 0), (N,)))
    res = sel.select(X, uniforms=draws[None, None])
    np.testing.assert_array_equal(res.sol_ids.numpy(), np.asarray(jres.sol_ids))
    np.testing.assert_allclose(float(res.value), float(jres.value), rtol=1e-6)
    assert int(res.n_dropped) == int(jres.n_dropped)
    assert [r.bytes_total for r in sel.round_log.records] == \
        [r.bytes_total for r in jsel.round_log.records]
    assert float(sel.opt_upper_bound(X)) >= float(res.value)
    # a bf16 selector keeps total (an accumulator statistic) in f32
    if total is not None:
        bf = tsel.DistributedSelector(
            tsel.SelectorSpec(k=K, oracle=name, precision="bf16"),
            n_total=N, feat_dim=DD, device="cpu", total=total)
        assert bf.oracle.total.dtype == torch.float32
        assert bf.oracle.cap.dtype == torch.float32
    with pytest.raises(ValueError, match="feature_coverage only"):
        tsel.DistributedSelector(spec, n_total=N, feat_dim=DD, device="cpu",
                                 total=total, weights=np.ones(DD, np.float32))


@pytest.mark.parametrize("name", ORACLES)
def test_cli_runs_on_cpu(name):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO / "src") + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.select", "--device", "cpu",
         "--use-kernel", "--oracle", name, "--n", "1024", "--k", "8", "--d",
         "16", "--machines", "4", "--engine", "fused"],
        capture_output=True, text=True, env=env, timeout=120, cwd=REPO)
    assert out.returncode == 0, out.stderr
    assert f"oracle={name}" in out.stdout
    assert "device=cpu" in out.stdout and "tau_fallback=0" in out.stdout
