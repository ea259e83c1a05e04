"""The FacilityLocation slice of the port against the JAX package, on the CPU.

On the CPU the port's kernel wrappers run their plain PyTorch versions
(repro_torch.kernels.ref); they are held here against the JAX reference
(repro.kernels.ref) and the Pallas kernels in interpret mode
(repro.kernels.ops), in f32 and bf16 and in every lane mode.

Tolerances.  On random floats the similarity sums run in another order in
each package, so a gain may differ by ``ref.gemm_gain_tol`` (a bound derived
from f32 rounding: 2 (d + r) 2^-24 sum_j sum_k |c_ik||r_jk|) and a
rectified residual sum by 2 r 2^-24 sum_j (|aux_ij| + |s_j|).  The
id-equality tests draw X and R from a dyadic grid (X = (a/8)^2, R = b/8,
d <= 32, r <= 48), where every similarity and gain is exact in f32 in any
summation order, so both packages must pick the same ids.
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

from repro.core import FacilityLocation as JFacilityLocation
from repro.core import MRConfig as JMRConfig
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
from repro_torch.kernels import facility_accept as tfa
from repro_torch.kernels import facility_marginals as tfm
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref

torch.set_num_threads(2)
jax.config.update("jax_platform_name", "cpu")

REPO = Path(__file__).resolve().parents[1]
L, C, D, R = 4, 40, 24, 36


def _bf16(a):
    return np.asarray(jnp.asarray(a, jnp.bfloat16))


def _t(a):
    return None if a is None else interop.tensor(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


def _random(seed, shape_c, r=R, d=D, dtype="f32", state_lanes=None):
    """Random-float inputs: cand U[0,1)^2, reference U[0,1), state a cover
    vector of similarity size."""
    rng = np.random.default_rng(seed)
    cand = (rng.random(shape_c + (d,)) ** 2).astype(np.float32)
    ref = rng.random((r, d)).astype(np.float32)
    if dtype == "bf16":
        cand, ref = _bf16(cand), _bf16(ref)
    st_shape = (r,) if state_lanes is None else (state_lanes, r)
    state = (rng.random(st_shape) * d / 4).astype(np.float32)
    return cand, ref, state


def _dyadic(rng, shape_c, r, d):
    """Dyadic inputs: cand (a/8)^2, reference b/8, a and b in 0..7."""
    cand = (rng.integers(0, 8, shape_c + (d,)) / 8.0) ** 2
    ref = rng.integers(0, 8, (r, d)) / 8.0
    return cand.astype(np.float32), ref.astype(np.float32)


def _gain_tol(cand, ref):
    return tref.gemm_gain_tol(_t(np.asarray(cand, np.float32)),
                              _t(np.asarray(ref, np.float32))).numpy()


def _rrs_tol(aux, state):
    aux, state = np.asarray(aux, np.float32), np.asarray(state, np.float32)
    r = aux.shape[-1]
    return 2 * r * 2.0 ** -24 * (np.abs(aux) + np.abs(state)[..., None, :]
                                 ).sum(-1)


def _close(got, want, tol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    err = np.abs(got - want)
    assert (err <= tol).all(), f"max err {err.max()} vs tol {np.min(tol)}"


# ---------------------------------------------------------------------------
# kernel twins
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("mode", ["unbatched", "shared", "per_lane"])
def test_facility_marginals_twin_matches_jax(mode, dtype):
    shape_c = (L, C) if mode == "per_lane" else (C,)
    cand, ref, state = _random(
        1, shape_c, dtype=dtype,
        state_lanes=None if mode == "unbatched" else L)
    got = ops.facility_marginals(_t(cand), _t(ref), _t(state)).numpy()
    tol = _gain_tol(cand, ref)
    if mode == "unbatched":
        want = [jref.facility_marginals(_j(cand), _j(ref), _j(state))]
        pallas = [jops.facility_marginals(_j(cand), _j(ref), _j(state))]
        got, tol = got[None], tol[None]
    else:
        xs = [cand[lane] if mode == "per_lane" else cand for lane in range(L)]
        want = [jref.facility_marginals(_j(x), _j(ref), _j(s))
                for x, s in zip(xs, state)]
        pallas = [jops.facility_marginals(_j(x), _j(ref), _j(s))
                  for x, s in zip(xs, state)]
        if mode == "shared":
            tol = np.broadcast_to(tol, got.shape)
    _close(got, np.stack(want), tol)
    _close(got, np.stack(pallas), tol)
    # each lane of a batched call equals the unbatched call
    if mode != "unbatched":
        for lane in range(L):
            x = cand[lane] if mode == "per_lane" else cand
            one = ops.facility_marginals(_t(x), _t(ref), _t(state[lane]))
            np.testing.assert_array_equal(got[lane], one.numpy())


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("mode", ["unbatched", "shared", "per_lane"])
def test_rectified_residual_sum_twin_matches_jax(mode, dtype):
    shape_c = (L, C) if mode == "per_lane" else (C,)
    cand, ref, state = _random(
        2, shape_c, state_lanes=None if mode == "unbatched" else L)
    aux = np.maximum(cand @ ref.T, 0.0).astype(np.float32)
    if dtype == "bf16":
        aux = _bf16(aux)
    got = ops.rectified_residual_sum(_t(aux), _t(state)).numpy()
    if mode == "unbatched":
        pairs = [(aux, state)]
        got = got[None]
    else:
        pairs = [(aux[lane] if mode == "per_lane" else aux, state[lane])
                 for lane in range(L)]
    want = np.stack([jref.rectified_residual_sum(_j(a), _j(s))
                     for a, s in pairs])
    pallas = np.stack([jops.rectified_residual_sum(_j(a), _j(s))
                       for a, s in pairs])
    tol = np.stack([_rrs_tol(a, s) for a, s in pairs])
    _close(got, want, tol)
    _close(got, pallas, tol)
    if mode != "unbatched":
        for lane, (a, s) in enumerate(pairs):
            one = ops.rectified_residual_sum(_t(a), _t(s))
            np.testing.assert_array_equal(got[lane], one.numpy())


def _accept_case(seed, B, r, d, lanes=None, dtype="f32"):
    rng = np.random.default_rng(seed)
    cand, ref = _dyadic(rng, (B,) if lanes is None else (lanes, B), r, d)
    if dtype == "bf16":
        cand, ref = _bf16(cand), _bf16(ref)
    st_shape = (r,) if lanes is None else (lanes, r)
    state = (rng.integers(0, 4 * d, st_shape) / 64.0).astype(np.float32)
    elig = rng.random(cand.shape[:-1]) < 0.8
    return cand, ref, state, elig


def _check_accept(got, want):
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("budget", [64, 3])
def test_facility_accept_twin_matches_jax(dtype, budget):
    """Dyadic inputs, so masks, states and gains are exact in both."""
    cand, ref, state, elig = _accept_case(3, 24, 30, 20, dtype=dtype)
    g0 = np.asarray(jref.facility_marginals(_j(cand), _j(ref), _j(state)))
    tau = np.float32(np.median(g0) * 0.02)
    got = ops.facility_accept(_t(cand), _t(ref), _t(state), _t(elig),
                              torch.tensor(tau), torch.tensor(budget,
                                                              dtype=torch.int32))
    if budget == 3:
        assert int(got[0].sum()) == 3   # the budget cut the sweep
    args = (_j(cand), _j(ref), _j(state), _j(elig), _j(tau),
            jnp.asarray(budget, jnp.int32))
    _check_accept(got, jref.facility_accept(*args))
    _check_accept(got, jops.facility_accept(*args))


def test_facility_accept_lanes_match_per_lane_loop():
    lanes, B = 4, 20
    cand, ref, state, elig = _accept_case(4, B, 26, 12, lanes=lanes)
    tau = np.array([0.05, 2.0, 6.0, 1e4], np.float32)
    bud = np.array([64, 2, 5, 64], np.int32)
    mask, st, gains = ops.facility_accept(_t(cand), _t(ref), _t(state),
                                          _t(elig), _t(tau), _t(bud))
    assert not mask[3].any() and mask[0].any()
    for lane in range(lanes):
        want = jref.facility_accept(_j(cand[lane]), _j(ref), _j(state[lane]),
                                    _j(elig[lane]), _j(tau[lane]),
                                    _j(bud[lane]))
        _check_accept((mask[lane], st[lane], gains[lane]), want)


def test_facility_wrappers_refuse_cpu_and_count_nothing_on_cpu():
    ops.reset_launch_counts()
    x, ref = torch.rand(8, 4), torch.rand(5, 4)
    with pytest.raises(ValueError, match="CUDA"):
        tfm.facility_marginals(x, ref, torch.zeros(5))
    with pytest.raises(ValueError, match="CUDA"):
        tfm.rectified_residual_sum(torch.rand(8, 5), torch.zeros(5))
    with pytest.raises(ValueError, match="CUDA"):
        tfa.facility_accept(x, ref, torch.zeros(5),
                            torch.ones(8, dtype=torch.bool), 0.1, 2)
    oracle = interop.facility_location(4, ref.numpy(), use_kernel=True)
    st = oracle.init_state(2)
    oracle.marginals(st, oracle.prep(st, x))
    oracle.chunk_marginals(st, x)
    oracle.chunk_accept(st, x[None].expand(2, 8, 4),
                        torch.ones(2, 8, dtype=torch.bool),
                        torch.tensor([0.1, 0.2]),
                        torch.tensor([4, 4], dtype=torch.int32))
    assert set(ops.launch_counts().values()) == {0}


# ---------------------------------------------------------------------------
# the oracle
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("use_kernel", [False, True])
def test_facility_oracle_matches_jax(use_kernel):
    cand, ref, state = _random(5, (C,), state_lanes=L)
    jo = JFacilityLocation(feat_dim=D, reference=jnp.asarray(ref))
    to = interop.facility_location(D, ref, use_kernel=use_kernel)
    assert to.init_state().shape == (R,) and to.init_state(L).shape == (L, R)
    aux = to.prep(to.init_state(), _t(cand))
    j_aux = jo.prep(jo.init_state(), jnp.asarray(cand))
    prod_tol = 2 * D * 2.0 ** -24 * (np.abs(cand) @ np.abs(ref).T)
    _close(aux.numpy(), j_aux, prod_tol)
    tol = np.broadcast_to(_gain_tol(cand, ref), (L, C))
    want = np.stack([jo.marginals(jnp.asarray(s), j_aux) for s in state])
    _close(to.marginals(_t(state), aux).numpy(), want, tol)
    _close(to.chunk_marginals(_t(state), _t(cand)).numpy(), want, tol)
    np.testing.assert_array_equal(
        to.add(_t(state[0]), aux[3]).numpy(),
        np.maximum(state[0], aux[3].numpy()))
    np.testing.assert_allclose(float(to.value(_t(state[0]))),
                               float(jo.value(jnp.asarray(state[0]))),
                               rtol=1e-6)
    # chunk_accept on dyadic inputs: exact against the JAX oracle's sweep
    dc, dr, ds, de = _accept_case(6, 16, R, D, lanes=L)
    jo = JFacilityLocation(feat_dim=D, reference=jnp.asarray(dr))
    to = interop.facility_location(D, dr, use_kernel=use_kernel)
    tau = np.array([0.5, 2.0, 4.0, 8.0], np.float32)
    bud = np.array([64, 3, 64, 64], np.int32)
    got = to.chunk_accept(_t(ds), _t(dc), _t(de), _t(tau), _t(bud))
    for lane in range(L):
        want = jo.chunk_accept(jnp.asarray(ds[lane]), jnp.asarray(dc[lane]),
                               jnp.asarray(de[lane]), tau[lane], bud[lane])
        _check_accept(tuple(g[lane] for g in got), want)


# ---------------------------------------------------------------------------
# engines and drivers (dyadic inputs: ids must be equal)
# ---------------------------------------------------------------------------

EC, ED, ER, EK, ECHUNK = 90, 16, 40, 10, 16   # EC % ECHUNK != 0


def _engine_case(seed, per_lane):
    rng = np.random.default_rng(seed)
    x, ref = _dyadic(rng, (L, EC) if per_lane else (EC,), ER, ED)
    ids = np.arange(EC, dtype=np.int32) * 3 + 7
    valid = rng.random(EC) < 0.9
    if per_lane:
        ids = np.stack([np.roll(ids, lane) for lane in range(L)])
        valid = rng.random((L, EC)) < 0.9
    g0 = np.maximum(x @ ref.T, 0.0).sum(-1)
    # from "accept until full" (tau 0) to "accept the first pick only"
    taus = (np.median(g0) * np.array([0.0, 0.01, 0.05, 0.5])
            ).astype(np.float32)
    return x, ref, ids, valid, taus


@pytest.mark.parametrize("engine", ["dense", "lazy", "fused"])
@pytest.mark.parametrize("per_lane", [False, True])
def test_facility_engines_first_match_jax_ids(engine, per_lane):
    x, ref, ids, valid, taus = _engine_case(20 + per_lane, per_lane)
    jo = JFacilityLocation(feat_dim=ED, reference=jnp.asarray(ref))

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
        to = interop.facility_location(ED, ref, use_kernel=use_kernel)
        st, sol, size, stats = tth.threshold_greedy(
            to, to.init_state(L), torch.full((L, EK), -1, dtype=torch.int32),
            torch.zeros(L, dtype=torch.int32), _t(x), _t(ids), _t(valid),
            _t(taus), EK, engine=engine, chunk=ECHUNK, with_stats=True)
        np.testing.assert_array_equal(sol.numpy(), np.asarray(j_sol))
        np.testing.assert_array_equal(size.numpy(), np.asarray(j_size))
        np.testing.assert_array_equal(to.value(st).numpy(), np.asarray(j_val))
        np.testing.assert_array_equal(stats.n_evals.numpy(),
                                      np.asarray(j_stats.n_evals))
        np.testing.assert_array_equal(stats.n_iters.numpy(),
                                      np.asarray(j_stats.n_iters))
    # the lanes span the outcomes: a full buffer and an early exit
    assert int(size.max()) == EK and int(size.min()) < EK


N, M, K, DD, RR = 512, 4, 6, 16, 24


def _corpus(seed):
    rng = np.random.default_rng(seed)
    X, ref = _dyadic(rng, (N,), RR, DD)
    return X, ref


@pytest.mark.parametrize("epochs,engine,precision", [
    (1, "dense", "f32"), (1, "fused", "bf16"), (2, "lazy", "f32"),
    (2, "fused", "bf16")])
def test_facility_drivers_match_jax(epochs, engine, precision):
    X, ref = _corpus(30 + epochs)
    fm = X.reshape(M, N // M, DD)
    ids = np.arange(N, dtype=np.int32).reshape(M, -1)
    valid = np.ones((M, N // M), bool)
    key = jax.random.PRNGKey(epochs)
    knobs = dict(k=K, n_total=N, n_machines=M, engine=engine, chunk=16,
                 precision=precision)
    jres, jlog = j_multi_epoch_sim(
        JFacilityLocation(feat_dim=DD, reference=jnp.asarray(ref)),
        jnp.asarray(fm), jnp.asarray(ids), jnp.asarray(valid),
        JMRConfig(**knobs), key, epochs=epochs)
    tres, tlog = tmr.multi_epoch_sim(
        interop.facility_location(DD, ref, use_kernel=True),
        *interop.shard(fm, ids, valid), tmr.MRConfig(**knobs),
        uniforms=interop.uniforms(jax_uniforms(key, epochs, M, N // M)),
        epochs=epochs)
    np.testing.assert_array_equal(tres.sol_ids.numpy(),
                                  np.asarray(jres.sol_ids))
    assert int(tres.sol_size) == int(jres.sol_size) >= 1
    assert int(tres.n_dropped) == int(jres.n_dropped)
    assert int(tres.tau_fallback) == int(jres.tau_fallback)
    np.testing.assert_allclose(float(tres.value), float(jres.value),
                               rtol=1e-6)
    assert [(r.name, r.bytes_per_machine, r.bytes_total, r.detail)
            for r in tlog.records] == \
        [(r.name, r.bytes_per_machine, r.bytes_total, r.detail)
         for r in jlog.records]
    assert tlog.n_rounds == 2 * epochs


@pytest.mark.parametrize("engine", ["dense", "fused"])
def test_facility_selector_matches_jax_selector(engine):
    """The port's DistributedSelector on the CPU against the JAX selector on
    a 1-device mesh (one machine, whose sample draws are the key folded in
    with machine index 0)."""
    X, ref = _corpus(40)
    key = jax.random.PRNGKey(5)
    jspec = JSelectorSpec(k=K, oracle="facility_location", engine=engine,
                          reference_size=RR)
    jsel = JDistributedSelector(jspec, make_mesh_for(1, model_parallel=1),
                                n_total=N, feat_dim=DD,
                                reference=jnp.asarray(ref))
    jres = jsel.select(jnp.asarray(X), key=key)
    spec = tsel.SelectorSpec(k=K, oracle="facility_location", engine=engine,
                             use_kernel=True, reference_size=RR)
    sel = tsel.DistributedSelector(spec, n_total=N, feat_dim=DD,
                                   device="cpu", reference=ref)
    draws = np.asarray(jax.random.uniform(jax.random.fold_in(key, 0), (N,)))
    res = sel.select(X, uniforms=draws[None, None])
    np.testing.assert_array_equal(res.sol_ids.numpy(), np.asarray(jres.sol_ids))
    np.testing.assert_allclose(float(res.value), float(jres.value), rtol=1e-6)
    assert int(res.n_dropped) == int(jres.n_dropped)
    assert [r.bytes_total for r in sel.round_log.records] == \
        [r.bytes_total for r in jsel.round_log.records]
    assert float(sel.opt_upper_bound(X)) >= float(res.value)
    # a bf16 selector keeps its reference at the storage precision
    bf = tsel.DistributedSelector(
        tsel.SelectorSpec(k=K, oracle="facility_location", precision="bf16"),
        n_total=N, feat_dim=DD, device="cpu", reference=ref)
    assert bf.oracle.reference.dtype == torch.bfloat16
    assert bf.oracle.init_state().dtype == torch.float32


def test_cli_facility_location_on_cpu():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO / "src") + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.select", "--device", "cpu",
         "--use-kernel", "--oracle", "facility_location", "--n", "1024",
         "--k", "8", "--d", "16", "--machines", "4", "--engine", "fused"],
        capture_output=True, text=True, env=env, timeout=120, cwd=REPO)
    assert out.returncode == 0, out.stderr
    assert "oracle=facility_location" in out.stdout
    assert "device=cpu" in out.stdout and "tau_fallback=0" in out.stdout
