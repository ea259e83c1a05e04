"""The ExemplarClustering slice of the port against the JAX package, on the
CPU.

On the CPU the port's kernel wrappers run their plain PyTorch versions
(repro_torch.kernels.ref); they are held here against the JAX reference
(repro.kernels.ref) and the Pallas kernels in interpret mode
(repro.kernels.ops), in f32 and bf16 and in every lane mode.

Tolerances.  On random floats the three-term distance
d2 = (||r||^2 - 2 <c, r>) + ||c||^2 sums its products in another order in
each package, so a gain may differ by ``ref.exemplar_gain_tol`` (the f32
rounding bound 2 (d + r + 2) 2^-24 sum_j (||r_j||^2 + 2 <|c|, |r_j|> +
||c||^2), for states at most m0 = ||r_j||^2).  The id-equality tests draw X
and R from a dyadic grid (X = a/8, R = b/8, a and b in 0..7, d <= 16,
r <= 32), where every distance and gain is exact in f32 in any summation
order, so both packages must pick the same ids.
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

from repro.core import ExemplarClustering as JExemplar
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
from repro_torch.kernels import exemplar_accept as tea
from repro_torch.kernels import exemplar_marginals as tem
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref

torch.set_num_threads(2)
jax.config.update("jax_platform_name", "cpu")

REPO = Path(__file__).resolve().parents[1]
L, C, D, R = 4, 40, 16, 30


def _bf16(a):
    return np.asarray(jnp.asarray(a, jnp.bfloat16))


def _t(a):
    return None if a is None else interop.tensor(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


def _m0(ref):
    ref = np.asarray(ref, np.float32)
    return (ref * ref).sum(-1)


def _random(seed, shape_c, r=R, d=D, dtype="f32", state_lanes=None):
    """Random-float inputs: cand and reference U[0, 1), state a fraction of
    m0 (a min-distance vector never exceeds it)."""
    rng = np.random.default_rng(seed)
    cand = rng.random(shape_c + (d,)).astype(np.float32)
    ref = rng.random((r, d)).astype(np.float32)
    if dtype == "bf16":
        cand, ref = _bf16(cand), _bf16(ref)
    st_shape = (r,) if state_lanes is None else (state_lanes, r)
    state = (rng.random(st_shape) * _m0(ref)).astype(np.float32)
    return cand, ref, state


def _dyadic(rng, shape_c, r, d):
    """Dyadic inputs: cand a/8, reference b/8, a and b in 0..7."""
    cand = rng.integers(0, 8, shape_c + (d,)) / 8.0
    ref = rng.integers(0, 8, (r, d)) / 8.0
    return cand.astype(np.float32), ref.astype(np.float32)


def _gain_tol(cand, ref):
    return tref.exemplar_gain_tol(_t(np.asarray(cand, np.float32)),
                                  _t(np.asarray(ref, np.float32))).numpy()


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
def test_exemplar_marginals_twin_matches_jax(mode, dtype):
    shape_c = (L, C) if mode == "per_lane" else (C,)
    cand, ref, state = _random(
        1, shape_c, dtype=dtype,
        state_lanes=None if mode == "unbatched" else L)
    got = ops.exemplar_marginals(_t(cand), _t(ref), _t(state)).numpy()
    tol = _gain_tol(cand, ref)
    if mode == "unbatched":
        pairs = [(cand, state)]
        got, tol = got[None], tol[None]
    else:
        pairs = [(cand[lane] if mode == "per_lane" else cand, state[lane])
                 for lane in range(L)]
        if mode == "shared":
            tol = np.broadcast_to(tol, got.shape)
    want = np.stack([jref.exemplar_marginals(_j(x), _j(ref), _j(s))
                     for x, s in pairs])
    pallas = np.stack([jops.exemplar_marginals(_j(x), _j(ref), _j(s))
                       for x, s in pairs])
    _close(got, want, tol)
    _close(got, pallas, tol)
    # each lane of a batched call equals the unbatched call
    if mode != "unbatched":
        for lane, (x, s) in enumerate(pairs):
            one = ops.exemplar_marginals(_t(x), _t(ref), _t(s))
            np.testing.assert_array_equal(got[lane], one.numpy())


def test_exemplar_marginals_dyadic_is_exact_and_clamps():
    """On dyadic data every distance is exact, so the plain version equals
    the JAX kernel bit for bit; a reference row equal to a candidate has
    distance 0, the clamp's edge."""
    rng = np.random.default_rng(2)
    cand, ref = _dyadic(rng, (C,), R, D)
    ref[:3] = cand[:3]
    state = _m0(ref)
    got = ops.exemplar_marginals(_t(cand), _t(ref), _t(state)).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jops.exemplar_marginals(_j(cand), _j(ref),
                                                _j(state))))
    d2 = tref.exemplar_distances(_t(cand), _t(ref)).numpy()
    assert d2.min() == 0.0 and (np.diag(d2[:3, :3]) == 0.0).all()


def _accept_case(seed, B, r, d, lanes=None, dtype="f32"):
    rng = np.random.default_rng(seed)
    cand, ref = _dyadic(rng, (B,) if lanes is None else (lanes, B), r, d)
    if dtype == "bf16":
        cand, ref = _bf16(cand), _bf16(ref)
    m0 = _m0(ref)
    # dyadic states between m0 / 4 and m0
    frac = rng.integers(2, 9, (r,) if lanes is None else (lanes, r)) / 8.0
    state = (m0 * frac).astype(np.float32)
    elig = rng.random(cand.shape[:-1]) < 0.8
    return cand, ref, state, elig


def _check_accept(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("budget", [64, 3])
def test_exemplar_accept_twin_matches_jax(dtype, budget):
    """Dyadic inputs, so masks, states and gains are exact in both."""
    cand, ref, state, elig = _accept_case(3, 24, R, D, dtype=dtype)
    g0 = np.asarray(jref.exemplar_marginals(_j(cand), _j(ref), _j(state)))
    tau = np.float32(np.median(g0) * 0.05)
    got = ops.exemplar_accept(_t(cand), _t(ref), _t(state), _t(elig),
                              torch.tensor(tau),
                              torch.tensor(budget, dtype=torch.int32))
    n_acc = int(got[0].sum())
    assert n_acc == 3 if budget == 3 else 3 < n_acc < 24
    args = (_j(cand), _j(ref), _j(state), _j(elig), _j(tau),
            jnp.asarray(budget, jnp.int32))
    _check_accept(got, jref.exemplar_accept(*args))
    _check_accept(got, jops.exemplar_accept(*args))


def test_exemplar_accept_lanes_match_per_lane_loop():
    lanes, B = 4, 20
    cand, ref, state, elig = _accept_case(4, B, 26, 12, lanes=lanes)
    tau = np.array([0.05, 2.0, 6.0, 1e4], np.float32)
    bud = np.array([64, 2, 5, 64], np.int32)
    mask, st, gains = ops.exemplar_accept(_t(cand), _t(ref), _t(state),
                                          _t(elig), _t(tau), _t(bud))
    assert not mask[3].any() and mask[0].any()
    for lane in range(lanes):
        want = jref.exemplar_accept(_j(cand[lane]), _j(ref), _j(state[lane]),
                                    _j(elig[lane]), _j(tau[lane]),
                                    _j(bud[lane]))
        _check_accept((mask[lane], st[lane], gains[lane]), want)


def test_exemplar_wrappers_refuse_cpu_and_count_nothing_on_cpu():
    ops.reset_launch_counts()
    x, ref = torch.rand(8, 4), torch.rand(5, 4)
    with pytest.raises(ValueError, match="CUDA"):
        tem.exemplar_marginals(x, ref, torch.zeros(5))
    with pytest.raises(ValueError, match="CUDA"):
        tea.exemplar_accept(x, ref, torch.zeros(5),
                            torch.ones(8, dtype=torch.bool), 0.1, 2)
    oracle = interop.exemplar(4, ref.numpy(), use_kernel=True)
    st = oracle.init_state(2)
    oracle.marginals(st, oracle.prep(st, x))
    oracle.chunk_marginals(st, x)
    oracle.chunk_accept(st, x[None].expand(2, 8, 4),
                        torch.ones(2, 8, dtype=torch.bool),
                        torch.tensor([0.1, 0.2]),
                        torch.tensor([4, 4], dtype=torch.int32))
    assert set(ops.launch_counts().values()) == {0}
    assert {"exemplar_marginals", "exemplar_accept"} <= set(
        ops.launch_counts())


# ---------------------------------------------------------------------------
# the oracle
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("use_kernel", [False, True])
def test_exemplar_oracle_matches_jax(use_kernel):
    cand, ref, state = _random(5, (C,), state_lanes=L)
    jo = JExemplar(feat_dim=D, reference=jnp.asarray(ref))
    to = interop.exemplar(D, ref, use_kernel=use_kernel)
    assert to.init_state().shape == (R,) and to.init_state(L).shape == (L, R)
    np.testing.assert_allclose(to.init_state().numpy(),
                               np.asarray(jo.init_state()), rtol=1e-6)
    aux = to.prep(to.init_state(), _t(cand))
    j_aux = jo.prep(jo.init_state(), jnp.asarray(cand))
    d2_tol = 2 * (D + 2) * 2.0 ** -24 * (
        _m0(ref)[None] + 2 * np.abs(cand) @ np.abs(ref).T
        + (cand * cand).sum(-1, keepdims=True))
    _close(aux.numpy(), j_aux, d2_tol)
    tol = np.broadcast_to(_gain_tol(cand, ref), (L, C))
    want = np.stack([jo.marginals(jnp.asarray(s), j_aux) for s in state])
    _close(to.marginals(_t(state), aux).numpy(), want, tol)
    _close(to.chunk_marginals(_t(state), _t(cand)).numpy(), want, tol)
    np.testing.assert_array_equal(
        to.add(_t(state[0]), aux[3]).numpy(),
        np.minimum(state[0], aux[3].numpy()))
    np.testing.assert_allclose(float(to.value(_t(state[0]))),
                               float(jo.value(jnp.asarray(state[0]))),
                               rtol=1e-6)
    assert float(to.value(to.init_state())) == 0.0
    # chunk_accept on dyadic inputs: exact against the JAX oracle's sweep
    dc, dr, ds, de = _accept_case(6, 16, R, D, lanes=L)
    jo = JExemplar(feat_dim=D, reference=jnp.asarray(dr))
    to = interop.exemplar(D, dr, use_kernel=use_kernel)
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

EC, ED, ER, EK, ECHUNK = 90, 12, 24, 10, 16   # EC % ECHUNK != 0


def _engine_case(seed, per_lane):
    rng = np.random.default_rng(seed)
    x, ref = _dyadic(rng, (L, EC) if per_lane else (EC,), ER, ED)
    ids = np.arange(EC, dtype=np.int32) * 3 + 7
    valid = rng.random(EC) < 0.9
    if per_lane:
        ids = np.stack([np.roll(ids, lane) for lane in range(L)])
        valid = rng.random((L, EC)) < 0.9
    g0 = np.asarray(jref.exemplar_marginals(
        jnp.asarray(x.reshape(-1, ED)), jnp.asarray(ref),
        jnp.asarray(_m0(ref))))
    # from "accept until full" (tau 0) to "accept the first pick only"
    taus = (np.median(g0) * np.array([0.0, 0.05, 0.2, 0.9])
            ).astype(np.float32)
    return x, ref, ids, valid, taus


@pytest.mark.parametrize("engine", ["dense", "lazy", "fused"])
@pytest.mark.parametrize("per_lane", [False, True])
def test_exemplar_engines_first_match_jax_ids(engine, per_lane):
    x, ref, ids, valid, taus = _engine_case(20 + per_lane, per_lane)
    jo = JExemplar(feat_dim=ED, reference=jnp.asarray(ref))

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
        to = interop.exemplar(ED, ref, use_kernel=use_kernel)
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


N, M, K, DD, RR = 512, 4, 6, 12, 24


def _corpus(seed):
    rng = np.random.default_rng(seed)
    return _dyadic(rng, (N,), RR, DD)


@pytest.mark.parametrize("epochs,engine,precision", [
    (1, "dense", "f32"), (1, "fused", "bf16"), (2, "lazy", "f32"),
    (2, "fused", "bf16")])
def test_exemplar_drivers_match_jax(epochs, engine, precision):
    X, ref = _corpus(30 + epochs)
    fm = X.reshape(M, N // M, DD)
    ids = np.arange(N, dtype=np.int32).reshape(M, -1)
    valid = np.ones((M, N // M), bool)
    key = jax.random.PRNGKey(epochs)
    knobs = dict(k=K, n_total=N, n_machines=M, engine=engine, chunk=16,
                 precision=precision)
    jres, jlog = j_multi_epoch_sim(
        JExemplar(feat_dim=DD, reference=jnp.asarray(ref)),
        jnp.asarray(fm), jnp.asarray(ids), jnp.asarray(valid),
        JMRConfig(**knobs), key, epochs=epochs)
    tres, tlog = tmr.multi_epoch_sim(
        interop.exemplar(DD, ref, use_kernel=True),
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


@pytest.mark.parametrize("engine,precision", [("dense", "f32"),
                                              ("fused", "bf16")])
def test_exemplar_selector_matches_jax_selector(engine, precision):
    """The port's DistributedSelector on the CPU against the JAX selector on
    a 1-device mesh (one machine, whose sample draws are the key folded in
    with machine index 0)."""
    X, ref = _corpus(40)
    key = jax.random.PRNGKey(5)
    jspec = JSelectorSpec(k=K, oracle="exemplar", engine=engine,
                          reference_size=RR, precision=precision)
    jsel = JDistributedSelector(jspec, make_mesh_for(1, model_parallel=1),
                                n_total=N, feat_dim=DD,
                                reference=jnp.asarray(ref))
    jres = jsel.select(jnp.asarray(X), key=key)
    spec = tsel.SelectorSpec(k=K, oracle="exemplar", engine=engine,
                             use_kernel=True, reference_size=RR,
                             precision=precision)
    sel = tsel.DistributedSelector(spec, n_total=N, feat_dim=DD,
                                   device="cpu", reference=ref)
    draws = np.asarray(jax.random.uniform(jax.random.fold_in(key, 0), (N,)))
    res = sel.select(X, uniforms=draws[None, None])
    np.testing.assert_array_equal(res.sol_ids.numpy(), np.asarray(jres.sol_ids))
    np.testing.assert_allclose(float(res.value), float(jres.value), rtol=1e-6)
    assert [r.bytes_total for r in sel.round_log.records] == \
        [r.bytes_total for r in jsel.round_log.records]
    assert float(sel.opt_upper_bound(X)) >= float(res.value)
    assert sel.oracle.reference.dtype == (torch.bfloat16 if precision == "bf16"
                                          else torch.float32)
    assert sel.oracle.init_state().dtype == torch.float32


def test_cli_exemplar_on_cpu():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO / "src") + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.select", "--device", "cpu",
         "--use-kernel", "--oracle", "exemplar", "--n", "1024", "--k", "8",
         "--d", "16", "--machines", "4", "--engine", "fused"],
        capture_output=True, text=True, env=env, timeout=120, cwd=REPO)
    assert out.returncode == 0, out.stderr
    assert "oracle=exemplar" in out.stdout
    assert "device=cpu" in out.stdout and "tau_fallback=0" in out.stdout
