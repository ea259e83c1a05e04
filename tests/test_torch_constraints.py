"""Knapsack and partition-matroid selection in the port against the JAX
package, on the CPU.

The same numpy inputs go through both packages: the plain sweeps' cost
mode against the JAX Pallas sweeps in interpret mode, the constraint
objects, every engine, the drivers (with their RoundLogs, whose messages
carry the d + 1 plane width), the selector and the CLI.

Tolerances.  Costs are dyadic (multiples of 1/8 in [0.5, 2)), so every
spend, tau * cost and budget comparison is exact in f32 in both packages.
The sweeps and engines run on dyadic data (FacilityLocation with X =
(a/8)^2, R = b/8; ExemplarClustering with a/8 and b/8; GraphCut with a/8;
WeightedCoverage with binary rows and dyadic weights; SaturatedCoverage
with (a/8)^2 rows and a dyadic cap), where masks, states and gains are
exact and must be equal.  FeatureCoverage's square roots are not dyadic:
its gains are held within rtol 1e-5 and its ids must be equal, as in the
port's cardinality tests on the same data.  The log-det sweep runs on
Gaussian rows at tau = 0, where every gain clears tau * c (gains are
>= 0), so its masks depend on eligibility and the budgets alone and must
be equal; its gains, bases and logdet are held to rtol 1e-5 / atol 1e-4.
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
from repro.core import FeatureCoverage as JFeatureCoverage
from repro.core import MRConfig as JMRConfig
from repro.core import constraints as jcons
from repro.core import multi_epoch_sim as j_multi_epoch_sim
from repro.core import sequential as jseq
from repro.core import threshold as jth
from repro.core.selector import DistributedSelector as JDistributedSelector
from repro.core.selector import SelectorSpec as JSelectorSpec
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.launch.mesh import make_mesh_for
from repro_torch import interop
from repro_torch.core import constraints as tcons
from repro_torch.core import mapreduce as tmr
from repro_torch.core import selector as tsel
from repro_torch.core import sequential as tseq
from repro_torch.core import threshold as tth
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref

torch.set_num_threads(2)
jax.config.update("jax_platform_name", "cpu")

REPO = Path(__file__).resolve().parents[1]


def _t(a):
    return None if a is None else interop.tensor(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


def _costs(rng, shape):
    """Dyadic costs in [0.5, 2): multiples of 1/8."""
    return ((4 + rng.integers(0, 12, shape)) / 8.0).astype(np.float32)


# ---------------------------------------------------------------------------
# the cost mode of every plain sweep, against the JAX sweeps
# ---------------------------------------------------------------------------

SB, SD, SR = 24, 12, 20     # sweep rows, features, reference rows


def _sweep_case(name, seed):
    """(call, eligible, tau) for one sweep: ``call(module, convert,
    eligible, tau, budget, cost, cost_budget)`` runs the sweep of
    ``module`` (the port's ``kernels.ops``, or the JAX package's
    ``kernels.ops`` or ``kernels.ref``) on fixed rows and state, each array
    passed through ``convert``; tau is a tenth of the median first-row
    gain (0 for the log-det sweeps)."""
    rng = np.random.default_rng(seed)
    elig = rng.random(SB) < 0.85
    if name in ("coverage", "saturated", "graph_cut", "weighted"):
        if name == "weighted":
            x = (rng.random((SB, SD)) < 0.3).astype(np.float32)
            state = (rng.integers(1, 9, SD) / 8.0).astype(np.float32)
        elif name == "graph_cut":
            x = (rng.integers(0, 8, (SB, SD)) / 8.0).astype(np.float32)
            state = (rng.integers(0, 8, SD) / 8.0).astype(np.float32)
        else:
            x = ((rng.integers(0, 8, (SB, SD)) / 8.0) ** 2).astype(np.float32)
            state = (rng.integers(0, 16, SD) / 8.0).astype(np.float32)
        extra = {"coverage": (None,),
                 "weighted": (),
                 "saturated": ((rng.integers(8, 24, SD) / 8.0)
                               .astype(np.float32), None),
                 "graph_cut": ((rng.integers(40, 80, SD) / 8.0)
                               .astype(np.float32),)}[name]
        fn = {"coverage": "coverage_accept",
              "weighted": "weighted_coverage_accept",
              "saturated": "saturated_coverage_accept",
              "graph_cut": "graph_cut_accept"}[name]
        if name == "graph_cut":
            def call(mod, conv, e, tau, b, c, cb):
                return getattr(mod, fn)(conv(x), conv(extra[0]), conv(state),
                                        conv(e), tau, b, 0.5, cost=conv(c),
                                        cost_budget=cb)
        else:
            def call(mod, conv, e, tau, b, c, cb):
                ex = tuple(conv(a) for a in extra)
                return getattr(mod, fn)(conv(x), conv(state), *ex, conv(e),
                                        tau, b, cost=conv(c), cost_budget=cb)
        if name == "coverage":
            g0 = np.sqrt(state + x).sum(-1) - np.sqrt(state).sum()
        elif name == "weighted":
            g0 = x @ state
        elif name == "saturated":
            cap = extra[0]
            g0 = (np.minimum(state + x, cap) - np.minimum(state, cap)).sum(-1)
        else:
            g0 = (x * (extra[0] - state) - 0.5 * x * x).sum(-1)
    elif name in ("facility", "exemplar"):
        if name == "facility":
            x = ((rng.integers(0, 8, (SB, SD)) / 8.0) ** 2).astype(np.float32)
        else:
            x = (rng.integers(0, 8, (SB, SD)) / 8.0).astype(np.float32)
        ref = (rng.integers(0, 8, (SR, SD)) / 8.0).astype(np.float32)
        if name == "facility":
            state = (rng.integers(0, 4 * SD, SR) / 64.0).astype(np.float32)
            g0 = np.maximum(np.maximum(x @ ref.T, 0) - state, 0).sum(-1)
        else:
            m0 = (ref * ref).sum(-1)
            state = (m0 * rng.integers(2, 9, SR) / 8.0).astype(np.float32)
            d2 = np.maximum(m0 - 2 * x @ ref.T + (x * x).sum(-1)[:, None], 0)
            g0 = np.maximum(state - d2, 0).sum(-1)
        fn = f"{name}_accept"

        def call(mod, conv, e, tau, b, c, cb):
            return getattr(mod, fn)(conv(x), conv(ref), conv(state), conv(e),
                                    tau, b, cost=conv(c), cost_budget=cb)
    else:   # log_det / mutual_information: Gaussian rows, tau = 0
        scale = 1.0 if name == "log_det" else 0.5
        x = rng.standard_normal((SB, SD)).astype(np.float32) * 0.5
        U = np.zeros((6, SD), np.float32)

        def call(mod, conv, e, tau, b, c, cb):
            return mod.logdet_accept(conv(x), conv(U), conv(np.float32(0)),
                                     conv(np.int32(0)), conv(e), tau, b,
                                     scale=scale, cost=conv(c),
                                     cost_budget=cb)
        g0 = np.zeros(SB)
    return call, elig, np.float32(np.median(g0) * 0.1)


SWEEPS = ("coverage", "weighted", "saturated", "graph_cut", "facility",
          "exemplar", "log_det", "mutual_information")


def _same(got, want, exact):
    """Masks and sizes equal; floats equal when ``exact``, else within
    rtol 1e-5 and atol 1e-6 (False) or 1e-4 (None, the log-det sweeps)."""
    for g, w in zip(got, want):
        w = np.asarray(w)
        if exact or g.dtype in (torch.bool, torch.int32):
            np.testing.assert_array_equal(g.numpy(), w)
        else:
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-5,
                                       atol=1e-4 if exact is None else 1e-6)


@pytest.mark.parametrize("name", SWEEPS)
def test_sweep_cost_mode_matches_jax(name):
    """A budget that binds inside the chunk: the spend test cuts accepts
    that the cardinality rule would take, and both packages cut the same
    rows."""
    call, elig, tau = _sweep_case(name, 3)
    rng = np.random.default_rng(4)
    cost = _costs(rng, SB)
    logdet = name in ("log_det", "mutual_information")
    exact = None if logdet else name != "coverage"
    for cb, budget in ((np.float32(3.5), 64), (np.float32(100.0), 5)):
        got = call(ops, _t, _t(elig), torch.tensor(tau), torch.tensor(budget),
                   cost, torch.tensor(cb))
        args = (_j(elig), jnp.float32(tau), jnp.int32(budget), cost,
                jnp.float32(cb))
        _same(got, call(jops, _j, *args), exact)
        _same(got, call(jref, _j, *args), exact)
        spent = cost[got[0].numpy()].sum()
        assert spent <= cb
    # the first budget bound: without it the sweep accepts more
    free = call(ops, _t, _t(elig), torch.tensor(tau), torch.tensor(64), cost,
                torch.tensor(np.float32(1e9)))
    bound = call(ops, _t, _t(elig), torch.tensor(tau), torch.tensor(64), cost,
                 torch.tensor(np.float32(3.5)))
    assert int(free[0].sum()) > int(bound[0].sum()) >= 1


@pytest.mark.parametrize("name", SWEEPS)
def test_sweep_unit_costs_keep_cardinality_bits(name):
    """Unit costs with an unbinding budget give the cardinality sweep's
    bits (tau * 1 == tau), and lanes of a batched call with per-lane
    budgets equal the unbatched calls."""
    call, elig, tau = _sweep_case(name, 5)
    card = call(ops, _t, _t(elig), torch.tensor(tau), torch.tensor(7), None,
                None)
    unit = call(ops, _t, _t(elig), torch.tensor(tau), torch.tensor(7),
                np.ones(SB, np.float32), torch.tensor(np.float32(64.0)))
    for a, b in zip(card, unit):
        assert torch.equal(a, b)


def test_sweep_cost_lanes_match_unbatched():
    rng = np.random.default_rng(6)
    x = ((rng.integers(0, 8, (3, SB, SD)) / 8.0) ** 2).astype(np.float32)
    ref = (rng.integers(0, 8, (SR, SD)) / 8.0).astype(np.float32)
    state = np.zeros((3, SR), np.float32)
    elig = rng.random((3, SB)) < 0.9
    cost = _costs(rng, (3, SB))
    tau = np.array([0.5, 1.0, 2.0], np.float32)
    bud = np.array([64, 4, 64], np.int32)
    cb = np.array([3.0, 100.0, 6.5], np.float32)
    got = ops.facility_accept(_t(x), _t(ref), _t(state), _t(elig), _t(tau),
                              _t(bud), _t(cost), _t(cb))
    for lane in range(3):
        one = ops.facility_accept(_t(x[lane]), _t(ref), _t(state[lane]),
                                  _t(elig[lane]), _t(tau[lane]), _t(bud[lane]),
                                  _t(cost[lane]), _t(cb[lane]))
        for a, b in zip(got, one):
            assert torch.equal(a[lane], b)
    with pytest.raises(ValueError, match="together"):
        ops.facility_accept(_t(x), _t(ref), _t(state), _t(elig), _t(tau),
                            _t(bud), _t(cost), None)


# ---------------------------------------------------------------------------
# the constraint objects
# ---------------------------------------------------------------------------

def test_constraint_objects_match_jax():
    rng = np.random.default_rng(7)
    n, P = 40, 5
    costs = _costs(rng, n)
    parts = rng.integers(0, P, n).astype(np.int32)
    caps = np.array([1, 2, 0, 3, 1], np.int32)
    jk, tk = jcons.Knapsack(budget=4.0, costs=jnp.asarray(costs)), \
        interop.knapsack(costs, 4.0)
    jp = jcons.PartitionMatroid(capacities=jnp.asarray(caps),
                                parts=jnp.asarray(parts))
    tp = interop.partition_matroid(parts, caps)
    ids = np.array([3, -1, 39, 7, 100], np.int32)
    for jc, tc in ((jk, tk), (jp, tp)):
        assert tc.name == jc.name and tc.fused_mode == jc.fused_mode
        assert tc.n_planes == jc.n_planes == 1
        np.testing.assert_array_equal(tc.plane(_t(ids)).numpy(),
                                      np.asarray(jc.plane(jnp.asarray(ids))))
    plane = np.asarray(jk.plane(jnp.arange(n)))
    for spent in (0.0, 2.5, 3.75):
        np.testing.assert_array_equal(
            tk.eligible(torch.tensor(np.float32(spent)), _t(plane)).numpy(),
            np.asarray(jk.eligible(jnp.float32(spent), jnp.asarray(plane))))
    lanes = torch.tensor([0.0, 2.5, 3.75])
    want = np.stack([np.asarray(jk.eligible(jnp.float32(s), plane))
                     for s in (0.0, 2.5, 3.75)])
    np.testing.assert_array_equal(tk.eligible(lanes, _t(plane)).numpy(), want)
    tau = torch.tensor([0.5, 3.0])
    np.testing.assert_array_equal(
        tk.row_tau(tau, _t(plane)).numpy(),
        np.stack([np.asarray(jk.row_tau(jnp.float32(t), plane))
                  for t in (0.5, 3.0)]))
    pplane = np.asarray(jp.plane(jnp.arange(n)))
    counts = np.array([[0, 1, 0, 3, 0], [1, 2, 0, 0, 1]], np.int32)
    np.testing.assert_array_equal(
        tp.eligible(_t(counts), _t(pplane)).numpy(),
        np.stack([np.asarray(jp.eligible(jnp.asarray(c), pplane))
                  for c in counts]))
    np.testing.assert_array_equal(
        tp.add(_t(counts), _t(pplane[:2])).numpy(),
        np.stack([np.asarray(jp.add(jnp.asarray(c), pplane[i]))
                  for i, c in enumerate(counts)]))
    ok, st = tp.admit(tp.init_state(), _t(pplane[0]))
    jok, jst = jp.admit(jp.init_state(), jnp.asarray(pplane[0]))
    assert bool(ok) == bool(jok)
    np.testing.assert_array_equal(st.numpy(), np.asarray(jst))
    assert tk.init_state(3).shape == (3,) and tp.init_state(3).shape == (3, P)
    assert tcons.make_constraint("cardinality") is None
    with pytest.raises(ValueError, match="needs costs"):
        tcons.make_constraint("knapsack", costs=costs)
    with pytest.raises(ValueError, match="corpus has"):
        tcons.make_constraint("partition_matroid", n_total=n + 1,
                              parts=parts, capacities=caps)
    with pytest.raises(ValueError, match="unknown constraint"):
        tsel.SelectorSpec(k=4, constraint="matroid")
    with pytest.raises(TypeError, match="Constraint"):
        tmr.MRConfig(k=4, n_total=8, n_machines=1, constraint="knapsack")


# ---------------------------------------------------------------------------
# engines (dyadic FacilityLocation, dyadic costs: ids must be equal)
# ---------------------------------------------------------------------------

EC, ED, ER, EK, ECHUNK, EL = 90, 12, 24, 10, 16, 4


def _engine_case(seed, kind):
    rng = np.random.default_rng(seed)
    x = ((rng.integers(0, 8, (EC, ED)) / 8.0) ** 2).astype(np.float32)
    ref = (rng.integers(0, 8, (ER, ED)) / 8.0).astype(np.float32)
    ids = np.arange(EC, dtype=np.int32) * 3 + 7
    valid = rng.random(EC) < 0.9
    g0 = np.maximum(x @ ref.T, 0).sum(-1)
    taus = (np.median(g0) * np.array([0.0, 0.05, 0.2, 0.9])
            ).astype(np.float32)
    if kind == "knapsack":
        data = _costs(rng, EC)
        jc = jcons.Knapsack(budget=6.0, costs=jnp.asarray(data))
        tc = interop.knapsack(data, 6.0)
    elif kind == "partition":
        data = rng.integers(0, 4, EC).astype(np.int32)
        caps = np.array([2, 1, 3, 2], np.int32)
        jc = jcons.PartitionMatroid(capacities=jnp.asarray(caps),
                                    parts=jnp.asarray(data))
        tc = interop.partition_matroid(data, caps)
    else:
        jc, tc = jcons.Cardinality(), tcons.Cardinality()
    plane = np.asarray(jc.plane(jnp.arange(EC, dtype=jnp.int32)))
    return x, ref, ids, valid, taus, jc, tc, plane


@pytest.mark.parametrize("engine", ["dense", "lazy", "fused"])
@pytest.mark.parametrize("kind", ["knapsack", "partition", "cardinality"])
def test_constrained_engines_match_jax_ids(kind, engine):
    x, ref, ids, valid, taus, jc, tc, plane = _engine_case(11, kind)
    jo = JFacilityLocation(feat_dim=ED, reference=jnp.asarray(ref))
    cplane = None if kind == "cardinality" else plane

    def one(tau):
        out = jth.threshold_greedy(
            jo, jo.init_state(), jnp.full((EK,), -1, jnp.int32),
            jnp.zeros((), jnp.int32), jnp.asarray(x), jnp.asarray(ids),
            jnp.asarray(valid), tau, EK, engine=engine, chunk=ECHUNK,
            with_stats=True, constraint=jc, cplane=_j(cplane))
        return out[1], out[2], jo.value(out[0]), out[3], out[4]

    j_sol, j_size, j_val, j_cst, j_stats = jax.vmap(one)(jnp.asarray(taus))
    to = interop.facility_location(ED, ref, use_kernel=True)
    st, sol, size, cst, stats = tth.threshold_greedy(
        to, to.init_state(EL), torch.full((EL, EK), -1, dtype=torch.int32),
        torch.zeros(EL, dtype=torch.int32), _t(x), _t(ids), _t(valid),
        _t(taus), EK, engine=engine, chunk=ECHUNK, with_stats=True,
        constraint=tc, cplane=_t(cplane))
    np.testing.assert_array_equal(sol.numpy(), np.asarray(j_sol))
    np.testing.assert_array_equal(size.numpy(), np.asarray(j_size))
    np.testing.assert_array_equal(to.value(st).numpy(), np.asarray(j_val))
    np.testing.assert_array_equal(stats.n_evals.numpy(),
                                  np.asarray(j_stats.n_evals))
    np.testing.assert_array_equal(stats.n_iters.numpy(),
                                  np.asarray(j_stats.n_iters))
    if kind == "cardinality":
        # an explicit Cardinality() selects exactly as constraint=None
        plain = tth.threshold_greedy(
            to, to.init_state(EL), torch.full((EL, EK), -1, dtype=torch.int32),
            torch.zeros(EL, dtype=torch.int32), _t(x), _t(ids), _t(valid),
            _t(taus), EK, engine=engine, chunk=ECHUNK)
        assert cst is None and torch.equal(plain[1], sol)
        return
    np.testing.assert_array_equal(cst.numpy(), np.asarray(j_cst))
    picked = [(ids == i).argmax() for i in sol.numpy().reshape(-1) if i >= 0]
    if kind == "knapsack":
        # the budget binds: the lanes stop below k with at most B spent
        assert int(size.min()) < EK
        for lane in range(EL):
            rows = [(ids == i).argmax() for i in sol[lane].numpy() if i >= 0]
            assert plane[rows, 0].sum() <= 6.0
    else:
        assert len(picked) > 0


def test_constrained_scan_lanes_match_jax_per_lane():
    """The fused engine's "scan" sweep with per-lane candidate blocks."""
    rng = np.random.default_rng(12)
    x = ((rng.integers(0, 8, (EL, EC, ED)) / 8.0) ** 2).astype(np.float32)
    ref = (rng.integers(0, 8, (ER, ED)) / 8.0).astype(np.float32)
    parts = rng.integers(0, 3, (EL, EC)).astype(np.int32)
    caps = np.array([1, 2, 2], np.int32)
    jc = jcons.PartitionMatroid(capacities=jnp.asarray(caps),
                                parts=jnp.asarray(parts[0]))
    tc = interop.partition_matroid(parts[0], caps)
    plane = parts[..., None].astype(np.float32)
    ids = np.stack([np.arange(EC, dtype=np.int32)] * EL)
    valid = np.ones((EL, EC), bool)
    taus = np.array([0.0, 1.0, 3.0, 9.0], np.float32)
    jo = JFacilityLocation(feat_dim=ED, reference=jnp.asarray(ref))

    def one(tau, xf, p):
        out = jth.threshold_greedy(
            jo, jo.init_state(), jnp.full((EK,), -1, jnp.int32),
            jnp.zeros((), jnp.int32), xf, jnp.asarray(ids[0]),
            jnp.asarray(valid[0]), tau, EK, engine="fused", chunk=ECHUNK,
            constraint=jc, cplane=p)
        return out[1], out[3]

    j_sol, j_cst = jax.vmap(one)(jnp.asarray(taus), jnp.asarray(x),
                                 jnp.asarray(plane))
    to = interop.facility_location(ED, ref)
    _, sol, _, cst = tth.threshold_greedy(
        to, to.init_state(EL), torch.full((EL, EK), -1, dtype=torch.int32),
        torch.zeros(EL, dtype=torch.int32), _t(x), _t(ids), _t(valid),
        _t(taus), EK, engine="fused", chunk=ECHUNK, constraint=tc,
        cplane=_t(plane))
    np.testing.assert_array_equal(sol.numpy(), np.asarray(j_sol))
    np.testing.assert_array_equal(cst.numpy(), np.asarray(j_cst))
    assert (cst.numpy() <= caps).all() and int(cst.sum()) > 0


# ---------------------------------------------------------------------------
# drivers, baselines, selector and CLI
# ---------------------------------------------------------------------------

N, M, K, DD = 512, 4, 8, 10


def _corpus(seed, kind):
    rng = np.random.default_rng(seed)
    X = (rng.random((N, DD), dtype=np.float32)) ** 2
    if kind == "knapsack":
        data = _costs(rng, N)
        return X, jcons.Knapsack(budget=5.0, costs=jnp.asarray(data)), \
            interop.knapsack(data, 5.0)
    if kind == "partition":
        data = rng.integers(0, 4, N).astype(np.int32)
        caps = np.full(4, 2, np.int32)
        return X, jcons.PartitionMatroid(capacities=jnp.asarray(caps),
                                         parts=jnp.asarray(data)), \
            interop.partition_matroid(data, caps)
    return X, jcons.Cardinality(), tcons.Cardinality()


@pytest.mark.parametrize("kind,epochs,engine,precision", [
    ("knapsack", 1, "dense", "f32"), ("knapsack", 1, "fused", "bf16"),
    ("knapsack", 2, "fused", "f32"),
    ("partition", 1, "fused", "f32"), ("partition", 2, "dense", "bf16"),
    ("cardinality", 1, "fused", "f32")])
def test_constrained_drivers_match_jax(kind, epochs, engine, precision):
    """Ids, sizes and values of the JAX drivers, and their RoundLog
    records, whose messages carry the d + 1 plane width; multi_epoch
    carries the feasibility state across epochs."""
    X, jc, tc = _corpus(30 + epochs, kind)
    fm = X.reshape(M, N // M, DD)
    ids = np.arange(N, dtype=np.int32).reshape(M, -1)
    valid = np.ones((M, N // M), bool)
    key = jax.random.PRNGKey(epochs)
    knobs = dict(k=K, n_total=N, n_machines=M, engine=engine, chunk=16,
                 precision=precision)
    jres, jlog = j_multi_epoch_sim(
        JFeatureCoverage(feat_dim=DD), jnp.asarray(fm), jnp.asarray(ids),
        jnp.asarray(valid), JMRConfig(**knobs, constraint=jc), key,
        epochs=epochs)
    tres, tlog = tmr.multi_epoch_sim(
        interop.feature_coverage(DD, use_kernel=True),
        *interop.shard(fm, ids, valid), tmr.MRConfig(**knobs, constraint=tc),
        uniforms=interop.uniforms(jax_uniforms(key, epochs, M, N // M)),
        epochs=epochs)
    np.testing.assert_array_equal(tres.sol_ids.numpy(),
                                  np.asarray(jres.sol_ids))
    assert int(tres.sol_size) == int(jres.sol_size) >= 1
    assert int(tres.n_dropped) == int(jres.n_dropped)
    np.testing.assert_allclose(float(tres.value), float(jres.value),
                               rtol=1e-5)
    assert [(r.name, r.bytes_per_machine, r.bytes_total, r.detail)
            for r in tlog.records] == \
        [(r.name, r.bytes_per_machine, r.bytes_total, r.detail)
         for r in jlog.records]
    width = DD + (0 if kind == "cardinality" else 1)
    isz = 2 if precision == "bf16" else 4
    assert tlog.records[0].bytes_per_machine % (width * isz + 5) == 0
    chosen = tres.sol_ids[:int(tres.sol_size)].numpy()
    if kind == "knapsack":
        assert np.asarray(jc.costs, np.float64)[chosen].sum() <= jc.budget
    elif kind == "partition":
        counts = np.bincount(np.asarray(jc.parts)[chosen], minlength=4)
        assert (counts <= 2).all()


@pytest.mark.parametrize("kind", ["knapsack", "partition"])
def test_constrained_greedy_and_brute_force_bands(kind):
    """Sequential greedy and constrained brute force equal the JAX
    package's, and two_round lands in the band the JAX suite pins against
    the constrained OPT."""
    n, d, m, k = 10, 6, 2, 4
    rng = np.random.default_rng(13 if kind == "knapsack" else 17)
    X = (rng.random((n, d)).astype(np.float32)) ** 2
    if kind == "knapsack":
        data = _costs(rng, n)
        jc = jcons.Knapsack(budget=2.5, costs=jnp.asarray(data))
        tc = interop.knapsack(data, 2.5)
        band = 0.3
    else:
        data = rng.integers(0, 4, n).astype(np.int32)
        jc = jcons.PartitionMatroid(capacities=jnp.ones(4, jnp.int32),
                                    parts=jnp.asarray(data))
        tc = interop.partition_matroid(data, np.ones(4, np.int32))
        band = 0.45
    jo, to = JFeatureCoverage(feat_dim=d), interop.feature_coverage(d)
    best, opt = tseq.brute_force_constrained(to, _t(X), k, tc)
    j_best, j_opt = jseq.brute_force_constrained(jo, X, k, jc)
    assert best == tuple(j_best)
    np.testing.assert_allclose(opt, j_opt, rtol=1e-5)
    g = tseq.greedy(to, _t(X), torch.ones(n, dtype=torch.bool), k,
                    constraint=tc)
    jg = jseq.greedy(jo, jnp.asarray(X), jnp.ones(n, bool), k, constraint=jc)
    np.testing.assert_array_equal(g[0].numpy(), np.asarray(jg[0]))
    np.testing.assert_allclose(float(g[2]), float(jg[2]), rtol=1e-5)
    assert float(g[2]) <= opt + 1e-5
    fm = X.reshape(m, n // m, d)
    ids = np.arange(n, dtype=np.int32).reshape(m, -1)
    res, _ = tmr.two_round_sim(
        to, *interop.shard(fm, ids, np.ones((m, n // m), bool)),
        tmr.MRConfig(k=k, n_total=n, n_machines=m, constraint=tc),
        generator=torch.Generator().manual_seed(2))
    assert float(res.value) >= band * opt
    assert tseq.brute_force_constrained(to, _t(X), k, None)[1] >= opt


@pytest.mark.parametrize("kind", ["knapsack", "partition"])
def test_constrained_selector_matches_jax_selector(kind):
    X, jc, tc = _corpus(40, kind)
    key = jax.random.PRNGKey(5)
    extra = (dict(element_costs=np.asarray(jc.costs))
             if kind == "knapsack" else
             dict(parts=np.asarray(jc.parts),
                  part_caps=np.asarray(jc.capacities)))
    cname = "knapsack" if kind == "knapsack" else "partition_matroid"
    budget = 5.0 if kind == "knapsack" else None
    jsel = JDistributedSelector(
        JSelectorSpec(k=K, engine="fused", constraint=cname,
                      knapsack_budget=budget),
        make_mesh_for(1, model_parallel=1), n_total=N, feat_dim=DD, **extra)
    jres = jsel.select(jnp.asarray(X), key=key)
    sel = tsel.DistributedSelector(
        tsel.SelectorSpec(k=K, engine="fused", use_kernel=True,
                          constraint=cname, knapsack_budget=budget),
        n_total=N, feat_dim=DD, device="cpu", **extra)
    draws = np.asarray(jax.random.uniform(jax.random.fold_in(key, 0), (N,)))
    res = sel.select(X, uniforms=draws[None, None])
    np.testing.assert_array_equal(res.sol_ids.numpy(), np.asarray(jres.sol_ids))
    np.testing.assert_allclose(float(res.value), float(jres.value), rtol=1e-5)
    assert [r.bytes_total for r in sel.round_log.records] == \
        [r.bytes_total for r in jsel.round_log.records]
    assert sel.cfg.constraint_planes == 1


@pytest.mark.parametrize("kind", ["knapsack", "partition_matroid"])
def test_cli_constraint_on_cpu(kind):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO / "src") + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.select", "--device", "cpu",
         "--use-kernel", "--n", "1024", "--k", "8", "--d", "16",
         "--machines", "4", "--engine", "fused", "--constraint", kind,
         "--n-parts", "4"],
        capture_output=True, text=True, env=env, timeout=120, cwd=REPO)
    assert out.returncode == 0, out.stderr
    assert f"constraint={kind}" in out.stdout and "tau_fallback=0" in out.stdout
