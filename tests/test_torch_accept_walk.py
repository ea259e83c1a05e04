"""The windowed walks of the accept sweeps against the row-by-row sweep,
on the CPU: the reference sweeps (facility_accept and exemplar_accept)
and the four feature sweeps (coverage_accept, weighted_coverage_accept,
saturated_coverage_accept and graph_cut_accept).

The CUDA sweeps score a window of rows against the live state at once,
accept the first row that passes, and score the rows after it again; the
state, the accept count and the spend change only on an accept, so the
walk must take the row loop's decisions.  The walk is written here in
plain numpy (float32, each product and sum rounded on its own, as the
kernels round them) and held against the port's plain sweeps
(``repro_torch.kernels.ref`` through ``kernels.ops`` on CPU tensors), the
JAX reference (``repro.kernels.ref``) and the Pallas kernels in interpret
mode (``repro.kernels.ops``), lane by lane.

Data are dyadic (candidates (a/8)^2 for facility and a/8 for exemplar,
reference rows b/8, states multiples of 1/64 or quarters of m0, costs
multiples of 1/8), small enough that every similarity, distance, gain,
tau * cost and spend is exact in f32 in any order: masks, states and gains
must be equal.  The feature rules run on dyadic rows too: binary rows over
states k/8 (weighted coverage), (a/8)^2 rows against dyadic caps and states
straddling them (saturated coverage), a/8 rows with totals k/2 (graph cut),
and for coverage states c/64 (c = 1, 4, 16) with each feature non-zero in
at most two rows of a lane, at 24 c/64, so a state runs through c/64,
25 c/64 and 49 c/64 and every square root is exact.  The lanes cover
budgets 0, 1, 3 and k, ineligible rows, a gain exactly at tau, a spend
exactly at the cost budget and tau = -inf.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch import interop
from repro_torch.kernels import ops

torch.set_num_threads(2)
jax.config.update("jax_platform_name", "cpu")

R, D, K = 40, 8, 64
#: pass widths: the row loop, a few rows, the kernels' wide pass, and
#: "mixed", the narrow instance's order of them (wide passes; one row a
#: pass after an accept among a wide pass's first 4 rows, until 2 rows in
#: a row are rejected)
WINDOWS = (1, 4, 32, "mixed")
WIDE, CLOSE, MISSES = 32, 4, 2
#: the feature walk (csrc/feature_sweep.cuh): its pass widths (32 rows up to
#: 2 features a thread, 16 at 4, 8 beyond: wide_rows), its row loop after
#: an accept among a pass's first FEATURE_CLOSE rows, until FEATURE_MISSES
#: rows in a row are rejected (FEATURE_DENSE once it has accepted a row),
#: and after a row loop that accepted a row a pass of FEATURE_NARROW rows,
#: each pass without an accept doubling the next one's up to the wide width
FEATURE_WIDE = (32, 16, 8)
FEATURE_CLOSE, FEATURE_MISSES, FEATURE_DENSE = 8, 2, 16
FEATURE_HITS, FEATURE_NARROW = 6, 8
#: the pass widths, hoping for rejects (an int) or for accepts ("hope"),
#: and the kernel's mixed order at each wide width with the rows its row
#: loop decides a step (tree_rows: 2 up to 8 features a thread, 1 at 16)
FEATURE_WINDOWS = (1, *FEATURE_WIDE, *(("hope", w) for w in FEATURE_WIDE),
                   ("mixed", 32, 2), ("mixed", 16, 2), ("mixed", 8, 2),
                   ("mixed", 8, 1))
#: features of the feature rules' lanes
FEATURE_D = 64


def _values(name, cand, ref):
    """The (B, r) value block of one lane, exact in float64, as float32."""
    cand, ref = cand.astype(np.float64), ref.astype(np.float64)
    if name == "facility":
        return np.maximum(cand @ ref.T, 0.0).astype(np.float32)
    d2 = ((ref * ref).sum(-1)[None, :] - 2.0 * (cand @ ref.T)
          + (cand * cand).sum(-1)[:, None])
    return np.maximum(d2, 0.0).astype(np.float32)


def _residual(name, s, v):
    return np.maximum(v - s if name == "facility" else s - v, np.float32(0))


def _update(name, s, v):
    return np.maximum(s, v) if name == "facility" else np.minimum(s, v)


def windowed_walk(gain, update, B, state, elig, tau, budget, cost=None,
                  cost_budget=None, window=32, wide=WIDE, close=CLOSE,
                  misses_out=MISSES, dense=None, narrow=None, hits=None,
                  tree=1):
    """One lane's sweep of B rows as the kernels walk it, in passes that
    score a window of rows against the state at once.  A pass of ``window``
    rows hopes for rejects: it takes the first row that passes, rejects the
    rows before it with the gains just taken, applies the accept and goes on
    from the row after it.  A ("hope", w) pass hopes for accepts: it scores
    each row against the state the rows before it would leave if every row
    that fits were accepted, and keeps the decisions up to the first row
    that fits but fails (a surprise, rejected).  "mixed" is the kernels'
    order: passes of ``wide`` rows; after an accept (a surprise, when
    hopeful) among a pass's first ``close`` rows the row loop, ``tree``
    rows a step, until ``misses_out`` rows in a row are rejected (``dense``
    once it has accepted a row) or, with ``hits``, that many rows in a row
    are accepted (then hopeful passes); with ``narrow``, a pass ``narrow``
    rows wide
    after a row loop that accepted a row, each pass that meets its hope
    doubling the next up to ``wide``.  ``gain(s, i)`` is row i's gain
    against state s (float32), ``update(s, i)`` the state after accepting
    it.  Returns (mask, state, gains)."""
    f32 = np.float32
    tau = f32(tau)
    mask = np.zeros(B, bool)
    gains = np.zeros(B, f32)
    lane = {"s": state.astype(f32).copy(), "n": 0, "spent": f32(0)}

    def fits(i, n, spent):
        if cost is None:
            return n < budget
        return n < budget and f32(spent + f32(cost[i])) <= f32(cost_budget)

    def passes(g, i):
        return g >= (tau if cost is None else f32(tau * f32(cost[i])))

    def spend(i, spent):
        return spent if cost is None else f32(spent + f32(cost[i]))

    def accept(i):
        mask[i] = True
        lane["s"] = update(lane["s"], i)
        lane["n"] += 1
        lane["spent"] = spend(i, lane["spent"])

    def reject_pass(cur, width):
        """The offset of the accept, or None."""
        rows = range(cur, min(cur + width, B))
        g = [f32(gain(lane["s"], i)) for i in rows]
        for k, i in enumerate(rows):
            gains[i] = g[k]
            if elig[i] and passes(g[k], i) and fits(i, lane["n"],
                                                    lane["spent"]):
                accept(i)
                return k
        return None

    def hope_pass(cur, width):
        """The offset of the surprise, or None."""
        rows = range(cur, min(cur + width, B))
        s, n, spent, hoped = lane["s"], lane["n"], lane["spent"], []
        for i in rows:
            g = f32(gain(s, i))
            a = bool(elig[i] and fits(i, n, spent))
            hoped.append((i, g, a))
            if a:
                s, n, spent = update(s, i), n + 1, spend(i, spent)
        for k, (i, g, a) in enumerate(hoped):
            gains[i] = g
            if a and not passes(g, i):
                return k
            if a:
                accept(i)
        return None

    cur, hopeful, width = 0, False, wide
    while cur < B:
        if window == "mixed":
            f = (hope_pass if hopeful else reject_pass)(cur, width)
        elif isinstance(window, tuple):
            f, width = hope_pass(cur, window[1]), window[1]
        else:
            f, width = reject_pass(cur, window), window
        cur += width if f is None else f + 1
        if window != "mixed":
            continue
        if f is None:
            width = min(2 * width, wide)
        elif f < close and cur < B:
            took, run, misses, hit = False, 0, 0, False
            while True:
                for i in range(cur, min(cur + tree, B)):
                    accepted = reject_pass(i, 1) is not None
                    took = took or accepted
                    run, misses = ((run + 1, 0) if accepted
                                   else (0, misses + 1))
                cur = min(cur + tree, B)
                hit = hits is not None and run >= hits
                if cur >= B or hit or misses >= (
                        dense if took and dense else misses_out):
                    break
            hopeful = hit
            width = narrow if narrow and (hit or took) else wide
    return mask, lane["s"], gains


def _case(name, B, mode, seed):
    """(cand (L, B, d), ref, state (L, r), elig, tau (L,), budget (L,),
    cost (L, B) or None, cost_budget (L,) or None) for eight lanes: budgets
    0, 1, 3 and k at a median tau; a lane with row 0 exactly at tau; one at
    tau = -inf; one with every row ineligible; and (cost mode) one whose
    budget is exactly the spend of its first two accepts at tau = -inf."""
    rng = np.random.default_rng(seed)
    L = 8
    if name == "facility":
        cand = (rng.integers(0, 8, (L, B, D)) / 8.0) ** 2
        ref = rng.integers(0, 8, (R, D)) / 8.0
        state = rng.integers(0, 4 * D, (L, R)) / 64.0
    else:
        cand = rng.integers(0, 8, (L, B, D)) / 8.0
        ref = rng.integers(0, 8, (R, D)) / 8.0
        m0 = (ref * ref).sum(-1) + D * (7 / 8) ** 2
        state = m0 * (rng.integers(1, 5, (L, R)) / 4.0)
    cand, ref = cand.astype(np.float32), ref.astype(np.float32)
    state = state.astype(np.float32)
    elig = rng.random((L, B)) < 0.85
    elig[6] = False
    cost = None
    if mode == "cost":
        cost = (4 + rng.integers(0, 12, (L, B))) / 8.0
        cost[4, 0] = 1.0  # so tau * c_0 is tau itself
        cost = cost.astype(np.float32)
    g0 = np.stack([_residual(name, state[l][None, :],
                             _values(name, cand[l], ref)).sum(-1)
                   for l in range(L)]).astype(np.float32)
    tau = np.median(g0, axis=1).astype(np.float32) * np.float32(0.5)
    budget = np.array([0, 1, 3, K, K, K, K, K], np.int32)
    elig[4, 0] = True
    tau[4] = g0[4, 0]  # row 0's gain is exactly tau
    tau[5] = tau[7] = -np.inf
    cost_budget = None
    if mode == "cost":
        cost_budget = np.full(L, 1e9, np.float32)
        cost_budget[2] = 2.0
        acc = np.flatnonzero(elig[7])[:2]
        cost_budget[7] = cost[7, acc].sum()  # the second accept spends it all
    return cand, ref, state, elig, tau, budget, cost, cost_budget


def _t(a):
    return None if a is None else interop.tensor(np.asarray(a))


@pytest.mark.parametrize("mode", ["cardinality", "cost"])
@pytest.mark.parametrize("B", [1, 31, 32, 33, 70, 128])
@pytest.mark.parametrize("name", ["facility", "exemplar"])
def test_windowed_walk_takes_the_row_loops_decisions(name, B, mode):
    cand, ref, state, elig, tau, budget, cost, cb = _case(name, B, mode,
                                                          seed=B)
    port = getattr(ops, f"{name}_accept")
    got = port(_t(cand), _t(ref), _t(state), _t(elig), _t(tau), _t(budget),
               _t(cost), _t(cb))
    j_ref = getattr(jref, f"{name}_accept")
    j_kernel = getattr(jops, f"{name}_accept")
    for lane in range(cand.shape[0]):
        values = _values(name, cand[lane], ref)
        kw = ({} if cost is None
              else dict(cost=cost[lane], cost_budget=cb[lane]))
        walks = [windowed_walk(
                     lambda s, i: _residual(name, s, values[i]).sum(
                         dtype=np.float32),
                     lambda s, i: _update(name, s, values[i]), B,
                     state[lane], elig[lane], tau[lane], budget[lane],
                     window=w, **kw)
                 for w in WINDOWS]
        args = (jnp.asarray(cand[lane]), jnp.asarray(ref),
                jnp.asarray(state[lane]), jnp.asarray(elig[lane]),
                jnp.asarray(tau[lane]), jnp.asarray(budget[lane]))
        jkw = ({} if cost is None
               else dict(cost=jnp.asarray(cost[lane]),
                         cost_budget=jnp.asarray(cb[lane])))
        others = [tuple(t[lane].numpy() for t in got), j_ref(*args, **jkw),
                  j_kernel(*args, **jkw)]
        for want in walks[1:] + others:
            for a, b in zip(walks[0], want):
                np.testing.assert_array_equal(a, np.asarray(b))
    mask = got[0].numpy()
    assert not mask[0].any() and not mask[6].any()  # budget 0, none eligible
    assert mask[1].sum() <= 1 and mask[2].sum() <= 3
    assert mask[4, 0]  # the gain exactly at tau is accepted
    if mode == "cardinality":
        # tau = -inf takes every eligible row up to the budget
        assert mask[5].sum() == min(K, elig[5].sum())
    else:
        assert mask[7].sum() == min(2, elig[7].sum())  # spend == budget


def _feature_rule(name, x, operands):
    """(gain(s, i), update(s, i)) of one lane's rows x (B, d) under feature
    rule ``name`` with its ``operands``, float32 and rounded as the plain
    versions round."""
    f32 = np.float32
    if name == "coverage":
        w = operands["weights"]
        return (lambda s, i: np.sum(w * (np.sqrt(s + x[i]) - np.sqrt(s)),
                                    dtype=f32),
                lambda s, i: s + x[i])
    if name == "weighted":
        return (lambda s, i: np.sum(s * x[i], dtype=f32),
                lambda s, i: s * (f32(1) - x[i]))
    if name == "saturated":
        cap, w = operands["cap"], operands["weights"]
        return (lambda s, i: np.sum(w * (np.minimum(s + x[i], cap)
                                         - np.minimum(s, cap)), dtype=f32),
                lambda s, i: s + x[i])
    t, lam = operands["total"], f32(0.5)
    return (lambda s, i: np.sum(x[i] * (t - f32(2) * lam * s)
                                - lam * x[i] * x[i], dtype=f32),
            lambda s, i: s + x[i])


def _feature_case(name, B, mode, seed):
    """(x (L, B, d), state (L, d), operands, elig, tau (L,), budget (L,),
    cost (L, B) or None, cost_budget (L,) or None) of eight lanes of a
    feature rule, laid out as _case lays out the reference sweeps'."""
    rng = np.random.default_rng(seed)
    L, d = 8, FEATURE_D
    operands = {}
    if name == "coverage":
        c = 4.0 ** rng.integers(0, 3, (L, 1, d))
        rows = np.arange(B)[None, :, None]
        on = np.zeros((L, B, d), bool)
        for _ in range(2):  # at most two rows of a lane per feature
            on |= ((rows == rng.integers(0, B, (L, 1, d)))
                   & (rng.random((L, 1, d)) < 0.7))
        x = np.where(on, 24.0 * c / 64.0, 0.0)
        state = c[:, 0] / 64.0
        operands["weights"] = (rng.integers(1, 8, d) / 4.0).astype(
            np.float32)
    elif name == "weighted":
        x = (rng.random((L, B, d)) < 0.3).astype(np.float64)
        state = rng.integers(0, 16, (L, d)) / 8.0
    elif name == "saturated":
        x = (rng.integers(0, 8, (L, B, d)) / 8.0) ** 2
        cap = rng.integers(4, 24, d) / 8.0
        frac = np.array([0.0, 0.5, 0.75, 1.0, 1.5])
        state = frac[rng.integers(0, 5, (L, d))] * cap
        operands["cap"] = cap.astype(np.float32)
        operands["weights"] = (rng.integers(1, 8, d) / 4.0).astype(
            np.float32)
    else:
        x = rng.integers(0, 9, (L, B, d)) / 8.0
        total = rng.integers(0, 64, d) / 2.0
        state = total * (rng.integers(0, 6, (L, 1)) / 4.0)
        operands["total"] = total.astype(np.float32)
    x, state = x.astype(np.float32), state.astype(np.float32)
    elig = rng.random((L, B)) < 0.85
    elig[6] = False
    cost = None
    if mode == "cost":
        cost = ((4 + rng.integers(0, 12, (L, B))) / 8.0).astype(np.float32)
        cost[4, 0] = 1.0  # so tau * c_0 is tau itself
    g0 = np.array([[_feature_rule(name, x[l], operands)[0](state[l], i)
                    for i in range(B)] for l in range(L)], np.float32)
    tau = np.median(g0, axis=1).astype(np.float32) * np.float32(0.5)
    budget = np.array([0, 1, 3, K, K, K, K, K], np.int32)
    elig[4, 0] = True
    tau[4] = g0[4, 0]  # row 0's gain is exactly tau
    tau[5] = tau[7] = -np.inf
    cost_budget = None
    if mode == "cost":
        cost_budget = np.full(L, 1e9, np.float32)
        cost_budget[2] = 2.0
        acc = np.flatnonzero(elig[7])[:2]
        cost_budget[7] = cost[7, acc].sum()  # the second accept spends it all
    return x, state, operands, elig, tau, budget, cost, cost_budget


def _feature_calls(name, operands):
    """(port call, JAX reference, JAX Pallas kernel) of a feature sweep:
    each takes (x, state, elig, tau, budget, cost, cost_budget)."""
    if name == "coverage":
        w = operands["weights"]
        return (lambda x, s, *r: ops.coverage_accept(x, s, _t(w), *r),
                lambda x, s, *r, **kw: jref.coverage_accept(
                    x, s, jnp.asarray(w), *r, **kw),
                lambda x, s, *r, **kw: jops.coverage_accept(
                    x, s, jnp.asarray(w), *r, **kw))
    if name == "weighted":
        return (ops.weighted_coverage_accept, jref.weighted_coverage_accept,
                jops.weighted_coverage_accept)
    if name == "saturated":
        cap, w = operands["cap"], operands["weights"]
        return (lambda x, s, *r: ops.saturated_coverage_accept(
                    x, s, _t(cap), _t(w), *r),
                lambda x, s, *r, **kw: jref.saturated_coverage_accept(
                    x, s, jnp.asarray(cap), jnp.asarray(w), *r, **kw),
                lambda x, s, *r, **kw: jops.saturated_coverage_accept(
                    x, s, jnp.asarray(cap), jnp.asarray(w), *r, **kw))
    t = operands["total"]
    return (lambda x, s, e, tau, b, c, cb: ops.graph_cut_accept(
                x, _t(t), s, e, tau, b, 0.5, c, cb),
            lambda x, s, *r, **kw: jref.graph_cut_accept(
                x, jnp.asarray(t), s, *r, 0.5, **kw),
            lambda x, s, *r, **kw: jops.graph_cut_accept(
                x, jnp.asarray(t), s, *r, 0.5, **kw))


@pytest.mark.parametrize("mode", ["cardinality", "cost"])
@pytest.mark.parametrize("B", [1, 33, 70, 128])
@pytest.mark.parametrize("name", ["coverage", "weighted", "saturated",
                                  "graph_cut"])
def test_feature_walk_takes_the_row_loops_decisions(name, B, mode):
    """The feature walk at every pass width it runs (32, 16, 8 rows) and in
    its mixed order at each, against the row loop, the port's plain sweep,
    the JAX reference and the Pallas kernel: masks, states and gains
    equal."""
    x, state, fops, elig, tau, budget, cost, cb = _feature_case(
        name, B, mode, seed=B + 1)
    port, j_ref, j_kernel = _feature_calls(name, fops)
    got = port(_t(x), _t(state), _t(elig), _t(tau), _t(budget), _t(cost),
               _t(cb))
    for lane in range(x.shape[0]):
        gain, update = _feature_rule(name, x[lane], fops)
        kw = ({} if cost is None
              else dict(cost=cost[lane], cost_budget=cb[lane]))
        mixed = [isinstance(w, tuple) and w[0] == "mixed"
                 for w in FEATURE_WINDOWS]
        walks = [windowed_walk(gain, update, B, state[lane], elig[lane],
                               tau[lane], budget[lane],
                               window="mixed" if m else w,
                               wide=w[1] if m else WIDE,
                               close=FEATURE_CLOSE,
                               misses_out=FEATURE_MISSES,
                               dense=FEATURE_DENSE, narrow=FEATURE_NARROW,
                               hits=FEATURE_HITS,
                               tree=w[2] if m else 1, **kw)
                 for w, m in zip(FEATURE_WINDOWS, mixed)]
        args = (jnp.asarray(x[lane]), jnp.asarray(state[lane]),
                jnp.asarray(elig[lane]), jnp.asarray(tau[lane]),
                jnp.asarray(budget[lane]))
        jkw = ({} if cost is None
               else dict(cost=jnp.asarray(cost[lane]),
                         cost_budget=jnp.asarray(cb[lane])))
        others = [tuple(t[lane].numpy() for t in got), j_ref(*args, **jkw),
                  j_kernel(*args, **jkw)]
        for want in walks[1:] + others:
            for a, b in zip(walks[0], want):
                np.testing.assert_array_equal(a, np.asarray(b))
    mask = got[0].numpy()
    assert not mask[0].any() and not mask[6].any()  # budget 0, none eligible
    assert mask[1].sum() <= 1 and mask[2].sum() <= 3
    assert mask[4, 0]  # the gain exactly at tau is accepted
    if mode == "cardinality":
        assert mask[5].sum() == min(K, elig[5].sum())
    else:
        assert mask[7].sum() == min(2, elig[7].sum())  # spend == budget


@pytest.mark.parametrize("name,dtype,d,instance", [
    ("graph_cut_accept", torch.float32, 45, -1),
    ("graph_cut_accept", torch.float32, 256, -2),
    ("graph_cut_accept", torch.bfloat16, 129, -2),
    ("graph_cut_accept", torch.float32, 512, 4),
    ("graph_cut_accept", torch.float32, 1000, -8),
    ("graph_cut_accept", torch.bfloat16, 1000, 8),
    ("graph_cut_accept", torch.bfloat16, 2048, 16),
    ("weighted_coverage_accept", torch.float32, 2048, -16),
    ("weighted_coverage_accept", torch.bfloat16, 2048, 16),
    ("weighted_coverage_accept", torch.float32, 256, 2),
    ("coverage_accept", torch.float32, 256, 2),
    ("saturated_coverage_accept", torch.bfloat16, 1000, 8),
    ("coverage_accept", torch.float32, 2049, 0),
    ("graph_cut_accept", torch.float32, 4096, 0)])
def test_feature_sweep_instance_keeps_the_row_loop_where_it_measured_faster(
        name, dtype, d, instance):
    """The wrapper's instance of a feature sweep: the walk at
    feature_sweep_per(d) features a thread, the row loop (negated) at the
    widths of _wrap.FEATURE_SWEEP_LOOPS, the wide instance (0) past 2048."""
    from repro_torch.kernels import _wrap
    assert _wrap.feature_sweep_instance(name, dtype, d) == instance
