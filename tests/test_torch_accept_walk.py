"""The windowed walk of the reference sweeps (facility_accept and
exemplar_accept) against the row-by-row sweep, on the CPU.

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
must be equal.  The lanes cover budgets 0, 1, 3 and k, ineligible rows, a
gain exactly at tau, a spend exactly at the cost budget and tau = -inf.
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


def windowed_walk(name, values, state, elig, tau, budget, cost=None,
                  cost_budget=None, window=32):
    """One lane's sweep as the kernels walk it: score rows [cur, cur +
    window) (or the "mixed" widths) against the state, take the first that passes, reject the rows
    before it with the gains just taken, apply the accept and go on from
    the row after it.  Returns (mask, state, gains)."""
    B = values.shape[0]
    s = state.astype(np.float32).copy()
    mask = np.zeros(B, bool)
    gains = np.zeros(B, np.float32)
    n_acc, spent = 0, np.float32(0)
    tau = np.float32(tau)
    cur, misses = 0, MISSES
    while cur < B:
        width = window
        if window == "mixed":
            width = 1 if misses < MISSES else WIDE
        rows = range(cur, min(cur + width, B))
        g = [np.float32(_residual(name, s, values[i]).sum(dtype=np.float32))
             for i in rows]
        first = None
        for k, i in enumerate(rows):
            if cost is None:
                ok = elig[i] and g[k] >= tau and n_acc < budget
            else:
                c = np.float32(cost[i])
                ok = (elig[i] and g[k] >= np.float32(tau * c)
                      and n_acc < budget
                      and np.float32(spent + c) <= np.float32(cost_budget))
            if ok:
                first = k
                break
        upto = len(rows) if first is None else first + 1
        for k in range(upto):
            gains[cur + k] = g[k]
        if window == "mixed" and width == 1:
            misses = 0 if first is not None else misses + 1
        elif window == "mixed" and first is not None and first < CLOSE:
            misses = 0
        if first is None:
            cur += len(rows)
            continue
        i = cur + first
        mask[i] = True
        s = _update(name, s, values[i])
        n_acc += 1
        if cost is not None:
            spent = np.float32(spent + np.float32(cost[i]))
        cur = i + 1
    return mask, s, gains


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
        walks = [windowed_walk(name, values, state[lane], elig[lane],
                               tau[lane], budget[lane], window=w, **kw)
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
