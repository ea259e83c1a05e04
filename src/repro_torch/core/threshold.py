"""Algorithm 1 (ThresholdGreedy) and Algorithm 2 (ThresholdFilter), with an
explicit lane axis.

The JAX package writes each engine as a ``lax.while_loop`` for one
threshold and vmaps it over the threshold grid.  A data-dependent loop does
not map onto ``torch.vmap``, so here every engine carries a leading lane
axis L and loops while any lane is active (not done and below k).  An
inactive lane keeps its carry through a per-lane select
(``repro_torch.states.where_state``), which is what JAX's batching rule
for ``while_loop`` does, so the per-lane ``GreedyStats`` count
only that lane's own trips.  Each trip costs one host sync (the ``any``
that decides whether to loop again).

Engines (see the JAX module for the full argument):

* ``dense``: every trip rescores the whole block, then accepts the first
  (``accept="first"``) or best (``"best"``) candidate at or above tau.
* ``lazy``: stale upper bounds; each trip rescores one ``chunk``: the
  contiguous chunk at the scan frontier (``"first"``) or the ``chunk``
  hottest stale bounds (``"best"``, with the lazy-greedy certificate).
* ``fused`` (``"first"`` only): each trip hands the chunk at the frontier
  to ``oracle.chunk_accept``, which accepts every qualifying row in stream
  order inside one sweep.

For ``accept="first"`` all three accept the same sequence.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.states import tree_map, where_state

NEG = float("-inf")

DEFAULT_CHUNK = 128

ENGINES = ("dense", "lazy", "fused")
ACCEPTS = ("first", "best")


def validate_engine(engine: str, accept: str = "first",
                    where: str = "threshold_greedy") -> None:
    """Shared validation of the (engine, accept) knobs, named by call site."""
    if engine not in ENGINES:
        raise ValueError(f"{where}: unknown engine {engine!r}; "
                         f"choose from {ENGINES}")
    if accept not in ACCEPTS:
        raise ValueError(f"{where}: unknown accept {accept!r}; "
                         f"choose from {ACCEPTS}")
    if engine == "fused" and accept != "first":
        raise ValueError(
            f"{where}: engine='fused' sweeps chunks in stream order — a "
            f"forward pass — so it only implements accept='first' "
            f"(Algorithm-1-faithful); use engine='lazy' for accept='best'")


class GreedyStats(NamedTuple):
    """Oracle-work accounting per lane, (L,) int32 each.  n_evals counts
    candidate rows pushed through a marginals evaluation; n_iters counts
    the lane's own loop trips."""
    n_evals: torch.Tensor
    n_iters: torch.Tensor


def _lane_rows(feats, idx):
    """Rows ``idx`` (L, B) of a shared (C, d) or per-lane (L, C, d) block,
    as (L, B, d)."""
    if feats.dim() == 2:
        return feats[idx]
    return torch.gather(feats, 1, idx[..., None].expand(-1, -1, feats.shape[-1]))


def _first_true(mask):
    """Index of the first True along the last axis (0 when none), the rule
    of ``jnp.argmax`` on a bool array."""
    return mask.to(torch.uint8).argmax(-1)


class _Carry:
    """The per-lane loop carry shared by the engines: solution buffer,
    taken flags, done flags and work counters.  ``k`` is the buffer's
    capacity, ``k_eff`` (L,) each lane's budget within it."""

    def __init__(self, sol_ids, sol_size, C, k, k_eff, done):
        L = sol_size.shape[0]
        dev = sol_size.device
        self.sol = sol_ids.clone()
        self.size = sol_size.clone()
        self.k = k
        self.k_eff = k_eff
        self.taken = torch.zeros(L, C, dtype=torch.bool, device=dev)
        self.done = done
        self.n_evals = torch.zeros(L, dtype=torch.int32, device=dev)
        self.n_iters = torch.zeros(L, dtype=torch.int32, device=dev)
        self.lanes = torch.arange(L, device=dev)

    def active(self):
        return ~self.done & (self.size < self.k_eff)

    def append_one(self, accept_now, cand_id, idx):
        """Append ``cand_id`` (L,) at each accepting lane's slot and mark
        row ``idx`` (L,) taken."""
        slot = self.size.clamp(max=self.k - 1)
        self.sol[self.lanes, slot] = torch.where(
            accept_now, cand_id, self.sol[self.lanes, slot])
        self.size = self.size + accept_now.to(torch.int32)
        self.taken[self.lanes, idx] |= accept_now

    def count(self, active, rows: int):
        a = active.to(torch.int32)
        self.n_evals = self.n_evals + a * rows
        self.n_iters = self.n_iters + a


def _row_tau(constraint, tau, cplane, C):
    """The (L, C) per-row accept threshold: each lane's tau, scaled per row
    by a cost-ratio constraint."""
    if constraint is None or cplane is None:
        return tau[:, None].expand(-1, C)
    return constraint.row_tau(tau, cplane).expand(tau.shape[0], C)


def _feasible(constraint, cstate, cplane, valid):
    """``valid`` (L, C) masked by the constraint's feasibility under
    ``cstate``: the lazy and fused engines may drop infeasible rows from
    their hot sets because feasibility is monotone."""
    if constraint is None or cplane is None:
        return valid
    return valid & constraint.eligible(cstate, cplane)


def _cstate_accept(constraint, cstate, cplane, idx, accept_now):
    """Account row ``idx`` (L,) into each accepting lane's state."""
    if constraint is None or cplane is None:
        return cstate
    row = _lane_rows(cplane, idx[:, None])[:, 0]
    return where_state(accept_now, constraint.add(cstate, row), cstate)


def threshold_greedy(oracle, oracle_state, sol_ids, sol_size, cand_feats,
                     cand_ids, cand_valid, tau, k: int, accept: str = "first",
                     engine: str = "dense", chunk: int = DEFAULT_CHUNK,
                     with_stats: bool = False, constraint=None, cstate=None,
                     cplane=None, k_dyn=None):
    """Algorithm 1 for L threshold lanes at once.  Extends each lane's
    (sol_ids, sol_size, oracle_state) greedily with candidates whose
    marginal against the lane's current solution is >= the lane's tau,
    until the lane holds its budget or no candidate qualifies.

    ``k`` is the solution buffer's capacity; ``k_dyn`` (an int, or (L,)
    int32 with each value <= k) is each lane's budget within it (None: k),
    so lanes of several queries with their own budgets share one call.  A
    lane whose budget is 0 is done at once.

    oracle_state (L, w), w the oracle's state width, or a tuple of tensors
    with that leading lane axis (the log-det oracles); sol_ids (L, k) int32,
    -1 padded; sol_size (L,) int32; cand_feats (C, d) shared by every lane
    or (L, C, d) per lane; cand_ids and cand_valid (C,) or (L, C); tau ()
    or (L,).

    Constrained selection (``core/constraints.py``): pass ``constraint``
    with the lanes' feasibility state ``cstate`` ((L,) or (L, P); None
    starts empty) and the candidates' attribute plane ``cplane``
    ((C, n_planes) or (L, C, n_planes)).  Every engine then accepts only
    feasible rows and applies the constraint's per-row threshold
    (tau * cost for a knapsack), and the return grows the updated cstate.

    Returns (oracle_state, sol_ids, sol_size[, cstate]), plus a per-lane
    GreedyStats when ``with_stats``.  The inputs are not modified.
    """
    validate_engine(engine, accept, where="threshold_greedy")
    L = sol_size.shape[0]
    C = cand_feats.shape[-2]
    dev = sol_size.device
    tau = torch.as_tensor(tau, dtype=torch.float32, device=dev).reshape(-1)
    tau = tau.expand(L).contiguous()
    cand_ids = cand_ids.expand(L, C)
    cand_valid = cand_valid.expand(L, C)
    k_eff = torch.as_tensor(k if k_dyn is None else k_dyn, dtype=torch.int32,
                            device=dev).reshape(-1).expand(L).clamp(max=k)
    if constraint is not None and cstate is None:
        cstate = constraint.init_state(L)
    fn = {"dense": _threshold_greedy_dense,
          "lazy": _threshold_greedy_lazy,
          "fused": _threshold_greedy_fused}[engine]
    st, carry, cst = fn(oracle, oracle_state, sol_ids, sol_size, cand_feats,
                        cand_ids, cand_valid, tau, k, k_eff, accept, chunk,
                        constraint, cstate, cplane)
    out = (st, carry.sol, carry.size)
    if constraint is not None:
        out = out + (cst,)
    if with_stats:
        return out + (GreedyStats(carry.n_evals, carry.n_iters),)
    return out


def threshold_greedy_batch(oracle, oracle_states, sol_ids, sol_sizes,
                           cand_feats, cand_ids, cand_valid, taus, k: int,
                           k_dyn=None, bind=None, bind_params=None,
                           accept: str = "first", engine: str = "dense",
                           chunk: int = DEFAULT_CHUNK,
                           with_stats: bool = False, constraint=None,
                           cstates=None, cplane=None):
    """Q independent ThresholdGreedy queries over one shared (C, d)
    candidate block.

    oracle_states, sol_ids, sol_sizes and taus carry a leading (Q,) axis,
    the candidates do not; ``k`` is the shared buffer capacity and
    ``k_dyn`` (Q,) the per-query budgets (<= k).  Without ``bind`` the Q
    queries are the Q lanes of one ``threshold_greedy`` call.  With it,
    ``bind(oracle, params_q)`` rebuilds the oracle with query q's slice of
    ``bind_params`` (a tensor, or a tuple of tensors, with a leading (Q,)
    axis; see ``functions.bind_query``), and each query runs as a one-lane
    call of its own oracle.  Constrained selection adds per-query
    feasibility states ``cstates`` over the shared plane ``cplane``.
    Returns (oracle_states, sol_ids, sol_sizes[, cstates][, GreedyStats])
    batched on Q."""
    validate_engine(engine, accept, where="threshold_greedy_batch")
    kw = dict(accept=accept, engine=engine, chunk=chunk,
              with_stats=with_stats, constraint=constraint, cplane=cplane)
    if bind is None:
        return threshold_greedy(oracle, oracle_states, sol_ids, sol_sizes,
                                cand_feats, cand_ids, cand_valid, taus, k,
                                cstate=cstates, k_dyn=k_dyn, **kw)
    Q = sol_sizes.shape[0]
    dev = sol_sizes.device
    taus = torch.as_tensor(taus, dtype=torch.float32,
                           device=dev).reshape(-1).expand(Q)
    k_dyn = torch.as_tensor(k if k_dyn is None else k_dyn, dtype=torch.int32,
                            device=dev).reshape(-1).expand(Q)
    outs = []
    for q in range(Q):
        def one(t):
            return t[q:q + 1]
        prm = (None if bind_params is None
               else tree_map(lambda a: a[q], bind_params))
        outs.append(threshold_greedy(
            bind(oracle, prm), tree_map(one, oracle_states), one(sol_ids),
            one(sol_sizes), cand_feats, cand_ids, cand_valid, one(taus), k,
            cstate=None if cstates is None else tree_map(one, cstates),
            k_dyn=one(k_dyn), **kw))

    def stack(parts):
        if isinstance(parts[0], GreedyStats):
            return GreedyStats(*(torch.cat(p) for p in zip(*parts)))
        return tree_map(lambda *p: torch.cat(p), *parts)

    return tuple(stack(parts) for parts in zip(*outs))


def _threshold_greedy_dense(oracle, st, sol_ids, sol_size, feats, ids, valid,
                            tau, k, k_eff, accept, chunk, constraint, cst,
                            cplane):
    """One full-block marginals call per accept."""
    L, C = valid.shape
    aux = oracle.prep(st, feats)
    order = torch.arange(C, device=valid.device)
    tau_row = _row_tau(constraint, tau, cplane, C)
    cr = _Carry(sol_ids, sol_size, C, k, k_eff,
                torch.zeros(L, dtype=torch.bool, device=valid.device))
    while True:
        active = cr.active()
        if not bool(active.any()):
            break
        gains = oracle.marginals(st, aux)
        ok = (_feasible(constraint, cst, cplane, valid & ~cr.taken)
              & (gains >= tau_row))
        if accept == "first":
            idx = torch.where(ok, order, C).argmin(-1)
        else:
            idx = torch.where(ok, gains, NEG).argmax(-1)
        accept_now = active & ok.any(-1)
        row = _lane_rows(aux, idx[:, None])[:, 0]
        st = where_state(accept_now, oracle.add(st, row), st)
        cst = _cstate_accept(constraint, cst, cplane, idx, accept_now)
        cr.append_one(accept_now, ids[cr.lanes, idx], idx)
        cr.done = torch.where(active, ~accept_now, cr.done)
        cr.count(active, C)
    return st, cr, cst


def _threshold_greedy_lazy(oracle, st, sol_ids, sol_size, feats, ids, valid,
                           tau, k, k_eff, accept, chunk, constraint, cst,
                           cplane):
    """Stale-gain upper bounds plus chunked on-demand rescoring.

    Invariant: ``g_stale >= fresh marginal`` for every row.  accept="first"
    rescores the contiguous chunk at the scan frontier (the first hot row),
    with its start clamped to C - B as ``lax.dynamic_slice`` clamps it, and
    accepts the earliest row whose fresh gain clears its threshold.
    accept="best" rescores the B hottest stale bounds and accepts the best
    fresh gain only when it also beats every stale bound outside the chunk.
    A constrained run folds feasibility into the hot set and compares fresh
    gains against the per-row threshold.
    """
    L, C = valid.shape
    B = max(1, min(chunk, C))
    dev = valid.device
    arange_b = torch.arange(B, device=dev)
    tau_row = _row_tau(constraint, tau, cplane, C)
    g_stale = torch.full((L, C), float("inf"), dtype=torch.float32, device=dev)
    cr = _Carry(sol_ids, sol_size, C, k, k_eff, ~valid.any(-1))
    while True:
        active = cr.active()
        if not bool(active.any()):
            break
        eligible = _feasible(constraint, cst, cplane, valid & ~cr.taken)
        hot = eligible & (g_stale >= tau_row)
        if accept == "first":
            base = _first_true(hot).clamp(max=C - B)
            idxs = base[:, None] + arange_b
            g_chunk = oracle.chunk_marginals(st, _lane_rows(feats, idxs))
            new_stale = g_stale.scatter(1, idxs, g_chunk)
            ok = (eligible.gather(1, idxs)
                  & (g_chunk >= tau_row.gather(1, idxs)))
            j = _first_true(ok)
            found = ok.any(-1)
        else:
            key = torch.where(hot, g_stale, NEG)
            idxs = torch.sort(key, dim=-1, descending=True,
                              stable=True).indices[:, :B]
            chunk_ok = hot.gather(1, idxs)
            g_chunk = oracle.chunk_marginals(st, _lane_rows(feats, idxs))
            new_stale = g_stale.scatter(
                1, idxs, torch.where(chunk_ok, g_chunk, g_stale.gather(1, idxs)))
            jkey = torch.where(chunk_ok, g_chunk, NEG)
            j = jkey.argmax(-1)
            best_fresh = jkey.gather(1, j[:, None])[:, 0]
            tau_j = tau_row.gather(1, idxs.gather(1, j[:, None]))[:, 0]
            max_rest = key.scatter(1, idxs, NEG).amax(-1)
            found = (chunk_ok.gather(1, j[:, None])[:, 0]
                     & (best_fresh >= tau_j) & (best_fresh >= max_rest))
        idx = idxs.gather(1, j[:, None])[:, 0]
        accept_now = active & found
        row = oracle.prep(st, _lane_rows(feats, idx[:, None]))[:, 0]
        st = where_state(accept_now, oracle.add(st, row), st)
        cst = _cstate_accept(constraint, cst, cplane, idx, accept_now)
        cr.append_one(accept_now, ids[cr.lanes, idx], idx)
        g_stale = torch.where(active[:, None], new_stale, g_stale)
        hot_left = (_feasible(constraint, cst, cplane, valid & ~cr.taken)
                    & (g_stale >= tau_row))
        cr.done = torch.where(active, ~hot_left.any(-1), cr.done)
        cr.count(active, B)
    return st, cr, cst


def constrained_chunk_accept(oracle, constraint, oracle_state, cstate,
                             feats_chunk, plane_chunk, eligible, tau, budget):
    """The plain constrained accept sweep: Algorithm 1's sequential loop
    over each lane's (B, d) chunk with a per-row feasibility consult, the
    JAX package's ``lax.scan`` of the same name as a Python loop.

    The fused engine runs it when the constraint's state cannot ride the
    sweep kernels' scalar cost carry (fused_mode "scan": the partition
    matroid's per-part counts, where two same-part rows of one chunk must
    see each other's count).  Returns (mask (L, B) bool, oracle_state,
    cstate, gains (L, B) f32)."""
    aux = oracle.prep(oracle_state, feats_chunk)
    L, B = eligible.shape
    dev = eligible.device
    tau_rows = constraint.row_tau(tau, plane_chunk).expand(L, B)
    st, cst = oracle_state, cstate
    n_acc = torch.zeros(L, dtype=torch.int32, device=dev)
    mask = torch.zeros(L, B, dtype=torch.bool, device=dev)
    gains = torch.zeros(L, B, dtype=torch.float32, device=dev)
    for i in range(B):
        row, prow = aux[:, i], plane_chunk[:, i]
        g = oracle.marginals(st, row[:, None])[:, 0]
        feas = constraint.eligible(cst, prow[:, None])[:, 0]
        acc = (eligible[:, i] & feas & (g >= tau_rows[:, i])
               & (n_acc < budget))
        st = where_state(acc, oracle.add(st, row), st)
        cst = where_state(acc, constraint.add(cst, prow), cst)
        n_acc = n_acc + acc.to(torch.int32)
        mask[:, i] = acc
        gains[:, i] = g
    return mask, st, cst, gains


def _threshold_greedy_fused(oracle, st, sol_ids, sol_size, feats, ids, valid,
                            tau, k, k_eff, accept, chunk, constraint, cst,
                            cplane):
    """The accept loop runs inside ``oracle.chunk_accept``: each trip sweeps
    the contiguous chunk at the scan frontier (start clamped to C - B) and
    appends every accepted row in stream order.  Same stale-gain invariant
    and frontier as the lazy engine; one trip per chunk, not per accept.

    Under a constraint the sweep follows its ``fused_mode``: "cost" hands
    the chunk's row costs and each lane's remaining budget to the oracle's
    sweep (the kernels' cost mode), then adds the accepted costs with one
    reduction per lane, as the JAX engine does; "scan" runs
    ``constrained_chunk_accept``."""
    L, C = valid.shape
    B = max(1, min(chunk, C))
    dev = valid.device
    arange_b = torch.arange(B, device=dev)
    tau_row = _row_tau(constraint, tau, cplane, C)
    mode = ("none" if constraint is None or cplane is None
            else constraint.fused_mode)
    g_stale = torch.full((L, C), float("inf"), dtype=torch.float32, device=dev)
    cr = _Carry(sol_ids, sol_size, C, k, k_eff, ~valid.any(-1))
    sentinel = torch.full((L, 1), -1, dtype=cr.sol.dtype, device=dev)
    while True:
        active = cr.active()
        if not bool(active.any()):
            break
        eligible = _feasible(constraint, cst, cplane, valid & ~cr.taken)
        hot = eligible & (g_stale >= tau_row)
        base = _first_true(hot).clamp(max=C - B)
        idxs = base[:, None] + arange_b
        budget = (k_eff - cr.size).to(torch.int32)
        rows, elig = _lane_rows(feats, idxs), eligible.gather(1, idxs)
        if mode == "none":
            mask, new_st, g_chunk = oracle.chunk_accept(st, rows, elig, tau,
                                                        budget)
            new_cst = cst
        elif mode == "cost":
            cost = constraint.fused_cost(_lane_rows(cplane, idxs))
            mask, new_st, g_chunk = oracle.chunk_accept(
                st, rows, elig, tau, budget, cost.contiguous(),
                constraint.fused_cost_budget(cst))
            new_cst = constraint.fused_spend(
                cst, torch.where(mask, cost, 0.0).sum(-1))
        else:
            mask, new_st, new_cst, g_chunk = constrained_chunk_accept(
                oracle, constraint, st, cst, rows, _lane_rows(cplane, idxs),
                elig, tau, budget)
        mask = mask & active[:, None]
        st = where_state(active, new_st, st)
        if new_cst is not None:
            cst = where_state(active, new_cst, cst)
        g_stale = torch.where(active[:, None], g_stale.scatter(1, idxs, g_chunk),
                              g_stale)
        # in-order append of every accepted row; slot k is the sentinel for
        # rows not accepted, dropped with the buffer's extra column
        m32 = mask.to(torch.int32)
        slots = torch.where(mask, cr.size[:, None] + m32.cumsum(-1) - 1, k)
        buf = torch.cat([cr.sol, sentinel], 1)
        buf.scatter_(1, slots.long(), ids.gather(1, idxs))
        cr.sol = buf[:, :k].contiguous()
        cr.size = cr.size + m32.sum(-1, dtype=torch.int32)
        cr.taken = cr.taken.scatter(1, idxs, cr.taken.gather(1, idxs) | mask)
        hot_left = (_feasible(constraint, cst, cplane, valid & ~cr.taken)
                    & (g_stale >= tau_row))
        cr.done = torch.where(active, ~hot_left.any(-1), cr.done)
        cr.count(active, B)
    return st, cr, cst


def threshold_filter(oracle, oracle_state, cand_feats, cand_valid, tau,
                     chunk=None):
    """Algorithm 2: the survivor mask of candidates whose marginal against
    the current solution is >= tau.

    oracle_state (w,) with tau () gives a (C,) mask; (L, w) with tau (L,)
    gives (L, C), and a per-row threshold (L, C) (a knapsack's tau * cost)
    or (L, 1) is taken as it is.  ``chunk`` sweeps the plain route in
    (chunk, d) tiles so it never holds the whole block's transient
    (L, C, .) aux, as the JAX filter's ``lax.map`` does; a kernel keeps its
    tiles on chip, so the kernel route scores the whole block in one launch
    either way.  Gains are row-wise identical."""
    tau = torch.as_tensor(tau, dtype=torch.float32, device=cand_valid.device)
    if tau.dim() == 1:
        tau = tau[:, None]
    if chunk is None or oracle.use_kernel:
        gains = oracle.chunk_marginals(oracle_state, cand_feats)
    else:
        gains = torch.cat([oracle.chunk_marginals(oracle_state, t)
                           for t in cand_feats.split(chunk, dim=-2)], -1)
    return cand_valid & (gains >= tau)


#: candidates x lanes that ``exclude_ids`` tests at a time: its temporaries
#: stay near 17 bytes an element of one tile (int64 slots, the ids and
#: their matches), whatever C and L are
EXCLUDE_TILE = 1 << 22


def exclude_ids(cand_ids, cand_valid, sol_ids):
    """Mask out candidates already selected (by global id).  cand_ids (C,)
    or (L, C) against sol_ids (k,) or (L, k); the mask has their broadcast
    shape, (C,) or (L, C).

    Each lane's solution is sorted once and every candidate looked up in it
    with ``torch.searchsorted``, over tiles of about ``EXCLUDE_TILE``
    elements of C, so the test needs memory for the (L, C) mask and one
    tile, never the (L, C, k) comparison of a broadcast.  It is an equality
    test either way: negative (padding) ids and duplicates in a solution
    mask exactly what the broadcast ``any(cand == sol)`` masks."""
    lead = torch.broadcast_shapes(cand_ids.shape[:-1], sol_ids.shape[:-1])
    C, k = cand_ids.shape[-1], sol_ids.shape[-1]
    hit = torch.zeros(lead + (C,), dtype=torch.bool, device=cand_ids.device)
    if k:
        dtype = torch.promote_types(cand_ids.dtype, sol_ids.dtype)
        lanes = math.prod(lead)
        srt = (sol_ids.to(dtype).sort(-1).values
               .expand(lead + (k,)).reshape(lanes, k).contiguous())
        step = max(1, EXCLUDE_TILE // max(lanes, 1))
        for c0 in range(0, C, step):
            q = (cand_ids[..., c0:c0 + step].to(dtype)
                 .expand(lead + (min(step, C - c0),)).reshape(lanes, -1)
                 .contiguous())
            slot = torch.searchsorted(srt, q).clamp_(max=k - 1)
            hit[..., c0:c0 + step] = (srt.gather(1, slot) == q).view(
                hit[..., c0:c0 + step].shape)
    return cand_valid & hit.logical_not_()


def pack_by_mask(feats, ids, mask, cap: int, priority=None):
    """Compress masked rows into a fixed-capacity buffer, over any leading
    batch axes (which broadcast between the operands).

    Takes up to ``cap`` masked rows, in stream order or by descending
    ``priority`` (the "O(k) largest elements" of Algorithm 7), and reports
    the overflow count.  The order is a stable descending sort of one
    composite key, so equal keys keep the lower index first, the tie rule
    of the JAX package's ``lax.top_k``.  Masked-out rows key at -inf and
    valid +-inf priorities are clamped to the finite float32 extremes, so
    every valid row sorts before every masked one.

    Returns (feats (..., cap, d), ids (..., cap), valid (..., cap),
    n_dropped (...) int32); the capacity is min(cap, n).
    """
    n = mask.shape[-1]
    if priority is None:
        key = torch.where(mask, -torch.arange(n, dtype=torch.float32,
                                              device=mask.device), NEG)
    else:
        fmax = torch.finfo(torch.float32).max
        key = torch.where(mask, priority.float().clamp(-fmax, fmax), NEG)
    take = torch.sort(key, dim=-1, descending=True,
                      stable=True).indices[..., :min(cap, n)]
    lead = take.shape[:-1]
    valid = mask.gather(-1, take)
    n_dropped = (mask.sum(-1) - cap).clamp(min=0).to(torch.int32)
    out_ids = ids.expand(*lead, n).gather(-1, take)
    out_feats = feats.expand(*lead, *feats.shape[-2:]).gather(
        -2, take[..., None].expand(*take.shape, feats.shape[-1]))
    return out_feats, torch.where(valid, out_ids, -1), valid, n_dropped
