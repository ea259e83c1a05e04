"""Single-pass SieveStreaming over corpus chunks: the streaming companion
of the MapReduce drivers (Badanidiyuru et al.'s sieve, on the port's
lane-batched oracle machinery).

The MapReduce drivers assume the corpus is materialized; the sieve assumes
only that it arrives as a sequence of fixed-size chunks.  It keeps the
paper's geometric threshold grid *online* as L parallel **lanes**: lane j
holds its own oracle state and solution buffer and the threshold
tau_j = v_j / (2k) of a grid value v_j = (1+eps)^{e_j}.  One
``sieve_update`` call per chunk:

  1. the chunk's singleton values (one ``oracle.chunk_marginals`` from the
     empty state: the one-lane route of the marginals kernel) update the
     running max v_max and the top-singleton reservoir;
  2. the live exponent window [lo, lo + L) slides so the grid values cover
     [v_max, ~2k v_max]; lanes whose exponent fell below the window are
     **reseeded** empty at the top (``grids.lane_exponents``: lane identity
     is exponent mod L, so surviving lanes keep their state bit for bit);
  3. every lane runs Algorithm 1 over the chunk (``accept="first"``, the
     paper's streaming accept loop restricted to the chunk).  The JAX
     package vmaps a one-lane accept over the lanes; here the L lanes are
     the lane axis of one ``threshold_greedy`` call over the shared (B, d)
     chunk, each with its own state, budget and feasibility state.

Everything is deterministic and fixed-shape: replaying the same chunk
sequence reproduces the same SieveState bit for bit (no RNG anywhere).

Guarantee (the classic sieve argument, chunk-granular): v_max is updated
*before* the chunk's accepts, so the lane covering OPT from above ends with
f(S_j) >= (1/2 - eps/2) OPT, and ``sieve_finish`` only improves on it.

``sieve_finish`` is the GreeDi-style central completion: the union of lane
solutions (<= L k rows, features carried in the state) and the reservoir
is deduped and re-run through the standard tau grid (its J thresholds the
J lanes of one ``threshold_greedy`` call) and classic greedy, best-of
taken against the raw best lane.  This costs O(L k) candidate rows,
independent of the stream length n.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional

import torch

from repro_torch.core import constraints as constraints_mod
from repro_torch.core import grids
from repro_torch.core import precision as precision_mod
from repro_torch.core.mapreduce import SelectionResult
from repro_torch.core.sequential import greedy
from repro_torch.core.threshold import (DEFAULT_CHUNK, exclude_ids,
                                        threshold_greedy, validate_engine)
from repro_torch.states import where_state

EXP_UNSEEDED = -(2 ** 30)   # exponent sentinel: lane never assigned


@dataclasses.dataclass(frozen=True)
class SieveSpec:
    """Knobs of the streaming engine (the streaming analogue of MRConfig)."""
    k: int
    eps: float = 0.1
    n_lanes: Optional[int] = None     # default: cover [v, 2kv] at (1+eps)
    top_cap: Optional[int] = None     # running top-singleton reservoir size
    accept: str = "first"
    engine: str = "dense"             # per-chunk ThresholdGreedy engine:
    #                                   "dense" | "lazy" | "fused"
    chunk: int = DEFAULT_CHUNK        # lazy/fused-engine chunk size
    precision: str = "f32"            # storage policy of the carried
    #                                   feature pools and host chunks
    #                                   ("f32" | "bf16"); oracle states and
    #                                   values stay f32
    constraint: Optional[constraints_mod.Constraint] = None
    #                                   each lane carries its own
    #                                   feasibility state (reseeded with the
    #                                   lane); the chunk's attribute plane
    #                                   is looked up from global ids

    def __post_init__(self):
        validate_engine(self.engine, self.accept, where="SieveSpec")
        precision_mod.validate(self.precision, where="SieveSpec")
        if self.constraint is not None and not isinstance(
                self.constraint, constraints_mod.Constraint):
            raise TypeError(
                "SieveSpec: constraint must be a repro_torch.core."
                "constraints.Constraint (or None), got "
                f"{type(self.constraint).__name__}")

    @property
    def precision_policy(self):
        return precision_mod.resolve(self.precision)

    @property
    def lanes(self) -> int:
        return self.n_lanes or grids.lane_count(self.k, self.eps)

    @property
    def tops(self) -> int:
        # Algorithm 7's "O(k) largest" sparse-path message, kept online
        return self.top_cap or 2 * self.k

    def grid_size(self) -> int:
        return grids.grid_size(self.k, self.eps)


class SieveState(NamedTuple):
    """Live state of one sieve pass: fixed-shape tensors, so it replays,
    checkpoints and warm-starts trivially."""
    oracle_states: Any       # (L, w) tensor, or a tuple of (L, ...) tensors
    sol_ids: torch.Tensor    # (L, k) int32 global ids, -1 padded
    sol_feats: torch.Tensor  # (L, k, d) selected feature rows (storage dtype)
    sol_sizes: torch.Tensor  # (L,) int32
    exps: torch.Tensor       # (L,) int32 grid exponents (EXP_UNSEEDED = new)
    v_max: torch.Tensor      # () f32 running max singleton value
    n_seen: torch.Tensor     # () int32 valid elements streamed so far
    top_feats: torch.Tensor  # (T, d) running top singletons (storage dtype)
    top_ids: torch.Tensor    # (T,) int32, -1 padded
    top_vals: torch.Tensor   # (T,) f32 singleton values, -inf padded
    cstates: Any = ()        # (L, ...) per-lane feasibility states; () when
    #                          unconstrained or the constraint is stateless


def _cinit(constraint, n_lanes: int):
    """(L,)-stacked empty feasibility states; () when there are none."""
    if constraint is None:
        return ()
    st = constraint.init_state(n_lanes)
    return () if st is None else st


def sieve_init(oracle, spec: SieveSpec, feat_dim: int) -> SieveState:
    """The empty sieve on the oracle's device."""
    L, k, T = spec.lanes, spec.k, spec.tops
    dev = oracle.device
    sdt = spec.precision_policy.storage   # carried feature rows only
    i32 = dict(dtype=torch.int32, device=dev)
    return SieveState(
        oracle_states=oracle.init_state(L),
        sol_ids=torch.full((L, k), -1, **i32),
        sol_feats=torch.zeros((L, k, feat_dim), dtype=sdt, device=dev),
        sol_sizes=torch.zeros((L,), **i32),
        exps=torch.full((L,), EXP_UNSEEDED, **i32),
        v_max=torch.zeros((), dtype=torch.float32, device=dev),
        n_seen=torch.zeros((), **i32),
        top_feats=torch.zeros((T, feat_dim), dtype=sdt, device=dev),
        top_ids=torch.full((T,), -1, **i32),
        top_vals=torch.full((T,), float("-inf"), dtype=torch.float32,
                            device=dev),
        cstates=_cinit(spec.constraint, L),
    )


def _top_reservoir(state: SieveState, singles, feats, ids, valid, T: int):
    """The running top-T singletons of the reservoir and this chunk.  A
    stable descending sort keeps the lower index first among equal values
    (duplicate rows tie exactly), the tie rule of ``lax.top_k``."""
    cat_vals = torch.cat([state.top_vals,
                          torch.where(valid, singles, float("-inf"))])
    order = torch.sort(cat_vals, descending=True, stable=True).indices[:T]
    top_vals = cat_vals[order]
    old = order < T
    j_old, j_new = order.clamp(max=T - 1), (order - T).clamp(min=0)
    top_ids = torch.where(old, state.top_ids[j_old], ids[j_new])
    top_ids = torch.where(torch.isfinite(top_vals), top_ids, -1)
    top_feats = torch.where(old[:, None], state.top_feats[j_old],
                            feats[j_new])
    return top_feats, top_ids, top_vals


def sieve_update(oracle, spec: SieveSpec, state: SieveState, feats, ids,
                 valid) -> SieveState:
    """Absorb one (B, d) chunk (ids (B,) int32 global, -1 padded; valid (B,)
    bool).  Bit for bit the same on replay of the same chunk sequence."""
    L, k = spec.lanes, spec.k
    # feature rows ride at storage precision (the same tensor under f32);
    # the carried pools take these rows, so the plane stays one dtype
    feats = spec.precision_policy.cast_storage(feats)

    # ---- 1. running max singleton (the marginals kernel's one-lane route)
    singles = oracle.chunk_marginals(oracle.init_state(), feats)
    v_chunk = torch.where(valid, singles, 0.0).amax().clamp(min=0.0)
    v_max = torch.maximum(state.v_max, v_chunk)
    active = v_max > 0.0

    # ---- 1b. running top-singleton reservoir (Algorithm 7, online) ------
    top_feats, top_ids, top_vals = _top_reservoir(state, singles, feats, ids,
                                                  valid, spec.tops)

    # ---- 2. slide the exponent window; reseed dropped lanes -------------
    lo = grids.lane_window_lo(v_max, spec.eps)
    new_exps = torch.where(active, grids.lane_exponents(lo, L), EXP_UNSEEDED)
    reseed = new_exps != state.exps
    lane_states = where_state(reseed, oracle.init_state(L),
                              state.oracle_states)
    sol_ids = torch.where(reseed[:, None], -1, state.sol_ids)
    sol_feats = torch.where(reseed[:, None, None], 0.0, state.sol_feats)
    sol_sizes = torch.where(reseed, 0, state.sol_sizes)
    cn = spec.constraint
    cstates = state.cstates
    if isinstance(cstates, torch.Tensor):
        cstates = where_state(reseed, _cinit(cn, L), cstates)

    # ---- 3. every lane's threshold accept over the chunk, one call ------
    taus = grids.lane_taus(new_exps, k, spec.eps, active)
    eligible = exclude_ids(ids, valid & (ids >= 0), sol_ids)   # (L, B)
    kw = dict(accept=spec.accept, engine=spec.engine, chunk=spec.chunk)
    if cn is not None:
        kw.update(constraint=cn,
                  cstate=cstates if isinstance(cstates, torch.Tensor)
                  else None,
                  cplane=None if cn.n_planes == 0 else cn.plane(ids))
    out = threshold_greedy(oracle, lane_states, sol_ids, sol_sizes, feats,
                           ids, eligible, taus, k, **kw)
    lane_states, sol_ids, new_sizes = out[:3]
    if cn is not None and out[3] is not None:
        cstates = out[3]

    # ---- 4. carry the accepted feature rows (the finish needs them) -----
    # a fresh slot's id is in this chunk: its row is the first match
    match = sol_ids[:, :, None] == ids[None, None, :]            # (L, k, B)
    here = (match & valid).any(-1)
    pos = match.to(torch.uint8).argmax(-1)
    slot = torch.arange(k, device=sol_ids.device)
    fresh = ((slot >= sol_sizes[:, None]) & (slot < new_sizes[:, None])
             & here)
    sol_feats = torch.where(fresh[..., None], feats[pos], sol_feats)

    return SieveState(lane_states, sol_ids, sol_feats, new_sizes, new_exps,
                      v_max, state.n_seen + valid.sum(dtype=torch.int32),
                      top_feats, top_ids, top_vals, cstates)


def sieve_best(oracle, state: SieveState):
    """(sol_ids (k,), size (), value ()) of the best raw lane."""
    vals = oracle.value(state.oracle_states)
    vals = torch.where(state.sol_sizes > 0, vals, float("-inf"))
    best = vals.argmax()
    return (state.sol_ids[best], state.sol_sizes[best],
            vals[best].clamp(min=0.0))


def duplicate_mask_pairwise(pool_ids, pool_valid):
    """Row i is a duplicate when an earlier *valid* row has its id: the JAX
    package's P x P form, the plain version of ``duplicate_mask``."""
    P = pool_ids.shape[0]
    eq = (pool_ids[:, None] == pool_ids[None, :]) & pool_valid[None, :]
    r = torch.arange(P, device=pool_ids.device)
    return (eq & (r[None, :] < r[:, None])).any(1)


def duplicate_mask(pool_ids, pool_valid):
    """``duplicate_mask_pairwise`` by a stable sort of the ids, in O(P log P)
    time and O(P) memory: within a run of equal ids (in index order) a row
    is a duplicate when the run holds a valid row before it."""
    P = pool_ids.shape[0]
    order = torch.sort(pool_ids, stable=True).indices
    s_ids = pool_ids[order]
    s_valid = pool_valid[order].to(torch.int64)
    r = torch.arange(P, device=pool_ids.device)
    start = torch.ones(P, dtype=torch.bool, device=pool_ids.device)
    start[1:] = s_ids[1:] != s_ids[:-1]
    run0 = torch.cummax(torch.where(start, r, 0), 0).values
    before = torch.cumsum(s_valid, 0) - s_valid      # valid rows before p
    dup = torch.empty(P, dtype=torch.bool, device=pool_ids.device)
    dup[order] = (before - before[run0]) > 0
    return dup


def merge_pool(oracle, spec: SieveSpec, pool_feats, pool_ids, pool_valid,
               v_max, best_sol, best_size, best_val,
               k_dyn=None) -> SelectionResult:
    """Central completion shared by ``sieve_finish`` and the distributed
    sieve: dedupe the pooled survivors by global id, run the standard tau
    grid over them (J lanes of one ThresholdGreedy call) and classic
    greedy, and return the best of (grid solutions, greedy, incoming best
    lane).

    ``k_dyn`` (optional, an int or a 0-d int tensor <= spec.k) serves a
    per-request budget from the same buffers; the raw best lane competes
    only at the full budget (its value is known only for the whole lane
    solution).  The pool is O(survivors): the stream length never appears
    here."""
    k = spec.k
    dev = pool_ids.device
    if k_dyn is not None:
        at_full = torch.as_tensor(k_dyn, device=dev) >= k
        best_val = torch.where(at_full, best_val, float("-inf"))
    # first occurrence wins: an element selected by several lanes or
    # machines is counted once
    pool_valid = pool_valid & ~duplicate_mask(pool_ids, pool_valid)

    taus, tau_fb = grids.tau_grid_from_v(v_max, k, spec.eps,
                                         spec.grid_size())
    J = taus.shape[0]
    cn = spec.constraint
    kw = dict(accept=spec.accept, engine=spec.engine, chunk=spec.chunk,
              k_dyn=k_dyn)
    if cn is not None:
        kw.update(constraint=cn, cstate=cn.init_state(J),
                  cplane=None if cn.n_planes == 0 else cn.plane(pool_ids))
    st, sol_j, size_j = threshold_greedy(
        oracle, oracle.init_state(J),
        torch.full((J, k), -1, dtype=torch.int32, device=dev),
        torch.zeros((J,), dtype=torch.int32, device=dev), pool_feats,
        pool_ids, pool_valid, taus, k, **kw)[:3]
    val_j = oracle.value(st)
    # the GreeDi completion: classic greedy on the pooled survivors,
    # O(k |pool|) marginal rows, still independent of the stream length
    g_sol, g_size, g_val = greedy(oracle, pool_feats, pool_valid, k,
                                  ids=pool_ids, k_dyn=k_dyn, constraint=cn)
    sols = torch.cat([sol_j, g_sol[None], best_sol[None]])
    sizes = torch.cat([size_j, g_size.reshape(1).to(torch.int32),
                       best_size.reshape(1).to(torch.int32)])
    vals = torch.cat([val_j, g_val.reshape(1), best_val.reshape(1)])
    b = vals.argmax()
    return SelectionResult(sols[b], sizes[b], vals[b],
                           torch.zeros((), dtype=torch.int32, device=dev),
                           tau_fb)


def sieve_finish(oracle, spec: SieveSpec, state: SieveState,
                 k_dyn=None) -> SelectionResult:
    """Read a selection out of the live sieve state (read-only: the state
    keeps streaming afterwards; this is the warm-start read path).
    ``k_dyn`` optionally serves a smaller per-request budget."""
    L, k = spec.lanes, spec.k
    d = state.sol_feats.shape[-1]
    pool_feats = torch.cat([state.sol_feats.reshape(L * k, d),
                            state.top_feats])
    pool_ids = torch.cat([state.sol_ids.reshape(L * k), state.top_ids])
    return merge_pool(oracle, spec, pool_feats, pool_ids, pool_ids >= 0,
                      state.v_max, *sieve_best(oracle, state), k_dyn=k_dyn)


def sieve_chunks(feats, ids, valid, chunk_elems: int):
    """Reshape a device-resident corpus into the (T, B, ...) chunk stream
    the sieve consumes, padding the tail with invalid rows (id -1)."""
    n, d = feats.shape
    T = -(-n // chunk_elems)
    pad = T * chunk_elems - n
    if pad:
        feats = torch.cat([feats, feats.new_zeros((pad, d))])
        ids = torch.cat([ids, ids.new_full((pad,), -1)])
        valid = torch.cat([valid, valid.new_zeros((pad,))])
    return (feats.reshape(T, chunk_elems, d),
            ids.reshape(T, chunk_elems),
            valid.reshape(T, chunk_elems))


def sieve_stream(oracle, spec: SieveSpec, feats, ids, valid,
                 chunk_elems: int) -> SieveState:
    """The sieve state after one pass over a device-resident corpus, chunk
    by chunk (the JAX package's ``lax.scan`` as a loop)."""
    state = sieve_init(oracle, spec, feats.shape[-1])
    for f, i, v in zip(*sieve_chunks(feats, ids, valid, chunk_elems)):
        state = sieve_update(oracle, spec, state, f, i, v)
    return state


def sieve_run(oracle, spec: SieveSpec, feats, ids, valid,
              chunk_elems: int = 512):
    """One-pass sieve over a device-resident corpus, then ``sieve_finish``.
    (For host-resident or growing corpora use
    ``repro_torch.streaming.ingest.StreamingSelector``, which feeds the
    same update from a double-buffered host stream.)

    Returns (SelectionResult, SieveState)."""
    state = sieve_stream(oracle, spec, feats, ids, valid, chunk_elems)
    return sieve_finish(oracle, spec, state), state
