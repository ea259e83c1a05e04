"""The round-primitives layer on the sim substrate, the epoch engine, and
round/communication accounting.

Every driver is a composition of the same moves: Bernoulli-sample
locally, accept centrally with ``threshold_greedy``, filter locally at a
threshold, gather the packed survivors, accept centrally again.  Here the m
machines are a leading batch axis on one device (``SimRounds``); each
"gather" is a reshape of the per-machine packed buffers into what the
central machine would receive.

``run_epochs`` executes a descending threshold schedule, one (G,) column
of guesses per epoch (G lanes sharing every epoch's sample), carrying the
lanes' partial solutions across epochs; one epoch is two MapReduce rounds.
``RoundLog`` records each round's message bytes from the static buffer
shapes, so the Lemma-2/6 bounds are checkable numbers.

Constrained selection (``MRConfig.constraint``): ``SimRounds`` appends the
constraint's attribute plane to the sharded rows, so every message ships
it (width d + n_planes); the local halves and the central accepts split it
off in front of the oracle, and the carry grows the lanes' feasibility
state, (state, sol, size, cstate), which rides across epochs.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import torch

from repro_torch.core.constraints import (append_plane, n_planes_of,
                                          split_plane)
from repro_torch.core.threshold import (exclude_ids, pack_by_mask,
                                        threshold_filter, threshold_greedy)


@dataclasses.dataclass(frozen=True)
class RoundRecord:
    name: str
    bytes_per_machine: int   # outgoing message bound per machine
    bytes_total: int         # total gathered volume (central-machine memory)
    detail: str = ""


@dataclasses.dataclass
class RoundLog:
    records: List[RoundRecord] = dataclasses.field(default_factory=list)
    #: runtime event counters (tau_fallback, n_dropped) noted by the
    #: selector after each run; values may be device scalars, realized only
    #: by ``summary``
    events: Dict[str, object] = dataclasses.field(default_factory=dict)

    def add(self, name: str, bytes_per_machine: int, bytes_total: int,
            detail: str = "") -> None:
        self.records.append(
            RoundRecord(name, int(bytes_per_machine), int(bytes_total), detail))

    def note(self, name: str, count) -> None:
        """Accumulate a runtime counter without forcing a device sync."""
        prev = self.events.get(name)
        self.events[name] = count if prev is None else prev + count

    @property
    def n_rounds(self) -> int:
        return len(self.records)

    @property
    def total_bytes(self) -> int:
        return sum(r.bytes_total for r in self.records)

    def summary(self) -> str:
        lines = [f"rounds={self.n_rounds} total_gathered={self.total_bytes}B"]
        for i, r in enumerate(self.records, 1):
            lines.append(
                f"  round {i}: {r.name:24s} per-machine<={r.bytes_per_machine}B "
                f"gathered={r.bytes_total}B {r.detail}")
        if self.events:
            counts = " ".join(f"{k}={int(v)}"
                              for k, v in sorted(self.events.items()))
            lines.append(f"  events: {counts}")
        return "\n".join(lines)


def buffer_bytes(cap: int, feat_dim: int, itemsize: int = 4) -> int:
    """Bytes of one packed message buffer: features + ids + validity, with
    features at the storage width ``itemsize``."""
    return cap * (feat_dim * itemsize + 4 + 1)


def log_gather(log: RoundLog, name: str, cap: int, m: int, feat_dim: int,
               detail: str = "", itemsize: int = 4) -> None:
    """Record one gather round of an m-machine packed message of ``cap``
    rows."""
    log.add(name, buffer_bytes(cap, feat_dim, itemsize),
            buffer_bytes(m * cap, feat_dim, itemsize), detail)


def epoch_round_log(cfg, m: int, feat_dim: int, epochs: int,
                    with_grid: bool = False, with_top: bool = False,
                    level_suffix=None) -> RoundLog:
    """The static RoundLog of an epoch-engine driver: 2 records per epoch
    (sample gather, survivor gather).  ``with_grid`` multiplies the
    survivor round by the tau-grid width; ``with_top`` rides the
    Algorithm-7 top-singleton message along with the first sample gather;
    ``level_suffix`` forces or suppresses the per-level ``-l{e}`` suffix
    (default: only when epochs > 1)."""
    s_cap, f_cap, t_cap = cfg.caps()
    J = cfg.grid_size() if with_grid else 1
    isz = cfg.precision_policy.storage_itemsize
    levels = (epochs > 1) if level_suffix is None else level_suffix
    log = RoundLog()
    for e in range(1, epochs + 1):
        sfx = f"-l{e}" if levels else ""
        if with_top and e == 1:
            log_gather(log, f"gather-sample||top{sfx}", s_cap + t_cap, m,
                       feat_dim, "dense || sparse round 1", itemsize=isz)
        else:
            log_gather(log, f"gather-sample{sfx}", s_cap, m, feat_dim,
                       itemsize=isz)
        if with_grid:
            log.add(f"gather-survivors[grid]{sfx}",
                    J * buffer_bytes(f_cap, feat_dim, isz),
                    J * buffer_bytes(m * f_cap, feat_dim, isz),
                    f"grid J={J}")
        else:
            log_gather(log, f"gather-survivors{sfx}", f_cap, m, feat_dim,
                       itemsize=isz)
    return log


# ---------------------------------------------------------------------------
# local round halves (what the machines compute before a gather), batched
# over the leading machine axis
# ---------------------------------------------------------------------------

def local_sample(feats, ids, valid, uniforms, p: float, cap: int):
    """Algorithm 3 local half: keep each row with probability p, packed.
    ``uniforms`` are the machines' U[0, 1) draws, shaped like ``ids``; the
    comparison is in float32, as the JAX package's ``uniform < p``."""
    p32 = torch.tensor(p, dtype=torch.float32, device=uniforms.device)
    return pack_by_mask(feats, ids, (uniforms < p32) & valid, cap)


def local_filter(oracle, st, sol, size, feats, ids, valid, tau, cap: int,
                 k, chunk=None, constraint=None, cstate=None):
    """Algorithm 2 local half for a grid of L lanes: each machine's
    survivors of ThresholdFilter against each lane's solution, packed.

    feats (m, n, d), ids and valid (m, n); st (L, w), sol (L, k), size and
    tau (L,); ``k`` the lanes' budget, an int or (L,) per lane.  Returns
    packed (L, m, cap, ...) buffers and (L, m) overflow counts.  A lane
    that already holds its budget sends nothing (Lemma 2's escape hatch:
    "we are done and do not send anything").

    Under a constraint the rows are augmented (plane columns last): the
    filter scores the base features, drops rows infeasible under each
    lane's ``cstate`` (sound: feasibility is monotone), compares against
    the per-row threshold (tau * cost for a knapsack), and the packed
    survivors keep their plane columns."""
    m, n, d = feats.shape
    L = tau.shape[0]
    v = exclude_ids(ids.reshape(-1), valid.reshape(-1), sol)
    base, plane = split_plane(feats.reshape(m * n, d),
                              n_planes_of(constraint))
    if plane is not None:
        v = v & constraint.eligible(cstate, plane)
        tau = constraint.row_tau(tau, plane)
    mask = threshold_filter(oracle, st, base, v, tau, chunk=chunk)
    mask = (mask & (size < k)[:, None]).reshape(L, m, n)
    return pack_by_mask(feats, ids, mask, cap)


def local_top(oracle, feats, ids, valid, cap: int, constraint=None):
    """Algorithm 7 local half: each machine's top-``cap`` rows by singleton
    value (scored on the base features when the rows carry a constraint
    plane; the packed rows keep it).  The cut to the O(k) largest is the
    algorithm's intent, not an overflow, so n_dropped is 0."""
    m, n, d = feats.shape
    st0 = oracle.init_state()
    base, _ = split_plane(feats.reshape(m * n, d), n_planes_of(constraint))
    gains = oracle.marginals(st0, oracle.prep(st0, base))
    f, i, v, _ = pack_by_mask(feats, ids, valid, cap,
                              priority=gains.reshape(m, n))
    return f, i, v, torch.zeros((), dtype=torch.int32, device=ids.device)


class SimRounds:
    """Round primitives with the m machines as a leading batch axis.

    Holds the (m, n/m, d) sharded ground set, with the constraint's
    attribute plane appended at the storage dtype (so ``feat_dim`` and the
    byte accounting are the augmented width); every primitive returns the
    *gathered* message triple (feats, ids, valid) with the machine axis
    flattened into the capacity axis, which is what the central machine
    sees, plus the summed overflow count."""

    def __init__(self, feats_mk, ids_mk, valid_mk, precision=None,
                 constraint=None):
        if precision is not None:
            feats_mk = precision.cast_storage(feats_mk)
        feats_mk = append_plane(feats_mk, constraint, ids_mk)
        self.constraint = constraint
        self.feats_mk, self.ids_mk, self.valid_mk = feats_mk, ids_mk, valid_mk
        self.m, self.n_local, self.feat_dim = feats_mk.shape

    def _constrained(self, **kw):
        """The constraint keywords of the local halves: none when the run
        is unconstrained, so the plain calls keep their signature."""
        if self.constraint is None:
            return {}
        return dict(constraint=self.constraint, **kw)

    def sample(self, uniforms, p: float, cap: int):
        sf, si, sv, sdrop = local_sample(self.feats_mk, self.ids_mk,
                                         self.valid_mk, uniforms, p, cap)
        return ((sf.reshape(self.m * cap, self.feat_dim), si.reshape(-1),
                 sv.reshape(-1)), sdrop.sum())

    def tops(self, oracle, cap: int):
        tf, ti, tv, tdrop = local_top(oracle, self.feats_mk, self.ids_mk,
                                      self.valid_mk, cap,
                                      **self._constrained())
        return ((tf.reshape(self.m * cap, self.feat_dim), ti.reshape(-1),
                 tv.reshape(-1)), tdrop)

    def filter_grid(self, oracle, st_j, sol_j, size_j, taus, cap: int,
                    k, chunk, cstate_j=None):
        """Per-lane survivor filter for a (J,)-stacked grid of partial
        solutions (and their feasibility states, under a constraint); lane
        j's gathered message is machine 0's buffer, then machine 1's, and
        so on.  ``k`` is the lanes' budget (an int, or (J,) per lane).
        Returns the gathered messages and each lane's (J,) overflow
        count."""
        J = taus.shape[0]
        rf, ri, rv, rdrop = local_filter(oracle, st_j, sol_j, size_j,
                                         self.feats_mk, self.ids_mk,
                                         self.valid_mk, taus, cap, k, chunk,
                                         **self._constrained(cstate=cstate_j))
        m, d = self.m, self.feat_dim
        return ((rf.reshape(J, m * cap, d), ri.reshape(J, m * cap),
                 rv.reshape(J, m * cap)), rdrop.sum(-1))


# ---------------------------------------------------------------------------
# central-phase pieces and the epoch engine
# ---------------------------------------------------------------------------

def empty_solution(oracle, k: int, lanes: int, constraint=None):
    """The empty carry of ``lanes`` lanes: (state (L, w) in the oracle's
    state width, or its tuple of (L, ...) tensors, sol (L, k) of -1, size
    (L,) of 0), and the lanes' empty feasibility state last under a
    constraint."""
    dev = oracle.device
    carry = (oracle.init_state(lanes),
             torch.full((lanes, k), -1, dtype=torch.int32, device=dev),
             torch.zeros(lanes, dtype=torch.int32, device=dev))
    if constraint is None:
        return carry
    return carry + (constraint.init_state(lanes),)


def _budgets(k_dyn):
    """The per-lane budget keyword of the central accepts: none when every
    lane's budget is the buffer's k, so the plain calls keep their
    signature."""
    return {} if k_dyn is None else {"k_dyn": k_dyn}


def greedy_step(oracle, carry, cands, tau, k: int, cfg, k_dyn=None):
    """One central accept: extend every lane's carried (state, sol, size)
    with the gathered candidates (shared, or one message per lane) at the
    lane's threshold, excluding already-selected ids.  ``k`` is the
    solution buffer's capacity, ``k_dyn`` (L,) each lane's budget within it
    (None: k).  Under ``cfg.constraint`` the carry holds the lanes'
    feasibility state last, and the candidates' plane columns are split off
    in front of the engine."""
    st, sol, size = carry[:3]
    feats, ids, valid = cands
    valid = exclude_ids(ids, valid & (ids >= 0), sol)
    constraint = cfg.constraint
    if constraint is None:
        return threshold_greedy(oracle, st, sol, size, feats, ids, valid, tau,
                                k, accept=cfg.accept, engine=cfg.engine,
                                chunk=cfg.chunk, **_budgets(k_dyn))
    base, plane = split_plane(feats, n_planes_of(constraint))
    return threshold_greedy(oracle, st, sol, size, base, ids, valid, tau, k,
                            accept=cfg.accept, engine=cfg.engine,
                            chunk=cfg.chunk, constraint=constraint,
                            cstate=carry[3], cplane=plane, **_budgets(k_dyn))


def grid_phase1(oracle, S, taus, k: int, cfg, k_dyn=None):
    """First central accept of a grid epoch: an independent empty-start
    greedy per threshold guess (the paper's parallel tau copies), all
    lanes over the one shared sample."""
    return greedy_step(oracle, empty_solution(oracle, k, taus.shape[0],
                                              cfg.constraint), S, taus, k,
                       cfg, **_budgets(k_dyn))


def sparse_sweep(oracle, pool, schedule, cfg, k_dyn=None):
    """Algorithm 7's central half: each guess lane runs its descending
    threshold sequence over the gathered top-singleton pool, with no extra
    rounds.  ``schedule`` is a list of per-level (G,) threshold columns,
    ``k_dyn`` (G,) the lanes' budgets (None: cfg.k).  Returns per-lane
    (sol (G, k), size (G,), value (G,))."""
    carry = empty_solution(oracle, cfg.k, schedule[0].shape[0],
                           cfg.constraint)
    for tau in schedule:
        carry = greedy_step(oracle, carry, pool, tau, cfg.k, cfg,
                            **_budgets(k_dyn))
    st, sol, size = carry[:3]
    return sol, size, oracle.value(st)


def run_epochs(oracle, rounds, schedule, epoch_uniforms, cfg,
               first_sample=None, k_dyn=None):
    """The epoch engine: execute a descending threshold schedule (a list of
    per-epoch (G,) guess columns) on a round-primitives backend, carrying
    the lanes' partial solutions across epochs.  A known-OPT schedule (one
    sequential solution, Algorithms 4 and 5) is a column of one lane.

    Each epoch at level thresholds tau_e:
      sample -> central accept at tau_e -> local filter at tau_e
             -> gather survivors -> central accept at tau_e.

    ``epoch_uniforms[e]`` are epoch e's (m, n/m) sample draws;
    ``first_sample`` injects epoch 1's already-gathered sample (the
    unknown-OPT drivers derive the grid from it first); ``k_dyn`` (G,) is
    each lane's budget within the buffer's cfg.k (None: cfg.k; the query
    axis).  Under ``cfg.constraint`` the lanes' feasibility state rides the
    carry across epochs and into every local filter.  Returns ((state, sol,
    size[, cstate]), (the sample rounds' overflow (), each lane's survivor
    overflow (G,))), both summed over the epochs."""
    k = cfg.k
    budget = k if k_dyn is None else k_dyn
    s_cap, f_cap, _ = cfg.caps()
    carry = None
    sdrops = torch.zeros((), dtype=torch.int32, device=oracle.device)
    rdrops = torch.zeros(schedule[0].shape[0], dtype=torch.int32,
                         device=oracle.device)
    for e, taus in enumerate(schedule):
        if e == 0 and first_sample is not None:
            S, sdrop = first_sample
        else:
            S, sdrop = rounds.sample(epoch_uniforms[e], cfg.sample_p, s_cap)
        if carry is None:
            carry = grid_phase1(oracle, S, taus, k, cfg, **_budgets(k_dyn))
        else:
            carry = greedy_step(oracle, carry, S, taus, k, cfg,
                                **_budgets(k_dyn))
        R, rdrop = rounds.filter_grid(oracle, *carry[:3], taus, f_cap, budget,
                                      cfg.filter_chunk, *carry[3:])
        carry = greedy_step(oracle, carry, R, taus, k, cfg, **_budgets(k_dyn))
        del R  # the survivor buffers, before the next epoch's sample
        sdrops = sdrops + sdrop
        rdrops = rdrops + rdrop
    return carry, (sdrops, rdrops)
