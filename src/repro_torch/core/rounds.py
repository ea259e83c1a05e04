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
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import torch

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
                 k: int, chunk=None):
    """Algorithm 2 local half for a grid of L lanes: each machine's
    survivors of ThresholdFilter against each lane's solution, packed.

    feats (m, n, d), ids and valid (m, n); st (L, w), sol (L, k), size and
    tau (L,).  Returns packed (L, m, cap, ...) buffers and (L, m) overflow
    counts.  A lane that already holds k elements sends nothing (Lemma 2's
    escape hatch: "we are done and do not send anything")."""
    m, n, d = feats.shape
    L = tau.shape[0]
    v = exclude_ids(ids.reshape(-1), valid.reshape(-1), sol)
    mask = threshold_filter(oracle, st, feats.reshape(m * n, d), v, tau,
                            chunk=chunk)
    mask = (mask & (size < k)[:, None]).reshape(L, m, n)
    return pack_by_mask(feats, ids, mask, cap)


def local_top(oracle, feats, ids, valid, cap: int):
    """Algorithm 7 local half: each machine's top-``cap`` rows by singleton
    value.  The cut to the O(k) largest is the algorithm's intent, not an
    overflow, so n_dropped is 0."""
    m, n, d = feats.shape
    st0 = oracle.init_state()
    gains = oracle.marginals(st0, oracle.prep(st0, feats.reshape(m * n, d)))
    f, i, v, _ = pack_by_mask(feats, ids, valid, cap,
                              priority=gains.reshape(m, n))
    return f, i, v, torch.zeros((), dtype=torch.int32, device=ids.device)


class SimRounds:
    """Round primitives with the m machines as a leading batch axis.

    Holds the (m, n/m, d) sharded ground set; every primitive returns the
    *gathered* message triple (feats, ids, valid) with the machine axis
    flattened into the capacity axis, which is what the central machine
    sees, plus the summed overflow count."""

    def __init__(self, feats_mk, ids_mk, valid_mk, precision=None):
        if precision is not None:
            feats_mk = precision.cast_storage(feats_mk)
        self.feats_mk, self.ids_mk, self.valid_mk = feats_mk, ids_mk, valid_mk
        self.m, self.n_local, self.feat_dim = feats_mk.shape

    def sample(self, uniforms, p: float, cap: int):
        sf, si, sv, sdrop = local_sample(self.feats_mk, self.ids_mk,
                                         self.valid_mk, uniforms, p, cap)
        return ((sf.reshape(self.m * cap, self.feat_dim), si.reshape(-1),
                 sv.reshape(-1)), sdrop.sum())

    def tops(self, oracle, cap: int):
        tf, ti, tv, tdrop = local_top(oracle, self.feats_mk, self.ids_mk,
                                      self.valid_mk, cap)
        return ((tf.reshape(self.m * cap, self.feat_dim), ti.reshape(-1),
                 tv.reshape(-1)), tdrop)

    def filter_grid(self, oracle, st_j, sol_j, size_j, taus, cap: int,
                    k: int, chunk):
        """Per-lane survivor filter for a (J,)-stacked grid of partial
        solutions; lane j's gathered message is machine 0's buffer, then
        machine 1's, and so on."""
        J = taus.shape[0]
        rf, ri, rv, rdrop = local_filter(oracle, st_j, sol_j, size_j,
                                         self.feats_mk, self.ids_mk,
                                         self.valid_mk, taus, cap, k, chunk)
        m, d = self.m, self.feat_dim
        return ((rf.reshape(J, m * cap, d), ri.reshape(J, m * cap),
                 rv.reshape(J, m * cap)), rdrop.sum())


# ---------------------------------------------------------------------------
# central-phase pieces and the epoch engine
# ---------------------------------------------------------------------------

def empty_solution(oracle, k: int, lanes: int):
    """The empty carry of ``lanes`` lanes: (state (L, w) in the oracle's
    state width, or its tuple of (L, ...) tensors, sol (L, k) of -1, size
    (L,) of 0)."""
    dev = oracle.device
    return (oracle.init_state(lanes),
            torch.full((lanes, k), -1, dtype=torch.int32, device=dev),
            torch.zeros(lanes, dtype=torch.int32, device=dev))


def greedy_step(oracle, carry, cands, tau, k: int, cfg):
    """One central accept: extend every lane's carried (state, sol, size)
    with the gathered candidates (shared, or one message per lane) at the
    lane's threshold, excluding already-selected ids."""
    st, sol, size = carry
    feats, ids, valid = cands
    valid = exclude_ids(ids, valid & (ids >= 0), sol)
    return threshold_greedy(oracle, st, sol, size, feats, ids, valid, tau, k,
                            accept=cfg.accept, engine=cfg.engine,
                            chunk=cfg.chunk)


def grid_phase1(oracle, S, taus, k: int, cfg):
    """First central accept of a grid epoch: an independent empty-start
    greedy per threshold guess (the paper's parallel tau copies), all
    lanes over the one shared sample."""
    return greedy_step(oracle, empty_solution(oracle, k, taus.shape[0]), S,
                       taus, k, cfg)


def sparse_sweep(oracle, pool, schedule, cfg):
    """Algorithm 7's central half: each guess lane runs its descending
    threshold sequence over the gathered top-singleton pool, with no extra
    rounds.  ``schedule`` is a list of per-level (G,) threshold columns.
    Returns per-lane (sol (G, k), size (G,), value (G,))."""
    carry = empty_solution(oracle, cfg.k, schedule[0].shape[0])
    for tau in schedule:
        carry = greedy_step(oracle, carry, pool, tau, cfg.k, cfg)
    st, sol, size = carry
    return sol, size, oracle.value(st)


def run_epochs(oracle, rounds, schedule, epoch_uniforms, cfg,
               first_sample=None):
    """The epoch engine: execute a descending threshold schedule (a list of
    per-epoch (G,) guess columns) on a round-primitives backend, carrying
    the lanes' partial solutions across epochs.

    Each epoch at level thresholds tau_e:
      sample -> central accept at tau_e -> local filter at tau_e
             -> gather survivors -> central accept at tau_e.

    ``epoch_uniforms[e]`` are epoch e's (m, n/m) sample draws;
    ``first_sample`` injects epoch 1's already-gathered sample (the
    unknown-OPT drivers derive the grid from it first).  Returns
    ((state, sol, size), drops)."""
    k = cfg.k
    s_cap, f_cap, _ = cfg.caps()
    carry = None
    drops = torch.zeros((), dtype=torch.int32, device=oracle.device)
    for e, taus in enumerate(schedule):
        if e == 0 and first_sample is not None:
            S, sdrop = first_sample
        else:
            S, sdrop = rounds.sample(epoch_uniforms[e], cfg.sample_p, s_cap)
        if carry is None:
            carry = grid_phase1(oracle, S, taus, k, cfg)
        else:
            carry = greedy_step(oracle, carry, S, taus, k, cfg)
        R, rdrop = rounds.filter_grid(oracle, *carry, taus, f_cap, k,
                                      cfg.filter_chunk)
        carry = greedy_step(oracle, carry, R, taus, k, cfg)
        drops = drops + sdrop + rdrop
    return carry, drops
