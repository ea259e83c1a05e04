"""The round-primitives layer: the sim and mesh substrates, the epoch
engine, and round/communication accounting.

Every driver is a composition of the same moves: Bernoulli-sample
locally, accept centrally with ``threshold_greedy``, filter locally at a
threshold, gather the packed survivors, accept centrally again.  They are
defined once, behind two substrates with one surface:

* ``SimRounds``: the m machines are a leading batch axis on one device,
  and a "gather" is a reshape of the machines' packed buffers into what
  the central machine would receive (the executable MRC model);
* ``MeshRounds``: this process is one machine of a process group, a
  gather is an ``all_gather`` over the group (``gather_packed``), and
  overflow counts are summed with one ``all_reduce``.

The central phase runs replicated on every machine of a mesh: every rank
receives the same gathered messages, so it takes the same decisions and
issues the same collectives in the same order.

``run_epochs`` executes a descending threshold schedule, one (G,) column
of guesses per epoch (G lanes sharing every epoch's sample), carrying the
lanes' partial solutions across epochs; one epoch is two MapReduce rounds.
``RoundLog`` records each round's message bytes from the static buffer
shapes, so the Lemma-2/6 bounds are checkable numbers, and the realized
faults of a fault plan (``FaultRecord``, ``core/faults.py``).

Constrained selection (``MRConfig.constraint``): the substrates append the
constraint's attribute plane to the sharded rows, so every message ships
it (width d + n_planes); the local halves and the central accepts split it
off in front of the oracle, and the carry grows the lanes' feasibility
state, (state, sol, size, cstate), which rides across epochs.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List

import torch
import torch.distributed as dist

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


@dataclasses.dataclass(frozen=True)
class FaultRecord:
    """One realized fault (``faults.FaultyRounds``), beside the byte
    accounting: ``eff_machines`` and ``eff_n`` are the machine count and
    ground-set size left once it landed, which the guarantee haircut is
    computed from (``faults.fault_summary``)."""
    kind: str                  # faults.FAULT_KINDS
    epoch: int                 # epoch the fault landed in
    round_index: int           # gather index within the driver call
    machines: tuple            # affected machine indices
    n_machines: int            # configured M
    eff_machines: int          # survivors after this fault
    eff_n: int                 # degraded effective ground-set size
    detail: str = ""


@dataclasses.dataclass
class RoundLog:
    records: List[RoundRecord] = dataclasses.field(default_factory=list)
    #: runtime event counters (tau_fallback, n_dropped, degraded_selects)
    #: noted by the selector after each run; values may be device scalars,
    #: realized only by ``summary``
    events: Dict[str, object] = dataclasses.field(default_factory=dict)
    #: the realized faults of the last driver call (faults.FaultyRounds)
    faults: List[FaultRecord] = dataclasses.field(default_factory=list)

    def add(self, name: str, bytes_per_machine: int, bytes_total: int,
            detail: str = "") -> None:
        self.records.append(
            RoundRecord(name, int(bytes_per_machine), int(bytes_total), detail))

    def note(self, name: str, count) -> None:
        """Accumulate a runtime counter without forcing a device sync."""
        prev = self.events.get(name)
        self.events[name] = count if prev is None else prev + count

    def fault(self, rec: FaultRecord) -> None:
        self.faults.append(rec)

    def fault_events(self) -> Dict[str, int]:
        """The fault records as flat counters: affected machines per kind,
        the number of distinct faulted gathers, and the worst gather's
        survivor count."""
        out: Dict[str, int] = {}
        for rec in self.faults:
            key = f"{rec.kind}_machines"
            out[key] = out.get(key, 0) + len(rec.machines)
        if self.faults:
            out["faulted_rounds"] = len(
                {(rec.epoch, rec.round_index) for rec in self.faults})
            out["min_eff_machines"] = min(
                rec.eff_machines for rec in self.faults)
        return out

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
        for rec in self.faults:
            lines.append(
                f"  FAULT [{rec.kind}] epoch={rec.epoch} "
                f"gather={rec.round_index} machines={list(rec.machines)} "
                f"eff=(M={rec.eff_machines}/{rec.n_machines}, "
                f"n~{rec.eff_n}) {rec.detail}")
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


def gather_packed(x, group, lead: int = 0):
    """all_gather one packed message buffer over ``group``, concatenating
    the machines' buffers on the capacity axis, machine-major; ``lead``
    leading axes (a lane axis, or query and lane) stay in place, and the
    whole stack moves in one collective.  A rank's rank in ``group`` is its
    machine index.  The machines' buffers land in one allocation, which
    holds the gathered stack once: under leading axes their blocks are
    reordered in place from machine-major to lead-major."""
    m = dist.get_world_size(group)
    x = x.contiguous()
    out = x.new_empty((m,) + x.shape)
    dist.all_gather(list(out.unbind(0)), x, group=group)
    lanes = math.prod(x.shape[:lead])
    if lanes > 1:
        _lead_major(out.view(m * lanes, -1), m, lanes)
    s = x.shape
    return out.view(s[:lead] + (m * s[lead],) + s[lead + 1:])


def _lead_major(blocks, m: int, lanes: int) -> None:
    """Reorder ``blocks``, an (m lanes, b) stack whose row c * lanes + l is
    machine c's block of lane l, in place to lane-major order (row
    l * m + c): the permutation's cycles, one block of scratch."""
    tmp = torch.empty_like(blocks[0])
    done = [False] * (m * lanes)
    for start in range(m * lanes):
        if done[start]:
            continue
        tmp.copy_(blocks[start])
        p = start
        while True:
            done[p] = True
            src = (p % m) * lanes + p // m   # where row p's block lies now
            if src == start:
                blocks[p].copy_(tmp)
                break
            blocks[p].copy_(blocks[src])
            p = src


class _Rounds:
    """The round primitives over a (M, n/m, d) block of machines' rows: all
    m machines on one device (the sim, M = m), or this rank's one machine
    (the mesh, M = 1).  Each op runs the local halves on the block and
    returns the *gathered* message triple (feats, ids, valid), machine-major
    on the capacity axis, which is what the central machine sees, with the
    block's overflow count; ``finalize_drops`` completes a count over the
    machines.  The constraint's attribute plane is appended to the rows at
    the storage dtype, so ``feat_dim`` and the byte accounting are the
    augmented width.

    ``m`` is the machine count, ``n_local`` the rows a machine holds,
    ``device`` where they live."""

    def __init__(self, feats, ids, valid, m: int, precision=None,
                 constraint=None):
        if precision is not None:
            feats = precision.cast_storage(feats)
        feats = append_plane(feats, constraint, ids)
        self.constraint = constraint
        self.feats_mk, self.ids_mk, self.valid_mk = feats, ids, valid
        self.m = int(m)
        _, self.n_local, self.feat_dim = feats.shape
        self.device = ids.device

    def begin_epoch(self, e: int) -> None:
        """Epoch-boundary hook, announced by ``run_epochs``: a no-op on the
        bare substrates; ``faults.FaultyRounds`` realizes its shard-loss
        mask there."""

    def _constrained(self, **kw):
        """The constraint keywords of the local halves: none when the run
        is unconstrained, so the plain calls keep their signature."""
        if self.constraint is None:
            return {}
        return dict(constraint=self.constraint, **kw)

    def _own(self, uniforms):
        """The block's rows of one epoch's (m, n/m) draws."""
        raise NotImplementedError

    def _gather(self, x, lead: int):
        """(*lead, M, cap, ...) local buffers -> (*lead, m cap, ...)."""
        raise NotImplementedError

    def _gather3(self, trip, lead: int = 0):
        return tuple(self._gather(x, lead) for x in trip)

    def sample(self, uniforms, p: float, cap: int):
        sf, si, sv, sdrop = local_sample(self.feats_mk, self.ids_mk,
                                         self.valid_mk, self._own(uniforms),
                                         p, cap)
        return self._gather3((sf, si, sv)), sdrop.sum()

    def tops(self, oracles, cap: int):
        """One top-singleton message per oracle (the run's oracle, or each
        query's rebound oracle), stacked on a leading axis and gathered in
        one collective a tensor: (len(oracles), m cap, ...)."""
        outs = [local_top(orc, self.feats_mk, self.ids_mk, self.valid_mk,
                          cap, **self._constrained()) for orc in oracles]
        stack = [torch.stack(p) for p in zip(*outs)]
        return self._gather3(stack[:3], 1), stack[3].sum()

    def filter_grid(self, groups, cap: int, chunk):
        """Per-lane survivor filter for lane groups that each have an
        oracle of their own (the run's lanes, or one query's rebound oracle
        and its J lanes): ``groups`` is a list of (oracle, carry, taus, k),
        the carry the lanes' (state, sol, size[, cstate]) and ``k`` their
        budget (an int, or per lane).  The groups' survivors are stacked on
        the lane axis, and lane j's gathered message is machine 0's buffer,
        then machine 1's, and so on.  Returns the gathered messages and
        each lane's overflow count."""
        # the carry's last entry is the feasibility state under a
        # constraint (and unused without one)
        outs = [local_filter(orc, *carry[:3], self.feats_mk, self.ids_mk,
                             self.valid_mk, taus, cap, k, chunk,
                             **self._constrained(cstate=carry[-1]))
                for orc, carry, taus, k in groups]
        rf, ri, rv, rdrop = (outs[0] if len(outs) == 1
                             else (torch.cat(p) for p in zip(*outs)))
        return self._gather3((rf, ri, rv), 1), rdrop.sum(-1)

    def finalize_drops(self, drops):
        """A local overflow count completed over every machine."""
        return drops


class SimRounds(_Rounds):
    """The m machines as a leading batch axis on one device: feats_mk
    (m, n/m, d), ids_mk and valid_mk (m, n/m); a gather is a reshape of the
    machines' buffers."""

    def __init__(self, feats_mk, ids_mk, valid_mk, precision=None,
                 constraint=None):
        super().__init__(feats_mk, ids_mk, valid_mk, feats_mk.shape[0],
                         precision, constraint)

    def _own(self, uniforms):
        return uniforms

    def _gather(self, x, lead: int):
        s = x.shape
        return x.reshape(s[:lead] + (s[lead] * s[lead + 1],) + s[lead + 2:])


class MeshRounds(_Rounds):
    """One machine of a process group: this rank's (n/m, d) shard (its
    column block under tensor parallelism), its global ids and validity.
    ``group`` is the machine axes' process group (``launch.mesh.Mesh``), in
    which a rank's rank is its machine index.  A gather is an all_gather
    over the group (``gather_packed``); overflow counts stay local until
    ``finalize_drops`` sums them with one all_reduce.  The sample round
    keeps this machine's row of the (m, n/m) draws, so a mesh given the
    sim's draws samples the sim's rows."""

    def __init__(self, feats, ids, valid, group, precision=None,
                 constraint=None):
        super().__init__(feats[None], ids[None], valid[None],
                         dist.get_world_size(group), precision, constraint)
        self.group = group
        self.machine_index = dist.get_rank(group)

    def _own(self, uniforms):
        return uniforms[self.machine_index][None]

    def _gather(self, x, lead: int):
        return gather_packed(x.squeeze(lead), self.group, lead)

    def finalize_drops(self, drops):
        drops = drops.clone()
        dist.all_reduce(drops, group=self.group)
        return drops


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
    """``run_epoch_groups`` for one lane group: the lanes of ``oracle``
    with their per-epoch (G,) threshold columns ``schedule`` and budgets
    ``k_dyn``.  Returns ((state, sol, size[, cstate]), (the sample rounds'
    overflow (), each lane's survivor overflow (G,)))."""
    (carry,), drops = run_epoch_groups([(oracle, schedule, k_dyn)], rounds,
                                       epoch_uniforms, cfg, first_sample)
    return carry, drops


def run_epoch_groups(groups, rounds, epoch_uniforms, cfg, first_sample=None):
    """The epoch engine: execute descending threshold schedules on a
    round-primitives backend, carrying the lanes' partial solutions across
    epochs.  ``groups`` is a list of lane groups (oracle, schedule, k_dyn),
    each with an oracle of its own (the run's, or one query's rebound
    oracle): ``schedule`` the per-epoch (G,) guess columns of its lanes
    (every group has as many epochs), ``k_dyn`` (G,) each lane's budget
    within the buffer's cfg.k (None: cfg.k; the query axis).  A known-OPT
    schedule (one sequential solution, Algorithms 4 and 5) is a column of
    one lane.

    Each epoch, every group at its level thresholds tau_e:
      sample -> central accept at tau_e -> local filter at tau_e
             -> gather survivors -> central accept at tau_e,
    with one sample and one survivor gather an epoch for all the groups.

    ``epoch_uniforms[e]`` are epoch e's (m, n/m) sample draws;
    ``first_sample`` injects epoch 1's already-gathered sample (the
    unknown-OPT drivers derive the grid from it first).  Under
    ``cfg.constraint`` the lanes' feasibility state rides the carry across
    epochs and into every local filter.  Returns (each group's (state, sol,
    size[, cstate]), (the sample rounds' overflow (), each lane's survivor
    overflow, the groups' lanes in order)), both summed over the
    epochs."""
    k = cfg.k
    s_cap, f_cap, _ = cfg.caps()
    dev = groups[0][0].device
    carries = [None] * len(groups)
    sdrops = torch.zeros((), dtype=torch.int32, device=dev)
    rdrops = torch.zeros(sum(g[1][0].shape[0] for g in groups),
                         dtype=torch.int32, device=dev)
    for e in range(len(groups[0][1])):
        # announce the epoch boundary (a fault wrapper realizes its
        # shard-loss mask; idempotent when epoch 1's sample was drawn first)
        rounds.begin_epoch(e)
        if e == 0 and first_sample is not None:
            S, sdrop = first_sample
        else:
            S, sdrop = rounds.sample(epoch_uniforms[e], cfg.sample_p, s_cap)
        for g, (orc, schedule, k_dyn) in enumerate(groups):
            if carries[g] is None:
                carries[g] = grid_phase1(orc, S, schedule[e], k, cfg,
                                         **_budgets(k_dyn))
            else:
                carries[g] = greedy_step(orc, carries[g], S, schedule[e], k,
                                         cfg, **_budgets(k_dyn))
        R, rdrop = rounds.filter_grid(
            [(orc, carry, schedule[e], k if k_dyn is None else k_dyn)
             for (orc, schedule, k_dyn), carry in zip(groups, carries)],
            f_cap, cfg.filter_chunk)
        lo = 0
        for g, (orc, schedule, k_dyn) in enumerate(groups):
            hi = lo + schedule[e].shape[0]
            Rg = R if len(groups) == 1 else tuple(x[lo:hi] for x in R)
            carries[g] = greedy_step(orc, carries[g], Rg, schedule[e], k,
                                     cfg, **_budgets(k_dyn))
            lo = hi
        del R, Rg  # the survivor buffers, before the next epoch's sample
        sdrops = sdrops + sdrop
        rdrops = rdrops + rdrop
    return carries, (sdrops, rdrops)
