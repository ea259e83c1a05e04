"""The paper's MapReduce drivers, on the sim and mesh substrates.

* ``two_round_known_opt_{sim,mesh}`` — Algorithm 4: one epoch at OPT/2k.
* ``multi_threshold_{sim,mesh}``     — Algorithm 5: t epochs at the
  known-OPT schedule alpha_l = (1 - 1/(t+1))^l OPT/k.
* ``dense_two_round_sim``  — Algorithm 6: one epoch over the unknown-OPT
  tau grid, one engine lane per guess.
* ``sparse_two_round_sim`` — Algorithm 7: the machines' top singletons,
  swept centrally over the grid.
* ``two_round_{sim,mesh}``   — Theorem 8: Algorithms 6 and 7 in the same
  two rounds; best of all lanes.
* ``multi_epoch_{sim,mesh}`` — the (1 - 1/e - eps) result: E = ceil(1/eps)
  epochs of the same grid driver, carrying the solution across epochs.
  E = 1 is two_round; the sim driver with ``opt`` runs Algorithm 5's
  schedule instead.
* ``two_round_batch_{sim,mesh}`` — Theorem 8 for Q queries (``QueryBatch``)
  that share one corpus partition and one sample round (the query axis).

A sim driver takes the (m, n/m, d) partition and returns its result and
RoundLog.  A mesh driver takes the mesh (``launch.mesh.Mesh``) and
returns a callable over this rank's shard, and the RoundLog; both
substrates run the same driver bodies (``_known_opt_select``,
``_epoch_select``, ``_batch_select``) and the same epoch engine
(``rounds.run_epochs``).  Under ``MRConfig.faults`` every driver runs over
``faults.FaultyRounds`` and stamps ``degraded`` and ``haircut`` on its
result.

A known-OPT schedule (one sequential solution) runs as a grid of one lane
through the same lane code; its driver squeezes the lane axis.  Every MRC
message is a fixed-capacity packed buffer with a validity mask and an
overflow counter (``threshold.pack_by_mask``); capacities default to the
paper's whp bounds (Lemma 2 / Lemma 6) with a safety factor.

Randomness: the sample rounds take their U[0, 1) draws as an (E, m, n/m)
tensor, so a test can feed the JAX package's own draws; without them the
drivers draw from the given ``torch.Generator``.  A mesh rank draws the
whole block and keeps its machine's row, so the same generator gives the
mesh the sim's draws.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.core import constraints as constraints_mod
from repro_torch.core import faults as faults_mod
from repro_torch.core import grids, rounds
from repro_torch.core import precision as precision_mod
from repro_torch.core.functions import bind_query, consumes_query_params
from repro_torch.core.rounds import (MeshRounds, RoundLog, SimRounds,
                                     buffer_bytes, run_epochs)
from repro_torch.core.threshold import DEFAULT_CHUNK, validate_engine
from repro_torch.device import resolve_device


class SelectionResult(NamedTuple):
    sol_ids: torch.Tensor       # (k,) int32 global element ids, -1 padded
    sol_size: torch.Tensor      # () int32
    value: torch.Tensor         # () f32, f(S)
    n_dropped: torch.Tensor     # () int32, total buffer overflow (0 whp)
    tau_fallback: torch.Tensor  # () int32, threshold grids that hit the
    #                             degenerate-sample (+inf) guard
    degraded: object = 0        # () int32 1 when a fault plan degraded
    #                             the run (its records are in the RoundLog)
    haircut: object = 1.0       # () f32 guarantee factor under the
    #                             recorded faults, the worst per-round
    #                             survivor fraction (faults.fault_summary)


class QueryBatch(NamedTuple):
    """Q selection queries against one shared corpus (the query axis): a
    query is a budget and the oracle hyper-parameters it may rebind
    (``functions.bind_query``); those that do not apply to the oracle are
    ignored.  Each field is (Q,)."""
    k: torch.Tensor              # int32 per-query budget, <= MRConfig.k
    graph_cut_lam: torch.Tensor  # f32 GraphCut redundancy weight
    logdet_alpha: torch.Tensor   # f32 LogDetDiversity kernel scale

    @property
    def n_queries(self) -> int:
        return self.k.shape[0]


def make_query_batch(ks, graph_cut_lam=None, logdet_alpha=None,
                     default_lam: float = 0.5, default_alpha: float = 1.0,
                     device=None) -> QueryBatch:
    """A QueryBatch from per-query budgets, the hyper-parameters filled with
    the defaults where not given; on the CUDA card unless ``device`` says
    otherwise."""
    dev = resolve_device(device)
    ks = torch.as_tensor(ks, dtype=torch.int32, device=dev).reshape(-1)

    def per_query(x, default):
        if x is None:
            return torch.full(ks.shape, default, dtype=torch.float32,
                              device=dev)
        return torch.as_tensor(x, dtype=torch.float32, device=dev).reshape(-1)

    return QueryBatch(ks, per_query(graph_cut_lam, default_lam),
                      per_query(logdet_alpha, default_alpha))


@dataclasses.dataclass(frozen=True)
class MRConfig:
    """Capacities and knobs.  Defaults follow the paper's memory bounds."""
    k: int
    n_total: int
    n_machines: int
    eps: float = 0.15
    sample_cap: Optional[int] = None      # per machine
    survivor_cap: Optional[int] = None    # per machine
    top_cap: Optional[int] = None         # per machine, Algorithm 7
    n_grid: Optional[int] = None          # unknown-OPT threshold grid size
    accept: str = "first"                 # "first" = Algorithm-1-faithful
    engine: str = "dense"                 # "dense" | "lazy" | "fused"
    chunk: int = DEFAULT_CHUNK            # lazy/fused-engine chunk size
    epochs: Optional[int] = None          # None derives ceil(1/eps)
    schedule_kind: str = "paper"          # grids.SCHEDULE_KINDS
    precision: str = "f32"                # "f32" | "bf16" storage policy
    constraint: Optional[constraints_mod.Constraint] = None
    #                                       feasibility constraint threaded
    #                                       through the drivers; None is
    #                                       plain k-cardinality
    faults: Optional[faults_mod.FaultPlan] = None
    #                                       deterministic chaos schedule
    #                                       (core/faults.py); None runs the
    #                                       bare substrate

    def __post_init__(self):
        validate_engine(self.engine, self.accept, where="MRConfig")
        grids.validate_schedule_kind(self.schedule_kind, where="MRConfig")
        precision_mod.validate(self.precision, where="MRConfig")
        if self.constraint is not None and not isinstance(
                self.constraint, constraints_mod.Constraint):
            raise TypeError(
                "MRConfig: constraint must be a repro_torch.core.constraints."
                f"Constraint (or None), got {type(self.constraint).__name__}"
                "; build one with constraints.make_constraint(...)")
        if self.faults is not None and not isinstance(
                self.faults, faults_mod.FaultPlan):
            raise TypeError(
                "MRConfig: faults must be a repro_torch.core.faults.FaultPlan "
                f"(or None), got {type(self.faults).__name__}")

    @property
    def constraint_planes(self) -> int:
        """Width of the constraint's attribute plane: the extra columns the
        round backends append to every packed message, which the Lemma-2/6
        byte accounting counts."""
        return constraints_mod.n_planes_of(self.constraint)

    @property
    def precision_policy(self) -> precision_mod.Precision:
        return precision_mod.resolve(self.precision)

    @property
    def filter_chunk(self) -> Optional[int]:
        """Tile size of the filter's plain-route sweep: the chunked engines
        bound the filter's transient aux like their rescore; dense does not."""
        return self.chunk if self.engine in ("lazy", "fused") else None

    @property
    def sample_p(self) -> float:
        return min(1.0, 4.0 * math.sqrt(self.k / self.n_total))

    @property
    def n_local(self) -> int:
        return -(-self.n_total // self.n_machines)

    def n_epochs(self, epochs=None) -> int:
        """Explicit argument, then the config's ``epochs``, then
        ceil(1/eps)."""
        return grids.epochs_for_eps(
            self.eps, epochs if epochs is not None else self.epochs)

    def require_even_shards(self, where: str = "sim reshape") -> None:
        """The (m, n/m, d) reshape needs exact divisibility."""
        if self.n_total % self.n_machines:
            raise ValueError(
                f"{where}: n_total={self.n_total} is not divisible by "
                f"n_machines={self.n_machines}; pad the ground set with "
                f"invalid (id=-1) rows to a multiple of n_machines")

    def caps(self) -> Tuple[int, int, int]:
        n_loc = self.n_local
        exp_sample = self.sample_p * n_loc
        s_cap = self.sample_cap or min(n_loc, int(3 * exp_sample) + 16)
        exp_surv = math.sqrt(self.n_total * self.k) / self.n_machines
        f_cap = self.survivor_cap or min(n_loc, int(4 * exp_surv) + self.k + 16)
        t_cap = self.top_cap or min(n_loc, 2 * self.k + 16)
        return s_cap, f_cap, t_cap

    def grid_size(self) -> int:
        """One tau_j within (1 + eps) of OPT/2k needs about log_{1+eps} k
        points; under a fault plan the derived grid is padded for the
        sampled estimate's sag (an explicit n_grid stays as it is)."""
        J = grids.grid_size(self.k, self.eps, self.n_grid)
        if self.n_grid is None and self.faults is not None:
            J += self.faults.grid_pad(self.eps)
        return J


def _tau_grid(oracle, cfg: MRConfig, s_feats, s_ids, s_valid):
    """Threshold guesses tau_j = (v/2k)(1+eps)^j from the max singleton v
    of a gathered message (its base features, without the constraint
    plane), with the degenerate-sample guard.  Returns (taus (J,),
    degenerate () int32)."""
    base, _ = constraints_mod.split_plane(s_feats, cfg.constraint_planes)
    v = grids.max_singleton(oracle, base, s_valid)
    return grids.tau_grid_from_v(v, cfg.k, cfg.eps, cfg.grid_size())


def _known_opt_select(oracle, rr, cfg: MRConfig, schedule,
                      epoch_uniforms) -> SelectionResult:
    """Known-OPT epoch driver (Algorithms 4 and 5): the scalar schedule
    runs as a grid of one lane, each threshold rounded to float32 once;
    the lane axis is squeezed here, so sol_ids is (k,) and the rest 0-d."""
    dev = rr.device
    sched = [torch.as_tensor(tau, dtype=torch.float32, device=dev).reshape(1)
             for tau in schedule]
    carry, (sdrop, rdrop) = run_epochs(oracle, rr, sched, epoch_uniforms,
                                       cfg)
    st, sol, size = carry[:3]
    return SelectionResult(sol[0], size[0], oracle.value(st)[0],
                           rr.finalize_drops(sdrop + rdrop.sum()),
                           torch.zeros((), dtype=torch.int32, device=dev))


def _epoch_select(oracle, rr, cfg: MRConfig, epoch_uniforms, epochs: int,
                  kind: str, with_sparse: bool = True) -> SelectionResult:
    """Unknown-OPT epoch driver: derive the tau grid from epoch 1's sample,
    run every guess's descending schedule as an engine lane, ride the
    Algorithm-7 sparse path through the same rounds (unless
    ``with_sparse`` is False: Algorithm 6 alone), and keep the best lane
    (the first of equal values)."""
    s_cap, _, t_cap = cfg.caps()
    S1, sdrop1 = rr.sample(epoch_uniforms[0], cfg.sample_p, s_cap)
    taus, fb_d = _tau_grid(oracle, cfg, *S1)
    sched = grids.epoch_schedule(taus, epochs, cfg.eps, kind)
    carry, (sdrop, rdrop) = run_epochs(oracle, rr, sched, epoch_uniforms, cfg,
                                       first_sample=(S1, sdrop1))
    drops = rr.finalize_drops(sdrop + rdrop.sum())
    st_j, sol_j, size_j = carry[:3]
    dval = oracle.value(st_j)
    if not with_sparse:
        best = dval.argmax()
        return SelectionResult(sol_j[best], size_j[best], dval[best], drops,
                               fb_d)

    pools, _ = rr.tops([oracle], t_cap)
    pool = tuple(x[0] for x in pools)
    taus_s, fb_s = _tau_grid(oracle, cfg, *pool)
    sched_s = grids.epoch_schedule(taus_s, epochs, cfg.eps, kind)
    ssol, ssize, sval = rounds.sparse_sweep(oracle, pool, sched_s, cfg)

    sols = torch.cat([sol_j, ssol], 0)
    sizes = torch.cat([size_j, ssize], 0)
    vals = torch.cat([dval, sval], 0)
    best = vals.argmax()
    return SelectionResult(sols[best], sizes[best], vals[best], drops,
                           fb_d + fb_s)


def epoch_uniforms(uniforms, epochs: int, m: int, n_local: int, device,
                   generator: Optional[torch.Generator] = None):
    """The sample rounds' (E, m, n/m) float32 U[0, 1) draws: ``uniforms``
    when given (any array-like of that size), else drawn from
    ``generator`` (a fresh generator seeded 0 when None)."""
    shape = (epochs, m, n_local)
    if uniforms is not None:
        u = torch.as_tensor(uniforms, dtype=torch.float32, device=device)
        if u.numel() != epochs * m * n_local:
            raise ValueError(f"uniforms of shape {tuple(u.shape)} do not "
                             f"cover {shape}")
        return u.reshape(shape)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    return torch.rand(shape, generator=generator, device=generator.device,
                      dtype=torch.float32).to(device)


def _sim_rounds(feats_mk, ids_mk, valid_mk, cfg: MRConfig) -> SimRounds:
    return SimRounds(feats_mk, ids_mk, valid_mk,
                     precision=cfg.precision_policy,
                     constraint=cfg.constraint)


def _faulty(rr, cfg: MRConfig, log: RoundLog):
    """The substrate under cfg's fault plan, recording into ``log`` (the
    substrate itself without a plan)."""
    return faults_mod.with_faults(rr, cfg.faults, log, rr.m, cfg.n_total)


def _draws(rr, uniforms, epochs: int, generator):
    """The (E, m, n/m) draws of a substrate's sample rounds; a mesh rank
    draws the whole block and keeps its own row, so one generator gives
    the mesh the sim's draws."""
    return epoch_uniforms(uniforms, epochs, rr.m, rr.n_local, rr.device,
                          generator)


def two_round_known_opt_sim(oracle, feats_mk, ids_mk, valid_mk, opt,
                            cfg: MRConfig, uniforms=None,
                            generator: Optional[torch.Generator] = None
                            ) -> Tuple[SelectionResult, RoundLog]:
    """Algorithm 4: 2 rounds, a 1/2-approximation with OPT known; one
    epoch at tau = OPT/2k.  ``uniforms``: the sample round's (1, m, n/m)
    draws."""
    rr = _sim_rounds(feats_mk, ids_mk, valid_mk, cfg)
    log = rounds.epoch_round_log(cfg, rr.m, rr.feat_dim, 1)
    rr = _faulty(rr, cfg, log)
    res = _known_opt_select(oracle, rr, cfg, [opt / (2.0 * cfg.k)],
                            _draws(rr, uniforms, 1, generator))
    return faults_mod.apply_fault_flags(res, log), log


def multi_threshold_sim(oracle, feats_mk, ids_mk, valid_mk, opt, t: int,
                        cfg: MRConfig, uniforms=None,
                        generator: Optional[torch.Generator] = None,
                        schedule=None) -> Tuple[SelectionResult, RoundLog]:
    """Algorithm 5: 2t rounds, a 1 - (1 - 1/(t+1))^t approximation with OPT
    known; t epochs at alpha_l = (1 - 1/(t+1))^l OPT/k.  ``schedule``
    overrides the thresholds (absolute, descending; the Theorem-4
    instance's).  ``uniforms``: the sample rounds' (t, m, n/m) draws."""
    rr = _sim_rounds(feats_mk, ids_mk, valid_mk, cfg)
    sched = (list(schedule) if schedule is not None
             else grids.alg5_schedule(opt, cfg.k, t))
    log = rounds.epoch_round_log(cfg, rr.m, rr.feat_dim, t, level_suffix=True)
    rr = _faulty(rr, cfg, log)
    res = _known_opt_select(oracle, rr, cfg, sched,
                            _draws(rr, uniforms, t, generator))
    return faults_mod.apply_fault_flags(res, log), log


def dense_two_round_sim(oracle, feats_mk, ids_mk, valid_mk, cfg: MRConfig,
                        uniforms=None,
                        generator: Optional[torch.Generator] = None
                        ) -> Tuple[SelectionResult, RoundLog]:
    """Algorithm 6: 2 rounds, (1/2 - eps) for 'dense' inputs; the
    Algorithm-4 pipeline for every tau_j of the grid, one engine lane each.
    ``uniforms``: the sample round's (1, m, n/m) draws."""
    rr = _sim_rounds(feats_mk, ids_mk, valid_mk, cfg)
    log = rounds.epoch_round_log(cfg, rr.m, rr.feat_dim, 1, with_grid=True)
    rr = _faulty(rr, cfg, log)
    res = _epoch_select(oracle, rr, cfg, _draws(rr, uniforms, 1, generator),
                        1, cfg.schedule_kind, with_sparse=False)
    return faults_mod.apply_fault_flags(res, log), log


def sparse_two_round_sim(oracle, feats_mk, ids_mk, valid_mk, cfg: MRConfig
                         ) -> Tuple[SelectionResult, RoundLog]:
    """Algorithm 7: 2 rounds, (1/2 - eps) for 'sparse' inputs; each machine
    ships its O(k) largest singletons, and the central machine sweeps the
    threshold grid over them.  It draws no sample."""
    _, _, t_cap = cfg.caps()
    rr = _sim_rounds(feats_mk, ids_mk, valid_mk, cfg)
    log = RoundLog()
    rounds.log_gather(log, "gather-top-singletons", t_cap, rr.m, rr.feat_dim,
                      f"top {t_cap}/machine",
                      itemsize=cfg.precision_policy.storage_itemsize)
    rr = _faulty(rr, cfg, log)
    pools, tdrop = rr.tops([oracle], t_cap)
    pool = tuple(x[0] for x in pools)
    taus, fb = _tau_grid(oracle, cfg, *pool)
    sol_j, size_j, val_j = rounds.sparse_sweep(oracle, pool, [taus], cfg)
    log.add("broadcast-result", buffer_bytes(cfg.k, 0),
            buffer_bytes(cfg.k, 0), "central solution out")
    best = val_j.argmax()
    res = SelectionResult(sol_j[best], size_j[best], val_j[best],
                          rr.finalize_drops(tdrop), fb)
    return faults_mod.apply_fault_flags(res, log), log


def multi_epoch_sim(oracle, feats_mk, ids_mk, valid_mk, cfg: MRConfig,
                    uniforms=None, generator: Optional[torch.Generator] = None,
                    epochs: Optional[int] = None,
                    schedule_kind: Optional[str] = None, opt=None
                    ) -> Tuple[SelectionResult, RoundLog]:
    """The paper's multi-epoch driver: E epochs (2E rounds) of descending
    thresholds, value >= (1 - (1 - 1/(E+1))^E) OPT for the paper schedule.
    OPT unknown (the default): every tau-grid guess runs its own schedule
    as an engine lane, the Algorithm-7 sparse path rides the same rounds,
    the best lane wins; ``epochs=1`` is two_round_sim.  With ``opt`` it
    runs one lane of Algorithm 5's schedule ("paper") or of
    epoch_schedule(opt/2k) (other kinds), with multi_threshold_sim's draws.

    feats_mk (m, n/m, d); ids_mk and valid_mk (m, n/m).  ``uniforms``:
    the sample rounds' (E, m, n/m) draws (see ``epoch_uniforms``).  Under
    ``cfg.constraint`` every message carries its attribute plane, and the
    RoundLog counts the width d + n_planes."""
    E = cfg.n_epochs(epochs)
    kind = schedule_kind or cfg.schedule_kind
    rr = _sim_rounds(feats_mk, ids_mk, valid_mk, cfg)
    u = _draws(rr, uniforms, E, generator)
    if opt is not None:
        sched = (grids.alg5_schedule(opt, cfg.k, E) if kind == "paper"
                 else grids.epoch_schedule(opt / (2.0 * cfg.k), E, cfg.eps,
                                           kind))
        log = rounds.epoch_round_log(cfg, rr.m, rr.feat_dim, E)
        res = _known_opt_select(oracle, _faulty(rr, cfg, log), cfg, sched, u)
    else:
        log = rounds.epoch_round_log(cfg, rr.m, rr.feat_dim, E,
                                     with_grid=True, with_top=True)
        res = _epoch_select(oracle, _faulty(rr, cfg, log), cfg, u, E, kind)
    return faults_mod.apply_fault_flags(res, log), log


def two_round_sim(oracle, feats_mk, ids_mk, valid_mk, cfg: MRConfig,
                  uniforms=None, generator: Optional[torch.Generator] = None
                  ) -> Tuple[SelectionResult, RoundLog]:
    """Theorem 8: Algorithms 6 and 7 in the same two rounds, best of the
    two; the (1/2 - eps) result with no knowledge of OPT.  The 1-epoch
    instantiation of multi_epoch_sim."""
    return multi_epoch_sim(oracle, feats_mk, ids_mk, valid_mk, cfg,
                           uniforms=uniforms, generator=generator, epochs=1)


def two_round_batch_sim(oracle, feats_mk, ids_mk, valid_mk, qb: QueryBatch,
                        cfg: MRConfig, uniforms=None,
                        generator: Optional[torch.Generator] = None
                        ) -> Tuple[SelectionResult, RoundLog]:
    """Theorem 8 for Q queries over one corpus partition (the query axis).

    The sample round is drawn once, with two_round_sim's draws (a Q = 1
    batch at k = cfg.k with the default hyper-parameters is two_round_sim),
    and shared by every query.  When the oracle takes no per-query
    hyper-parameters (``functions.consumes_query_params``), the Q queries x
    J guesses are one lane axis of Q*J lanes, each with its tau and budget
    ``qb.k``, so a round is one launch per kernel; the max-singleton
    estimates and the top-singleton pool are shared.  GraphCut and
    LogDetDiversity run one J-lane group per query with ``bind_query``'s
    oracle (lam and alpha read once into Python floats, so the kernel route
    stays); their top-singleton messages ride one gather, and all Q x J
    survivor messages another.

    Returns a SelectionResult whose every field but ``degraded`` and
    ``haircut`` has a leading (Q,) axis, and a RoundLog with the shared and
    per-query bytes broken out."""
    _require_unconstrained(cfg, "two_round_batch_sim")
    rr = _sim_rounds(feats_mk, ids_mk, valid_mk, cfg)
    log = _batch_round_log(cfg, rr.m, rr.feat_dim, qb.n_queries,
                           not consumes_query_params(oracle))
    rr = _faulty(rr, cfg, log)
    res = _batch_select(oracle, rr, cfg, qb,
                        _draws(rr, uniforms, 1, generator)[0])
    return faults_mod.apply_fault_flags(res, log), log


def _require_unconstrained(cfg: MRConfig, where: str) -> None:
    """The query-batched driver shares one sample and gather round across
    the queries and has no per-query feasibility state."""
    if cfg.constraint is not None:
        raise NotImplementedError(
            f"{where}: constrained selection is not supported on the "
            "query-batched path; run the single-query drivers per query")


def _batch_round_log(cfg: MRConfig, m: int, feat_dim: int, n_queries: int,
                     shared_stats: bool) -> RoundLog:
    """The batched driver's RoundLog: the shared sample with one top
    message (or one per query), then Q x J survivor messages."""
    s_cap, f_cap, t_cap = cfg.caps()
    J = cfg.grid_size()
    Q = n_queries
    isz = cfg.precision_policy.storage_itemsize
    n_tops = 1 if shared_stats else Q
    log = RoundLog()
    log.add("gather-sample||top[Q]",
            buffer_bytes(s_cap, feat_dim, isz)
            + n_tops * buffer_bytes(t_cap, feat_dim, isz),
            buffer_bytes(m * s_cap, feat_dim, isz)
            + n_tops * buffer_bytes(m * t_cap, feat_dim, isz),
            f"Q={Q}: shared sample {buffer_bytes(m * s_cap, feat_dim, isz)}B "
            f"+ {'shared' if n_tops == 1 else 'per-query'} top "
            f"{buffer_bytes(m * t_cap, feat_dim, isz)}B")
    log.add("gather-survivors[QxJ]",
            Q * J * buffer_bytes(f_cap, feat_dim, isz),
            Q * J * buffer_bytes(m * f_cap, feat_dim, isz),
            f"per-query {J * buffer_bytes(m * f_cap, feat_dim, isz)}B "
            f"grid J={J}")
    return log


def _batch_select(oracle, rr, cfg: MRConfig, qb: QueryBatch, uniforms
                  ) -> SelectionResult:
    """The batched body on either substrate: the shared sample round (the
    (m, n/m) draws ``uniforms``), the top-singleton round (one message for
    the batch, or one a query when the queries rebind the oracle), then the
    queries' lanes."""
    s_cap, _, t_cap = cfg.caps()
    sample = rr.sample(uniforms, cfg.sample_p, s_cap)
    ks = [int(kq) for kq in qb.k.tolist()]
    if consumes_query_params(oracle):
        lams, alphas = qb.graph_cut_lam.tolist(), qb.logdet_alpha.tolist()
        groups = [(bind_query(oracle, lams[q], alphas[q]), ks[q:q + 1])
                  for q in range(len(ks))]
    else:
        groups = [(oracle, ks)]
    pools, _ = rr.tops([orc for orc, _ in groups], t_cap)
    return SelectionResult(*_query_select(cfg, rr, sample, groups, pools))


def _query_select(cfg: MRConfig, rr, sample, groups, pools):
    """Queries in lane groups of J lanes a query: ``groups`` is a list of
    (oracle, budgets), either one group of every query over one oracle, or
    one group a query with its rebound oracle; lane q * J + j is query q's
    guess j.  One epoch of ``run_epoch_groups`` over the shared ``sample``
    (the gathered sample and its overflow), each group's grid from its max
    singleton in the sample, the sparse sweep of each group's top-singleton
    pool (``pools``, (len(groups), m cap, ...)), and each query's best
    lane.  Returns (sol (Q, k), size (Q,), value (Q,), n_dropped (Q,),
    tau_fallback (Q,))."""
    J = cfg.grid_size()
    S = sample[0]
    kqs = [torch.tensor(ks, dtype=torch.int32, device=rr.device)
           for _, ks in groups]
    lanes, fbs = [], []
    for (orc, _), kq in zip(groups, kqs):
        taus, fb_d = grids.tau_grid_from_v(
            grids.max_singleton(orc, S[0], S[2]), kq, cfg.eps, J)
        lanes.append((orc, [taus.reshape(-1)], kq.repeat_interleave(J)))
        fbs.append(fb_d)
    carries, (sdrop, rdrop) = rounds.run_epoch_groups(
        lanes, rr, None, cfg, first_sample=sample)
    dense, sparse = [], []
    for g, ((orc, ks), kq) in enumerate(zip(groups, kqs)):
        st, sol, size = carries[g]
        dense.append((sol, size, orc.value(st)))
        pool = tuple(x[g] for x in pools)
        taus_s, fb_s = grids.tau_grid_from_v(
            grids.max_singleton(orc, pool[0], pool[2]), kq, cfg.eps, J)
        sparse.append(rounds.sparse_sweep(orc, pool, [taus_s.reshape(-1)],
                                          cfg, k_dyn=lanes[g][2]))
        fbs[g] = (fbs[g] + fb_s).expand(len(ks))
    return _best_lanes(cfg, sum(len(ks) for _, ks in groups),
                       [torch.cat(p) for p in zip(*dense)],
                       [torch.cat(p) for p in zip(*sparse)],
                       rr.finalize_drops(sdrop + rdrop.view(-1, J).sum(1)),
                       torch.cat(fbs))


def _best_lanes(cfg: MRConfig, Q: int, dense, sparse, drops, fallback):
    """Each query's best of its J dense and J sparse lanes (the first of
    equal values): (sol (Q, k), size (Q,), value (Q,), n_dropped (Q,),
    tau_fallback (Q,))."""
    K, J = cfg.k, cfg.grid_size()
    (sol, size, val), (ssol, ssize, sval) = dense, sparse
    sols = torch.cat([sol.view(Q, J, K), ssol.view(Q, J, K)], 1)
    sizes = torch.cat([size.view(Q, J), ssize.view(Q, J)], 1)
    vals = torch.cat([val.view(Q, J), sval.view(Q, J)], 1)
    best = vals.argmax(1, keepdim=True)
    return (sols.gather(1, best[..., None].expand(-1, -1, K))[:, 0],
            sizes.gather(1, best)[:, 0], vals.gather(1, best)[:, 0],
            drops, fallback)


# ---------------------------------------------------------------------------
# mesh drivers: this process is one machine of a process group
# ---------------------------------------------------------------------------

def _mesh_setup(mesh, axes):
    """The machine count and process group of ``mesh``'s axes ``axes``
    (those it has)."""
    axes = tuple(a for a in axes if a in mesh.shape)
    if not axes:
        raise ValueError(f"the mesh {mesh.shape} has none of the machine "
                         f"axes {axes}")
    return mesh.size(axes), mesh.group(axes)


def _mesh_rounds(feats, ids, group, cfg: MRConfig, log: RoundLog):
    rr = MeshRounds(feats, ids, ids >= 0, group,
                    precision=cfg.precision_policy, constraint=cfg.constraint)
    return _faulty(rr, cfg, log)


def _opt32(opt, device):
    """OPT as a float32 scalar, as the JAX mesh drivers take it: the
    schedule is then computed in float32."""
    return torch.as_tensor(opt, dtype=torch.float32, device=device)


def two_round_known_opt_mesh(oracle, cfg: MRConfig, mesh, axes=("data",)):
    """Algorithm 4 on a mesh.  Returns ``run(feats, ids, opt, uniforms=None,
    generator=None) -> SelectionResult`` over this rank's shard (feats
    (n/m, d), its column block under a TPOracle; ids (n/m,) global, -1 for
    padding) and the RoundLog.  ``uniforms``: the sample round's (1, m,
    n/m) draws, of which the rank keeps its machine's row.  The messages'
    width in the log is the oracle's, the shard width under a TPOracle."""
    m, group = _mesh_setup(mesh, axes)
    log = rounds.epoch_round_log(cfg, m,
                                 oracle.feat_dim + cfg.constraint_planes, 1)

    def run(feats, ids, opt, uniforms=None, generator=None):
        rr = _mesh_rounds(feats, ids, group, cfg, log)
        res = _known_opt_select(oracle, rr, cfg,
                                [_opt32(opt, rr.device) / (2.0 * cfg.k)],
                                _draws(rr, uniforms, 1, generator))
        return faults_mod.apply_fault_flags(res, log)

    return run, log


def multi_threshold_mesh(oracle, cfg: MRConfig, t: int, mesh,
                         axes=("data",)):
    """Algorithm 5 on a mesh: t epochs (2t gathers) at the known-OPT
    schedule.  ``run(feats, ids, opt, uniforms=None, generator=None)`` as
    ``two_round_known_opt_mesh``'s, with (t, m, n/m) draws."""
    m, group = _mesh_setup(mesh, axes)
    log = rounds.epoch_round_log(cfg, m,
                                 oracle.feat_dim + cfg.constraint_planes, t,
                                 level_suffix=True)

    def run(feats, ids, opt, uniforms=None, generator=None):
        rr = _mesh_rounds(feats, ids, group, cfg, log)
        res = _known_opt_select(
            oracle, rr, cfg,
            grids.alg5_schedule(_opt32(opt, rr.device), cfg.k, t),
            _draws(rr, uniforms, t, generator))
        return faults_mod.apply_fault_flags(res, log)

    return run, log


def multi_epoch_mesh(oracle, cfg: MRConfig, mesh, axes=("data",),
                     epochs: Optional[int] = None,
                     schedule_kind: Optional[str] = None):
    """The multi-epoch (1 - 1/e - eps) driver on a mesh: E epochs of the
    unknown-OPT grid engine (2E gathers), the sparse path riding the same
    rounds; ``epochs=1`` is two_round_mesh.  Returns ``run(feats, ids,
    uniforms=None, generator=None)`` over this rank's shard, with (E, m,
    n/m) draws, and the RoundLog."""
    E = cfg.n_epochs(epochs)
    kind = schedule_kind or cfg.schedule_kind
    m, group = _mesh_setup(mesh, axes)
    log = rounds.epoch_round_log(cfg, m,
                                 oracle.feat_dim + cfg.constraint_planes, E,
                                 with_grid=True, with_top=True)

    def run(feats, ids, uniforms=None, generator=None):
        rr = _mesh_rounds(feats, ids, group, cfg, log)
        res = _epoch_select(oracle, rr, cfg,
                            _draws(rr, uniforms, E, generator), E, kind)
        return faults_mod.apply_fault_flags(res, log)

    return run, log


def two_round_mesh(oracle, cfg: MRConfig, mesh, axes=("data",)):
    """Theorem 8 on a mesh: the 1-epoch multi_epoch_mesh."""
    return multi_epoch_mesh(oracle, cfg, mesh, axes, epochs=1)


def two_round_batch_mesh(oracle, cfg: MRConfig, mesh, axes=("data",)):
    """Theorem 8 for Q queries on a mesh: the two gathers of two_round_mesh
    carry every query.  The first gathers the shared sample, then the
    top-singleton message (one for the batch, or the queries' stacked on a
    leading (Q,) axis in one collective for GraphCut and LogDetDiversity);
    the second gathers the Q x J survivor stack in one collective.

    Returns ``run(feats, ids, qb, uniforms=None, generator=None)`` (a
    SelectionResult with a leading (Q,) axis) and ``round_log(Q)``, which
    builds a batch's RoundLog; every such log shares the driver's fault
    records."""
    _require_unconstrained(cfg, "two_round_batch_mesh")
    m, group = _mesh_setup(mesh, axes)
    shared = not consumes_query_params(oracle)
    fault_log = RoundLog()

    def round_log(n_queries: int) -> RoundLog:
        blog = _batch_round_log(cfg, m, oracle.feat_dim, n_queries, shared)
        blog.faults = fault_log.faults
        return blog

    def run(feats, ids, qb: QueryBatch, uniforms=None, generator=None):
        rr = _mesh_rounds(feats, ids, group, cfg, fault_log)
        res = _batch_select(oracle, rr, cfg, qb,
                            _draws(rr, uniforms, 1, generator)[0])
        return faults_mod.apply_fault_flags(res, fault_log)

    return run, round_log
