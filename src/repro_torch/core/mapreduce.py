"""The paper's MapReduce drivers on the sim substrate.

* ``two_round_known_opt_sim`` — Algorithm 4: one epoch at OPT/2k.
* ``multi_threshold_sim``     — Algorithm 5: t epochs at the known-OPT
  schedule alpha_l = (1 - 1/(t+1))^l OPT/k.
* ``dense_two_round_sim``     — Algorithm 6: one epoch over the unknown-OPT
  tau grid, one engine lane per guess.
* ``sparse_two_round_sim``    — Algorithm 7: the machines' top singletons,
  swept centrally over the grid.
* ``two_round_sim``   — Theorem 8: Algorithms 6 and 7 in the same two
  rounds; best of all lanes.
* ``multi_epoch_sim`` — the (1 - 1/e - eps) result: E = ceil(1/eps) epochs
  of the same grid driver, carrying the solution across epochs.  E = 1 is
  two_round_sim; with ``opt`` it runs Algorithm 5's schedule instead.
* ``two_round_batch_sim`` — Theorem 8 for Q queries (``QueryBatch``) that
  share one corpus partition and one sample round (the query axis).

A known-OPT schedule (one sequential solution) runs as a grid of one lane
through the same lane code; its driver squeezes the lane axis.  Every MRC
message is a fixed-capacity packed buffer with a validity mask and an
overflow counter (``threshold.pack_by_mask``); capacities default to the
paper's whp bounds (Lemma 2 / Lemma 6) with a safety factor.

Randomness: the sample rounds take their U[0, 1) draws as an (E, m, n/m)
tensor, so a test can feed the JAX package's own draws; without them the
drivers draw from the given ``torch.Generator``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.core import constraints as constraints_mod
from repro_torch.core import grids, rounds
from repro_torch.core import precision as precision_mod
from repro_torch.core.functions import bind_query, consumes_query_params
from repro_torch.core.rounds import (RoundLog, SimRounds, buffer_bytes,
                                     run_epochs)
from repro_torch.core.threshold import DEFAULT_CHUNK, validate_engine
from repro_torch.device import resolve_device


class SelectionResult(NamedTuple):
    sol_ids: torch.Tensor       # (k,) int32 global element ids, -1 padded
    sol_size: torch.Tensor      # () int32
    value: torch.Tensor         # () f32, f(S)
    n_dropped: torch.Tensor     # () int32, total buffer overflow (0 whp)
    tau_fallback: torch.Tensor  # () int32, threshold grids that hit the
    #                             degenerate-sample (+inf) guard


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
        return grids.grid_size(self.k, self.eps, self.n_grid)


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
    dev = rr.ids_mk.device
    sched = [torch.as_tensor(tau, dtype=torch.float32, device=dev).reshape(1)
             for tau in schedule]
    carry, (sdrop, rdrop) = run_epochs(oracle, rr, sched, epoch_uniforms,
                                       cfg)
    st, sol, size = carry[:3]
    return SelectionResult(sol[0], size[0], oracle.value(st)[0],
                           sdrop + rdrop.sum(),
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
    drops = sdrop + rdrop.sum()
    st_j, sol_j, size_j = carry[:3]
    dval = oracle.value(st_j)
    if not with_sparse:
        best = dval.argmax()
        return SelectionResult(sol_j[best], size_j[best], dval[best], drops,
                               fb_d)

    pool, _ = rr.tops(oracle, t_cap)
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


def _draws(rr: SimRounds, uniforms, epochs: int, generator):
    return epoch_uniforms(uniforms, epochs, rr.m, rr.n_local,
                          rr.ids_mk.device, generator)


def two_round_known_opt_sim(oracle, feats_mk, ids_mk, valid_mk, opt,
                            cfg: MRConfig, uniforms=None,
                            generator: Optional[torch.Generator] = None
                            ) -> Tuple[SelectionResult, RoundLog]:
    """Algorithm 4: 2 rounds, a 1/2-approximation with OPT known; one
    epoch at tau = OPT/2k.  ``uniforms``: the sample round's (1, m, n/m)
    draws."""
    rr = _sim_rounds(feats_mk, ids_mk, valid_mk, cfg)
    log = rounds.epoch_round_log(cfg, rr.m, rr.feat_dim, 1)
    return _known_opt_select(oracle, rr, cfg, [opt / (2.0 * cfg.k)],
                             _draws(rr, uniforms, 1, generator)), log


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
    return _known_opt_select(oracle, rr, cfg, sched,
                             _draws(rr, uniforms, t, generator)), log


def dense_two_round_sim(oracle, feats_mk, ids_mk, valid_mk, cfg: MRConfig,
                        uniforms=None,
                        generator: Optional[torch.Generator] = None
                        ) -> Tuple[SelectionResult, RoundLog]:
    """Algorithm 6: 2 rounds, (1/2 - eps) for 'dense' inputs; the
    Algorithm-4 pipeline for every tau_j of the grid, one engine lane each.
    ``uniforms``: the sample round's (1, m, n/m) draws."""
    rr = _sim_rounds(feats_mk, ids_mk, valid_mk, cfg)
    log = rounds.epoch_round_log(cfg, rr.m, rr.feat_dim, 1, with_grid=True)
    return _epoch_select(oracle, rr, cfg, _draws(rr, uniforms, 1, generator),
                         1, cfg.schedule_kind, with_sparse=False), log


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
    pool, tdrop = rr.tops(oracle, t_cap)
    taus, fb = _tau_grid(oracle, cfg, *pool)
    sol_j, size_j, val_j = rounds.sparse_sweep(oracle, pool, [taus], cfg)
    log.add("broadcast-result", buffer_bytes(cfg.k, 0),
            buffer_bytes(cfg.k, 0), "central solution out")
    best = val_j.argmax()
    return SelectionResult(sol_j[best], size_j[best], val_j[best], tdrop,
                           fb), log


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
        return _known_opt_select(oracle, rr, cfg, sched, u), log
    log = rounds.epoch_round_log(cfg, rr.m, rr.feat_dim, E, with_grid=True,
                                 with_top=True)
    return _epoch_select(oracle, rr, cfg, u, E, kind), log


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
    LogDetDiversity run one J-lane pass per query with ``bind_query``'s
    oracle (lam and alpha read once into Python floats, so the kernel route
    stays).

    Returns a SelectionResult whose every field has a leading (Q,) axis,
    and a RoundLog with the shared and per-query bytes broken out."""
    _require_unconstrained(cfg, "two_round_batch_sim")
    s_cap, _, t_cap = cfg.caps()
    Q = qb.n_queries
    shared = not consumes_query_params(oracle)
    rr = _sim_rounds(feats_mk, ids_mk, valid_mk, cfg)
    log = _batch_round_log(cfg, rr.m, rr.feat_dim, Q, shared)
    sample = rr.sample(_draws(rr, uniforms, 1, generator)[0], cfg.sample_p,
                       s_cap)
    S = sample[0]
    ks = [int(kq) for kq in qb.k.tolist()]

    def lanes(orc, ks):
        pool, _ = rr.tops(orc, t_cap)
        return _query_lanes(orc, cfg, rr, sample, ks,
                            grids.max_singleton(orc, S[0], S[2]), pool,
                            grids.max_singleton(orc, pool[0], pool[2]))

    if shared:
        out = lanes(oracle, ks)
    else:
        lams, alphas = qb.graph_cut_lam.tolist(), qb.logdet_alpha.tolist()
        parts = [lanes(bind_query(oracle, lams[q], alphas[q]), ks[q:q + 1])
                 for q in range(Q)]
        out = [torch.cat(p) for p in zip(*parts)]
    return SelectionResult(*out), log


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


def _query_lanes(orc, cfg: MRConfig, rr: SimRounds, sample, ks, v_dense,
                 pool, v_sparse):
    """Queries with budgets ``ks`` over one oracle, folded into len(ks) x J
    lanes (lane q * J + j is query q's guess j): one epoch of ``run_epochs``
    over the shared ``sample`` (the gathered sample and its overflow), the
    sparse sweep of the top-singleton ``pool``, and each query's best lane.
    Returns (sol (Q, k), size (Q,), value (Q,), n_dropped (Q,),
    tau_fallback (Q,))."""
    K, J = cfg.k, cfg.grid_size()
    Q = len(ks)
    kq = torch.tensor(ks, dtype=torch.int32, device=pool[1].device)
    k_dyn = kq.repeat_interleave(J)
    taus, fb_d = grids.tau_grid_from_v(v_dense, kq, cfg.eps, J)
    (st, sol, size), (sdrop, rdrop) = run_epochs(
        orc, rr, [taus.reshape(-1)], None, cfg, first_sample=sample,
        k_dyn=k_dyn)
    taus_s, fb_s = grids.tau_grid_from_v(v_sparse, kq, cfg.eps, J)
    ssol, ssize, sval = rounds.sparse_sweep(orc, pool, [taus_s.reshape(-1)],
                                            cfg, k_dyn=k_dyn)
    sols = torch.cat([sol.view(Q, J, K), ssol.view(Q, J, K)], 1)
    sizes = torch.cat([size.view(Q, J), ssize.view(Q, J)], 1)
    vals = torch.cat([orc.value(st).view(Q, J), sval.view(Q, J)], 1)
    best = vals.argmax(1, keepdim=True)
    return (sols.gather(1, best[..., None].expand(-1, -1, K))[:, 0],
            sizes.gather(1, best)[:, 0], vals.gather(1, best)[:, 0],
            sdrop + rdrop.view(Q, J).sum(1), (fb_d + fb_s).expand(Q))
