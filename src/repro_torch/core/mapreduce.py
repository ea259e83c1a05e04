"""The paper's OPT-free MapReduce drivers on the sim substrate.

* ``two_round_sim``   — Theorem 8: one epoch over the unknown-OPT tau grid
  (Algorithm 6, one engine lane per guess) with the sparse top-singleton
  path (Algorithm 7) riding the same two rounds; best of all lanes.
* ``multi_epoch_sim`` — the (1 - 1/e - eps) result: E = ceil(1/eps) epochs
  of the same grid driver, carrying the solution across epochs.  E = 1 is
  two_round_sim.

Every MRC message is a fixed-capacity packed buffer with a validity mask
and an overflow counter (``threshold.pack_by_mask``); capacities default to
the paper's whp bounds (Lemma 2 / Lemma 6) with a safety factor.

Randomness: the sample round takes its U[0, 1) draws as an (E, m, n/m)
tensor, so a test can feed the JAX package's own draws; without them the
drivers draw from the given ``torch.Generator``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.core import grids, rounds
from repro_torch.core import precision as precision_mod
from repro_torch.core.rounds import RoundLog, SimRounds, run_epochs
from repro_torch.core.threshold import DEFAULT_CHUNK, validate_engine


class SelectionResult(NamedTuple):
    sol_ids: torch.Tensor       # (k,) int32 global element ids, -1 padded
    sol_size: torch.Tensor      # () int32
    value: torch.Tensor         # () f32, f(S)
    n_dropped: torch.Tensor     # () int32, total buffer overflow (0 whp)
    tau_fallback: torch.Tensor  # () int32, threshold grids that hit the
    #                             degenerate-sample (+inf) guard


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

    def __post_init__(self):
        validate_engine(self.engine, self.accept, where="MRConfig")
        grids.validate_schedule_kind(self.schedule_kind, where="MRConfig")
        precision_mod.validate(self.precision, where="MRConfig")

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
    of a gathered message, with the degenerate-sample guard.  Returns
    (taus (J,), degenerate () int32)."""
    v = grids.max_singleton(oracle, s_feats, s_valid)
    return grids.tau_grid_from_v(v, cfg.k, cfg.eps, cfg.grid_size())


def _epoch_select(oracle, rr, cfg: MRConfig, epoch_uniforms, epochs: int,
                  kind: str) -> SelectionResult:
    """Unknown-OPT epoch driver: derive the tau grid from epoch 1's sample,
    run every guess's descending schedule as an engine lane, ride the
    Algorithm-7 sparse path through the same rounds, and keep the best
    lane (the first of equal values)."""
    s_cap, _, t_cap = cfg.caps()
    S1, sdrop1 = rr.sample(epoch_uniforms[0], cfg.sample_p, s_cap)
    taus, fb_d = _tau_grid(oracle, cfg, *S1)
    sched = grids.epoch_schedule(taus, epochs, cfg.eps, kind)
    (st_j, sol_j, size_j), drops = run_epochs(
        oracle, rr, sched, epoch_uniforms, cfg, first_sample=(S1, sdrop1))
    dval = oracle.value(st_j)

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


def multi_epoch_sim(oracle, feats_mk, ids_mk, valid_mk, cfg: MRConfig,
                    uniforms=None, generator: Optional[torch.Generator] = None,
                    epochs: Optional[int] = None,
                    schedule_kind: Optional[str] = None
                    ) -> Tuple[SelectionResult, RoundLog]:
    """The paper's multi-epoch driver, OPT unknown: E epochs (2E rounds) of
    descending thresholds, value >= (1 - (1 - 1/(E+1))^E) OPT for the
    paper schedule.  Every tau-grid guess runs its own schedule as an
    engine lane, the Algorithm-7 sparse path rides the same rounds, the
    best lane wins; ``epochs=1`` is two_round_sim.

    feats_mk (m, n/m, d); ids_mk and valid_mk (m, n/m).  ``uniforms``:
    the sample rounds' (E, m, n/m) draws (see ``epoch_uniforms``)."""
    E = cfg.n_epochs(epochs)
    kind = schedule_kind or cfg.schedule_kind
    rr = SimRounds(feats_mk, ids_mk, valid_mk, precision=cfg.precision_policy)
    log = rounds.epoch_round_log(cfg, rr.m, rr.feat_dim, E, with_grid=True,
                                 with_top=True)
    u = epoch_uniforms(uniforms, E, rr.m, rr.n_local, feats_mk.device,
                       generator)
    return _epoch_select(oracle, rr, cfg, u, E, kind), log


def two_round_sim(oracle, feats_mk, ids_mk, valid_mk, cfg: MRConfig,
                  uniforms=None, generator: Optional[torch.Generator] = None
                  ) -> Tuple[SelectionResult, RoundLog]:
    """Theorem 8: Algorithms 6 and 7 in the same two rounds, best of the
    two; the (1/2 - eps) result with no knowledge of OPT.  The 1-epoch
    instantiation of multi_epoch_sim."""
    return multi_epoch_sim(oracle, feats_mk, ids_mk, valid_mk, cfg,
                           uniforms=uniforms, generator=generator, epochs=1)
