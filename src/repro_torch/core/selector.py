"""DistributedSelector: the user-facing API for the paper's technique.

It owns oracle construction from a spec, MRConfig derivation and the
driver choice: the OPT-free two_round and multi_epoch, and the known-OPT
multi_threshold (Algorithm 5) and two_round_known_opt (Algorithm 4), which
take an OPT estimate per select.  ``select_batch`` answers Q queries
(``mapreduce.QueryBatch``) against one corpus.  The m machines of the
MapReduce model are a leading batch axis on one device (the sim
substrate).  The selector runs on the CUDA card unless the caller passes
``device="cpu"``; with no card and no explicit device it raises rather
than fall back.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core import constraints as constraints_mod
from repro_torch.core import functions as F
from repro_torch.core import mapreduce as mr
from repro_torch.core import precision as precision_mod
from repro_torch.core.grids import validate_schedule_kind
from repro_torch.core.rounds import epoch_round_log
from repro_torch.core.threshold import validate_engine
from repro_torch.device import resolve_device

#: every algorithm DistributedSelector runs; the CLI takes its choices
#: from this tuple
ALGORITHMS = ("two_round", "multi_epoch", "multi_threshold",
              "two_round_known_opt")

#: the algorithms that need no OPT estimate or guess loop, the only ones
#: ``select_batch`` runs
OPT_FREE_ALGORITHMS = ("two_round", "multi_epoch")

#: every oracle of the JAX package
ORACLE_NAMES = ("feature_coverage", "facility_location", "weighted_coverage",
                "saturated_coverage", "graph_cut", "log_det", "exemplar",
                "mutual_information")

#: the oracles the port runs: all of them
PORTED_ORACLES = ORACLE_NAMES


@dataclasses.dataclass(frozen=True)
class SelectorSpec:
    k: int
    oracle: str = "feature_coverage"   # see ORACLE_NAMES
    algorithm: str = "two_round"       # see ALGORITHMS
    t: int = 1                         # multi_threshold's thresholds
    eps: float = 0.15
    epochs: Optional[int] = None       # multi_epoch levels; None derives
    #                                    ceil(1/eps)
    schedule_kind: str = "paper"       # grids.SCHEDULE_KINDS
    accept: str = "first"
    engine: str = "dense"              # "dense" | "lazy" | "fused"
    chunk: int = 128                   # lazy/fused-engine chunk size
    reference_size: int = 256          # facility location / exemplar
    #                                    reference rows (rows of R that a
    #                                    caller draws or keeps)
    saturated_alpha: float = 0.25      # SaturatedCoverage saturation frac
    graph_cut_lam: float = 0.5         # GraphCut redundancy weight lam
    logdet_alpha: float = 1.0          # LogDetDiversity kernel scale alpha
    mi_noise: float = 1.0              # MutualInformationGaussian noise
    use_kernel: bool = False           # route through the CUDA kernels
    precision: str = "f32"             # "f32" | "bf16" storage policy
    constraint: str = "cardinality"    # feasibility constraint, see
    #                                    constraints.CONSTRAINT_NAMES; the
    #                                    per-element data (costs / part
    #                                    labels) is a DistributedSelector
    #                                    argument: it belongs to the corpus
    knapsack_budget: Optional[float] = None   # constraint="knapsack" budget

    def __post_init__(self):
        precision_mod.validate(self.precision, where="SelectorSpec")
        constraints_mod.validate_constraint_name(self.constraint,
                                                 where="SelectorSpec")
        validate_engine(self.engine, self.accept, where="SelectorSpec")
        validate_schedule_kind(self.schedule_kind, where="SelectorSpec")
        if self.algorithm not in ALGORITHMS:
            raise ValueError(f"SelectorSpec: unknown algorithm "
                             f"{self.algorithm!r}; choose from {ALGORITHMS}")

    @property
    def precision_policy(self):
        return precision_mod.resolve(self.precision)


def make_oracle(spec: SelectorSpec, feat_dim: int, device, weights=None,
                reference=None, total=None):
    """Build the spec's oracle on ``device``; ``weights`` are
    FeatureCoverage's optional (d,) feature weights, ``reference`` the
    replicated (r, d) client set that facility_location and exemplar need,
    ``total``
    the ground set's (d,) feature sum that saturated_coverage and graph_cut
    need (a corpus statistic, computed once up front).  weighted_coverage
    gets all-ones item weights, as the JAX selector builds it; the log-det
    oracles get k_max = spec.k."""
    if weights is not None and spec.oracle != "feature_coverage":
        raise ValueError(f"weights= applies to feature_coverage only, not "
                         f"{spec.oracle!r}")
    if spec.oracle == "feature_coverage":
        if weights is not None:
            weights = torch.as_tensor(weights, dtype=torch.float32,
                                      device=device)
        return F.FeatureCoverage(feat_dim=feat_dim, weights=weights,
                                 use_kernel=spec.use_kernel,
                                 device=torch.device(device))
    if spec.oracle == "facility_location":
        if reference is None:
            raise ValueError("facility_location needs a reference set "
                             "(reference=, shape (r, feat_dim))")
        return F.FacilityLocation(feat_dim=feat_dim,
                                  reference=torch.as_tensor(reference,
                                                            device=device),
                                  use_kernel=spec.use_kernel,
                                  device=torch.device(device))
    if spec.oracle == "weighted_coverage":
        return F.WeightedCoverage(feat_dim=feat_dim,
                                  use_kernel=spec.use_kernel,
                                  device=torch.device(device))
    if spec.oracle == "saturated_coverage":
        if total is None:
            raise ValueError("saturated_coverage needs the ground set's "
                             "feature sum (total=, shape (feat_dim,))")
        return F.SaturatedCoverage(feat_dim=feat_dim, total=total,
                                   alpha=spec.saturated_alpha,
                                   use_kernel=spec.use_kernel,
                                   device=torch.device(device))
    if spec.oracle == "graph_cut":
        if total is None:
            raise ValueError("graph_cut needs the ground set's feature sum "
                             "(total=, shape (feat_dim,))")
        return F.GraphCut(feat_dim=feat_dim, total=total,
                          lam=spec.graph_cut_lam, use_kernel=spec.use_kernel,
                          device=torch.device(device))
    if spec.oracle == "log_det":
        return F.LogDetDiversity(feat_dim=feat_dim, k_max=spec.k,
                                 alpha=spec.logdet_alpha,
                                 use_kernel=spec.use_kernel,
                                 device=torch.device(device))
    if spec.oracle == "mutual_information":
        return F.MutualInformationGaussian(feat_dim=feat_dim, k_max=spec.k,
                                           noise=spec.mi_noise,
                                           use_kernel=spec.use_kernel,
                                           device=torch.device(device))
    if spec.oracle == "exemplar":
        if reference is None:
            raise ValueError("exemplar needs a reference set "
                             "(reference=, shape (r, feat_dim))")
        return F.ExemplarClustering(feat_dim=feat_dim,
                                    reference=torch.as_tensor(reference,
                                                              device=device),
                                    use_kernel=spec.use_kernel,
                                    device=torch.device(device))
    raise ValueError(f"unknown oracle {spec.oracle!r}; "
                     f"registered: {ORACLE_NAMES}")


class DistributedSelector:
    """Runs the paper's MapReduce selection with ``n_machines`` simulated
    machines on one device.

    ``select(embeddings)``: embeddings (n_total, feat_dim); returns a
    SelectionResult.  ``n_total`` must be a multiple of ``n_machines``.
    ``reference`` is facility_location's and exemplar's (r, feat_dim)
    reference set; it rides at the storage precision, as the JAX selector
    keeps it.  ``total`` is saturated_coverage's and graph_cut's
    (feat_dim,) ground-set feature sum; it is an accumulator statistic and
    stays float32 whatever the storage precision.  ``element_costs``
    (n_total,) are the knapsack's per-element costs (``spec.constraint ==
    "knapsack"``, with ``spec.knapsack_budget``); ``parts`` (n_total,) and
    ``part_caps`` (P,) the partition matroid's labels and capacities.
    """

    def __init__(self, spec: SelectorSpec, n_total: int, feat_dim: int,
                 n_machines: int = 1, device=None, weights=None,
                 reference=None, total=None, element_costs=None, parts=None,
                 part_caps=None):
        self.spec = spec
        self.device = resolve_device(device)
        if reference is not None:
            reference = spec.precision_policy.cast_storage(
                torch.as_tensor(reference, device=self.device)).contiguous()
        if total is not None:
            total = torch.as_tensor(total, dtype=torch.float32,
                                    device=self.device)
        self.oracle = make_oracle(spec, feat_dim, self.device, weights,
                                  reference, total)
        # the constraint marries the spec's knob (name, budget) to the
        # corpus's per-element data, which only the selector sees
        self.constraint = constraints_mod.make_constraint(
            spec.constraint, n_total, costs=element_costs,
            budget=spec.knapsack_budget, parts=parts, capacities=part_caps,
            device=self.device)
        self.cfg = mr.MRConfig(k=spec.k, n_total=n_total,
                               n_machines=n_machines, eps=spec.eps,
                               accept=spec.accept, engine=spec.engine,
                               chunk=spec.chunk, epochs=spec.epochs,
                               schedule_kind=spec.schedule_kind,
                               precision=spec.precision,
                               constraint=self.constraint)
        self.cfg.require_even_shards(where="DistributedSelector")
        self._epochs = 1 if spec.algorithm == "two_round" else None
        # each algorithm's log is the one its sim driver returns; every
        # message carries the constraint's plane columns
        d_msg = feat_dim + self.cfg.constraint_planes
        if spec.algorithm == "multi_threshold":
            self.round_log = epoch_round_log(self.cfg, n_machines, d_msg,
                                             spec.t, level_suffix=True)
        elif spec.algorithm == "two_round_known_opt":
            self.round_log = epoch_round_log(self.cfg, n_machines, d_msg, 1)
        else:
            self.round_log = epoch_round_log(
                self.cfg, n_machines, d_msg, self.cfg.n_epochs(self._epochs),
                with_grid=True, with_top=True)
        self._batch_logs = {}      # Q -> RoundLog (its events accumulate)
        self.round_log_batch = None

    def _shards(self, embeddings, where: str):
        """The corpus as the sim drivers take it: (m, n/m, d) rows, ids and
        validity, on the selector's device."""
        X = torch.as_tensor(embeddings, device=self.device)
        n, d = X.shape
        if n != self.cfg.n_total:
            raise ValueError(f"{where}: got {n} rows, the selector was built "
                             f"for n_total={self.cfg.n_total}")
        m = self.cfg.n_machines
        ids = torch.arange(n, dtype=torch.int32, device=self.device)
        valid = torch.ones(n, dtype=torch.bool, device=self.device)
        return (X.reshape(m, n // m, d), ids.reshape(m, -1),
                valid.reshape(m, -1))

    def select(self, embeddings, opt_estimate=None,
               generator: Optional[torch.Generator] = None,
               uniforms=None) -> mr.SelectionResult:
        """Select k of the n_total rows.  The known-OPT algorithms need
        ``opt_estimate`` (a float, or a 0-d tensor); the OPT-free ones
        ignore it.  The sample rounds draw from ``generator`` (on the
        selector's device), or take ``uniforms``, an (E, m, n/m) array of
        U[0, 1) draws (E = t for multi_threshold, 1 for
        two_round_known_opt)."""
        shards = self._shards(embeddings, "select")
        algorithm = self.spec.algorithm
        if algorithm in OPT_FREE_ALGORITHMS:
            res, _ = mr.multi_epoch_sim(self.oracle, *shards, self.cfg,
                                        uniforms=uniforms,
                                        generator=generator,
                                        epochs=self._epochs)
        elif opt_estimate is None:
            raise ValueError(f"select: {algorithm} needs an OPT estimate "
                             f"(opt_estimate=)")
        elif algorithm == "multi_threshold":
            res, _ = mr.multi_threshold_sim(self.oracle, *shards,
                                            float(opt_estimate), self.spec.t,
                                            self.cfg, uniforms=uniforms,
                                            generator=generator)
        else:
            res, _ = mr.two_round_known_opt_sim(self.oracle, *shards,
                                                float(opt_estimate), self.cfg,
                                                uniforms=uniforms,
                                                generator=generator)
        # degenerate-sample and overflow events surface in the round log's
        # runtime counters (device scalars, no sync here)
        self.round_log.note("tau_fallback", res.tau_fallback)
        self.round_log.note("n_dropped", res.n_dropped)
        return res

    def select_batch(self, embeddings, queries: mr.QueryBatch,
                     generator: Optional[torch.Generator] = None,
                     uniforms=None) -> mr.SelectionResult:
        """Answer Q queries (budgets queries.k <= spec.k, and the oracle
        hyper-parameters they rebind) against one corpus: one shared sample
        round and one gather round (``mapreduce.two_round_batch_sim``, the
        two_round pipeline whatever the OPT-free algorithm).  Returns a
        SelectionResult whose fields carry a leading (Q,) axis.  One
        RoundLog per Q is kept and reused as ``round_log_batch``, so its
        tau_fallback and n_dropped counters add up over calls."""
        if self.spec.algorithm not in OPT_FREE_ALGORITHMS:
            raise ValueError(f"select_batch: needs an OPT-free algorithm "
                             f"{OPT_FREE_ALGORITHMS}, not "
                             f"{self.spec.algorithm!r}")
        k_max = int(queries.k.max())
        if k_max > self.spec.k:
            raise ValueError(f"select_batch: a query's budget {k_max} exceeds "
                             f"the solution buffer spec.k={self.spec.k}")
        res, log = mr.two_round_batch_sim(
            self.oracle, *self._shards(embeddings, "select_batch"), queries,
            self.cfg, uniforms=uniforms, generator=generator)
        self.round_log_batch = self._batch_logs.setdefault(
            queries.n_queries, log)
        self.round_log_batch.note("tau_fallback", res.tau_fallback.sum())
        self.round_log_batch.note("n_dropped", res.n_dropped.sum())
        return res

    def opt_upper_bound(self, embeddings) -> torch.Tensor:
        """k * (max singleton value) >= OPT >= max singleton."""
        X = torch.as_tensor(embeddings, device=self.device)
        st0 = self.oracle.init_state()
        singles = self.oracle.marginals(st0, self.oracle.prep(st0, X))
        return singles.max() * self.spec.k
