"""DistributedSelector: the user-facing API for the paper's technique.

It owns oracle construction from a spec, MRConfig derivation and the
driver choice: the OPT-free two_round and multi_epoch, and the known-OPT
multi_threshold (Algorithm 5) and two_round_known_opt (Algorithm 4), which
take an OPT estimate per select.  ``select_batch`` answers Q queries
(``mapreduce.QueryBatch``) against one corpus.

Without a mesh the m machines of the MapReduce model are a leading batch
axis on one device (the sim substrate).  With ``mesh=`` (a
``launch.mesh.Mesh``) every rank of the job is one machine of the mesh's
machine axes and runs the ``*_mesh`` drivers on its shard of the corpus;
with ``spec.oracle_tp`` and a model axis larger than 1 the coverage
oracles split their features over it (``functions.TPOracle``).  Every rank
returns the same result.  ``spec.faults`` runs either substrate under a
fault plan (``core/faults.py``).  The selector runs on the CUDA card
unless the caller passes ``device="cpu"``; with no card and no explicit
device it raises rather than fall back.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core import constraints as constraints_mod
from repro_torch.core import faults as faults_mod
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
    oracle_tp: bool = False            # split the coverage oracles'
    #                                    features over the mesh's model
    #                                    axis (functions.TPOracle)
    faults: Optional[faults_mod.FaultPlan] = None   # chaos schedule;
    #                                    None runs the bare substrate

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


#: the oracles whose features a TPOracle can split over the model axis
TP_ORACLES = ("feature_coverage", "weighted_coverage")


class DistributedSelector:
    """Runs the paper's MapReduce selection: with ``n_machines`` simulated
    machines on one device, or on ``mesh``, one machine a rank.

    ``select(embeddings)``: embeddings (n_total, feat_dim), or on a mesh
    this rank's shard of them (``data_sharding``); returns a
    SelectionResult.
    ``n_total`` must be a multiple of the machine count.  ``reference`` is
    facility_location's and exemplar's (r, feat_dim) reference set; it
    rides at the storage precision, as the JAX selector keeps it.
    ``total`` is saturated_coverage's and graph_cut's (feat_dim,)
    ground-set feature sum; it is an accumulator statistic and stays
    float32 whatever the storage precision.  ``element_costs`` (n_total,)
    are the knapsack's per-element costs (``spec.constraint ==
    "knapsack"``, with ``spec.knapsack_budget``); ``parts`` (n_total,) and
    ``part_caps`` (P,) the partition matroid's labels and capacities.

    On a mesh the machines are the mesh's ``axes`` (those it has) and
    ``n_machines`` is their size; the tensor-parallel oracle applies when
    ``spec.oracle_tp``, the model axis is larger than 1, it divides
    ``feat_dim`` and the oracle is one of ``TP_ORACLES``.
    """

    def __init__(self, spec: SelectorSpec, n_total: int, feat_dim: int,
                 n_machines: int = 1, device=None, weights=None,
                 reference=None, total=None, element_costs=None, parts=None,
                 part_caps=None, mesh=None, axes=("data",)):
        self.spec = spec
        self.device = resolve_device(device)
        self.mesh = mesh
        if reference is not None:
            reference = spec.precision_policy.cast_storage(
                torch.as_tensor(reference, device=self.device)).contiguous()
        if total is not None:
            total = torch.as_tensor(total, dtype=torch.float32,
                                    device=self.device)
        self.feat_dim = feat_dim
        self._weights, self.reference, self.total = weights, reference, total
        tp = 1 if mesh is None else mesh.tp
        self.tp = (mesh is not None and spec.oracle_tp and tp > 1
                   and feat_dim % tp == 0 and spec.oracle in TP_ORACLES)
        if self.tp:
            cols = self._cols()
            w = (None if weights is None
                 else torch.as_tensor(weights, device=self.device)[cols])
            self.oracle = F.TPOracle(
                base=make_oracle(spec, feat_dim // tp, self.device, w),
                group=mesh.group("model"))
        else:
            self.oracle = make_oracle(spec, feat_dim, self.device, weights,
                                      reference, total)
        if mesh is not None:
            self.axes = tuple(a for a in axes if a in mesh.shape)
            n_machines = mesh.size(self.axes)
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
                               constraint=self.constraint,
                               faults=spec.faults)
        self.cfg.require_even_shards(where="DistributedSelector")
        self._epochs = 1 if spec.algorithm == "two_round" else None
        self._batch_logs = {}      # Q -> RoundLog (its events accumulate)
        self.round_log_batch = None
        if mesh is not None:
            self._run, self.round_log = self._mesh_driver()
            self._batch_run = self._batch_round_log = None
            return
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

    def _mesh_driver(self):
        algorithm, mesh = self.spec.algorithm, self.mesh
        if algorithm == "multi_threshold":
            return mr.multi_threshold_mesh(self.oracle, self.cfg, self.spec.t,
                                           mesh, self.axes)
        if algorithm == "two_round_known_opt":
            return mr.two_round_known_opt_mesh(self.oracle, self.cfg, mesh,
                                               self.axes)
        return mr.multi_epoch_mesh(self.oracle, self.cfg, mesh, self.axes,
                                   epochs=self._epochs)

    def _rows(self) -> slice:
        """This rank's rows of the corpus on a mesh."""
        n_loc = self.cfg.n_total // self.cfg.n_machines
        start = self.mesh.index(self.axes) * n_loc
        return slice(start, start + n_loc)

    def _cols(self) -> slice:
        """This rank's feature columns (all of them without the
        tensor-parallel oracle)."""
        if not self.tp:
            return slice(0, self.feat_dim)
        w = self.feat_dim // self.mesh.tp
        start = self.mesh.coords["model"] * w
        return slice(start, start + w)

    def data_sharding(self, embeddings) -> torch.Tensor:
        """This rank's shard of the global (n_total, feat_dim) corpus: its
        machine's rows, and its column block under the tensor-parallel
        oracle; contiguous, on the selector's device."""
        X = torch.as_tensor(embeddings, device=self.device)
        self._check_rows(X, self.cfg.n_total, "data_sharding")
        return X[self._rows(), self._cols()].contiguous()

    def _check_rows(self, X, n: int, where: str) -> None:
        if X.shape[0] != n:
            raise ValueError(f"{where}: got {X.shape[0]} rows, expected {n} "
                             f"(the selector was built for n_total="
                             f"{self.cfg.n_total})")

    def _local(self, shard, where: str):
        """This rank's shard, checked, and its rows' global ids."""
        X = torch.as_tensor(shard, device=self.device)
        rows, cols = self._rows(), self._cols()
        want = (rows.stop - rows.start, cols.stop - cols.start)
        if tuple(X.shape) != want:
            raise ValueError(f"{where}: on a mesh, pass this rank's shard "
                             f"{want} (data_sharding), got {tuple(X.shape)}")
        ids = torch.arange(rows.start, rows.stop, dtype=torch.int32,
                           device=self.device)
        return X, ids

    def _shards(self, embeddings, where: str):
        """The corpus as the sim drivers take it: (m, n/m, d) rows, ids and
        validity, on the selector's device."""
        X = torch.as_tensor(embeddings, device=self.device)
        self._check_rows(X, self.cfg.n_total, where)
        n, d = X.shape
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
        selector's device; every rank of a mesh seeds it alike), or take
        ``uniforms``, an (E, m, n/m) array of U[0, 1) draws (E = t for
        multi_threshold, 1 for two_round_known_opt); a mesh rank keeps its
        machine's rows."""
        algorithm = self.spec.algorithm
        needs_opt = algorithm not in OPT_FREE_ALGORITHMS
        if needs_opt and opt_estimate is None:
            raise ValueError(f"select: {algorithm} needs an OPT estimate "
                             f"(opt_estimate=)")
        draws = dict(uniforms=uniforms, generator=generator)
        if self.mesh is not None:
            X, ids = self._local(embeddings, "select")
            opt = (opt_estimate,) if needs_opt else ()
            res = self._run(X, ids, *opt, **draws)
        else:
            shards = self._shards(embeddings, "select")
            if not needs_opt:
                res, log = mr.multi_epoch_sim(self.oracle, *shards, self.cfg,
                                              epochs=self._epochs, **draws)
            elif algorithm == "multi_threshold":
                res, log = mr.multi_threshold_sim(
                    self.oracle, *shards, float(opt_estimate), self.spec.t,
                    self.cfg, **draws)
            else:
                res, log = mr.two_round_known_opt_sim(
                    self.oracle, *shards, float(opt_estimate), self.cfg,
                    **draws)
            # the plan realizes the same faults on every call
            self.round_log.faults[:] = log.faults
        # degenerate-sample, overflow and fault events surface in the round
        # log's runtime counters (device scalars, no sync here)
        self.round_log.note("tau_fallback", res.tau_fallback)
        self.round_log.note("n_dropped", res.n_dropped)
        self.round_log.note("degraded_selects", res.degraded)
        return res

    def select_batch(self, embeddings, queries: mr.QueryBatch,
                     generator: Optional[torch.Generator] = None,
                     uniforms=None) -> mr.SelectionResult:
        """Answer Q queries (budgets queries.k <= spec.k, and the oracle
        hyper-parameters they rebind) against one corpus: one shared sample
        round and one gather round (``two_round_batch_sim`` or
        ``two_round_batch_mesh``, the two_round pipeline whatever the
        OPT-free algorithm).  Returns a SelectionResult whose fields carry
        a leading (Q,) axis.  One RoundLog per Q is kept and reused as
        ``round_log_batch``, so its counters add up over calls."""
        if self.spec.algorithm not in OPT_FREE_ALGORITHMS:
            raise ValueError(f"select_batch: needs an OPT-free algorithm "
                             f"{OPT_FREE_ALGORITHMS}, not "
                             f"{self.spec.algorithm!r}")
        k_max = int(queries.k.max())
        if k_max > self.spec.k:
            raise ValueError(f"select_batch: a query's budget {k_max} exceeds "
                             f"the solution buffer spec.k={self.spec.k}")
        Q = queries.n_queries
        draws = dict(uniforms=uniforms, generator=generator)
        if self.mesh is not None:
            if self._batch_run is None:
                self._batch_run, self._batch_round_log = \
                    mr.two_round_batch_mesh(self.oracle, self.cfg, self.mesh,
                                            self.axes)
            if Q not in self._batch_logs:
                self._batch_logs[Q] = self._batch_round_log(Q)
            res = self._batch_run(*self._local(embeddings, "select_batch"),
                                  queries, **draws)
        else:
            res, log = mr.two_round_batch_sim(
                self.oracle, *self._shards(embeddings, "select_batch"),
                queries, self.cfg, **draws)
            self._batch_logs.setdefault(Q, log).faults[:] = log.faults
        self.round_log_batch = self._batch_logs[Q]
        self.round_log_batch.note("tau_fallback", res.tau_fallback.sum())
        self.round_log_batch.note("n_dropped", res.n_dropped.sum())
        self.round_log_batch.note("degraded_selects", res.degraded)
        return res

    def runtime_events(self) -> dict:
        """The runtime counters (tau_fallback, n_dropped, degraded_selects)
        summed over every select and select_batch this selector served,
        merged with the fault records as ``fault_*`` keys
        (``RoundLog.fault_events``); the one place the device scalars are
        read."""
        out: dict = {}
        seen_faults = set()
        for log in (self.round_log, *self._batch_logs.values()):
            for name, v in log.events.items():
                out[name] = out.get(name, 0) + int(v)
            # the mesh's batch logs share one fault list: count it once
            if id(log.faults) in seen_faults:
                continue
            seen_faults.add(id(log.faults))
            for name, v in log.fault_events().items():
                key = f"fault_{name}"
                if name == "min_eff_machines":
                    out[key] = min(out.get(key, v), v)
                else:
                    out[key] = out.get(key, 0) + v
        return out

    def opt_upper_bound(self, embeddings) -> torch.Tensor:
        """k * (max singleton value) >= OPT >= max singleton, over the
        global (n_total, feat_dim) corpus.  Under the tensor-parallel
        oracle it rebuilds the full-width oracle, since the sum over the
        model axis has no place outside the drivers."""
        X = torch.as_tensor(embeddings, device=self.device)
        oracle = self.oracle
        if self.tp:
            oracle = make_oracle(self.spec, X.shape[-1], self.device,
                                 self._weights, self.reference, self.total)
        st0 = oracle.init_state()
        singles = oracle.marginals(st0, oracle.prep(st0, X))
        return singles.max() * self.spec.k
