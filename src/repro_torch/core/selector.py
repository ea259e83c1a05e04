"""DistributedSelector: the user-facing API for the paper's technique.

It owns oracle construction from a spec, MRConfig derivation and the
driver choice.  The m machines of the MapReduce model are a leading batch
axis on one device (the sim substrate).  The selector runs on the CUDA card
unless the caller passes ``device="cpu"``; with no card and no explicit
device it raises rather than fall back.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core import functions as F
from repro_torch.core import mapreduce as mr
from repro_torch.core import precision as precision_mod
from repro_torch.core.grids import validate_schedule_kind
from repro_torch.core.rounds import epoch_round_log
from repro_torch.core.threshold import validate_engine
from repro_torch.device import resolve_device

#: the OPT-free drivers, which need no OPT estimate or guess loop
ALGORITHMS = ("two_round", "multi_epoch")

#: every oracle of the JAX package
ORACLE_NAMES = ("feature_coverage", "facility_location", "weighted_coverage",
                "saturated_coverage", "graph_cut", "log_det", "exemplar",
                "mutual_information")

#: the oracles the port runs so far
PORTED_ORACLES = ("feature_coverage", "facility_location",
                  "weighted_coverage", "saturated_coverage", "graph_cut",
                  "log_det", "mutual_information")

#: the port's slice that brings each not-yet-ported oracle (ROADMAP.md)
_PENDING_ORACLES = {
    "exemplar": "slice 5 (ExemplarClustering and its two kernels)",
}


@dataclasses.dataclass(frozen=True)
class SelectorSpec:
    k: int
    oracle: str = "feature_coverage"   # see ORACLE_NAMES
    algorithm: str = "two_round"       # see ALGORITHMS
    eps: float = 0.15
    epochs: Optional[int] = None       # multi_epoch levels; None derives
    #                                    ceil(1/eps)
    schedule_kind: str = "paper"       # grids.SCHEDULE_KINDS
    accept: str = "first"
    engine: str = "dense"              # "dense" | "lazy" | "fused"
    chunk: int = 128                   # lazy/fused-engine chunk size
    reference_size: int = 256          # facility location clients (rows of
    #                                    R that a caller draws or keeps)
    saturated_alpha: float = 0.25      # SaturatedCoverage saturation frac
    graph_cut_lam: float = 0.5         # GraphCut redundancy weight lam
    logdet_alpha: float = 1.0          # LogDetDiversity kernel scale alpha
    mi_noise: float = 1.0              # MutualInformationGaussian noise
    use_kernel: bool = False           # route through the CUDA kernels
    precision: str = "f32"             # "f32" | "bf16" storage policy

    def __post_init__(self):
        precision_mod.validate(self.precision, where="SelectorSpec")
        validate_engine(self.engine, self.accept, where="SelectorSpec")
        validate_schedule_kind(self.schedule_kind, where="SelectorSpec")
        if self.algorithm not in ALGORITHMS:
            raise ValueError(f"SelectorSpec: unknown or not yet ported "
                             f"algorithm {self.algorithm!r}; choose from "
                             f"{ALGORITHMS}")

    @property
    def precision_policy(self):
        return precision_mod.resolve(self.precision)


def make_oracle(spec: SelectorSpec, feat_dim: int, device, weights=None,
                reference=None, total=None):
    """Build the spec's oracle on ``device``; ``weights`` are
    FeatureCoverage's optional (d,) feature weights, ``reference`` the
    replicated (r, d) client set that facility_location needs, ``total``
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
    if spec.oracle in _PENDING_ORACLES:
        raise NotImplementedError(
            f"oracle {spec.oracle!r} is not ported to PyTorch yet; it comes "
            f"with {_PENDING_ORACLES[spec.oracle]}")
    raise ValueError(f"unknown oracle {spec.oracle!r}; "
                     f"registered: {ORACLE_NAMES}")


class DistributedSelector:
    """Runs the paper's MapReduce selection with ``n_machines`` simulated
    machines on one device.

    ``select(embeddings)``: embeddings (n_total, feat_dim); returns a
    SelectionResult.  ``n_total`` must be a multiple of ``n_machines``.
    ``reference`` is facility_location's (r, feat_dim) client set; it rides
    at the storage precision, as the JAX selector keeps it.  ``total`` is
    saturated_coverage's and graph_cut's (feat_dim,) ground-set feature
    sum; it is an accumulator statistic and stays float32 whatever the
    storage precision.
    """

    def __init__(self, spec: SelectorSpec, n_total: int, feat_dim: int,
                 n_machines: int = 1, device=None, weights=None,
                 reference=None, total=None):
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
        self.cfg = mr.MRConfig(k=spec.k, n_total=n_total,
                               n_machines=n_machines, eps=spec.eps,
                               accept=spec.accept, engine=spec.engine,
                               chunk=spec.chunk, epochs=spec.epochs,
                               schedule_kind=spec.schedule_kind,
                               precision=spec.precision)
        self.cfg.require_even_shards(where="DistributedSelector")
        self._epochs = 1 if spec.algorithm == "two_round" else None
        self.round_log = epoch_round_log(
            self.cfg, n_machines, feat_dim, self.cfg.n_epochs(self._epochs),
            with_grid=True, with_top=True)

    def select(self, embeddings, generator: Optional[torch.Generator] = None,
               uniforms=None) -> mr.SelectionResult:
        """Select k of the n_total rows.  The sample rounds draw from
        ``generator`` (on the selector's device), or take ``uniforms``, an
        (E, m, n/m) array of U[0, 1) draws."""
        X = torch.as_tensor(embeddings, device=self.device)
        n, d = X.shape
        if n != self.cfg.n_total:
            raise ValueError(f"select: got {n} rows, the selector was built "
                             f"for n_total={self.cfg.n_total}")
        m = self.cfg.n_machines
        ids = torch.arange(n, dtype=torch.int32, device=self.device)
        valid = torch.ones(n, dtype=torch.bool, device=self.device)
        res, _ = mr.multi_epoch_sim(
            self.oracle, X.reshape(m, n // m, d), ids.reshape(m, -1),
            valid.reshape(m, -1), self.cfg, uniforms=uniforms,
            generator=generator, epochs=self._epochs)
        # degenerate-sample and overflow events surface in the round log's
        # runtime counters (device scalars, no sync here)
        self.round_log.note("tau_fallback", res.tau_fallback)
        self.round_log.note("n_dropped", res.n_dropped)
        return res

    def opt_upper_bound(self, embeddings) -> torch.Tensor:
        """k * (max singleton value) >= OPT >= max singleton."""
        X = torch.as_tensor(embeddings, device=self.device)
        st0 = self.oracle.init_state()
        singles = self.oracle.marginals(st0, self.oracle.prep(st0, X))
        return singles.max() * self.spec.k
