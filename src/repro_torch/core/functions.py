"""Monotone submodular objective oracles on tensors, with a lane axis.

As in the JAX package, each oracle is state-based: the current solution S
is summarized by a compact ``state`` tensor, ``marginals(state, aux)``
scores a whole block of candidates at once, and ``add`` folds one element
into the state.  The engines run a whole grid of thresholds at once, so
every method also takes a leading lane axis L: a state of shape (L, w)
holds one solution per lane, and a candidate block is either shared by
every lane, (C, d), or held per lane, (L, C, d).  An unbatched state (w,)
with a (C, d) block is the plain single-solution call.  The state width w
is the oracle's own: d for FeatureCoverage, SaturatedCoverage and GraphCut,
the universe size for WeightedCoverage (whose feature rows are incidence
rows), the reference-set size r for FacilityLocation.  LogDetDiversity and
MutualInformationGaussian keep a tuple state, (U (L, k_max, d), logdet
(L,), size (L,)), each member with the lane axis (``repro_torch.states``
selects and maps such states).

Oracles ported so far: FeatureCoverage, FacilityLocation, WeightedCoverage,
SaturatedCoverage, GraphCut, LogDetDiversity and MutualInformationGaussian.
ExemplarClustering arrives with a later slice of the port (see
ROADMAP.md).

Every oracle lives on the CUDA card unless it is built with
``device="cpu"``; without a card and without that argument it raises (the
same rule as the selector, ``repro_torch.device.resolve_device``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import ops, ref


class SubmodularOracle:
    """Protocol (duck-typed) for lane-batched submodular oracles.

    Precision contract: feature rows may arrive in the storage dtype (f32 or
    bf16); gains, states and values are always f32.

    feat_dim:     width of an element's feature row.
    device:       where the oracle's states and weights live.
    use_kernel:   route the hot calls through the CUDA kernels (CUDA
                  tensors) or their plain versions (CPU tensors).
    init_state(lanes=None):   state for S = {}: (w,), or (lanes, w) (a
                  tuple of such tensors for the log-det oracles).
    prep(state, cand_feats):  per-candidate aux, computed once per block.
    marginals(state, aux):    gains f_S(e) for the block: (C,) or (L, C).
    chunk_marginals(state, cand_feats): gains straight from features (the
                  lazy engine's and the filter's streaming path).
    chunk_accept(state, cand_feats, eligible, tau, budget): the fused
                  engine's path.  Runs Algorithm 1's accept loop over each
                  lane's (B, d) chunk in stream order and returns (mask
                  (L, B) bool, new_state, gains (L, B) f32).  The default
                  is a row scan (correct for every oracle); kerneled
                  oracles override it with one sweep kernel.
    add(state, aux_row):      state for S + {e}.
    value(state):             f(S): () or (L,).
    """

    feat_dim: int
    use_kernel: bool = False

    def init_state(self, lanes: Optional[int] = None):  # pragma: no cover
        raise NotImplementedError

    def prep(self, state, cand_feats):
        return cand_feats

    def chunk_marginals(self, state, cand_feats):
        return self.marginals(state, self.prep(state, cand_feats))

    def chunk_accept(self, state, cand_feats, eligible, tau, budget):
        """Sequential threshold-accept sweep over one (L, B, d) chunk per
        lane: row i's gain is its fresh marginal against the state after
        every earlier accepted row; it is accepted when eligible & gain >=
        tau & accepts-so-far < budget, and accepted rows update the state.
        The gains are valid stale upper bounds for the lazy buffer."""
        aux = self.prep(state, cand_feats)
        return ref.accept_scan(
            lambda st, row: self.marginals(st, row[:, None])[:, 0],
            self.add, aux, state, eligible, tau, budget)

    def marginals(self, state, aux):  # pragma: no cover - interface
        raise NotImplementedError

    def add(self, state, aux_row):  # pragma: no cover - interface
        raise NotImplementedError

    def value(self, state):  # pragma: no cover - interface
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class FeatureCoverage(SubmodularOracle):
    """f(S) = sum_f w_f sqrt(sum_{e in S} x_{e,f}),  x >= 0.

    Concave over modular, hence monotone submodular.  The state is the
    modular accumulator (d,), so "ship G to every machine" is a d-float
    message.
    """

    feat_dim: int
    weights: Optional[torch.Tensor] = None  # optional (d,) nonneg f32
    use_kernel: bool = False
    device: Optional[torch.device] = None   # None: the CUDA card

    def __post_init__(self):
        object.__setattr__(self, "device", resolve_device(self.device))

    def init_state(self, lanes: Optional[int] = None):
        shape = (self.feat_dim,) if lanes is None else (lanes, self.feat_dim)
        return torch.zeros(shape, dtype=torch.float32, device=self.device)

    def marginals(self, state, aux):
        if self.use_kernel:
            return ops.coverage_marginals(aux.contiguous(), state.contiguous(),
                                          self.weights)
        return ref.coverage_marginals(aux, state, self.weights)

    def chunk_accept(self, state, cand_feats, eligible, tau, budget):
        if self.use_kernel:
            return ops.coverage_accept(cand_feats.contiguous(),
                                       state.contiguous(), self.weights,
                                       eligible.contiguous(), tau, budget)
        return super().chunk_accept(state, cand_feats, eligible, tau, budget)

    def add(self, state, aux_row):
        return state + aux_row

    def value(self, state):
        v = torch.sqrt(state)
        if self.weights is not None:
            v = v * self.weights
        return v.sum(-1)


@dataclasses.dataclass(frozen=True)
class FacilityLocation(SubmodularOracle):
    """f(S) = sum_{v in R} max(0, max_{e in S} <x_v, x_e>).

    ``reference`` is a replicated client set R (r, d), in the storage dtype
    (the selector casts it, as the JAX selector does).  The state is the
    cover vector (r,).  ``prep`` computes the (C, r) rectified similarity
    block once per block; ``chunk_marginals`` and ``chunk_accept`` compute
    their similarities inside the kernels, so the (C, r) block never
    reaches device memory on those paths.
    """

    feat_dim: int
    reference: Optional[torch.Tensor] = None  # (r, d)
    use_kernel: bool = False
    device: Optional[torch.device] = None     # None: the CUDA card

    def __post_init__(self):
        if self.reference is None:
            raise ValueError("FacilityLocation needs a reference set (r, d)")
        dev = resolve_device(self.device)
        ref_ = torch.as_tensor(self.reference, device=dev).contiguous()
        if ref_.dim() != 2 or ref_.shape[1] != self.feat_dim:
            raise ValueError(f"FacilityLocation: reference must be (r, "
                             f"{self.feat_dim}), got {tuple(ref_.shape)}")
        object.__setattr__(self, "device", dev)
        object.__setattr__(self, "reference", ref_)
        # the f32 copy the products read (exact for a bf16 reference)
        object.__setattr__(self, "_ref32", ref_.float())

    def init_state(self, lanes: Optional[int] = None):
        r = self.reference.shape[0]
        shape = (r,) if lanes is None else (lanes, r)
        return torch.zeros(shape, dtype=torch.float32, device=self.device)

    def prep(self, state, cand_feats):
        # f32 operands: a bf16 x bf16 matmul would round every similarity
        # to bf16, where the JAX package accumulates and returns f32
        return ref.similarities(cand_feats, self._ref32)

    def marginals(self, state, aux):
        if self.use_kernel:
            return ops.rectified_residual_sum(aux.contiguous(),
                                              state.contiguous())
        return ref.rectified_residual_sum(aux, state)

    def chunk_marginals(self, state, cand_feats):
        if self.use_kernel:
            return ops.facility_marginals(cand_feats.contiguous(), self._ref32,
                                          state.contiguous())
        return self.marginals(state, self.prep(state, cand_feats))

    def chunk_accept(self, state, cand_feats, eligible, tau, budget):
        if self.use_kernel:
            return ops.facility_accept(cand_feats.contiguous(), self._ref32,
                                       state.contiguous(),
                                       eligible.contiguous(), tau, budget)
        return super().chunk_accept(state, cand_feats, eligible, tau, budget)

    def add(self, state, aux_row):
        return torch.maximum(state, aux_row)

    def value(self, state):
        return state.sum(-1)


def _feature_operand(t, feat_dim, device, what):
    """An optional per-feature operand as a contiguous float32 (feat_dim,)
    tensor on ``device`` (None stays None)."""
    if t is None:
        return None
    t = torch.as_tensor(t, dtype=torch.float32, device=device).contiguous()
    if t.shape != (feat_dim,):
        raise ValueError(f"{what} must be ({feat_dim},), got {tuple(t.shape)}")
    return t


@dataclasses.dataclass(frozen=True)
class WeightedCoverage(SubmodularOracle):
    """Weighted max-coverage: element e covers universe item u when
    x[e, u] = 1, and f(S) is the weight of the items S covers.

    The feature row is an incidence row over the universe of ``feat_dim``
    items.  The state is the remaining (uncovered) weight per item, so it
    starts at the weights, not at zeros; the marginal is the remaining
    weight a row picks up, sum_u s_u x_u, and an accept applies
    s = s (1 - x).
    """

    feat_dim: int                           # universe size
    weights: Optional[torch.Tensor] = None  # (U,) item weights; None: ones
    use_kernel: bool = False
    device: Optional[torch.device] = None   # None: the CUDA card

    def __post_init__(self):
        dev = resolve_device(self.device)
        w = _feature_operand(self.weights, self.feat_dim, dev, "weights")
        if w is None:
            w = torch.ones(self.feat_dim, dtype=torch.float32, device=dev)
        object.__setattr__(self, "device", dev)
        object.__setattr__(self, "weights", w)

    def init_state(self, lanes: Optional[int] = None):
        # a fresh contiguous copy: the kernels refuse an expanded view, and
        # the state must never alias the weights
        if lanes is None:
            return self.weights.clone()
        return self.weights.repeat(lanes, 1)

    def marginals(self, state, aux):
        if self.use_kernel:
            return ops.weighted_coverage_marginals(aux.contiguous(),
                                                   state.contiguous())
        return ref.weighted_coverage_marginals(aux, state)

    def chunk_accept(self, state, cand_feats, eligible, tau, budget):
        if self.use_kernel:
            return ops.weighted_coverage_accept(cand_feats.contiguous(),
                                                state.contiguous(),
                                                eligible.contiguous(), tau,
                                                budget)
        return super().chunk_accept(state, cand_feats, eligible, tau, budget)

    def add(self, state, aux_row):
        # s (1 - x), not s - s x: exact (0 or s) on binary incidence rows
        return state * (1.0 - aux_row)

    def value(self, state):
        return self.weights.sum() - state.sum(-1)


@dataclasses.dataclass(frozen=True)
class SaturatedCoverage(SubmodularOracle):
    """f(S) = sum_f w_f min(sum_{e in S} x_{e,f}, alpha * total_f), x >= 0.

    Coverage that saturates at a fraction ``alpha`` of the ground set's
    per-feature total (cf. Krause-Guestrin SATURATE); min(., cap) is
    concave nondecreasing, so the composition with the modular accumulator
    is monotone submodular.  ``total`` is a corpus-level statistic computed
    once up front by the caller, kept in float32; cap = alpha * total is
    one float32 multiply, as in the JAX package.  The state is the O(d)
    accumulator.
    """

    feat_dim: int
    total: Optional[torch.Tensor] = None    # (d,) sum of all element rows
    alpha: float = 0.25                     # saturation fraction of total
    weights: Optional[torch.Tensor] = None  # optional (d,) nonneg f32
    use_kernel: bool = False
    device: Optional[torch.device] = None   # None: the CUDA card

    def __post_init__(self):
        if self.total is None:
            raise ValueError("SaturatedCoverage needs the ground set's "
                             "feature sum (total, shape (feat_dim,))")
        dev = resolve_device(self.device)
        total = _feature_operand(self.total, self.feat_dim, dev, "total")
        object.__setattr__(self, "device", dev)
        object.__setattr__(self, "total", total)
        object.__setattr__(self, "weights", _feature_operand(
            self.weights, self.feat_dim, dev, "weights"))
        object.__setattr__(self, "cap", total * torch.tensor(
            self.alpha, dtype=torch.float32, device=dev))

    def init_state(self, lanes: Optional[int] = None):
        shape = (self.feat_dim,) if lanes is None else (lanes, self.feat_dim)
        return torch.zeros(shape, dtype=torch.float32, device=self.device)

    def marginals(self, state, aux):
        if self.use_kernel:
            return ops.saturated_coverage_marginals(
                aux.contiguous(), state.contiguous(), self.cap, self.weights)
        return ref.saturated_coverage_marginals(aux, state, self.cap,
                                                self.weights)

    def chunk_accept(self, state, cand_feats, eligible, tau, budget):
        if self.use_kernel:
            return ops.saturated_coverage_accept(
                cand_feats.contiguous(), state.contiguous(), self.cap,
                self.weights, eligible.contiguous(), tau, budget)
        return super().chunk_accept(state, cand_feats, eligible, tau, budget)

    def add(self, state, aux_row):
        return state + aux_row

    def value(self, state):
        v = torch.minimum(state, self.cap)
        if self.weights is not None:
            v = v * self.weights
        return v.sum(-1)


@dataclasses.dataclass(frozen=True)
class GraphCut(SubmodularOracle):
    """Monotone graph cut over the similarity graph w(u, v) = <x_u, x_v>:

        f(S) = sum_{u in V, v in S} w(u, v) - lam sum_{u, v in S} w(u, v)
             = <t, s> - lam ||s||^2

    with s = sum_{v in S} x_v (the O(d) state) and t = ``total``, the
    ground set's feature sum, computed once up front by the caller and
    kept float32.  lam in [0, 1/2] keeps f monotone; it is one scalar,
    kept as a Python float (a NumPy scalar or a 0-d tensor is converted,
    anything else is refused).
    """

    feat_dim: int
    total: Optional[torch.Tensor] = None    # (d,) sum of all element rows
    lam: float = 0.5
    use_kernel: bool = False
    device: Optional[torch.device] = None   # None: the CUDA card

    def __post_init__(self):
        if self.total is None:
            raise ValueError("GraphCut needs the ground set's feature sum "
                             "(total, shape (feat_dim,))")
        try:
            lam = float(self.lam)
        except (TypeError, ValueError) as e:
            raise ValueError(f"GraphCut lam must be one scalar, got "
                             f"{self.lam!r}") from e
        object.__setattr__(self, "lam", lam)
        dev = resolve_device(self.device)
        object.__setattr__(self, "device", dev)
        object.__setattr__(self, "total", _feature_operand(
            self.total, self.feat_dim, dev, "total"))

    def init_state(self, lanes: Optional[int] = None):
        shape = (self.feat_dim,) if lanes is None else (lanes, self.feat_dim)
        return torch.zeros(shape, dtype=torch.float32, device=self.device)

    def marginals(self, state, aux):
        if self.use_kernel:
            return ops.graph_cut_marginals(aux.contiguous(), self.total,
                                           state.contiguous(), self.lam)
        return ref.graph_cut_marginals(aux, self.total, state, self.lam)

    def chunk_accept(self, state, cand_feats, eligible, tau, budget):
        if self.use_kernel:
            return ops.graph_cut_accept(cand_feats.contiguous(), self.total,
                                        state.contiguous(),
                                        eligible.contiguous(), tau, budget,
                                        self.lam)
        return super().chunk_accept(state, cand_feats, eligible, tau, budget)

    def add(self, state, aux_row):
        return state + aux_row

    def value(self, state):
        return state @ self.total - self.lam * (state * state).sum(-1)


class _WhitenedBasis(SubmodularOracle):
    """The log-det geometry shared by LogDetDiversity and
    MutualInformationGaussian: f(S) = scale * log det(I + alpha X_S X_S^T).

    The state is the whitened incremental Cholesky of the JAX package: with
    I + alpha X_S X_S^T = L L^T, U = L^-1 X_S (k_max rows, those at or past
    |S| zero), the running f(S), and |S|.  A candidate's marginal is
    scale * log d2 with v = alpha U x and the Schur complement
    d2 = 1 + alpha ||x||^2 - ||v||^2, and ``add`` is the rank-1 Gram-Schmidt
    append (``ref.logdet_append``).  The marginals follow the JAX oracle's
    order (alpha^2 ||U x||^2), the accept sweep and ``add`` the sweep's
    (v = alpha U x, then ||v||^2).

    ``k_max`` must be at least the cardinality budget (``make_oracle`` sets
    it to SelectorSpec.k).  The dense engine adds every lane's row before
    it selects, so a lane already holding k_max rows sees an append at
    size == k_max: it writes no row of U, as the JAX package's
    out-of-bounds scatter writes none, and the engine discards that state.
    """

    scale = 1.0

    def init_state(self, lanes: Optional[int] = None):
        lead = () if lanes is None else (lanes,)
        dev = self.device
        return (torch.zeros(lead + (self.k_max, self.feat_dim),
                            dtype=torch.float32, device=dev),
                torch.zeros(lead, dtype=torch.float32, device=dev),
                torch.zeros(lead, dtype=torch.int32, device=dev))

    def marginals(self, state, aux):
        U = state[0]
        if self.use_kernel:
            return ops.logdet_marginals(aux.contiguous(), U.contiguous(),
                                        self.alpha, self.scale)
        return ref.logdet_marginals(aux, U, self.alpha, scale=self.scale)

    def chunk_accept(self, state, cand_feats, eligible, tau, budget):
        if self.use_kernel:
            mask, U, logdet, size, gains = ops.logdet_accept(
                cand_feats.contiguous(), *(t.contiguous() for t in state),
                eligible.contiguous(), tau, budget, self.alpha, self.scale)
            return mask, (U, logdet, size), gains
        return super().chunk_accept(state, cand_feats, eligible, tau, budget)

    def add(self, state, aux_row):
        return ref.logdet_append(state, aux_row, self.alpha,
                                 scale=self.scale)

    def value(self, state):
        return state[1]


@dataclasses.dataclass(frozen=True)
class LogDetDiversity(_WhitenedBasis):
    """DPP-style diversity, f(S) = log det(I + alpha X_S X_S^T): monotone
    submodular for any features.  See ``_WhitenedBasis`` for the state."""

    feat_dim: int
    k_max: int = 1
    alpha: float = 1.0
    use_kernel: bool = False
    device: Optional[torch.device] = None   # None: the CUDA card

    def __post_init__(self):
        object.__setattr__(self, "device", resolve_device(self.device))


@dataclasses.dataclass(frozen=True)
class MutualInformationGaussian(_WhitenedBasis):
    """Sensor-placement mutual information under a Gaussian process with
    i.i.d. observation noise of standard deviation ``noise``:

        f(S) = 0.5 log det(I + noise^-2 X_S X_S^T),

    the log-det geometry at alpha = 1 / noise^2 with scale 0.5; it shares
    LogDetDiversity's state and kernels.  At noise 1 it is exactly half of
    LogDetDiversity at alpha 1: the 0.5 scale is a power of two."""

    feat_dim: int
    k_max: int = 1
    noise: float = 1.0
    use_kernel: bool = False
    device: Optional[torch.device] = None   # None: the CUDA card

    scale = 0.5

    def __post_init__(self):
        object.__setattr__(self, "device", resolve_device(self.device))

    @property
    def alpha(self):
        return 1.0 / (self.noise * self.noise)
