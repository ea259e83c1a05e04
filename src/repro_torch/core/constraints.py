"""Feasibility constraints for distributed submodular selection, with a lane
axis.

The paper's drivers are k-cardinality only; the Barbosa-Ene-Nguyen-Ward
framework extends the same two-round / multi-epoch structure to any
hereditary constraint, provided the local ThresholdGreedy loops accept only
elements that keep the running solution feasible.  As in the JAX package
(``repro.core.constraints``):

* ``Cardinality``: the paper's |S| <= k.  No state and no attribute plane;
  every engine treats it as the unconstrained path, so its selections equal
  those of ``constraint=None``.
* ``Knapsack``: per-element costs c_e, a budget B, feasible while
  sum(c_e) <= B.  An element qualifies at threshold tau when
  gain >= tau * c_e (cost-ratio thresholding); with unit costs and B = k it
  is cardinality exactly (tau * 1.0 == tau in f32).  State: the f32 spent
  budget.
* ``PartitionMatroid``: elements carry a part label; part p holds at most
  cap_p elements.  State: the int32 per-part counts.

The engines run a grid of L thresholds at once, so every state carries a
leading lane axis where the engines hold one: a knapsack's spent budget is
(L,) and a partition's counts (L, P); the unbatched forms, () and (P,), are
the single-solution calls (``sequential.greedy``, brute force).
``repro_torch.states.where_state`` selects them per lane.

**The attribute plane.**  The engines never see the constraint's
(n_total,) arrays directly: each constraint packs the per-element
attributes it needs (cost; part id) into ``n_planes`` f32 columns via
``plane(ids)``, and the round drivers concatenate them onto the feature
rows at the storage dtype (``append_plane``), so every pack and gather
ships them and the RoundLog counts a message width of d + n_planes.
``split_plane`` peels them off in front of every oracle call, as a
contiguous copy of the features (the kernels take no strided view).  Under
bf16 storage the plane is rounded like any feature column: costs lose
bits, and part ids stay exact only up to 256 parts.

Monotonicity: the lazy and fused engines drop currently infeasible rows
from their hot set, which is sound because spent budget and part counts
only grow, so infeasible-now is infeasible-forever.
"""

from __future__ import annotations

import dataclasses
from typing import ClassVar, Optional

import torch

#: the constraint registry; the CLI and SelectorSpec choices derive from it
CONSTRAINT_NAMES = ("cardinality", "knapsack", "partition_matroid")


def validate_constraint_name(name: str, where: str = "constraint") -> None:
    if name not in CONSTRAINT_NAMES:
        raise ValueError(f"{where}: unknown constraint {name!r}; "
                         f"choose from {CONSTRAINT_NAMES}")


def split_plane(feats, n_planes: int):
    """Peel the constraint's attribute columns off an augmented block:
    (..., d + p) -> (contiguous (..., d), (..., p) f32).  p == 0 returns the
    block itself and None."""
    if n_planes == 0:
        return feats, None
    return (feats[..., :-n_planes].contiguous(),
            feats[..., -n_planes:].float())


def append_plane(feats, constraint, ids):
    """Concatenate the constraint's attribute columns onto a feature block
    at the block's storage dtype, the inverse of ``split_plane``; the same
    tensor when the constraint carries no plane."""
    if constraint is None or constraint.n_planes == 0:
        return feats
    return torch.cat([feats, constraint.plane(ids).to(feats.dtype)], -1)


def n_planes_of(constraint) -> int:
    return 0 if constraint is None else int(constraint.n_planes)


class Constraint:
    """The feasibility contract.  The defaults are the stateless, plane-less
    (cardinality) case.

    ``fused_mode`` tells the fused engine how its sweep runs:
      * "none": no per-row input; the unconstrained ``chunk_accept``.
      * "cost": a scalar budget over per-row costs; the sweep kernels take
        the (L, B) costs and the (L,) remaining budgets and track the spend
        in their loop (``kernels/csrc/accept_sweep.cuh``).
      * "scan": a vector state (per-part counts) that cannot ride the
        kernels' scalar carry; the engine runs the plain constrained row
        scan (``threshold.constrained_chunk_accept``), as the JAX engine
        runs a ``lax.scan`` outside any Pallas kernel.
    """

    name: ClassVar[str] = "cardinality"
    n_planes: ClassVar[int] = 0
    fused_mode: ClassVar[str] = "none"

    def init_state(self, lanes: Optional[int] = None):
        """Fresh feasibility state, on the device of the constraint's data
        (() or (L,) leading shape): None when stateless."""
        return None

    def plane(self, ids):
        """(...,) int32 global ids -> (..., n_planes) f32 attribute rows.
        Invalid ids (-1 padding) map to any row; validity masks gate
        them."""
        return torch.zeros(ids.shape + (0,), dtype=torch.float32,
                           device=ids.device)

    def eligible(self, cstate, plane):
        """Could each row of ``plane`` ((C, n_planes) shared, or
        (L, C, n_planes) per lane) be admitted under ``cstate`` (unbatched,
        or with a leading lane axis L)?  Returns (C,) or (L, C) bool;
        monotone in the state."""
        return torch.ones(plane.shape[:-1], dtype=torch.bool,
                          device=plane.device)

    def row_tau(self, tau, plane):
        """The per-row accept threshold at level ``tau`` (() or (L,)) for
        rows ``plane`` (..., C, n_planes), broadcastable against (L, C):
        tau itself with a trailing unit axis, scaled by the row's cost
        for a cost-ratio constraint."""
        return tau.unsqueeze(-1)

    def add(self, cstate, plane_row):
        """Account one accepted element's (n_planes,) or (L, n_planes)
        plane row into the state, unconditionally."""
        return cstate

    def admit(self, cstate, plane_row):
        """The one-element contract on an unbatched state: (ok () bool,
        cstate with the element accounted iff ok)."""
        ok = self.eligible(cstate, plane_row[None])[0]
        new = self.add(cstate, plane_row)
        return ok, torch.where(ok, new, cstate)

    # the fused engine's cost mode (fused_mode == "cost" only)
    def fused_cost(self, plane):
        """(..., n_planes) -> (...,) f32 per-row cost."""
        raise NotImplementedError

    def fused_cost_budget(self, cstate):
        """The remaining cost budget, shaped like the state."""
        raise NotImplementedError

    def fused_spend(self, cstate, delta):
        """Account ``delta`` (shaped like the state) of accepted cost."""
        raise NotImplementedError


@dataclasses.dataclass(frozen=True, eq=False)
class Cardinality(Constraint):
    """|S| <= k, the paper's own constraint.  Stateless and plane-less: the
    k-slot budget is enforced by every engine already, so selections equal
    those of ``constraint=None``."""


@dataclasses.dataclass(frozen=True, eq=False)
class Knapsack(Constraint):
    """sum of per-element costs <= budget, with cost-ratio thresholding.

    ``costs`` is the (n_total,) f32 per-element cost tensor (positive) and
    ``budget`` the Python float B.  State: the spent budget, f32, () or
    (L,).  A row qualifies at threshold tau when gain >= tau * cost and is
    feasible while spent + cost <= B, both in f32 as the JAX package
    computes them."""

    budget: float
    costs: torch.Tensor                # (n_total,) f32
    name: ClassVar[str] = "knapsack"
    n_planes: ClassVar[int] = 1
    fused_mode: ClassVar[str] = "cost"

    def __post_init__(self):
        object.__setattr__(self, "budget32", torch.tensor(
            self.budget, dtype=torch.float32, device=self.costs.device))

    def init_state(self, lanes: Optional[int] = None):
        shape = () if lanes is None else (lanes,)
        return torch.zeros(shape, dtype=torch.float32,
                           device=self.costs.device)

    def plane(self, ids):
        i = ids.long().clamp(0, self.costs.shape[0] - 1)
        return self.costs[i][..., None]

    def eligible(self, cstate, plane):
        return cstate.unsqueeze(-1) + plane[..., 0] <= self.budget32

    def row_tau(self, tau, plane):
        return tau.unsqueeze(-1) * plane[..., 0]

    def add(self, cstate, plane_row):
        return cstate + plane_row[..., 0]

    def fused_cost(self, plane):
        return plane[..., 0]

    def fused_cost_budget(self, cstate):
        return self.budget32 - cstate

    def fused_spend(self, cstate, delta):
        return cstate + delta


@dataclasses.dataclass(frozen=True, eq=False)
class PartitionMatroid(Constraint):
    """Per-part capacities: an element of part p is feasible while the
    solution holds fewer than cap_p elements of that part.

    ``capacities`` is the (P,) int32 cap tensor and ``parts`` the
    (n_total,) int32 part labels.  State: the int32 counts, (P,) or (L, P).
    The label rides the plane as an f32 column (exact up to 2^24 parts at
    f32 storage, 256 at bf16).  Thresholds are the plain rule
    gain >= tau."""

    capacities: torch.Tensor           # (P,) int32
    parts: torch.Tensor                # (n_total,) int32
    name: ClassVar[str] = "partition_matroid"
    n_planes: ClassVar[int] = 1
    fused_mode: ClassVar[str] = "scan"

    def init_state(self, lanes: Optional[int] = None):
        P = self.capacities.shape[0]
        shape = (P,) if lanes is None else (lanes, P)
        return torch.zeros(shape, dtype=torch.int32,
                           device=self.capacities.device)

    def plane(self, ids):
        i = ids.long().clamp(0, self.parts.shape[0] - 1)
        return self.parts[i].float()[..., None]

    def _part_of(self, plane):
        P = self.capacities.shape[0]
        return plane[..., 0].to(torch.int32).clamp(0, P - 1).long()

    def eligible(self, cstate, plane):
        pid = self._part_of(plane)
        caps = self.capacities[pid]
        if cstate.dim() == 1:
            return cstate[pid] < caps
        pid = pid.expand(cstate.shape[0], pid.shape[-1])
        return cstate.gather(1, pid) < caps

    def add(self, cstate, plane_row):
        P = self.capacities.shape[0]
        hit = torch.nn.functional.one_hot(self._part_of(plane_row), P)
        return cstate + hit.to(cstate.dtype)


def make_constraint(name: str, n_total: Optional[int] = None, costs=None,
                    budget: Optional[float] = None, parts=None,
                    capacities=None, device=None) -> Optional[Constraint]:
    """The registry factory.  "cardinality" returns None, the fast path
    every driver takes for the unconstrained case (an explicit
    ``Cardinality()`` takes the generic path and gives the same
    selections).  The per-element data lands on ``device`` (default: the
    CPU)."""
    validate_constraint_name(name, where="make_constraint")
    if name == "cardinality":
        return None
    if name == "knapsack":
        if costs is None or budget is None:
            raise ValueError("make_constraint('knapsack') needs costs= "
                             "and budget=")
        costs = torch.as_tensor(costs, dtype=torch.float32,
                                device=device).reshape(-1)
        if n_total is not None and costs.shape[0] != n_total:
            raise ValueError(f"knapsack costs cover {costs.shape[0]} "
                             f"elements, corpus has {n_total}")
        return Knapsack(budget=float(budget), costs=costs)
    if parts is None or capacities is None:
        raise ValueError("make_constraint('partition_matroid') needs "
                         "parts= and capacities=")
    parts = torch.as_tensor(parts, dtype=torch.int32,
                            device=device).reshape(-1)
    if n_total is not None and parts.shape[0] != n_total:
        raise ValueError(f"partition parts cover {parts.shape[0]} "
                         f"elements, corpus has {n_total}")
    return PartitionMatroid(
        capacities=torch.as_tensor(capacities, dtype=torch.int32,
                                   device=device).reshape(-1),
        parts=parts)
