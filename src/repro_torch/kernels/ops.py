"""Public entry points for the port's kernels.

Device dispatch (the JAX package's ``_interpret()`` switch, replaced by a
check of where the tensor lies): a CUDA tensor goes to the hand-written
CUDA kernel, which launches or raises; a CPU tensor goes to the plain
PyTorch version in ``kernels.ref``.  Nothing falls back from one to the
other.

Every accept sweep takes ``cost`` and ``cost_budget``, both given or both
None: the knapsack cost mode of the JAX sweeps (row i accepted when
gain >= tau * c_i and the running spend + c_i stays within the remaining
budget), or the cardinality mode.
"""

from __future__ import annotations

from repro_torch.kernels import _wrap
from repro_torch.kernels import coverage_accept as _ca
from repro_torch.kernels import coverage_marginals as _cm
from repro_torch.kernels import exemplar_accept as _ea
from repro_torch.kernels import exemplar_marginals as _em
from repro_torch.kernels import facility_accept as _fa
from repro_torch.kernels import facility_marginals as _fm
from repro_torch.kernels import graph_cut_accept as _ga
from repro_torch.kernels import graph_cut_marginals as _gm
from repro_torch.kernels import logdet_accept as _la
from repro_torch.kernels import logdet_marginals as _lm
from repro_torch.kernels import ref
from repro_torch.kernels import saturated_coverage_accept as _sa
from repro_torch.kernels import saturated_coverage_marginals as _sm
from repro_torch.kernels import weighted_coverage_accept as _wa
from repro_torch.kernels import weighted_coverage_marginals as _wm

#: the wrapper modules that count their launches in a plain integer
_COUNTED = {"coverage_marginals": _cm, "coverage_accept": _ca,
            "facility_accept": _fa, "weighted_coverage_marginals": _wm,
            "weighted_coverage_accept": _wa,
            "saturated_coverage_marginals": _sm,
            "saturated_coverage_accept": _sa, "graph_cut_marginals": _gm,
            "graph_cut_accept": _ga, "logdet_marginals": _lm,
            "logdet_accept": _la, "exemplar_marginals": _em,
            "exemplar_accept": _ea}


def _on_card(x) -> bool:
    """True for a CUDA tensor, False for a CPU tensor; any other device is
    refused."""
    if x.device.type == "cuda":
        return True
    if x.device.type == "cpu":
        return False
    raise ValueError(f"no kernel or plain route for device {x.device}")


def launch_counts() -> dict:
    """Kernel launches per entry point since the last reset."""
    counts = {name: mod.launches for name, mod in _COUNTED.items()}
    counts.update(_fm.launches)
    return counts


def cost_launch_counts() -> dict:
    """Launches of each accept sweep in the knapsack cost mode since the
    last reset (a part of ``launch_counts``)."""
    return {name: mod.cost_launches for name, mod in _COUNTED.items()
            if hasattr(mod, "cost_launches")}


def shape_launch_counts() -> dict:
    """Launches per entry point since the last reset, split by the rows a
    lane each took (``_wrap.SHAPES``): {"filter": more than a chunk,
    "chunk": up to a chunk, "row": one row}; they sum to
    ``launch_counts``."""
    return {name: dict(_wrap.shape_launches.get(
                name, dict.fromkeys(_wrap.SHAPES, 0)))
            for name in launch_counts()}


def filter_launch_counts() -> dict:
    """The "filter" class launches of ``shape_launch_counts`` since the last
    reset, split by lanes, shared or per-lane x and rows a lane:
    {name: {"<lanes>, <x> x, <rows> rows": launches}}, for the entry points
    that split them (coverage_marginals, saturated_coverage_marginals, and
    rectified_residual_sum, whose x is its aux block)."""
    return {name: dict(split) for name, split in _wrap.filter_launches.items()}


def reset_launch_counts() -> None:
    """Set every kernel's launch counts to 0."""
    for mod in _COUNTED.values():
        mod.launches = 0
        if hasattr(mod, "cost_launches"):
            mod.cost_launches = 0
    for name in _fm.launches:
        _fm.launches[name] = 0
    _wrap.shape_launches.clear()
    _wrap.filter_launches.clear()


def coverage_marginals(x, state, weights=None):
    """(C, d) | (L, C, d), (d,) | (L, d)[, (d,)] -> (C,) | (L, C)
    FeatureCoverage marginals."""
    if _on_card(x):
        return _cm.coverage_marginals(x, state, weights)
    return ref.coverage_marginals(x, state, weights)


def coverage_accept(x, state, weights, eligible, tau, budget, cost=None,
                    cost_budget=None):
    """Fused FeatureCoverage chunk-accept sweep over a (B, d) tile per
    lane.  Returns (mask bool, state f32, gains f32), batched like x."""
    fn = _ca.coverage_accept if _on_card(x) else ref.coverage_accept
    return fn(x, state, weights, eligible, tau, budget, cost, cost_budget)


def facility_marginals(cand, reference, state):
    """(C, d) | (L, C, d), (r, d), (r,) | (L, r) -> (C,) | (L, C) fused
    FacilityLocation marginals (similarity product and rectified sum)."""
    if _on_card(cand):
        return _fm.facility_marginals(cand, reference, state)
    return ref.facility_marginals(cand, reference, state)


def rectified_residual_sum(aux, state):
    """(C, r) | (L, C, r), (r,) | (L, r) -> (C,) | (L, C) FacilityLocation
    marginals from precomputed similarities."""
    if _on_card(aux):
        return _fm.rectified_residual_sum(aux, state)
    return ref.rectified_residual_sum(aux, state)


def facility_accept(cand, reference, state, eligible, tau, budget,
                    cost=None, cost_budget=None):
    """Fused FacilityLocation chunk-accept sweep over a (B, d) chunk per
    lane.  Returns (mask bool, state f32, gains f32), batched like cand."""
    fn = _fa.facility_accept if _on_card(cand) else ref.facility_accept
    return fn(cand, reference, state, eligible, tau, budget, cost,
              cost_budget)


def exemplar_marginals(cand, reference, state):
    """(C, d) | (L, C, d), (r, d), (r,) | (L, r) -> (C,) | (L, C) fused
    ExemplarClustering marginals (distance product and residual sum)."""
    if _on_card(cand):
        return _em.exemplar_marginals(cand, reference, state)
    return ref.exemplar_marginals(cand, reference, state)


def exemplar_accept(cand, reference, state, eligible, tau, budget,
                    cost=None, cost_budget=None):
    """Fused ExemplarClustering chunk-accept sweep over a (B, d) chunk per
    lane.  Returns (mask bool, state f32, gains f32), batched like cand."""
    fn = _ea.exemplar_accept if _on_card(cand) else ref.exemplar_accept
    return fn(cand, reference, state, eligible, tau, budget, cost,
              cost_budget)


def weighted_coverage_marginals(x, state):
    """(C, U) | (L, C, U), (U,) | (L, U) -> (C,) | (L, C) WeightedCoverage
    marginals."""
    if _on_card(x):
        return _wm.weighted_coverage_marginals(x, state)
    return ref.weighted_coverage_marginals(x, state)


def weighted_coverage_accept(x, state, eligible, tau, budget, cost=None,
                             cost_budget=None):
    """Fused WeightedCoverage chunk-accept sweep over a (B, U) tile per
    lane.  Returns (mask bool, state f32, gains f32), batched like x."""
    fn = (_wa.weighted_coverage_accept if _on_card(x)
          else ref.weighted_coverage_accept)
    return fn(x, state, eligible, tau, budget, cost, cost_budget)


def saturated_coverage_marginals(x, state, cap, weights=None):
    """(C, d) | (L, C, d), (d,) | (L, d), (d,)[, (d,)] -> (C,) | (L, C)
    SaturatedCoverage marginals."""
    if _on_card(x):
        return _sm.saturated_coverage_marginals(x, state, cap, weights)
    return ref.saturated_coverage_marginals(x, state, cap, weights)


def saturated_coverage_accept(x, state, cap, weights, eligible, tau, budget,
                              cost=None, cost_budget=None):
    """Fused SaturatedCoverage chunk-accept sweep over a (B, d) tile per
    lane.  Returns (mask bool, state f32, gains f32), batched like x."""
    fn = (_sa.saturated_coverage_accept if _on_card(x)
          else ref.saturated_coverage_accept)
    return fn(x, state, cap, weights, eligible, tau, budget, cost,
              cost_budget)


def graph_cut_marginals(x, total, state, lam=0.5):
    """(C, d) | (L, C, d), (d,), (d,) | (L, d) -> (C,) | (L, C) GraphCut
    marginals."""
    if _on_card(x):
        return _gm.graph_cut_marginals(x, total, state, lam)
    return ref.graph_cut_marginals(x, total, state, lam)


def graph_cut_accept(x, total, state, eligible, tau, budget, lam=0.5,
                     cost=None, cost_budget=None):
    """Fused GraphCut chunk-accept sweep over a (B, d) tile per lane.
    Returns (mask bool, state f32, gains f32), batched like x."""
    fn = _ga.graph_cut_accept if _on_card(x) else ref.graph_cut_accept
    return fn(x, total, state, eligible, tau, budget, lam, cost, cost_budget)


def logdet_marginals(x, U, alpha=1.0, scale=1.0, size=None):
    """(C, d) | (L, C, d), (k, d) | (L, k, d) -> (C,) | (L, C) log-det
    (scale 1) or mutual-information (scale 0.5) marginals; ``size`` (one
    integer per lane, or None for k) counts each lane's live rows of U."""
    if _on_card(x):
        return _lm.logdet_marginals(x, U, alpha, scale, size)
    return ref.logdet_marginals(x, U, alpha, scale=scale, size=size)


def logdet_accept(x, U, logdet, size, eligible, tau, budget, alpha=1.0,
                  scale=1.0, cost=None, cost_budget=None):
    """Fused log-det / mutual-information chunk-accept sweep over a (B, d)
    tile per lane.  Returns (mask bool, U f32, logdet f32, size int32,
    gains f32), batched like x."""
    if _on_card(x):
        return _la.logdet_accept(x, U, logdet, size, eligible, tau, budget,
                                 alpha, scale, cost, cost_budget)
    return ref.logdet_accept(x, U, logdet, size, eligible, tau, budget,
                             alpha, scale=scale, cost=cost,
                             cost_budget=cost_budget)
