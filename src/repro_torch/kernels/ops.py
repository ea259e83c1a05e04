"""Public entry points for the port's kernels.

Device dispatch (the JAX package's ``_interpret()`` switch, replaced by a
check of where the tensor lies): a CUDA tensor goes to the hand-written
CUDA kernel, which launches or raises; a CPU tensor goes to the plain
PyTorch version in ``kernels.ref``.  Nothing falls back from one to the
other.
"""

from __future__ import annotations

from repro_torch.kernels import coverage_accept as _ca
from repro_torch.kernels import coverage_marginals as _cm
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
            "logdet_accept": _la}


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


def reset_launch_counts() -> None:
    """Set every kernel's launch count to 0."""
    for mod in _COUNTED.values():
        mod.launches = 0
    for name in _fm.launches:
        _fm.launches[name] = 0


def coverage_marginals(x, state, weights=None):
    """(C, d) | (L, C, d), (d,) | (L, d)[, (d,)] -> (C,) | (L, C)
    FeatureCoverage marginals."""
    if _on_card(x):
        return _cm.coverage_marginals(x, state, weights)
    return ref.coverage_marginals(x, state, weights)


def coverage_accept(x, state, weights, eligible, tau, budget):
    """Fused FeatureCoverage chunk-accept sweep over a (B, d) tile per
    lane.  Returns (mask bool, state f32, gains f32), batched like x."""
    if _on_card(x):
        return _ca.coverage_accept(x, state, weights, eligible, tau, budget)
    return ref.coverage_accept(x, state, weights, eligible, tau, budget)


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


def facility_accept(cand, reference, state, eligible, tau, budget):
    """Fused FacilityLocation chunk-accept sweep over a (B, d) chunk per
    lane.  Returns (mask bool, state f32, gains f32), batched like cand."""
    if _on_card(cand):
        return _fa.facility_accept(cand, reference, state, eligible, tau,
                                   budget)
    return ref.facility_accept(cand, reference, state, eligible, tau, budget)


def weighted_coverage_marginals(x, state):
    """(C, U) | (L, C, U), (U,) | (L, U) -> (C,) | (L, C) WeightedCoverage
    marginals."""
    if _on_card(x):
        return _wm.weighted_coverage_marginals(x, state)
    return ref.weighted_coverage_marginals(x, state)


def weighted_coverage_accept(x, state, eligible, tau, budget):
    """Fused WeightedCoverage chunk-accept sweep over a (B, U) tile per
    lane.  Returns (mask bool, state f32, gains f32), batched like x."""
    if _on_card(x):
        return _wa.weighted_coverage_accept(x, state, eligible, tau, budget)
    return ref.weighted_coverage_accept(x, state, eligible, tau, budget)


def saturated_coverage_marginals(x, state, cap, weights=None):
    """(C, d) | (L, C, d), (d,) | (L, d), (d,)[, (d,)] -> (C,) | (L, C)
    SaturatedCoverage marginals."""
    if _on_card(x):
        return _sm.saturated_coverage_marginals(x, state, cap, weights)
    return ref.saturated_coverage_marginals(x, state, cap, weights)


def saturated_coverage_accept(x, state, cap, weights, eligible, tau, budget):
    """Fused SaturatedCoverage chunk-accept sweep over a (B, d) tile per
    lane.  Returns (mask bool, state f32, gains f32), batched like x."""
    if _on_card(x):
        return _sa.saturated_coverage_accept(x, state, cap, weights, eligible,
                                             tau, budget)
    return ref.saturated_coverage_accept(x, state, cap, weights, eligible,
                                         tau, budget)


def graph_cut_marginals(x, total, state, lam=0.5):
    """(C, d) | (L, C, d), (d,), (d,) | (L, d) -> (C,) | (L, C) GraphCut
    marginals."""
    if _on_card(x):
        return _gm.graph_cut_marginals(x, total, state, lam)
    return ref.graph_cut_marginals(x, total, state, lam)


def graph_cut_accept(x, total, state, eligible, tau, budget, lam=0.5):
    """Fused GraphCut chunk-accept sweep over a (B, d) tile per lane.
    Returns (mask bool, state f32, gains f32), batched like x."""
    if _on_card(x):
        return _ga.graph_cut_accept(x, total, state, eligible, tau, budget,
                                    lam)
    return ref.graph_cut_accept(x, total, state, eligible, tau, budget, lam)


def logdet_marginals(x, U, alpha=1.0, scale=1.0):
    """(C, d) | (L, C, d), (k, d) | (L, k, d) -> (C,) | (L, C) log-det
    (scale 1) or mutual-information (scale 0.5) marginals."""
    if _on_card(x):
        return _lm.logdet_marginals(x, U, alpha, scale)
    return ref.logdet_marginals(x, U, alpha, scale=scale)


def logdet_accept(x, U, logdet, size, eligible, tau, budget, alpha=1.0,
                  scale=1.0):
    """Fused log-det / mutual-information chunk-accept sweep over a (B, d)
    tile per lane.  Returns (mask bool, U f32, logdet f32, size int32,
    gains f32), batched like x."""
    if _on_card(x):
        return _la.logdet_accept(x, U, logdet, size, eligible, tau, budget,
                                 alpha, scale)
    return ref.logdet_accept(x, U, logdet, size, eligible, tau, budget,
                             alpha, scale=scale)
