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
from repro_torch.kernels import ref


def _on_card(x) -> bool:
    """True for a CUDA tensor, False for a CPU tensor; any other device is
    refused."""
    if x.device.type == "cuda":
        return True
    if x.device.type == "cpu":
        return False
    raise ValueError(f"no kernel or plain route for device {x.device}")


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
