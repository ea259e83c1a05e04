"""CUDA kernel: fused WeightedCoverage chunk-accept sweep
(csrc/weighted_coverage_accept.cu on the shared sweep in
csrc/feature_sweep.cuh).

The port of ``repro.kernels.weighted_coverage_accept`` (a Pallas TPU kernel
built by ``accept_call`` in ``repro/kernels/_accept_common.py``),
cardinality mode: one launch sweeps the (B, U) incidence tile of every
lane, one CTA per lane, in stream order against the live remaining-weight
vector; row i's gain is sum_u s_u x_iu and an accepted row applies
s = s (1 - x_i).  This wrapper only launches; ``kernels.ops`` routes CPU
tensors to the plain version in ``kernels.ref``.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build, _wrap
from repro_torch.kernels.coverage_accept import MAX_D

#: kernel launches since the last reset (set to 0 to reset)
launches = 0


def weighted_coverage_accept(x, state, eligible, tau, budget):
    """Launch the sweep.  x (B, U) or (L, B, U), float32 or bfloat16;
    state (U,) or (L, U) float32; eligible (B,) or (L, B) bool; tau () or
    (L,) float32; budget () or (L,) int32.  Returns (mask bool, state
    float32, gains float32), batched like x."""
    global launches
    name = "weighted_coverage_accept"
    _wrap.check_rows(name, x)
    U = x.shape[-1]
    _wrap.check(U <= MAX_D, name, f"U={U} exceeds {MAX_D}")
    x, state, eligible, tau, budget, unbatched = _wrap.sweep_operands(
        name, x, state, eligible, tau, budget, U)
    _wrap.placed(name, (x, state, eligible, tau, budget), x.device)
    mask, state_out, gains = _wrap.sweep_outputs(x, U)
    L, B = x.shape[:2]
    _wrap.launch(name, _build.library(name).weighted_coverage_accept_launch,
                 x.device, x.data_ptr(), int(x.dtype == torch.bfloat16),
                 state.data_ptr(), eligible.data_ptr(), tau.data_ptr(),
                 budget.data_ptr(), mask.data_ptr(), state_out.data_ptr(),
                 gains.data_ptr(), L, B, U)
    launches += 1
    if unbatched:
        return mask[0], state_out[0], gains[0]
    return mask, state_out, gains
