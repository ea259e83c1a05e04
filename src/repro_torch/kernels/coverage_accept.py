"""CUDA kernel: fused FeatureCoverage chunk-accept sweep
(csrc/coverage_accept.cu on the shared sweep in csrc/feature_sweep.cuh).

The port of ``repro.kernels.coverage_accept`` (a Pallas TPU kernel built by
``accept_call`` in ``repro/kernels/_accept_common.py``), cardinality mode:
one launch sweeps the (B, d) tile of every lane, one CTA per lane, in stream
order against the live state.  This wrapper only launches; ``kernels.ops``
routes CPU tensors to the plain version in ``kernels.ref``.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build, _wrap

#: kernel launches since the last reset (set to 0 to reset)
launches = 0

#: widest feature row one CTA holds in registers (128 threads x 16)
MAX_D = 2048


def coverage_accept(x, state, weights, eligible, tau, budget):
    """Launch the sweep.  x (B, d) or (L, B, d), float32 or bfloat16;
    state (d,) or (L, d) float32; weights (d,) float32 or None; eligible
    (B,) or (L, B) bool; tau () or (L,) float32; budget () or (L,) int32.
    Returns (mask bool, state float32, gains float32), batched like x."""
    global launches
    name = "coverage_accept"
    _wrap.check_rows(name, x)
    d = x.shape[-1]
    _wrap.check(d <= MAX_D, name, f"d={d} exceeds {MAX_D}")
    x, state, eligible, tau, budget, unbatched = _wrap.sweep_operands(
        name, x, state, eligible, tau, budget, d)
    _wrap.feature(name, weights, d, "weights")
    _wrap.placed(name, (x, state, weights, eligible, tau, budget), x.device)
    mask, state_out, gains = _wrap.sweep_outputs(x, d)
    L, B = x.shape[:2]
    _wrap.launch(name, _build.library(name).coverage_accept_launch, x.device,
                 x.data_ptr(), int(x.dtype == torch.bfloat16),
                 state.data_ptr(),
                 None if weights is None else weights.data_ptr(),
                 eligible.data_ptr(), tau.data_ptr(), budget.data_ptr(),
                 mask.data_ptr(), state_out.data_ptr(), gains.data_ptr(),
                 L, B, d)
    launches += 1
    if unbatched:
        return mask[0], state_out[0], gains[0]
    return mask, state_out, gains
