"""CUDA kernel: fused GraphCut chunk-accept sweep
(csrc/graph_cut_accept.cu on the shared sweep in csrc/feature_sweep.cuh).

The port of ``repro.kernels.graph_cut_accept`` (a Pallas TPU kernel built
by ``accept_call`` in ``repro/kernels/_accept_common.py``), cardinality
mode: one launch sweeps the (B, d) tile of every lane, one CTA per lane, in
stream order against the live selected-row sum; row i's gain is
sum_f (x_if (t_f - 2 lam s_f) - lam x_if^2) and an accepted row applies
s += x_i.  This wrapper only launches; ``kernels.ops`` routes CPU tensors
to the plain version in ``kernels.ref``.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build, _wrap
from repro_torch.kernels.coverage_accept import MAX_D

#: kernel launches since the last reset (set to 0 to reset)
launches = 0


def graph_cut_accept(x, total, state, eligible, tau, budget, lam=0.5):
    """Launch the sweep.  x (B, d) or (L, B, d), float32 or bfloat16;
    total (d,) float32; state (d,) or (L, d) float32; eligible (B,) or
    (L, B) bool; tau () or (L,) float32; budget () or (L,) int32.  Returns
    (mask bool, state float32, gains float32), batched like x."""
    global launches
    name = "graph_cut_accept"
    _wrap.check_rows(name, x)
    d = x.shape[-1]
    _wrap.check(d <= MAX_D, name, f"d={d} exceeds {MAX_D}")
    x, state, eligible, tau, budget, unbatched = _wrap.sweep_operands(
        name, x, state, eligible, tau, budget, d)
    _wrap.check(total is not None, name, "total is required")
    _wrap.feature(name, total, d, "total")
    _wrap.placed(name, (x, state, total, eligible, tau, budget), x.device)
    mask, state_out, gains = _wrap.sweep_outputs(x, d)
    L, B = x.shape[:2]
    _wrap.launch(name, _build.library(name).graph_cut_accept_launch,
                 x.device, x.data_ptr(), int(x.dtype == torch.bfloat16),
                 state.data_ptr(), total.data_ptr(), float(lam),
                 eligible.data_ptr(), tau.data_ptr(), budget.data_ptr(),
                 mask.data_ptr(), state_out.data_ptr(), gains.data_ptr(),
                 L, B, d)
    launches += 1
    if unbatched:
        return mask[0], state_out[0], gains[0]
    return mask, state_out, gains
