"""CUDA kernel: SaturatedCoverage marginal gains
(csrc/saturated_coverage_marginals.cu).

    gains[l, i] = sum_f w_f * ( min(state[l, f] + x[i, f], cap_f)
                                - min(state[l, f], cap_f) )

The port of ``repro.kernels.saturated_coverage_marginals`` (a Pallas TPU
kernel), with an explicit lane axis: one launch scores a candidate block
against every lane of a threshold grid.  ``cap`` is alpha * total, from the
oracle.  This wrapper only launches; ``kernels.ops`` routes CPU tensors to
the plain version in ``kernels.ref``.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build, _wrap

#: kernel launches since the last reset (set to 0 to reset)
launches = 0


def saturated_coverage_marginals(x, state, cap, weights=None):
    """Launch the kernel.  x (C, d) or (L, C, d), float32 or bfloat16;
    state (d,) or (L, d) float32; cap (d,) float32; weights (d,) float32 or
    None; all contiguous CUDA tensors on one device.  Returns (C,) for x
    (C, d) with state (d,), else (L, C) float32."""
    global launches
    name = "saturated_coverage_marginals"
    _wrap.check_rows(name, x)
    d = x.shape[-1]
    L, C, per_lane, out_shape = _wrap.lanes(name, x, state, d)
    _wrap.check(cap is not None, name, "cap is required")
    _wrap.feature(name, cap, d, "cap")
    _wrap.feature(name, weights, d, "weights")
    _wrap.placed(name, (x, state, cap, weights), x.device)
    out = torch.empty(out_shape, dtype=torch.float32, device=x.device)
    if C == 0:
        return out
    _wrap.launch(name, _build.library(name).saturated_coverage_marginals_launch,
                 x.device, x.data_ptr(), int(x.dtype == torch.bfloat16),
                 int(per_lane), state.data_ptr(), cap.data_ptr(),
                 None if weights is None else weights.data_ptr(),
                 out.data_ptr(), L, C, d)
    launches += 1
    return out
