"""CUDA kernel: WeightedCoverage marginal gains
(csrc/weighted_coverage_marginals.cu).

    gains[l, i] = sum_u state[l, u] * x[i, u]

with ``state`` the remaining (uncovered) weight per universe item.  The
port of ``repro.kernels.weighted_coverage_marginals`` (a Pallas TPU
kernel), with an explicit lane axis: one launch scores a candidate block
against every lane of a threshold grid.  This wrapper only launches;
``kernels.ops`` routes CPU tensors to the plain version in ``kernels.ref``.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build, _wrap

#: kernel launches since the last reset (set to 0 to reset)
launches = 0


def weighted_coverage_marginals(x, state):
    """Launch the kernel.  x (C, U) or (L, C, U), float32 or bfloat16;
    state (U,) or (L, U) float32; contiguous CUDA tensors on one device.
    Returns (C,) for x (C, U) with state (U,), else (L, C) float32."""
    global launches
    name = "weighted_coverage_marginals"
    _wrap.check_rows(name, x)
    U = x.shape[-1]
    L, C, per_lane, out_shape = _wrap.lanes(name, x, state, U)
    _wrap.placed(name, (x, state), x.device)
    out = torch.empty(out_shape, dtype=torch.float32, device=x.device)
    if C == 0:
        return out
    _wrap.launch(name, _build.library(name).weighted_coverage_marginals_launch,
                 x.device, x.data_ptr(), int(x.dtype == torch.bfloat16),
                 int(per_lane), state.data_ptr(), out.data_ptr(), L, C, U)
    launches += 1
    _wrap.count_shape(name, C)
    return out
