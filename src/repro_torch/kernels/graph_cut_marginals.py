"""CUDA kernel: GraphCut marginal gains (csrc/graph_cut_marginals.cu).

    gains[l, i] = <x_i, total - 2 lam state[l]> - lam ||x_i||^2

The port of ``repro.kernels.graph_cut_marginals`` (a Pallas TPU kernel),
with an explicit lane axis: one launch scores a candidate block against
every lane of a threshold grid.  lam is a launch argument (the TPU kernel
bakes it in at compile time).  This wrapper only launches;
``kernels.ops`` routes CPU tensors to the plain version in
``kernels.ref``.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build, _wrap

#: kernel launches since the last reset (set to 0 to reset)
launches = 0


def graph_cut_marginals(x, total, state, lam=0.5):
    """Launch the kernel.  x (C, d) or (L, C, d), float32 or bfloat16;
    total (d,) float32; state (d,) or (L, d) float32; contiguous CUDA
    tensors on one device.  Returns (C,) for x (C, d) with state (d,), else
    (L, C) float32."""
    global launches
    name = "graph_cut_marginals"
    _wrap.check_rows(name, x)
    d = x.shape[-1]
    L, C, per_lane, out_shape = _wrap.lanes(name, x, state, d)
    _wrap.check(total is not None, name, "total is required")
    _wrap.feature(name, total, d, "total")
    _wrap.placed(name, (x, state, total), x.device)
    out = torch.empty(out_shape, dtype=torch.float32, device=x.device)
    if C == 0:
        return out
    _wrap.launch(name, _build.library(name).graph_cut_marginals_launch,
                 x.device, x.data_ptr(), int(x.dtype == torch.bfloat16),
                 int(per_lane), state.data_ptr(), total.data_ptr(),
                 float(lam), out.data_ptr(), L, C, d)
    launches += 1
    return out
