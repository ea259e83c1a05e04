"""CUDA kernel: LogDetDiversity / MutualInformationGaussian marginal gains
(csrc/logdet_marginals.cu).

    gains[l, i] = scale * log(max(1 + alpha ||x_i||^2
                                  - alpha^2 ||U_l x_i||^2, 1e-12))

The port of ``repro.kernels.logdet_marginals`` (a Pallas TPU kernel), with
an explicit lane axis: one launch scores a candidate block against every
lane's whitened basis.  alpha and scale are launch arguments (the TPU
kernel bakes them in at compile time); scale = 0.5 is mutual information.
This wrapper only launches; ``kernels.ops`` routes CPU tensors to the plain
version in ``kernels.ref``.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build, _wrap
from repro_torch.kernels.ref import LOGDET_EPS

#: kernel launches since the last reset (set to 0 to reset)
launches = 0


def logdet_marginals(x, U, alpha=1.0, scale=1.0):
    """Launch the kernel.  x (C, d) or (L, C, d), float32 or bfloat16; U
    (k, d) or (L, k, d) float32; contiguous CUDA tensors on one device.
    Returns (C,) for x (C, d) with U (k, d), else (L, C) float32; a (C, d)
    x with an (L, k, d) basis is shared by every lane."""
    global launches
    name = "logdet_marginals"
    _wrap.check_rows(name, x)
    _wrap.check(x.dim() in (2, 3) and U.dim() in (2, 3), name,
                f"bad ranks x{tuple(x.shape)} U{tuple(U.shape)}")
    C, d = x.shape[-2:]
    _wrap.check(U.dtype == torch.float32 and U.shape[-1] == d
                and U.shape[-2] >= 1, name,
                f"U must be float32 (k >= 1, {d}), got {U.dtype} "
                f"{tuple(U.shape)}")
    k = U.shape[-2]
    L = 1 if U.dim() == 2 else U.shape[0]
    per_lane = x.dim() == 3
    _wrap.check(not per_lane or (U.dim() == 3 and x.shape[0] == L), name,
                f"per-lane x{tuple(x.shape)} needs U (L, k, {d}), got "
                f"{tuple(U.shape)}")
    _wrap.placed(name, (x, U), x.device)
    out = torch.empty((L, C) if U.dim() == 3 else (C,), dtype=torch.float32,
                      device=x.device)
    if C == 0 or L == 0:
        return out
    _wrap.launch(name, _build.library(name).logdet_marginals_launch,
                 x.device, x.data_ptr(), int(x.dtype == torch.bfloat16),
                 int(per_lane), U.data_ptr(), out.data_ptr(), L, k, C, d,
                 float(alpha), float(alpha * alpha), float(scale),
                 float(LOGDET_EPS))
    launches += 1
    return out
