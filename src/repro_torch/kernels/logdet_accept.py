"""CUDA kernel: fused LogDetDiversity / MutualInformationGaussian
chunk-accept sweep (csrc/logdet_accept.cu).

The port of ``repro.kernels.logdet_accept`` (a Pallas TPU kernel),
cardinality mode: one launch sweeps the (B, d) tile of every lane, one CTA
per lane, in stream order against the lane's whitened basis U (k, d), which
stays in shared memory; an accepted row is the rank-1 Gram-Schmidt append
U[size] = (x - v^T U) / d with logdet += gain, and an append at size == k
writes no row.  alpha and scale are launch arguments (scale = 0.5 is mutual
information).  This wrapper only launches; ``kernels.ops`` routes CPU
tensors to the plain version in ``kernels.ref``.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build, _wrap
from repro_torch.kernels.ref import LOGDET_EPS

#: kernel launches since the last reset (set to 0 to reset)
launches = 0

#: dynamic shared memory one block may use on the H100
SMEM_LIMIT = 227 * 1024


def smem_bytes(k: int, d: int) -> int:
    """Shared memory of one lane's sweep: U (k, d), two staged rows and
    k + 1 dot products, float32 (the same sum as csrc/logdet_accept.cu)."""
    return (k * d + 2 * d + k + 1) * 4


def logdet_accept(x, U, logdet, size, eligible, tau, budget, alpha=1.0,
                  scale=1.0):
    """Launch the sweep.  x (B, d) or (L, B, d), float32 or bfloat16; U
    (k, d) or (L, k, d) float32; logdet () or (L,) float32; size () or (L,)
    int32; eligible (B,) or (L, B) bool; tau () or (L,) float32; budget ()
    or (L,) int32.  Returns (mask bool, U float32, logdet float32, size
    int32, gains float32), batched like x.  Raises ValueError when U does
    not fit in shared memory."""
    global launches
    name = "logdet_accept"
    _wrap.check_rows(name, x)
    _wrap.check(x.dim() in (2, 3), name,
                f"x must be (B, d) or (L, B, d), got {tuple(x.shape)}")
    unbatched = x.dim() == 2
    if unbatched:
        x, U, eligible = x[None], U[None], eligible[None]
        logdet, size = logdet.reshape(1), size.reshape(1)
    L, B, d = x.shape
    _wrap.check(U.dim() == 3 and U.shape[0] == L and U.shape[2] == d
                and U.shape[1] >= 1 and U.dtype == torch.float32, name,
                f"U must be float32 ({L}, k >= 1, {d}), got {U.dtype} "
                f"{tuple(U.shape)}")
    k = U.shape[1]
    _wrap.check(smem_bytes(k, d) <= SMEM_LIMIT, name,
                f"the basis (k={k}, d={d}) needs {smem_bytes(k, d)} bytes of "
                f"shared memory, more than the {SMEM_LIMIT} a block may use")
    _wrap.check(logdet.dtype == torch.float32 and logdet.shape == (L,), name,
                f"logdet must be float32 ({L},), got {logdet.dtype} "
                f"{tuple(logdet.shape)}")
    _wrap.check(size.dtype == torch.int32 and size.shape == (L,), name,
                f"size must be int32 ({L},), got {size.dtype} "
                f"{tuple(size.shape)}")
    _wrap.check(eligible.dtype == torch.bool and eligible.shape == (L, B),
                name, f"eligible must be bool {(L, B)}, got {eligible.dtype} "
                f"{tuple(eligible.shape)}")
    tau = torch.as_tensor(tau, dtype=torch.float32, device=x.device).reshape(-1)
    budget = torch.as_tensor(budget, dtype=torch.int32,
                             device=x.device).reshape(-1)
    _wrap.check(tau.shape == (L,), name, f"tau must be ({L},), got "
                f"{tuple(tau.shape)}")
    _wrap.check(budget.shape == (L,), name, f"budget must be ({L},), got "
                f"{tuple(budget.shape)}")
    _wrap.placed(name, (x, U, logdet, size, eligible, tau, budget), x.device)
    dev = x.device
    mask = torch.empty((L, B), dtype=torch.bool, device=dev)
    U_out = torch.empty((L, k, d), dtype=torch.float32, device=dev)
    ld_out = torch.empty((L,), dtype=torch.float32, device=dev)
    size_out = torch.empty((L,), dtype=torch.int32, device=dev)
    gains = torch.empty((L, B), dtype=torch.float32, device=dev)
    _wrap.launch(name, _build.library(name).logdet_accept_launch, dev,
                 x.data_ptr(), int(x.dtype == torch.bfloat16), U.data_ptr(),
                 logdet.data_ptr(), size.data_ptr(), eligible.data_ptr(),
                 tau.data_ptr(), budget.data_ptr(), mask.data_ptr(),
                 U_out.data_ptr(), ld_out.data_ptr(), size_out.data_ptr(),
                 gains.data_ptr(), L, B, k, d, float(alpha), float(scale),
                 float(LOGDET_EPS))
    launches += 1
    if unbatched:
        return mask[0], U_out[0], ld_out[0], size_out[0], gains[0]
    return mask, U_out, ld_out, size_out, gains
