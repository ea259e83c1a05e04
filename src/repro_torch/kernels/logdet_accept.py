"""CUDA kernel: fused LogDetDiversity / MutualInformationGaussian
chunk-accept sweep (csrc/logdet_accept.cu).

The port of ``repro.kernels.logdet_accept`` (a Pallas TPU kernel), in both
of its modes (cardinality, and the knapsack cost mode of
``cost``/``cost_budget``): one launch sweeps the (B, d) tile of every
lane, one CTA per lane, in stream order against the lane's whitened basis
U (k, d); an accepted row is the rank-1 Gram-Schmidt append
U[size] = (x - v^T U) / d with logdet += gain, and an append at size == k
writes no row.  While U and a block of rows fit in shared memory (the
narrow instance) the kernel forms every row's projections onto the basis
at once and walks the rows with scalar work, reducing only on accept;
past that the wide instance keeps U in the (L, k, d) output, resident in
L2, and scores row by row (``instance``).  alpha and scale are launch arguments
(scale = 0.5 is mutual information).  This wrapper only launches;
``kernels.ops`` routes CPU tensors to the plain version in ``kernels.ref``.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build, _wrap
from repro_torch.kernels.ref import LOGDET_EPS

#: kernel launches since the last reset (set to 0 to reset)
launches = 0

#: of those, launches in the knapsack cost mode
cost_launches = 0

#: dynamic shared memory one block may use on the H100
SMEM_LIMIT = 227 * 1024

#: rows of the chunk one block of the narrow instance holds: at most
#: MAX_ROWS (one thread each in the walk), at least MIN_ROWS, a multiple of
#: MIN_ROWS
MAX_ROWS, MIN_ROWS = 128, 8


def _pad(d: int) -> int:
    return (d + 31) // 32 * 32


def _fixed(k: int, d: int) -> int:
    return k * _pad(d) + (k + 3) // 4 * 4 + 20


def rows_per_block(k: int, d: int) -> int:
    """Rows of the chunk one block of the narrow instance holds for a
    (k, d) basis: the most that fit beside U, or 0 (the wide instance)."""
    per_row = _pad(d) + (k | 1) + 4
    rows = max((SMEM_LIMIT // 4 - _fixed(k, d)) // per_row, 0)
    return min(rows // MIN_ROWS * MIN_ROWS, MAX_ROWS)


def smem_bytes(k: int, d: int) -> int:
    """Shared memory of one lane's sweep in the narrow instance: U (k, d),
    an append's k coefficients, and a block of ``rows_per_block`` rows (at
    least MIN_ROWS) with its (rows, k) dot matrix and four floats a row
    (||x||^2, the sum of squares, the gain, the cost), d padded to 32 and
    k to odd (to 4 for the coefficients), float32, and twenty words of
    ballots (the same sum as csrc/logdet_accept.cu)."""
    rows = max(rows_per_block(k, d), MIN_ROWS)
    return 4 * (_fixed(k, d) + rows * (_pad(d) + (k | 1) + 4))


def instance(k: int, d: int) -> str:
    """The instance of the sweep for a (k, d) basis: "shared" keeps U, a
    block of rows and its dot products in shared memory while they fit,
    "global" keeps U in the output tensor and only the k + 1 dot products
    of the row being scored in shared memory."""
    return "shared" if smem_bytes(k, d) <= SMEM_LIMIT else "global"


def logdet_accept(x, U, logdet, size, eligible, tau, budget, alpha=1.0,
                  scale=1.0, cost=None, cost_budget=None):
    """Launch the sweep.  x (B, d) or (L, B, d), float32 or bfloat16; U
    (k, d) or (L, k, d) float32; logdet () or (L,) float32; size () or (L,)
    int32; eligible (B,) or (L, B) bool; tau () or (L,) float32; budget ()
    or (L,) int32; cost (B,) or (L, B) and cost_budget () or (L,) float32,
    or both None (the knapsack cost mode, or the cardinality mode).  Returns
    (mask bool, U float32, logdet float32, size int32, gains float32),
    batched like x."""
    global launches, cost_launches
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
    wide = instance(k, d) == "global"
    _wrap.check(not wide or (k + 1) * 4 <= SMEM_LIMIT, name,
                f"k={k}: the k + 1 dot products outgrow shared memory")
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
    cost, cost_budget = _wrap.cost_operands(name, cost, cost_budget, L, B,
                                            x.device, unbatched)
    _wrap.placed(name, (x, U, logdet, size, eligible, tau, budget, cost,
                        cost_budget), x.device)
    dev = x.device
    mask = torch.empty((L, B), dtype=torch.bool, device=dev)
    U_out = torch.empty((L, k, d), dtype=torch.float32, device=dev)
    ld_out = torch.empty((L,), dtype=torch.float32, device=dev)
    size_out = torch.empty((L,), dtype=torch.int32, device=dev)
    gains = torch.empty((L, B), dtype=torch.float32, device=dev)
    _wrap.launch(name, _build.library(name).logdet_accept_launch, dev,
                 x.data_ptr(), int(x.dtype == torch.bfloat16), U.data_ptr(),
                 logdet.data_ptr(), size.data_ptr(), eligible.data_ptr(),
                 tau.data_ptr(), budget.data_ptr(), _wrap.ptr(cost),
                 _wrap.ptr(cost_budget), mask.data_ptr(),
                 U_out.data_ptr(), ld_out.data_ptr(), size_out.data_ptr(),
                 gains.data_ptr(), L, B, k, d, float(alpha), float(scale),
                 float(LOGDET_EPS), int(wide))
    launches += 1
    _wrap.count_shape(name, eligible.shape[-1])
    if cost is not None:
        cost_launches += 1
    if unbatched:
        return mask[0], U_out[0], ld_out[0], size_out[0], gains[0]
    return mask, U_out, ld_out, size_out, gains
