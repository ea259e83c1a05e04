"""CUDA kernel: fused FeatureCoverage chunk-accept sweep
(csrc/coverage_accept.cu on the shared sweep in csrc/accept_sweep.cuh).

The port of ``repro.kernels.coverage_accept`` (a Pallas TPU kernel built by
``accept_call`` in ``repro/kernels/_accept_common.py``), cardinality mode:
one launch sweeps the (B, d) tile of every lane, one CTA per lane, in stream
order against the live state.  This wrapper only launches; ``kernels.ops``
routes CPU tensors to the plain version in ``kernels.ref``.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

#: kernel launches since the last reset (set to 0 to reset)
launches = 0

#: widest feature row one CTA holds in registers (128 threads x 16)
MAX_D = 2048


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"coverage_accept: {msg}")


def coverage_accept(x, state, weights, eligible, tau, budget):
    """Launch the sweep.  x (B, d) or (L, B, d), float32 or bfloat16;
    state (d,) or (L, d) float32; weights (d,) float32 or None; eligible
    (B,) or (L, B) bool; tau () or (L,) float32; budget () or (L,) int32.
    Returns (mask bool, state float32, gains float32), batched like x."""
    global launches
    _check(x.is_cuda, f"x must be a CUDA tensor, got {x.device}")
    _check(x.dtype in (torch.float32, torch.bfloat16),
           f"x must be float32 or bfloat16, got {x.dtype}")
    unbatched = x.dim() == 2
    _check(x.dim() in (2, 3), f"x must be (B, d) or (L, B, d), got {tuple(x.shape)}")
    if unbatched:
        x, state, eligible = x[None], state[None], eligible[None]
    L, B, d = x.shape
    _check(d <= MAX_D, f"d={d} exceeds {MAX_D}")
    tau = torch.as_tensor(tau, dtype=torch.float32, device=x.device).reshape(-1)
    budget = torch.as_tensor(budget, dtype=torch.int32,
                             device=x.device).reshape(-1)
    _check(state.dtype == torch.float32 and state.shape == (L, d),
           f"state must be float32 {(L, d)}, got {state.dtype} {tuple(state.shape)}")
    _check(eligible.dtype == torch.bool and eligible.shape == (L, B),
           f"eligible must be bool {(L, B)}, got {eligible.dtype} {tuple(eligible.shape)}")
    _check(tau.dtype == torch.float32 and tau.shape == (L,),
           f"tau must be float32 ({L},), got {tau.dtype} {tuple(tau.shape)}")
    _check(budget.dtype == torch.int32 and budget.shape == (L,),
           f"budget must be int32 ({L},), got {budget.dtype} {tuple(budget.shape)}")
    tensors = [x, state, eligible, tau, budget]
    if weights is not None:
        _check(weights.dtype == torch.float32 and weights.shape == (d,),
               f"weights must be float32 ({d},), got {weights.dtype} {tuple(weights.shape)}")
        tensors.append(weights)
    for t in tensors:
        _check(t.device == x.device, f"tensors on {t.device} and {x.device}")
        _check(t.is_contiguous(), "inputs must be contiguous")
    mask = torch.empty((L, B), dtype=torch.bool, device=x.device)
    state_out = torch.empty((L, d), dtype=torch.float32, device=x.device)
    gains = torch.empty((L, B), dtype=torch.float32, device=x.device)
    lib = _build.library("coverage_accept")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.coverage_accept_launch(
            x.data_ptr(), int(x.dtype == torch.bfloat16), state.data_ptr(),
            weights.data_ptr() if weights is not None else None,
            eligible.data_ptr(), tau.data_ptr(), budget.data_ptr(),
            mask.data_ptr(), state_out.data_ptr(), gains.data_ptr(),
            L, B, d, ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"coverage_accept: CUDA error {err} at launch")
    launches += 1
    if unbatched:
        return mask[0], state_out[0], gains[0]
    return mask, state_out, gains
