"""CUDA kernel: FeatureCoverage marginal gains (csrc/coverage_marginals.cu).

    gains[l, i] = sum_f w_f * ( sqrt(state[l, f] + x[i, f]) - sqrt(state[l, f]) )

The port of ``repro.kernels.coverage_marginals`` (a Pallas TPU kernel), with
an explicit lane axis: one launch scores a candidate block against every
lane of a threshold grid.  This wrapper only launches; ``kernels.ops``
routes CPU tensors to the plain version in ``kernels.ref``.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

#: kernel launches since the last reset (set to 0 to reset)
launches = 0


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"coverage_marginals: {msg}")


def coverage_marginals(x, state, weights=None):
    """Launch the kernel.  x (C, d) or (L, C, d), float32 or bfloat16;
    state (d,) or (L, d) float32; weights (d,) float32 or None; all
    contiguous CUDA tensors on one device.  Returns (C,) for x (C, d) with
    state (d,), else (L, C) float32."""
    global launches
    _check(x.is_cuda, f"x must be a CUDA tensor, got {x.device}")
    _check(x.dtype in (torch.float32, torch.bfloat16),
           f"x must be float32 or bfloat16, got {x.dtype}")
    _check(state.dtype == torch.float32, f"state must be float32, got {state.dtype}")
    _check(x.dim() in (2, 3) and state.dim() in (1, 2),
           f"bad ranks x{tuple(x.shape)} state{tuple(state.shape)}")
    d = x.shape[-1]
    C = x.shape[-2]
    L = 1 if state.dim() == 1 else state.shape[0]
    per_lane = x.dim() == 3
    _check(state.shape[-1] == d, f"state width {state.shape[-1]} != d={d}")
    _check(not per_lane or (state.dim() == 2 and x.shape[0] == L),
           f"per-lane x{tuple(x.shape)} needs state (L, d), got {tuple(state.shape)}")
    tensors = [x, state]
    if weights is not None:
        _check(weights.dtype == torch.float32 and weights.shape == (d,),
               f"weights must be float32 ({d},), got {weights.dtype} {tuple(weights.shape)}")
        tensors.append(weights)
    for t in tensors:
        _check(t.device == x.device, f"tensors on {t.device} and {x.device}")
        _check(t.is_contiguous(), "inputs must be contiguous")
    out = torch.empty((L, C) if state.dim() == 2 else (C,),
                      dtype=torch.float32, device=x.device)
    if C == 0:
        return out
    lib = _build.library("coverage_marginals")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.coverage_marginals_launch(
            x.data_ptr(), int(x.dtype == torch.bfloat16), int(per_lane),
            state.data_ptr(), weights.data_ptr() if weights is not None else None,
            out.data_ptr(), L, C, d, ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"coverage_marginals: CUDA error {err} at launch")
    launches += 1
    return out
