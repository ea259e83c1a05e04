"""CUDA kernels: FacilityLocation marginal gains (csrc/facility_marginals.cu).

    facility_marginals:      gains[l, i] = sum_j max(max(<cand_i, ref_j>, 0) - state[l, j], 0)
    rectified_residual_sum:  gains[l, i] = sum_j max(aux[i, j] - state[l, j], 0)

The ports of ``repro.kernels.facility_marginals`` (both Pallas TPU kernels
of that file), with an explicit lane axis: one launch scores a candidate
block against every lane of a threshold grid, and the fused kernel
computes each similarity tile once for all lanes.  These wrappers only
launch; ``kernels.ops`` routes CPU tensors to the plain versions in
``kernels.ref``.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

#: kernel launches per entry point since the last reset (set to 0 to reset)
launches = {"facility_marginals": 0, "rectified_residual_sum": 0}


def _check(cond: bool, name: str, msg: str) -> None:
    if not cond:
        raise ValueError(f"{name}: {msg}")


def _check_lanes(name, x, state, r):
    """Shared rank/lane checks for a (C, .) or (L, C, .) block against an
    (r,) or (L, r) state; returns (L, C, per_lane, out shape)."""
    _check(x.dim() in (2, 3) and state.dim() in (1, 2), name,
           f"bad ranks x{tuple(x.shape)} state{tuple(state.shape)}")
    _check(state.dtype == torch.float32, name,
           f"state must be float32, got {state.dtype}")
    _check(state.shape[-1] == r, name, f"state width {state.shape[-1]} != r={r}")
    L = 1 if state.dim() == 1 else state.shape[0]
    per_lane = x.dim() == 3
    _check(not per_lane or (state.dim() == 2 and x.shape[0] == L), name,
           f"per-lane x{tuple(x.shape)} needs state (L, r), got "
           f"{tuple(state.shape)}")
    C = x.shape[-2]
    return L, C, per_lane, ((L, C) if state.dim() == 2 else (C,))


def _check_placed(name, tensors, device):
    for t in tensors:
        _check(t.device == device, name, f"tensors on {t.device} and {device}")
        _check(t.is_contiguous(), name, "inputs must be contiguous")


def facility_marginals(cand, ref, state):
    """Launch the fused kernel.  cand (C, d) or (L, C, d), float32 or
    bfloat16; ref (r, d), float32 or bfloat16 (a bf16 ref is widened to
    f32, which is exact); state (r,) or (L, r) float32; all contiguous CUDA
    tensors on one device.  Returns (C,) for cand (C, d) with state (r,),
    else (L, C) float32."""
    name = "facility_marginals"
    _check(cand.is_cuda, name, f"cand must be a CUDA tensor, got {cand.device}")
    for t, what in ((cand, "cand"), (ref, "ref")):
        _check(t.dtype in (torch.float32, torch.bfloat16), name,
               f"{what} must be float32 or bfloat16, got {t.dtype}")
    _check(ref.dim() == 2 and ref.shape[1] == cand.shape[-1], name,
           f"ref must be (r, {cand.shape[-1]}), got {tuple(ref.shape)}")
    r, d = ref.shape
    L, C, per_lane, out_shape = _check_lanes(name, cand, state, r)
    _check_placed(name, (cand, ref, state), cand.device)
    ref = ref.float()
    out = torch.empty(out_shape, dtype=torch.float32, device=cand.device)
    if C == 0:
        return out
    if r == 0:
        return out.zero_()
    lib = _build.library("facility_marginals")
    with torch.cuda.device(cand.device):
        stream = torch.cuda.current_stream(cand.device).cuda_stream
        err = lib.facility_marginals_launch(
            cand.data_ptr(), int(cand.dtype == torch.bfloat16), int(per_lane),
            ref.data_ptr(), state.data_ptr(), out.data_ptr(), L, C, r, d,
            ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
    launches[name] += 1
    return out


def rectified_residual_sum(aux, state):
    """Launch the streaming kernel.  aux (C, r) or (L, C, r) float32;
    state (r,) or (L, r) float32; contiguous CUDA tensors on one device.
    Returns (C,) for aux (C, r) with state (r,), else (L, C) float32."""
    name = "rectified_residual_sum"
    _check(aux.is_cuda, name, f"aux must be a CUDA tensor, got {aux.device}")
    _check(aux.dtype == torch.float32, name,
           f"aux must be float32, got {aux.dtype}")
    r = aux.shape[-1]
    L, C, per_lane, out_shape = _check_lanes(name, aux, state, r)
    _check_placed(name, (aux, state), aux.device)
    out = torch.empty(out_shape, dtype=torch.float32, device=aux.device)
    if C == 0:
        return out
    if r == 0:
        return out.zero_()
    lib = _build.library("facility_marginals")
    with torch.cuda.device(aux.device):
        stream = torch.cuda.current_stream(aux.device).cuda_stream
        err = lib.rectified_residual_sum_launch(
            aux.data_ptr(), int(per_lane), state.data_ptr(), out.data_ptr(),
            L, C, r, ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
    launches[name] += 1
    return out
