"""CUDA kernel: fused FacilityLocation chunk-accept sweep
(csrc/facility_accept.cu on the shared sweep in csrc/accept_sweep.cuh).

The port of ``repro.kernels.facility_accept`` (a Pallas TPU kernel),
cardinality mode: one launch sweeps the (B, d) chunk of every lane, one CTA
per lane; each CTA first computes its (B, r) rectified similarity block
into a workspace this wrapper allocates, then sweeps it in stream order
against the live cover vector.  This wrapper only launches;
``kernels.ops`` routes CPU tensors to the plain version in ``kernels.ref``.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

#: kernel launches since the last reset (set to 0 to reset)
launches = 0

#: most reference rows one CTA holds in registers (256 threads x 16)
MAX_R = 4096


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"facility_accept: {msg}")


def facility_accept(cand, ref, state, eligible, tau, budget):
    """Launch the sweep.  cand (B, d) or (L, B, d), float32 or bfloat16;
    ref (r, d), float32 or bfloat16 (widened to f32, which is exact); state
    (r,) or (L, r) float32; eligible (B,) or (L, B) bool; tau () or (L,)
    float32; budget () or (L,) int32.  Returns (mask bool, state float32,
    gains float32), batched like cand."""
    global launches
    _check(cand.is_cuda, f"cand must be a CUDA tensor, got {cand.device}")
    for t, what in ((cand, "cand"), (ref, "ref")):
        _check(t.dtype in (torch.float32, torch.bfloat16),
               f"{what} must be float32 or bfloat16, got {t.dtype}")
    _check(cand.dim() in (2, 3),
           f"cand must be (B, d) or (L, B, d), got {tuple(cand.shape)}")
    unbatched = cand.dim() == 2
    if unbatched:
        cand, state, eligible = cand[None], state[None], eligible[None]
    L, B, d = cand.shape
    _check(ref.dim() == 2 and ref.shape[1] == d,
           f"ref must be (r, {d}), got {tuple(ref.shape)}")
    r = ref.shape[0]
    _check(1 <= r <= MAX_R, f"r={r} outside [1, {MAX_R}]")
    tau = torch.as_tensor(tau, dtype=torch.float32, device=cand.device).reshape(-1)
    budget = torch.as_tensor(budget, dtype=torch.int32,
                             device=cand.device).reshape(-1)
    _check(state.dtype == torch.float32 and state.shape == (L, r),
           f"state must be float32 {(L, r)}, got {state.dtype} {tuple(state.shape)}")
    _check(eligible.dtype == torch.bool and eligible.shape == (L, B),
           f"eligible must be bool {(L, B)}, got {eligible.dtype} "
           f"{tuple(eligible.shape)}")
    _check(tau.dtype == torch.float32 and tau.shape == (L,),
           f"tau must be float32 ({L},), got {tau.dtype} {tuple(tau.shape)}")
    _check(budget.dtype == torch.int32 and budget.shape == (L,),
           f"budget must be int32 ({L},), got {budget.dtype} {tuple(budget.shape)}")
    for t in (cand, ref, state, eligible, tau, budget):
        _check(t.device == cand.device, f"tensors on {t.device} and {cand.device}")
        _check(t.is_contiguous(), "inputs must be contiguous")
    ref = ref.float()
    mask = torch.empty((L, B), dtype=torch.bool, device=cand.device)
    state_out = torch.empty((L, r), dtype=torch.float32, device=cand.device)
    gains = torch.empty((L, B), dtype=torch.float32, device=cand.device)
    work = torch.empty((L, B, r), dtype=torch.float32, device=cand.device)
    lib = _build.library("facility_accept")
    with torch.cuda.device(cand.device):
        stream = torch.cuda.current_stream(cand.device).cuda_stream
        err = lib.facility_accept_launch(
            cand.data_ptr(), int(cand.dtype == torch.bfloat16), ref.data_ptr(),
            state.data_ptr(), eligible.data_ptr(), tau.data_ptr(),
            budget.data_ptr(), mask.data_ptr(), state_out.data_ptr(),
            gains.data_ptr(), work.data_ptr(), L, B, r, d,
            ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"facility_accept: CUDA error {err} at launch")
    launches += 1
    if unbatched:
        return mask[0], state_out[0], gains[0]
    return mask, state_out, gains
