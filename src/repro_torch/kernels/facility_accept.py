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

import torch

from repro_torch.kernels import _build, _wrap

#: kernel launches since the last reset (set to 0 to reset)
launches = 0

#: most reference rows one CTA holds in registers (256 threads x 16)
MAX_R = 4096


def facility_accept(cand, ref, state, eligible, tau, budget):
    """Launch the sweep.  cand (B, d) or (L, B, d), float32 or bfloat16;
    ref (r, d), float32 or bfloat16 (widened to f32, which is exact); state
    (r,) or (L, r) float32; eligible (B,) or (L, B) bool; tau () or (L,)
    float32; budget () or (L,) int32.  Returns (mask bool, state float32,
    gains float32), batched like cand."""
    global launches
    name = "facility_accept"
    _wrap.check_rows(name, cand, "cand")
    _wrap.check_rows(name, ref, "ref")
    d = cand.shape[-1]
    _wrap.check(ref.dim() == 2 and ref.shape[1] == d, name,
                f"ref must be (r, {d}), got {tuple(ref.shape)}")
    r = ref.shape[0]
    _wrap.check(1 <= r <= MAX_R, name, f"r={r} outside [1, {MAX_R}]")
    cand, state, eligible, tau, budget, unbatched = _wrap.sweep_operands(
        name, cand, state, eligible, tau, budget, r)
    _wrap.placed(name, (cand, ref, state, eligible, tau, budget), cand.device)
    ref = ref.float()
    mask, state_out, gains = _wrap.sweep_outputs(cand, r)
    L, B = cand.shape[:2]
    work = torch.empty((L, B, r), dtype=torch.float32, device=cand.device)
    _wrap.launch(name, _build.library(name).facility_accept_launch,
                 cand.device, cand.data_ptr(),
                 int(cand.dtype == torch.bfloat16), ref.data_ptr(),
                 state.data_ptr(), eligible.data_ptr(), tau.data_ptr(),
                 budget.data_ptr(), mask.data_ptr(), state_out.data_ptr(),
                 gains.data_ptr(), work.data_ptr(), L, B, r, d)
    launches += 1
    if unbatched:
        return mask[0], state_out[0], gains[0]
    return mask, state_out, gains
