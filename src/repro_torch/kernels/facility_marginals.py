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

import torch

from repro_torch.kernels import _build, _wrap

#: kernel launches per entry point since the last reset (set to 0 to reset)
launches = {"facility_marginals": 0, "rectified_residual_sum": 0}


def facility_marginals(cand, ref, state):
    """Launch the fused kernel.  cand (C, d) or (L, C, d), float32 or
    bfloat16; ref (r, d), float32 or bfloat16 (a bf16 ref is widened to
    f32, which is exact); state (r,) or (L, r) float32; all contiguous CUDA
    tensors on one device.  Returns (C,) for cand (C, d) with state (r,),
    else (L, C) float32."""
    name = "facility_marginals"
    _wrap.check_rows(name, cand, "cand")
    _wrap.check_rows(name, ref, "ref")
    _wrap.check(ref.dim() == 2 and ref.shape[1] == cand.shape[-1], name,
                f"ref must be (r, {cand.shape[-1]}), got {tuple(ref.shape)}")
    r, d = ref.shape
    L, C, per_lane, out_shape = _wrap.lanes(name, cand, state, r)
    _wrap.placed(name, (cand, ref, state), cand.device)
    ref = ref.float()
    out = torch.empty(out_shape, dtype=torch.float32, device=cand.device)
    if C == 0:
        return out
    if r == 0:
        return out.zero_()
    _wrap.launch(name, _build.library(name).facility_marginals_launch,
                 cand.device, cand.data_ptr(),
                 int(cand.dtype == torch.bfloat16), int(per_lane),
                 ref.data_ptr(), state.data_ptr(), out.data_ptr(), L, C, r, d)
    launches[name] += 1
    _wrap.count_shape(name, C)
    return out


def rectified_residual_sum(aux, state):
    """Launch the streaming kernel.  aux (C, r) or (L, C, r) float32;
    state (r,) or (L, r) float32; contiguous CUDA tensors on one device.
    Returns (C,) for aux (C, r) with state (r,), else (L, C) float32."""
    name = "rectified_residual_sum"
    _wrap.check(aux.is_cuda, name, f"aux must be a CUDA tensor, got {aux.device}")
    _wrap.check(aux.dtype == torch.float32, name,
                f"aux must be float32, got {aux.dtype}")
    r = aux.shape[-1]
    L, C, per_lane, out_shape = _wrap.lanes(name, aux, state, r)
    _wrap.placed(name, (aux, state), aux.device)
    out = torch.empty(out_shape, dtype=torch.float32, device=aux.device)
    if C == 0:
        return out
    if r == 0:
        return out.zero_()
    _wrap.launch(name,
                 _build.library("facility_marginals").rectified_residual_sum_launch,
                 aux.device, aux.data_ptr(), int(per_lane), state.data_ptr(),
                 out.data_ptr(), L, C, r)
    launches[name] += 1
    _wrap.count_shape(name, C)
    return out
