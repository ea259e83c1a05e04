"""CUDA kernel: ExemplarClustering marginal gains
(csrc/exemplar_marginals.cu).

    gains[l, i] = sum_j max(state[l, j] - d2(i, j), 0)
    d2(i, j)    = max((||ref_j||^2 - 2 <cand_i, ref_j>) + ||cand_i||^2, 0)

The port of ``repro.kernels.exemplar_marginals`` (a Pallas TPU kernel),
with an explicit lane axis: one launch scores a candidate block against
every lane of a threshold grid, and each distance tile is computed once
for all lanes.  This wrapper only launches; ``kernels.ops`` routes CPU
tensors to the plain version in ``kernels.ref``.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build, _wrap

#: kernel launches since the last reset (set to 0 to reset)
launches = 0


def exemplar_marginals(cand, ref, state):
    """Launch the kernel.  cand (C, d) or (L, C, d), float32 or bfloat16;
    ref (r, d), float32 or bfloat16 (widened to f32, which is exact); state
    (r,) or (L, r) float32; all contiguous CUDA tensors on one device.
    Returns (C,) for cand (C, d) with state (r,), else (L, C) float32."""
    global launches
    name = "exemplar_marginals"
    _wrap.check_rows(name, cand, "cand")
    _wrap.check_rows(name, ref, "ref")
    _wrap.check(ref.dim() == 2 and ref.shape[1] == cand.shape[-1], name,
                f"ref must be (r, {cand.shape[-1]}), got {tuple(ref.shape)}")
    r, d = ref.shape
    L, C, per_lane, out_shape = _wrap.lanes(name, cand, state, r)
    _wrap.placed(name, (cand, ref, state), cand.device)
    out = torch.empty(out_shape, dtype=torch.float32, device=cand.device)
    if C == 0:
        return out
    if r == 0:
        return out.zero_()
    ref = ref.float()
    refsq = (ref * ref).sum(-1)
    _wrap.launch(name, _build.library(name).exemplar_marginals_launch,
                 cand.device, cand.data_ptr(),
                 int(cand.dtype == torch.bfloat16), int(per_lane),
                 ref.data_ptr(), refsq.data_ptr(), state.data_ptr(),
                 out.data_ptr(), L, C, r, d)
    launches += 1
    _wrap.count_shape(name, C)
    return out
