"""CUDA kernel: fused ExemplarClustering chunk-accept sweep
(csrc/exemplar_accept.cu on csrc/reference_tile.cuh).

The port of ``repro.kernels.exemplar_accept`` (a Pallas TPU kernel), in
both of its modes (cardinality, and the knapsack cost mode of
``cost``/``cost_budget``): one call sweeps the (B, d) chunk of every lane.
It launches the (L, B, r) squared-distance product over the whole card
into a workspace this wrapper allocates, then one CTA per lane walks its
block in stream order against the live min-distance vector, a window of
rows a pass.  This wrapper only launches; ``kernels.ops`` routes CPU
tensors to the plain version in ``kernels.ref``.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build, _wrap

#: kernel launches since the last reset (set to 0 to reset)
launches = 0

#: of those, launches in the knapsack cost mode
cost_launches = 0


def exemplar_accept(cand, ref, state, eligible, tau, budget, cost=None,
                    cost_budget=None):
    """Launch the sweep.  cand (B, d) or (L, B, d), float32 or bfloat16;
    ref (r, d), float32 or bfloat16 (widened to f32, which is exact); state
    (r,) or (L, r) float32; eligible (B,) or (L, B) bool; tau () or (L,)
    float32; budget () or (L,) int32; cost (B,) or (L, B) and cost_budget ()
    or (L,) float32, or both None (the knapsack cost mode, or the
    cardinality mode).  Returns (mask bool, state float32, gains float32),
    batched like cand."""
    global launches, cost_launches
    name = "exemplar_accept"
    _wrap.check_rows(name, cand, "cand")
    _wrap.check_rows(name, ref, "ref")
    d = cand.shape[-1]
    _wrap.check(ref.dim() == 2 and ref.shape[1] == d, name,
                f"ref must be (r, {d}), got {tuple(ref.shape)}")
    r = ref.shape[0]
    _wrap.check(r >= 1, name, "ref has no rows")
    cand, state, eligible, tau, budget, unbatched = _wrap.sweep_operands(
        name, cand, state, eligible, tau, budget, r)
    L, B = cand.shape[:2]
    cost, cost_budget = _wrap.cost_operands(name, cost, cost_budget, L, B,
                                            cand.device, unbatched)
    _wrap.placed(name, (cand, ref, state, eligible, tau, budget, cost,
                        cost_budget), cand.device)
    ref = ref.float()
    refsq = (ref * ref).sum(-1)
    mask, state_out, gains = _wrap.sweep_outputs(cand, r)
    work = torch.empty((L, B, r), dtype=torch.float32, device=cand.device)
    _wrap.launch(name, _build.library(name).exemplar_accept_launch,
                 cand.device, cand.data_ptr(),
                 int(cand.dtype == torch.bfloat16), ref.data_ptr(),
                 refsq.data_ptr(), state.data_ptr(), eligible.data_ptr(),
                 tau.data_ptr(), budget.data_ptr(), _wrap.ptr(cost),
                 _wrap.ptr(cost_budget), mask.data_ptr(),
                 state_out.data_ptr(), gains.data_ptr(), work.data_ptr(), L,
                 B, r, d, _wrap.reference_sweep_per(r))
    launches += 1
    _wrap.count_shape(name, eligible.shape[-1])
    if cost is not None:
        cost_launches += 1
    if unbatched:
        return mask[0], state_out[0], gains[0]
    return mask, state_out, gains
