"""Plain PyTorch versions of the port's CUDA kernels.

These are the semantics.  The CUDA kernels must match them to float
tolerance, the CPU route runs them, and the tests hold them against the JAX
package's ``repro.kernels.ref``.  Each takes an optional leading lane axis
L, the batch the JAX engines got from ``vmap``; the unbatched call keeps the
JAX reference's signature.
"""

from __future__ import annotations

import torch


def coverage_marginals(x, state, weights=None):
    """FeatureCoverage marginal gains.

    x (C, d) or (L, C, d), float32 or bfloat16; state (d,) or (L, d) f32;
    weights optional (d,) f32.  Returns (C,) for an unbatched call, else
    (L, C) f32, with

        gains[l, i] = sum_f w_f (sqrt(state[l, f] + x[i, f]) - sqrt(state[l, f]))

    A (C, d) ``x`` with an (L, d) state is shared by every lane.
    """
    st = state.float().unsqueeze(-2)
    g = torch.sqrt(st + x.float()) - torch.sqrt(st)
    if weights is not None:
        g = g * weights
    return g.sum(-1)


def _lanes(x, state, eligible, tau, budget):
    """Lift an unbatched accept call onto one lane; returns the lane-batched
    operands and whether to drop the lane axis again."""
    unbatched = x.dim() == 2
    if unbatched:
        x, state, eligible = x[None], state[None], eligible[None]
    L = x.shape[0]
    tau = torch.as_tensor(tau, dtype=torch.float32, device=x.device)
    budget = torch.as_tensor(budget, dtype=torch.int32, device=x.device)
    return (x, state, eligible, tau.reshape(-1).expand(L),
            budget.reshape(-1).expand(L), unbatched)


def accept_scan(gain_fn, update_fn, rows, state, eligible, tau, budget):
    """The sequential accept sweep over (L, B, d) rows, one lane per batch
    entry: row i's gain is taken against the state after every earlier
    accepted row, and the row is accepted when eligible & gain >= tau &
    accepts-so-far < budget.  Returns (mask (L, B) bool, state (L, d) f32,
    gains (L, B) f32)."""
    st = state.float()
    L, B = rows.shape[:2]
    n_acc = torch.zeros(L, dtype=torch.int32, device=st.device)
    mask = torch.zeros(L, B, dtype=torch.bool, device=st.device)
    gains = torch.zeros(L, B, dtype=torch.float32, device=st.device)
    for i in range(B):
        xr = rows[:, i]
        g = gain_fn(st, xr)
        acc = eligible[:, i] & (g >= tau) & (n_acc < budget)
        st = torch.where(acc[:, None], update_fn(st, xr), st)
        n_acc = n_acc + acc.to(torch.int32)
        mask[:, i] = acc
        gains[:, i] = g
    return mask, st, gains


def coverage_accept(x, state, weights, eligible, tau, budget):
    """FeatureCoverage accept sweep.

    x (B, d) or (L, B, d); state (d,) or (L, d) f32; weights (d,) f32 or
    None; eligible (B,) or (L, B) bool; tau () or (L,); budget () or (L,)
    int.  Returns (mask bool, state f32, gains f32), batched like ``x``.
    """
    x, state, eligible, tau, budget, unbatched = _lanes(
        x, state, eligible, tau, budget)
    w = (weights if weights is not None
         else torch.ones(x.shape[-1], dtype=torch.float32, device=x.device))
    out = accept_scan(
        lambda st, xr: ((torch.sqrt(st + xr) - torch.sqrt(st)) * w).sum(-1),
        lambda st, xr: st + xr,
        x.float(), state, eligible.bool(), tau, budget)
    return tuple(o[0] for o in out) if unbatched else out
