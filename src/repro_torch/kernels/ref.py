"""Plain PyTorch versions of the port's CUDA kernels.

These are the semantics.  The CUDA kernels must match them to float
tolerance, the CPU route runs them, and the tests hold them against the JAX
package's ``repro.kernels.ref``.  Each takes an optional leading lane axis
L, the batch the JAX engines got from ``vmap``; the unbatched call keeps the
JAX reference's signature.
"""

from __future__ import annotations

import torch

from repro_torch.states import tree_map, where_state

#: clamp of the log-det Schur complement (exact math keeps it >= 1)
LOGDET_EPS = 1e-12


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


def weighted_coverage_marginals(x, state):
    """WeightedCoverage marginal gains.

    x (C, U) or (L, C, U), float32 or bfloat16; state (U,) or (L, U) f32,
    the remaining (uncovered) weight per universe item.  Returns (C,) for
    an unbatched call, else (L, C) f32, with

        gains[l, i] = sum_u state[l, u] * x[i, u]

    A (C, U) ``x`` with an (L, U) state is shared by every lane.
    """
    return (state.float().unsqueeze(-2) * x.float()).sum(-1)


def saturated_coverage_marginals(x, state, cap, weights=None):
    """SaturatedCoverage marginal gains.

    x (C, d) or (L, C, d), float32 or bfloat16; state (d,) or (L, d) f32;
    cap (d,) f32, the per-feature saturation level alpha * total; weights
    optional (d,) f32.  Returns (C,) for an unbatched call, else (L, C) f32,
    with

        gains[l, i] = sum_f w_f (min(state[l, f] + x[i, f], cap_f)
                                 - min(state[l, f], cap_f))

    A (C, d) ``x`` with an (L, d) state is shared by every lane.
    """
    st = state.float().unsqueeze(-2)
    cap = cap.float()
    g = torch.minimum(st + x.float(), cap) - torch.minimum(st, cap)
    if weights is not None:
        g = g * weights
    return g.sum(-1)


def rectified_residual_sum(aux, state):
    """FacilityLocation marginal gains from precomputed similarities.

    aux (C, r) or (L, C, r); state (r,) or (L, r) f32.  Returns (C,) for an
    unbatched call, else (L, C) f32, with

        gains[l, i] = sum_j max(aux[i, j] - state[l, j], 0)

    A (C, r) ``aux`` with an (L, r) state is shared by every lane.
    """
    return torch.clamp_min(aux.float() - state.float().unsqueeze(-2),
                           0.0).sum(-1)


def similarities(cand, ref):
    """The rectified similarity block max(cand @ ref.T, 0), f32 products of
    the f32-lifted operands: (C, d) or (L, C, d) against (r, d)."""
    return torch.clamp_min(torch.matmul(cand.float(), ref.float().T), 0.0)


def facility_marginals(cand, ref, state):
    """FacilityLocation marginal gains straight from features.

    cand (C, d) or (L, C, d), float32 or bfloat16; ref (r, d); state (r,)
    or (L, r) f32.  Returns (C,) for an unbatched call, else (L, C) f32:

        gains[l, i] = sum_j max(max(<cand_i, ref_j>, 0) - state[l, j], 0)
    """
    return rectified_residual_sum(similarities(cand, ref), state)


def exemplar_distances(cand, ref):
    """The clamped squared-distance block of ExemplarClustering,

        d2[i, j] = max((||ref_j||^2 - 2 <cand_i, ref_j>) + ||cand_i||^2, 0),

    in the JAX package's order, all on the f32 accumulate plane (the
    operands lifted to f32, the norms f32 sums of squares): (C, d) or
    (L, C, d) against (r, d) gives (C, r) or (L, C, r)."""
    cand = cand.float()
    ref = ref.float()
    refsq = (ref * ref).sum(-1)
    sq = (cand * cand).sum(-1, keepdim=True)
    return torch.clamp_min(refsq - 2.0 * torch.matmul(cand, ref.T) + sq, 0.0)


def exemplar_residual_sum(aux, state):
    """ExemplarClustering marginal gains from precomputed distances.

    aux (C, r) or (L, C, r); state (r,) or (L, r) f32, the current
    per-reference min squared distance.  Returns (C,) for an unbatched
    call, else (L, C) f32, with

        gains[l, i] = sum_j max(state[l, j] - aux[i, j], 0)

    A (C, r) ``aux`` with an (L, r) state is shared by every lane.
    """
    return torch.clamp_min(state.float().unsqueeze(-2) - aux.float(),
                           0.0).sum(-1)


def exemplar_marginals(cand, ref, state):
    """ExemplarClustering marginal gains straight from features.

    cand (C, d) or (L, C, d), float32 or bfloat16; ref (r, d); state (r,)
    or (L, r) f32.  Returns (C,) for an unbatched call, else (L, C) f32:

        gains[l, i] = sum_j max(state[l, j] - d2(i, j), 0)

    with d2 the clamped squared distance of ``exemplar_distances``.
    """
    return exemplar_residual_sum(exemplar_distances(cand, ref), state)


def graph_cut_marginals(x, total, state, lam=0.5):
    """GraphCut marginal gains.

    x (C, d) or (L, C, d), float32 or bfloat16; total (d,) f32, the ground
    set's feature sum t; state (d,) or (L, d) f32, the selected rows' sum s.
    Returns (C,) for an unbatched call, else (L, C) f32, with

        gains[l, i] = <x_i, t - 2 lam s_l> - lam ||x_i||^2

    written as the JAX reference writes it: the product first, then the
    squared norm subtracted.  A (C, d) ``x`` with an (L, d) state is shared
    by every lane.
    """
    x = x.float()
    coef = total.float() - 2.0 * lam * state.float()
    if x.dim() == 2 and coef.dim() == 2:
        lin = torch.matmul(x, coef.T).T
    else:
        lin = torch.matmul(x, coef.unsqueeze(-1)).squeeze(-1)
    return lin - lam * (x * x).sum(-1)


def logdet_marginals(x, U, alpha=1.0, eps=LOGDET_EPS, scale=1.0,
                     size=None):
    """LogDetDiversity (scale 1) and MutualInformationGaussian (scale 0.5)
    marginal gains.

    x (C, d) or (L, C, d), float32 or bfloat16; U (k, d) or (L, k, d) f32,
    the whitened basis of each lane's solution (rows at or past |S| are 0).
    Returns (C,) for an unbatched call, else (L, C) f32, with

        gains[l, i] = scale * log(max(1 + alpha ||x_i||^2
                                      - alpha^2 ||U_l x_i||^2, eps))

    A (C, d) ``x`` with an (L, k, d) basis is shared by every lane.
    ``size`` (one integer per lane, 0-d for an unbatched call; None: k)
    counts each lane's live rows: the rows of U at or past it are taken as
    zero, as the CUDA kernel never reads them.  Where they are zero already
    (the oracle's state) the gains are those of ``size=None``.
    """
    x = x.float()
    U = U.float()
    if size is not None:
        size = torch.as_tensor(size, device=U.device)
        live = (torch.arange(U.shape[-2], device=U.device)
                < size.reshape(U.shape[:-2] + (1,)))
        U = torch.where(live.unsqueeze(-1), U, 0.0)
    proj = torch.matmul(x, U.transpose(-1, -2))
    resid = (1.0 + alpha * (x * x).sum(-1)
             - (alpha * alpha) * (proj * proj).sum(-1))
    gains = torch.log(torch.clamp_min(resid, eps))
    return gains if scale == 1.0 else scale * gains


def _border(U, x, alpha, eps):
    """The Cholesky border v = alpha U x of row x (d,) or (L, d) against
    the basis U (k, d) or (L, k, d), and the clamped Schur complement
    d2 = max(1 + alpha ||x||^2 - ||v||^2, eps), in the JAX sweep's order."""
    v = alpha * torch.matmul(U, x.unsqueeze(-1)).squeeze(-1)
    d2 = torch.clamp_min(1.0 + alpha * (x * x).sum(-1) - (v * v).sum(-1), eps)
    return v, d2


def logdet_append(state, x, alpha=1.0, eps=LOGDET_EPS, scale=1.0):
    """The log-det state after adding row ``x``: the rank-1 Gram-Schmidt
    append of the JAX oracle's ``add``,

        v = alpha U x,  d2 = max(1 + alpha ||x||^2 - ||v||^2, eps),
        U[size] = (x - v^T U) / sqrt(d2),  logdet += scale log d2,
        size += 1.

    state (U (k, d), logdet (), size ()) or lane-batched (U (L, k, d),
    logdet (L,), size (L,)); x (d,) or (L, d).  An append at size >= k
    writes no row of U (the JAX package's out-of-bounds scatter, which it
    drops); logdet and size still move, as there."""
    U, logdet, size = state
    x = x.float()
    v, d2 = _border(U, x, alpha, eps)
    u_new = (x - torch.matmul(v.unsqueeze(-2), U).squeeze(-2)) \
        / torch.sqrt(d2).unsqueeze(-1)
    rows = torch.arange(U.shape[-2], device=U.device)
    hit = rows == size.unsqueeze(-1)   # all False at size >= k
    U = torch.where(hit.unsqueeze(-1), u_new.unsqueeze(-2), U)
    return U, logdet + scale * torch.log(d2), size + 1


def logdet_basis(rows, sizes, alpha=1.0):
    """The lane-batched log-det state (U (L, k, d), logdet (L,), size (L,))
    in which lane l has appended rows[0, l], ..., rows[sizes[l] - 1, l] one
    by one with ``logdet_append``.  rows (k, L, d) f32, sizes (L,) int;
    rows of U at or past a lane's size stay zero."""
    k, L, d = rows.shape
    dev = rows.device
    st = (torch.zeros((L, k, d), device=dev), torch.zeros(L, device=dev),
          torch.zeros(L, dtype=torch.int32, device=dev))
    for step in range(k):
        st = where_state(step < sizes, logdet_append(st, rows[step], alpha),
                         st)
    return st


def gemm_gain_tol(cand, ref):
    """Per-row bound on how far two float32 evaluations of a facility gain
    may differ when they sum in different orders.

    A similarity s_ij = sum_k c_ik r_jk summed in any order is within
    d * 2^-24 * sum_k |c_ik| |r_jk| of the exact value; the gain sums r
    rectified residuals (each 1-Lipschitz in s_ij) and its own rounding adds
    at most r * 2^-24 times the same magnitude.  Two evaluations can each
    be that far off, so

        tol_i = 2 (d + r) 2^-24 sum_j sum_k |c_ik| |r_jk|
              = 2 (d + r) 2^-24 <|c_i|, sum_j |r_j|>.

    Shapes follow ``cand``: (C,) or (L, C)."""
    d, r = ref.shape[-1], ref.shape[0]
    mag = torch.matmul(cand.float().abs(), ref.float().abs().sum(0))
    return 2.0 * (d + r) * 2.0 ** -24 * mag


def exemplar_gain_tol(cand, ref):
    """Per-row bound on how far two float32 evaluations of an exemplar gain
    may differ when they sum in different orders.

    Each term of d2_ij = (||r_j||^2 - 2 <c_i, r_j>) + ||c_i||^2 is a sum of
    at most d products, within d 2^-24 of its magnitude in any order, and
    the two adds round once each, so d2_ij is within (d + 2) 2^-24 M_ij of
    the exact value, M_ij = ||r_j||^2 + 2 <|c_i|, |r_j|> + ||c_i||^2.  The
    gain sums r residuals, each 1-Lipschitz in d2_ij and at most
    s_j <= ||r_j||^2 (the state only falls from m0), so its own rounding
    adds at most r 2^-24 sum_j M_ij.  Two evaluations can each be that far
    off:

        tol_i = 2 (d + r + 2) 2^-24 sum_j M_ij
              = 2 (d + r + 2) 2^-24 (sum_j ||r_j||^2
                                     + 2 <|c_i|, sum_j |r_j|> + r ||c_i||^2).

    Shapes follow ``cand``: (C,) or (L, C)."""
    d, r = ref.shape[-1], ref.shape[0]
    cand, ref = cand.float(), ref.float()
    mag = ((ref * ref).sum() + 2.0 * torch.matmul(cand.abs(),
                                                  ref.abs().sum(0))
           + r * (cand * cand).sum(-1))
    return 2.0 * (d + r + 2) * 2.0 ** -24 * mag


def accept_scan(gain_fn, update_fn, rows, state, eligible, tau, budget,
                cost=None, cost_budget=None):
    """The sequential accept sweep over (L, B, d) rows, one lane per batch
    entry: row i's gain is taken against the state after every earlier
    accepted row, and the row is accepted when eligible & gain >= tau &
    accepts-so-far < budget.  Returns (mask (L, B) bool, state (L, d) f32,
    gains (L, B) f32).  The state may be a tuple of lane-batched tensors
    (``repro_torch.states``).

    ``cost`` (L, B) f32 and ``cost_budget`` (L,) f32, both given or both
    None, switch to the knapsack rule of the JAX sweep: row i with cost c_i
    is accepted when eligible & gain >= tau * c_i & accepts-so-far < budget
    & spent + c_i <= cost_budget, where ``spent`` is an f32 carry of the
    accepted costs, added in row order.  ``cost=None`` is the cardinality
    sweep, unchanged."""
    if (cost is None) != (cost_budget is None):
        raise ValueError("give cost and cost_budget together")
    st = tree_map(lambda t: t.float() if t.is_floating_point() else t, state)
    L, B = rows.shape[:2]
    dev = rows.device
    n_acc = torch.zeros(L, dtype=torch.int32, device=dev)
    mask = torch.zeros(L, B, dtype=torch.bool, device=dev)
    gains = torch.zeros(L, B, dtype=torch.float32, device=dev)
    if cost is not None:
        spent = torch.zeros(L, dtype=torch.float32, device=dev)
    for i in range(B):
        xr = rows[:, i]
        g = gain_fn(st, xr)
        if cost is None:
            acc = eligible[:, i] & (g >= tau) & (n_acc < budget)
        else:
            ci = cost[:, i]
            acc = (eligible[:, i] & (g >= tau * ci) & (n_acc < budget)
                   & (spent + ci <= cost_budget))
            spent = spent + torch.where(acc, ci, 0.0)
        st = where_state(acc, update_fn(st, xr), st)
        n_acc = n_acc + acc.to(torch.int32)
        mask[:, i] = acc
        gains[:, i] = g
    return mask, st, gains


def _sweep(gain_fn, update_fn, rows, state, eligible, tau, budget,
           cost=None, cost_budget=None):
    """``accept_scan`` over rows (B, w') or (L, B, w'), f32 or bf16 (lifted
    to f32), with an unbatched call lifted onto one lane and its outputs
    unbatched again.  The state may be a tuple (``repro_torch.states``);
    ``cost`` (B,) or (L, B) and ``cost_budget`` () or (L,) select the
    knapsack rule."""
    if (cost is None) != (cost_budget is None):
        raise ValueError("give cost and cost_budget together")
    unbatched = rows.dim() == 2
    if unbatched:
        rows, eligible = rows[None], eligible[None]
        state = tree_map(lambda t: t[None], state)
    L = rows.shape[0]
    dev = rows.device
    tau = torch.as_tensor(tau, dtype=torch.float32, device=dev)
    budget = torch.as_tensor(budget, dtype=torch.int32, device=dev)
    if cost is not None:
        cost = torch.as_tensor(cost, dtype=torch.float32,
                               device=dev).reshape(L, -1)
        cost_budget = torch.as_tensor(cost_budget, dtype=torch.float32,
                                      device=dev).reshape(-1).expand(L)
    out = accept_scan(gain_fn, update_fn, rows.float(), state,
                      eligible.bool(), tau.reshape(-1).expand(L),
                      budget.reshape(-1).expand(L), cost, cost_budget)
    return tree_map(lambda t: t[0], out) if unbatched else out


def coverage_accept(x, state, weights, eligible, tau, budget, cost=None,
                    cost_budget=None):
    """FeatureCoverage accept sweep.

    x (B, d) or (L, B, d); state (d,) or (L, d) f32; weights (d,) f32 or
    None; eligible (B,) or (L, B) bool; tau () or (L,); budget () or (L,)
    int; cost (B,) or (L, B) and cost_budget () or (L,) f32, or both None
    (``accept_scan``).  Returns (mask bool, state f32, gains f32), batched
    like ``x``.
    """
    w = (weights if weights is not None
         else torch.ones(x.shape[-1], dtype=torch.float32, device=x.device))
    return _sweep(
        lambda st, xr: ((torch.sqrt(st + xr) - torch.sqrt(st)) * w).sum(-1),
        lambda st, xr: st + xr, x, state, eligible, tau, budget, cost,
        cost_budget)


def weighted_coverage_accept(x, state, eligible, tau, budget, cost=None,
                             cost_budget=None):
    """WeightedCoverage accept sweep.

    x (B, U) or (L, B, U); state (U,) or (L, U) f32, the remaining weight;
    eligible (B,) or (L, B) bool; tau () or (L,); budget () or (L,) int;
    cost and cost_budget as in ``coverage_accept``.  Row i's gain is
    sum_u s_u x_iu, and an accepted row applies s = s * (1 - x_i), exact
    (0 or s) on binary incidence rows.  Returns (mask bool, state f32,
    gains f32), batched like ``x``.
    """
    return _sweep(lambda st, xr: (st * xr).sum(-1),
                  lambda st, xr: st * (1.0 - xr),
                  x, state, eligible, tau, budget, cost, cost_budget)


def saturated_coverage_accept(x, state, cap, weights, eligible, tau, budget,
                              cost=None, cost_budget=None):
    """SaturatedCoverage accept sweep.

    x (B, d) or (L, B, d); state (d,) or (L, d) f32; cap (d,) f32; weights
    (d,) f32 or None; eligible (B,) or (L, B) bool; tau () or (L,); budget
    () or (L,) int; cost and cost_budget as in ``coverage_accept``.  Row
    i's gain is sum_f w_f (min(s_f + x_if, cap_f) - min(s_f, cap_f)), and
    an accepted row applies s += x_i.  Returns (mask bool, state f32, gains
    f32), batched like ``x``.
    """
    w = (weights if weights is not None
         else torch.ones(x.shape[-1], dtype=torch.float32, device=x.device))
    cap = cap.float()
    return _sweep(
        lambda st, xr: ((torch.minimum(st + xr, cap)
                         - torch.minimum(st, cap)) * w).sum(-1),
        lambda st, xr: st + xr, x, state, eligible, tau, budget, cost,
        cost_budget)


def facility_accept(cand, ref, state, eligible, tau, budget, cost=None,
                    cost_budget=None):
    """FacilityLocation accept sweep over the rectified similarity rows.

    cand (B, d) or (L, B, d); ref (r, d); state (r,) or (L, r) f32;
    eligible (B,) or (L, B) bool; tau () or (L,); budget () or (L,) int;
    cost and cost_budget as in ``coverage_accept``.  Row i's gain is
    sum_j max(sims_ij - s_j, 0) against the live cover vector s, and an
    accepted row applies s = max(s, sims_i).  Returns (mask bool, state
    f32, gains f32), batched like ``cand``.
    """
    return _sweep(lambda st, sr: torch.clamp_min(sr - st, 0.0).sum(-1),
                  torch.maximum, similarities(cand, ref), state, eligible,
                  tau, budget, cost, cost_budget)


def exemplar_accept(cand, ref, state, eligible, tau, budget, cost=None,
                    cost_budget=None):
    """ExemplarClustering accept sweep over the squared-distance rows.

    cand (B, d) or (L, B, d); ref (r, d); state (r,) or (L, r) f32, the
    live min-distance vector; eligible (B,) or (L, B) bool; tau () or (L,);
    budget () or (L,) int; cost and cost_budget as in ``coverage_accept``.
    Row i's gain is sum_j max(s_j - d2_ij, 0) with d2 from
    ``exemplar_distances``, and an accepted row applies s = min(s, d2_i).
    Returns (mask bool, state f32, gains f32), batched like ``cand``.
    """
    return _sweep(lambda st, dr: torch.clamp_min(st - dr, 0.0).sum(-1),
                  torch.minimum, exemplar_distances(cand, ref), state,
                  eligible, tau, budget, cost, cost_budget)


def graph_cut_accept(x, total, state, eligible, tau, budget, lam=0.5,
                     cost=None, cost_budget=None):
    """GraphCut accept sweep.

    x (B, d) or (L, B, d); total (d,) f32; state (d,) or (L, d) f32;
    eligible (B,) or (L, B) bool; tau () or (L,); budget () or (L,) int;
    cost and cost_budget as in ``coverage_accept``.  Row i's gain is
    sum_f (x_if (t_f - 2 lam s_f) - lam x_if^2), the JAX reference sweep's
    order, and an accepted row applies s += x_i.  Returns (mask bool,
    state f32, gains f32), batched like ``x``.
    """
    total = total.float()
    return _sweep(
        lambda st, xr: (xr * (total - 2.0 * lam * st) - lam * xr * xr).sum(-1),
        lambda st, xr: st + xr, x, state, eligible, tau, budget, cost,
        cost_budget)


def logdet_accept(x, U, logdet, size, eligible, tau, budget, alpha=1.0,
                  eps=LOGDET_EPS, scale=1.0, cost=None, cost_budget=None):
    """LogDetDiversity (scale 1) / MutualInformationGaussian (scale 0.5)
    accept sweep.

    x (B, d) or (L, B, d); U (k, d) or (L, k, d) f32; logdet () or (L,)
    f32; size () or (L,) int32; eligible (B,) or (L, B) bool; tau () or
    (L,); budget () or (L,) int; cost and cost_budget as in
    ``coverage_accept``.  Row i's gain is scale * log d2 with
    v = alpha U x_i and d2 = max(1 + alpha ||x_i||^2 - ||v||^2, eps), against
    the live basis; an accepted row is appended by ``logdet_append`` (an
    append at size >= k writes no row).  Returns (mask bool, U f32, logdet
    f32, size int32, gains f32), batched like ``x``.
    """
    def gain(st, xr):
        g = torch.log(_border(st[0], xr, alpha, eps)[1])
        return g if scale == 1.0 else scale * g

    mask, (U, logdet, size), gains = _sweep(
        gain, lambda st, xr: logdet_append(st, xr, alpha, eps, scale), x,
        (U.float(), torch.as_tensor(logdet, dtype=torch.float32,
                                    device=x.device),
         torch.as_tensor(size, dtype=torch.int32, device=x.device)),
        eligible, tau, budget, cost, cost_budget)
    return mask, U, logdet, size, gains
