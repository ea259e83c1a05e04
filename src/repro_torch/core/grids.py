"""Threshold-grid and OPT-estimate helpers.

The paper's unknown-OPT machinery: estimate OPT from the max singleton
value v (v <= OPT <= k*v) and cover the uncertainty with a geometric grid
of thresholds tau_j, so that some tau_j lands within (1+eps) of OPT/2k.
"""

from __future__ import annotations

import math

import torch


def grid_size(k: int, eps: float, n_grid=None) -> int:
    """Points needed so one tau_j lies within (1+eps) of OPT/2k given
    OPT in [v, k*v]: ~log_{1+eps}(k), padded."""
    return n_grid or max(4, int(math.ceil(
        math.log(max(2 * k, 4)) / math.log1p(eps))) + 2)


def max_singleton(oracle, s_feats, s_valid):
    """Max singleton value v over a packed sample (0 when nothing is
    valid): the dense OPT estimate."""
    st0 = oracle.init_state()
    singles = oracle.marginals(st0, oracle.prep(st0, s_feats))
    return torch.where(s_valid, singles, 0.0).amax().clamp(min=0.0)


def tau_grid_from_v(v, k, eps: float, n_points: int):
    """Scale a max-singleton estimate v (a 0-d f32 tensor) into the (J,)
    grid tau_j = (v/2k)(1+eps)^j, with j a float32 arange as in the JAX
    package.  ``k`` is an int, or a (Q,) int tensor of per-query budgets,
    which gives a (Q, J) grid (2k is exact in float32 either way).

    Degenerate-sample guard: v = 0 would make every tau 0 and let every
    candidate pass, so the grid falls back to +inf (nothing qualifies) and
    the returned () int32 flag is 1, surfaced as
    SelectionResult.tau_fallback.

    Returns (taus (J,), degenerate () int32)."""
    degenerate = v <= 0.0
    j = torch.arange(n_points, dtype=torch.float32, device=v.device)
    if isinstance(k, torch.Tensor):
        k = k.to(torch.float32)[:, None]
    taus = (v / (2.0 * k)) * (1.0 + eps) ** j
    taus = torch.where(degenerate, float("inf"), taus)
    return taus, degenerate.to(torch.int32)


#: Descending-threshold schedule families understood by the epoch engine:
#: "paper"     — Algorithm 5's alpha_l = (1 - 1/(E+1))^l * OPT/k, behind the
#:               1 - (1 - 1/(E+1))^E >= 1 - 1/e - eps guarantee;
#: "geometric" — tau_0 (1-eps)^l, plain descending threshold greedy.
SCHEDULE_KINDS = ("paper", "geometric")


def validate_schedule_kind(kind: str, where: str = "epoch_schedule") -> None:
    if kind not in SCHEDULE_KINDS:
        raise ValueError(f"{where}: unknown schedule kind {kind!r}; "
                         f"registered: {SCHEDULE_KINDS}")


def epochs_for_eps(eps: float, epochs=None) -> int:
    """Epoch count for a target shortfall eps below 1 - 1/e: E =
    ceil(1/eps), unless ``epochs`` is given."""
    if epochs:
        return int(epochs)
    return max(1, int(math.ceil(1.0 / eps)))


def epoch_schedule(tau0, epochs: int, eps: float, kind: str = "paper"):
    """Descending threshold schedule from the level-1 guess ``tau0`` =
    OPT_guess/2k (a (G,) grid of guesses, one lane each).  Returns a list
    of ``epochs`` per-level thresholds shaped like ``tau0``; the 1-epoch
    schedule of either kind is exactly ``[tau0]``."""
    validate_schedule_kind(kind)
    if kind == "geometric":
        return [tau0 * float((1.0 - eps) ** l) for l in range(epochs)]
    return [2.0 * tau0 * float((1.0 - 1.0 / (epochs + 1)) ** l)
            for l in range(1, epochs + 1)]


def alg5_schedule(opt, k: int, epochs: int):
    """Algorithm 5's known-OPT schedule alpha_l = (1 - 1/(E+1))^l OPT/k, in
    the JAX package's order of operations: in Python floats for a float
    ``opt``, rounded to float32 once, where a driver makes each threshold
    a tensor."""
    return [(1.0 - 1.0 / (epochs + 1)) ** ell * opt / k
            for ell in range(1, epochs + 1)]


# ---------------------------------------------------------------------------
# geometric threshold lanes (the streaming sieve's online form of the grid)
# ---------------------------------------------------------------------------

def lane_count(k: int, eps: float) -> int:
    """Lanes needed to cover v_grid in [m, 2km] at ratio (1+eps): the
    SieveStreaming instantiation window (Badanidiyuru et al.)."""
    return int(math.ceil(math.log(max(2 * k, 4)) / math.log1p(eps))) + 2


def _log1p32(eps: float, device) -> torch.Tensor:
    """log1p(eps) computed in float32 from eps rounded to float32 first, as
    the JAX package's weakly typed ``jnp.log1p(eps)``: ``math.log1p`` in
    float64 and then rounded is another number."""
    return torch.log1p(torch.tensor(eps, dtype=torch.float32, device=device))


def _recip32(x: torch.Tensor) -> torch.Tensor:
    """1 / x rounded to float32: the constant that XLA multiplies by where
    the JAX package divides by a constant (its algebraic simplifier turns
    ``a / c`` into ``a * (1 / c)`` in every compiled sieve)."""
    return torch.ones_like(x) / x


def lane_window_lo(v_max, eps: float):
    """Exponent of the smallest grid value >= v_max: the live window is
    exponents [lo, lo + L - 1], i.e. grid values ~[v_max, 2k*v_max].  Only
    meaningful when v_max > 0 (callers gate on that).  Every step is
    float32, in the order of the JAX package's compiled sieve: log(v)
    times the float32 reciprocal of the float32 log1p(eps).  A one-ulp
    change of the quotient near an integer moves ``lo`` and reseeds a
    lane."""
    v = torch.clamp(v_max.to(torch.float32), min=1e-30)
    inv = _recip32(_log1p32(eps, v.device))
    return torch.ceil(torch.log(v) * inv).to(torch.int32)


def lane_exponents(lo, n_lanes: int):
    """The unique exponent assignment e_j in [lo, lo + L) with
    e_j = j (mod L): lane identity is exponent mod L, so when the window
    slides up, exactly the lanes whose exponents fell below ``lo`` are
    reassigned to the top of the window (and must be reseeded empty); every
    other lane keeps its exponent and its accumulated state."""
    j = torch.arange(n_lanes, dtype=torch.int32, device=lo.device)
    return lo + torch.remainder(j - lo, n_lanes)


def lane_taus(exps, k, eps: float, active):
    """tau_j = (1+eps)^{e_j} / (2k) while active; +inf before the first
    nonzero singleton arrives (the same degenerate guard as the grid).  The
    division by 2k is a product with its float32 reciprocal, as in the JAX
    package's compiled sieve."""
    v = torch.exp(exps.to(torch.float32) * _log1p32(eps, exps.device))
    inv = _recip32(torch.tensor(2.0 * k, dtype=torch.float32,
                                device=exps.device))
    return torch.where(active, v * inv, float("inf"))
