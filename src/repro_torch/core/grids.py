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
    package.

    Degenerate-sample guard: v = 0 would make every tau 0 and let every
    candidate pass, so the grid falls back to +inf (nothing qualifies) and
    the returned () int32 flag is 1, surfaced as
    SelectionResult.tau_fallback.

    Returns (taus (J,), degenerate () int32)."""
    degenerate = v <= 0.0
    j = torch.arange(n_points, dtype=torch.float32, device=v.device)
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
