"""Argument checks and the launch call shared by the ctypes kernel wrappers.

Every wrapper takes contiguous CUDA tensors on one device and raises
``ValueError`` on anything its kernel does not take; a launch that the
driver refuses raises ``RuntimeError``.  Nothing here falls back to a plain
version: ``kernels.ops`` routes CPU tensors before a wrapper is reached.
"""

from __future__ import annotations

import ctypes

import torch

STORAGE_DTYPES = (torch.float32, torch.bfloat16)


def check(cond: bool, name: str, msg: str) -> None:
    if not cond:
        raise ValueError(f"{name}: {msg}")


def check_rows(name, x, what="x"):
    """``x`` must be a float32 or bfloat16 CUDA tensor."""
    check(x.is_cuda, name, f"{what} must be a CUDA tensor, got {x.device}")
    check(x.dtype in STORAGE_DTYPES, name,
          f"{what} must be float32 or bfloat16, got {x.dtype}")


def lanes(name, x, state, width):
    """Rank and lane checks for a (C, .) or (L, C, .) block against a
    (width,) or (L, width) float32 state; returns (L, C, per_lane, out
    shape).  A (C, .) block with an (L, width) state is shared by every
    lane."""
    check(x.dim() in (2, 3) and state.dim() in (1, 2), name,
          f"bad ranks x{tuple(x.shape)} state{tuple(state.shape)}")
    check(state.dtype == torch.float32, name,
          f"state must be float32, got {state.dtype}")
    check(state.shape[-1] == width, name,
          f"state width {state.shape[-1]} != {width}")
    L = 1 if state.dim() == 1 else state.shape[0]
    per_lane = x.dim() == 3
    check(not per_lane or (state.dim() == 2 and x.shape[0] == L), name,
          f"per-lane x{tuple(x.shape)} needs state (L, {width}), got "
          f"{tuple(state.shape)}")
    C = x.shape[-2]
    return L, C, per_lane, ((L, C) if state.dim() == 2 else (C,))


def feature(name, t, d, what):
    """An optional per-feature operand must be float32 (d,)."""
    if t is not None:
        check(t.dtype == torch.float32 and tuple(t.shape) == (d,), name,
              f"{what} must be float32 ({d},), got {t.dtype} "
              f"{tuple(t.shape)}")


def placed(name, tensors, device):
    """Every given tensor lies on ``device`` and is contiguous."""
    for t in tensors:
        if t is None:
            continue
        check(t.device == device, name, f"tensors on {t.device} and {device}")
        check(t.is_contiguous(), name, "inputs must be contiguous")


def sweep_operands(name, x, state, eligible, tau, budget, width):
    """The operands of an accept sweep, lifted onto one lane when the call
    is unbatched: x (B, .) or (L, B, .), state (width,) or (L, width) f32,
    eligible (B,) or (L, B) bool, tau () or (L,) f32, budget () or (L,)
    int32.  Returns (x, state, eligible, tau, budget, unbatched)."""
    check(x.dim() in (2, 3), name,
          f"x must be (B, .) or (L, B, .), got {tuple(x.shape)}")
    unbatched = x.dim() == 2
    if unbatched:
        x, state, eligible = x[None], state[None], eligible[None]
    L, B = x.shape[:2]
    tau = torch.as_tensor(tau, dtype=torch.float32, device=x.device).reshape(-1)
    budget = torch.as_tensor(budget, dtype=torch.int32,
                             device=x.device).reshape(-1)
    check(state.dtype == torch.float32 and state.shape == (L, width), name,
          f"state must be float32 {(L, width)}, got {state.dtype} "
          f"{tuple(state.shape)}")
    check(eligible.dtype == torch.bool and eligible.shape == (L, B), name,
          f"eligible must be bool {(L, B)}, got {eligible.dtype} "
          f"{tuple(eligible.shape)}")
    check(tau.shape == (L,), name, f"tau must be ({L},), got {tuple(tau.shape)}")
    check(budget.shape == (L,), name,
          f"budget must be ({L},), got {tuple(budget.shape)}")
    return x, state, eligible, tau, budget, unbatched


def cost_operands(name, cost, cost_budget, L, B, device, unbatched):
    """The knapsack operands of a sweep's cost mode, lifted like
    ``sweep_operands``: cost (B,) or (L, B) float32 per-row costs and
    cost_budget () or (L,) float32 remaining budgets, both given or both
    None (the cardinality mode).  Returns (cost (L, B) or None,
    cost_budget (L,) or None)."""
    check((cost is None) == (cost_budget is None), name,
          "cost and cost_budget go together")
    if cost is None:
        return None, None
    if unbatched:
        cost = cost[None]
    cost_budget = torch.as_tensor(cost_budget, dtype=torch.float32,
                                  device=device).reshape(-1)
    check(cost.dtype == torch.float32 and cost.shape == (L, B), name,
          f"cost must be float32 {(L, B)}, got {cost.dtype} "
          f"{tuple(cost.shape)}")
    check(cost_budget.shape == (L,), name,
          f"cost_budget must be ({L},), got {tuple(cost_budget.shape)}")
    return cost, cost_budget


#: threads of a feature sweep's CTA (csrc/feature_sweep.cuh) and of a
#: reference sweep's (csrc/reference_tile.cuh)
FEATURE_SWEEP_THREADS = 128
REFERENCE_SWEEP_THREADS = 256

#: per-thread widths of the narrow sweep instances, which hold their
#: slice of the state in registers; the widest is 16
NARROW_PER = (1, 2, 4, 8, 16)


def _per(width, threads):
    for per in NARROW_PER:
        if width <= per * threads:
            return per
    return 0


def feature_sweep_per(d: int) -> int:
    """The instance of a feature sweep (coverage, weighted and saturated
    coverage, graph cut) for d features: the features each thread holds in
    registers (1, 2, 4, 8 or 16, for d <= 2048), or 0 for the wide instance,
    whose state lives in global memory and takes any d."""
    return _per(d, FEATURE_SWEEP_THREADS)


#: the narrow feature-sweep instances that keep the row loop (one row a
#: barrier, csrc/feature_sweep.cuh's loop_kernel) in place of the windowed
#: walk, by (sweep, dtype of x): the features a thread where the walk
#: measured more than 5 % slower than the row loop in some rule on an H100
#: (``ab_compare.py --only feature_sweeps``, which times both): graph cut,
#: whose lanes accept about every other row, up to 256 features and in
#: f32 at 8 (its cost mode), and weighted coverage's f32 sweep at 16
FEATURE_SWEEP_LOOPS = {
    ("graph_cut_accept", torch.float32): (1, 2, 8),
    ("graph_cut_accept", torch.bfloat16): (1, 2),
    ("weighted_coverage_accept", torch.float32): (16,),
}


def feature_sweep_instance(name: str, dtype, d: int) -> int:
    """The instance feature sweep ``name`` launches for d features of x in
    ``dtype``: feature_sweep_per(d) for the walk (or 0, the wide instance),
    negated for the row loop where FEATURE_SWEEP_LOOPS keeps it."""
    per = feature_sweep_per(d)
    return -per if per in FEATURE_SWEEP_LOOPS.get((name, dtype), ()) else per


def reference_sweep_per(r: int) -> int:
    """The instance of a reference sweep (facility, exemplar) for r
    reference rows: the columns each thread holds in registers (1, 2, 4, 8
    or 16, for r <= 4096), or 0 for the wide instance, whose state lives in
    global memory and takes any r."""
    return _per(r, REFERENCE_SWEEP_THREADS)


#: rows a lane of the lazy and fused engines' chunk
#: (core.threshold.DEFAULT_CHUNK)
CHUNK_ROWS = 128

#: the shape classes of a launch, by its rows a lane: more than a chunk
#: (the filter over the corpus, the singleton passes, the sample), a chunk
#: (the lazy and fused engines' chunks and sweeps), or one row (the
#: partition matroid's row scan)
SHAPES = ("filter", "chunk", "row")

#: launches per entry point and shape class since the last reset
shape_launches: dict = {}

#: launches of the "filter" class per entry point since the last reset,
#: split by lanes, shared or per-lane x and rows a lane (for the wrappers
#: that pass their lanes to ``count_shape``)
filter_launches: dict = {}


def shape_of(rows: int) -> str:
    """The shape class of a launch over ``rows`` rows a lane."""
    return "row" if rows == 1 else "chunk" if rows <= CHUNK_ROWS else "filter"


def count_shape(name: str, rows: int, lanes=None, per_lane=False) -> None:
    """Count one launch of entry point ``name`` over ``rows`` rows a lane
    under its shape class (beside the wrapper's own count); a launch of the
    "filter" class that gives its ``lanes`` is also counted under its lanes,
    x (shared or per-lane) and rows."""
    counts = shape_launches.setdefault(name, dict.fromkeys(SHAPES, 0))
    shape = shape_of(rows)
    counts[shape] += 1
    if shape == "filter" and lanes is not None:
        key = (f"{'1 lane' if lanes == 1 else f'{lanes} lanes'}, "
               f"{'per-lane' if per_lane else 'shared'} x, {rows} rows")
        split = filter_launches.setdefault(name, {})
        split[key] = split.get(key, 0) + 1


def ptr(t):
    """A tensor's device address, or None (a null pointer) for None."""
    return None if t is None else t.data_ptr()


def sweep_outputs(x, width):
    """Empty (mask (L, B) bool, state (L, width) f32, gains (L, B) f32)
    for a lifted (L, B, .) sweep."""
    L, B = x.shape[:2]
    return (torch.empty((L, B), dtype=torch.bool, device=x.device),
            torch.empty((L, width), dtype=torch.float32, device=x.device),
            torch.empty((L, B), dtype=torch.float32, device=x.device))


def launch(name, fn, device, *args) -> None:
    """Call the C entry point ``fn(*args, stream)`` on the current stream of
    ``device``; raises when it returns a CUDA error."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*args, ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
