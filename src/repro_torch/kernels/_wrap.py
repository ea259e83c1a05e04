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
