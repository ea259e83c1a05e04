"""Gradient compression with error feedback.

The port of the JAX package's ``repro.optim.compression``: int8
per-tensor symmetric quantization and top-k sparsification, each a round
trip (what the receiving side of a collective would see), with the
quantization error carried to the next step.  As in the JAX package, the
train step does not call ``compress``: no collective carries it yet.
Gradients are a mapping from a parameter's name to its tensor.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, NamedTuple

import torch


@dataclasses.dataclass(frozen=True)
class CompressionConfig:
    kind: str = "none"        # none | int8 | topk
    topk_frac: float = 0.01


class CompressionState(NamedTuple):
    error: Dict[str, torch.Tensor]  # like the gradients, f32


def init(grads: Mapping[str, torch.Tensor]) -> CompressionState:
    return CompressionState(error={
        n: torch.zeros(g.shape, dtype=torch.float32, device=g.device)
        for n, g in grads.items()})


def _int8_roundtrip(g):
    scale = torch.max(torch.abs(g)) / 127.0 + 1e-12
    # torch.round rounds half to even, as jnp.round does
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q.float() * scale


def _topk_roundtrip(g, frac):
    flat = g.reshape(-1)
    k = max(1, int(flat.shape[0] * frac))
    thresh = torch.topk(torch.abs(flat), k).values[-1]
    # every |g| >= thresh is kept, ties at the threshold included
    return torch.where(torch.abs(g) >= thresh, g, 0.0)


def compress(cfg: CompressionConfig, grads: Mapping[str, torch.Tensor],
             state: CompressionState):
    """-> (decompressed grads as seen after the collective, new state,
    bytes_factor: payload bytes / f32 bytes)."""
    if cfg.kind == "none":
        return grads, state, 1.0
    out, err = {}, {}
    for name, g in grads.items():
        g32 = g.float() + state.error[name]
        if cfg.kind == "int8":
            sent = _int8_roundtrip(g32)
        else:
            sent = _topk_roundtrip(g32, cfg.topk_frac)
        out[name] = sent.to(g.dtype)
        err[name] = g32 - sent
    factor = 0.25 if cfg.kind == "int8" else (cfg.topk_frac * 2)
    return out, CompressionState(error=err), factor
