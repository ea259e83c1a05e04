"""AdamW with a cosine schedule and global-norm clipping.

The port of the JAX package's ``repro.optim.adamw``, in its order: the
step counter first, the learning rate of the new step, the norm of the
unclipped gradients, the clip, the moments, the bias corrections in f32,
decoupled weight decay on the decayed leaves, and ``p - lr * upd`` in f32
cast to the parameter's dtype.  The parameters, gradients and moments are
mappings from a parameter's name (``Model.params.named_parameters()``'s
dotted names) to its tensor; ``update`` writes the parameters and moments
in place under ``torch.no_grad()``.  The moments share the parameters'
device.

On a mesh every tensor is this rank's block (the parameters' ZeRO-3
blocks; the moments inherit them, so ZeRO-1 falls out, as in the JAX
package); the update is elementwise, so it runs on the blocks unchanged,
and only the global norm sums over the ranks (``global_norm``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Mapping, NamedTuple

import torch

from repro_torch.models import collectives as coll
from repro_torch.models.sharding import mesh_ranks, split_axes


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


class OptState(NamedTuple):
    step: torch.Tensor              # () int32
    m: Dict[str, torch.Tensor]      # f32, one per parameter
    v: Dict[str, torch.Tensor]      # f32, one per parameter


def schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    """Linear warm-up to ``cfg.lr``, then a cosine down to
    ``min_lr_frac * lr`` at ``total_steps``; f32, for an int step tensor."""
    step = torch.as_tensor(step).float()
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps) /
                       max(cfg.total_steps - cfg.warmup_steps, 1), 0, 1)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * \
        (1 + torch.cos(math.pi * prog))
    return cfg.lr * warm * cos


def init(params: Mapping[str, torch.Tensor]) -> OptState:
    zeros = {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
             for n, p in params.items()}
    device = next(iter(params.values())).device
    return OptState(step=torch.zeros((), dtype=torch.int32, device=device),
                    m=zeros,
                    v={n: torch.zeros_like(z) for n, z in zeros.items()})


def global_norm(grads: Mapping[str, torch.Tensor], mesh=None,
                specs: Mapping[str, tuple] = None) -> torch.Tensor:
    """sqrt of the sum of every gradient's squares, in f32.  On a mesh
    (``specs``: each leaf's spec) a leaf's squares are summed over the
    ranks that hold its distinct blocks, the axes its spec splits, and a
    leaf replicated over an axis counts once: one ``all_reduce`` for the
    leaves that split over the same axes."""
    if mesh_ranks(mesh) == 1:
        return torch.sqrt(sum(torch.sum(g.float() ** 2)
                              for g in grads.values()))
    by_axes = {}
    for name, g in grads.items():
        ax = tuple(a for a in mesh.axis_names
                   if a in split_axes(specs[name]))
        by_axes[ax] = by_axes.get(ax, 0) + torch.sum(g.float() ** 2)
    total = 0
    for ax in sorted(by_axes):
        total = total + coll.all_reduce(by_axes[ax].reshape(1), mesh,
                                        ax)[0]
    return torch.sqrt(total)


_NO_DECAY = ("ln", "norm", "bias", "A_log", "D_skip", "dt_bias")


def decays(name: str, p: torch.Tensor) -> bool:
    """Whether the leaf ``name`` takes weight decay: the JAX package's rule
    (``src/repro/optim/adamw.py:83``): no norm, bias or SSM-dynamics leaf by
    name, and ``ndim >= 2``.  The JAX package stacks each group's leaves on
    a leading G axis, where the port keeps one module a group, so a leaf
    under ``groups.`` counts that axis too: Mamba's 1-D ``conv_b`` is
    (G, C) there and decayed, and so it is here."""
    leaf = name.rsplit(".", 1)[-1]
    stacked = 1 if name.startswith("groups.") else 0
    return not any(s in leaf for s in _NO_DECAY) and p.dim() + stacked >= 2


def update(cfg: AdamWConfig, params: Mapping[str, torch.Tensor],
           grads: Mapping[str, torch.Tensor], state: OptState, mesh=None,
           specs: Mapping[str, tuple] = None):
    """-> (params, new state, {"lr", "grad_norm"}); the parameters and the
    moments are written in place.  On a mesh (``specs``: each leaf's spec)
    every tensor is this rank's block."""
    step = state.step + 1
    lr = schedule(cfg, step)
    gn = global_norm(grads, mesh, specs)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gn, min=1e-9), max=1.0) \
        if cfg.clip_norm else 1.0
    b1c = 1 - cfg.b1 ** step.float()
    b2c = 1 - cfg.b2 ** step.float()
    with torch.no_grad():
        for name, p in params.items():
            m, v = state.m[name], state.v[name]
            g32 = grads[name].float() * scale
            m.mul_(cfg.b1).add_((1 - cfg.b1) * g32)
            v.mul_(cfg.b2).add_((1 - cfg.b2) * g32 * g32)
            upd = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
            if cfg.weight_decay and decays(name, p):
                upd = upd + cfg.weight_decay * p.float()
            p.copy_((p.float() - lr * upd).to(p.dtype))
    return params, OptState(step, state.m, state.v), \
        {"lr": lr, "grad_norm": gn}
