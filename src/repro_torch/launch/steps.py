"""Step builders shared by the serving launcher and its callers.

Each builder returns a ``StepBundle``: the step function, the batch it
takes (name -> shape and dtype) and the sharding policy.  The JAX package's
bundles also carry abstract arguments and shardings for its dry-run; on
one card there is nothing to place (neither KV nor SSM caches), and the
model owns its parameters, so a step takes the ``Model`` as its first
argument.  The bundles serve every family that decodes.
``train_step_bundle`` comes with the training slice of the port.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

from repro_torch.configs.base import SHAPES, ArchConfig, ShapeSpec
from repro_torch.models.model import TensorSpec, input_specs
from repro_torch.models.sharding import ShardingPolicy, make_policy


@dataclasses.dataclass(frozen=True)
class StepBundle:
    fn: Any
    input_specs: Dict[str, TensorSpec]
    policy: ShardingPolicy


def prefill_bundle(cfg: ArchConfig, shape: ShapeSpec,
                   mesh=None) -> StepBundle:
    """Serving prefill: ``fn(model, batch, cache_len=None)`` takes full
    sequences of ``shape.seq_len`` positions and gives the last-token
    logits and caches of ``cache_len`` slots (default ``shape.seq_len``;
    a server that goes on to generate asks for room for its tokens)."""
    policy = make_policy(mesh, shape.global_batch, "prefill",
                         head_fsdp=cfg.head_fsdp,
                         pure_fsdp=cfg.parallelism == "fsdp")

    def prefill(model, batch, cache_len=None):
        return model.prefill(batch, policy,
                             cache_len=cache_len or shape.seq_len)

    return StepBundle(fn=prefill, input_specs=input_specs(cfg, shape),
                      policy=policy)


def decode_step_bundle(cfg: ArchConfig, shape: ShapeSpec,
                       mesh=None) -> StepBundle:
    """serve_step: ``fn(model, caches, tokens, positions)`` runs one new
    token per request through the caches."""
    policy = make_policy(mesh, shape.global_batch, "decode",
                         head_fsdp=cfg.head_fsdp)

    def serve_step(model, caches, tokens, positions):
        return model.decode_step(caches, tokens, positions, policy)

    return StepBundle(fn=serve_step, input_specs=input_specs(cfg, shape),
                      policy=policy)


def bundle_for(cfg: ArchConfig, shape_name: str, mesh=None) -> StepBundle:
    shape = SHAPES[shape_name]
    if shape.kind == "train":
        raise NotImplementedError(
            f"{shape_name}: train_step_bundle comes with the port's training "
            f"slice (optim/, the loss, runtime/trainer.py)")
    if shape.kind == "prefill":
        return prefill_bundle(cfg, shape, mesh)
    return decode_step_bundle(cfg, shape, mesh)
