"""ShardingPolicy on one card.

The JAX package's ``repro.models.sharding.ShardingPolicy`` answers every
"which mesh axis?" question of the LM stack (batch over data, tensor
parallelism over model, FSDP weights, sequence-sharded caches) and places
each tensor with ``with_sharding_constraint``.  On one card every answer is
"none": the policy here keeps the fields and answers that the transformer
and the step builders read (``model_size``, ``pure_fsdp``, ``head_fsdp``)
and places nothing, so ``constrain_tokens`` is the identity.  A mesh of
more than one rank raises: the LM stack over ``torch.distributed`` comes
with a later slice of the port.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ShardingPolicy:
    mesh: Optional[object]          # None or a one-rank launch.mesh.Mesh
    global_batch: int
    kind: str = "train"             # train | prefill | decode
    head_fsdp: bool = True
    pure_fsdp: bool = False

    def __post_init__(self):
        ranks = 1
        if self.mesh is not None:
            for size in self.mesh.shape.values():
                ranks *= size
        if ranks > 1:
            raise NotImplementedError(
                f"ShardingPolicy: a mesh of {ranks} ranks; the port's LM "
                f"stack runs on one card until its multi-rank "
                f"ShardingPolicy lands (a later slice)")

    @property
    def model_size(self) -> int:
        return 1

    def constrain_tokens(self, x):
        """(B, S, ...) activations: on one card, where they already are."""
        return x


def make_policy(mesh, global_batch: int, kind: str = "train",
                head_fsdp: bool = True,
                pure_fsdp: bool = False) -> ShardingPolicy:
    return ShardingPolicy(mesh=mesh, global_batch=global_batch, kind=kind,
                          head_fsdp=head_fsdp, pure_fsdp=pure_fsdp)
