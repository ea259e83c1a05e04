"""Precision: the one dtype policy across the selection stack.

Three planes, one invariant (as in the JAX package):

  storage     feature rows at rest and on the wire (the corpus, the sample
              and survivor messages).  bf16 halves the bytes the marginal
              and accept kernels stream and the Lemma-2/6 message sizes.
  compute     what the kernels read: the storage dtype.
  accumulate  oracle state, gains, thresholds and values: always float32,
              because ThresholdGreedy compares gains against tau and a bf16
              state accumulated over k adds loses about three digits.

The default policy is f32 everywhere, and ``cast_storage`` returns its
input unchanged when the dtype already matches.  Specs carry the policy by
name ("f32" | "bf16"); ``resolve`` returns the shared instance.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class Precision:
    """A named (storage, compute, accumulate) dtype policy."""

    name: str
    storage: torch.dtype
    compute: torch.dtype
    accumulate: torch.dtype

    @property
    def storage_itemsize(self) -> int:
        """Bytes per feature element at rest: the Lemma-2/6 wire width."""
        return torch.empty((), dtype=self.storage).element_size()

    def cast_storage(self, x):
        """Cast a feature tensor onto the storage plane; the same tensor
        when the dtype already matches."""
        return x if x.dtype == self.storage else x.to(self.storage)


F32 = Precision(name="f32", storage=torch.float32, compute=torch.float32,
                accumulate=torch.float32)
BF16 = Precision(name="bf16", storage=torch.bfloat16, compute=torch.bfloat16,
                 accumulate=torch.float32)

POLICIES = {p.name: p for p in (F32, BF16)}
PRECISION_NAMES = tuple(POLICIES)


def resolve(name) -> Precision:
    """Map a policy name (or an already-resolved Precision) to the shared
    instance; raises ValueError with the registered names otherwise."""
    if isinstance(name, Precision):
        return name
    try:
        return POLICIES[name]
    except KeyError:
        raise ValueError(f"unknown precision {name!r}; "
                         f"registered: {PRECISION_NAMES}") from None


def validate(name, where: str) -> None:
    """__post_init__ hook for MRConfig / SelectorSpec."""
    if name not in POLICIES:
        raise ValueError(f"{where}: unknown precision {name!r}; "
                         f"registered: {PRECISION_NAMES}")
