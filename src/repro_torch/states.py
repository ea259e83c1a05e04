"""Oracle states with a leading lane axis.

Most oracles keep one tensor per solution, (w,) or (L, w) for L lanes.
LogDetDiversity and MutualInformationGaussian keep a tuple of tensors,
(U (L, k, d), logdet (L,), size (L,)), each with the same leading lane
axis.  These helpers treat both alike: they are the port's counterpart of
``jax.tree.map`` over a state pytree.
"""

from __future__ import annotations

import torch


def tree_map(fn, state, *rest):
    """``fn`` applied leaf by leaf: to the tensor itself, or to each member
    of a tuple state (with the matching members of ``rest``)."""
    if isinstance(state, tuple):
        return tuple(tree_map(fn, *leaves) for leaves in zip(state, *rest))
    return fn(state, *rest)


def where_state(cond, new, old):
    """Per lane, ``new`` where ``cond`` is True, else ``old``: the port's
    ``jax.tree.map(lambda a, b: jnp.where(cond, a, b), new, old)``.
    ``cond`` is (L,) for lane-batched states, () for unbatched ones; it is
    broadcast over each leaf's trailing axes."""
    def pick(a, b):
        c = cond.reshape(cond.shape + (1,) * (b.dim() - cond.dim()))
        return torch.where(c, a, b)
    return tree_map(pick, new, old)
