"""The LM stack's collectives over a ``launch.mesh.Mesh``.

GSPMD inserts the JAX package's collectives; the port's layers call these.
Each runs over one mesh axis or a tuple of axes (the process group of the
ranks that share this rank's other coordinates, ordered row-major along
the axes, the first axis major: the order of a ``PartitionSpec`` entry
that names those axes), on ``torch.distributed``'s default backend:
NCCL with one rank a card, gloo on the CPU or for ranks sharing a card.
torch 2.11's gloo takes CUDA tensors for all four collectives used here
(``all_gather_into_tensor``, ``reduce_scatter_tensor``, ``all_reduce``,
``all_to_all_single``; not the list form of ``all_to_all``), so no call
is staged through the host here; an op that a backend lacks raises.

Every call adds its kind, axes and operand bytes (the bytes of the tensor
this rank hands to the collective) to a counter that ``counts()`` reads
and ``reset_counts()`` zeroes: the port's own collective bytes, for the
roofline and the dry-run.  A call on one rank (axes of size 1) moves
nothing and is not counted.

Under autograd each collective has its backward, fixed by one rule: every
rank holds the same global loss, and a rank's gradient is its block of
d(global loss)/d(global tensor).  So ``all_gather``'s backward is a summing
``reduce_scatter`` (the gathered copies feed different work on each rank:
other rows, other vocab slices, other queries), ``reduce_scatter``'s is
``all_gather``, ``all_to_all``'s the inverse ``all_to_all``, and a summing
``all_reduce``'s the identity (its result feeds the same work on every
rank: the CE's log-sum-exp over "model", the loss's token sums, the MoE's
aux mean).  A backward call counts under its own kind and the same axes;
remat's re-run forward calls count too.  ``gather_cast`` is the FSDP
weight gather: the cast first, so the gather moves the compute dtype's
bytes, and its backward sums each rank's gradient into its block in the
parameter's dtype.

Under tensor parallelism the model axis carries no tokens: its ranks hold
the same activations and the same loss, and split the work of a layer
(Megatron's pair).  A summing ``all_reduce`` ends a row-parallel product
(backward: the identity); ``replicate`` starts a column-parallel one, or
any work that differs across the axis on a tensor every rank holds alike
(a rank's slice of a replicated leaf): the identity forward, and in
backward the sum of the ranks' partial gradients (counted under
"replicate").  A gather whose copies feed the same work on every rank
(``alike``) hands back, in backward, this rank's block of a gradient that
is already whole, where a gather whose copies feed different work sums.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.distributed as dist

from repro_torch.models.sharding import axes_of

_COUNTS: Dict[Tuple[str, Tuple[str, ...]], list] = {}


def counts() -> Dict[Tuple[str, Tuple[str, ...]], Tuple[int, int]]:
    """(kind, axes) -> (calls, operand bytes) since the last reset."""
    return {k: (v[0], v[1]) for k, v in _COUNTS.items()}


def reset_counts() -> None:
    _COUNTS.clear()


def _norm(mesh, axes) -> Tuple[str, ...]:
    axes = axes_of(axes)
    order = [mesh.axis_names.index(a) for a in axes]
    if order != sorted(order):
        raise ValueError(f"collectives: axes {axes} out of the mesh's order "
                         f"{mesh.axis_names}")
    return axes


def _group(kind, mesh, axes, x):
    """(group, size) of ``axes``; counts the call when it moves data."""
    axes = _norm(mesh, axes)
    n = mesh.size(axes) if axes else 1
    if n > 1:
        acc = _COUNTS.setdefault((kind, axes), [0, 0])
        acc[0] += 1
        acc[1] += x.numel() * x.element_size()
    return (mesh.group(axes) if n > 1 else None), n


def _all_gather(x, mesh, axes, dim: int = 0):
    group, n = _group("all_gather", mesh, axes, x)
    if n == 1:
        return x
    xt = x.movedim(dim, 0).contiguous()
    out = torch.empty((n * xt.shape[0],) + tuple(xt.shape[1:]),
                      dtype=x.dtype, device=x.device)
    dist.all_gather_into_tensor(out, xt, group=group)
    return out.movedim(0, dim)


def _reduce_scatter(x, mesh, axes, dim: int = 0):
    group, n = _group("reduce_scatter", mesh, axes, x)
    if n == 1:
        return x
    xt = x.movedim(dim, 0).contiguous()
    if xt.shape[0] % n:
        raise ValueError(f"reduce_scatter: dim {dim} of {xt.shape[0]} does "
                         f"not split over {n} ranks")
    out = torch.empty((xt.shape[0] // n,) + tuple(xt.shape[1:]),
                      dtype=x.dtype, device=x.device)
    dist.reduce_scatter_tensor(out, xt, group=group)
    return out.movedim(0, dim)


def _all_reduce(x, mesh, axes, op: str = "sum", kind: str = "all_reduce"):
    group, n = _group(kind, mesh, axes, x)
    if n == 1:
        return x
    out = x.contiguous().clone()
    dist.all_reduce(out, op=dist.ReduceOp.MAX if op == "max"
                    else dist.ReduceOp.SUM, group=group)
    return out


def _all_to_all(x, mesh, axes, split_dim: int, concat_dim: int):
    group, n = _group("all_to_all", mesh, axes, x)
    if n == 1:
        return x
    if x.shape[split_dim] % n:
        raise ValueError(f"all_to_all: dim {split_dim} of "
                         f"{x.shape[split_dim]} does not split over {n} "
                         f"ranks")
    xs = x.movedim(split_dim, 0).contiguous()
    out = torch.empty_like(xs)
    dist.all_to_all_single(out, xs, group=group)
    # out: n blocks on dim 0, block j from rank j
    parts = out.chunk(n, 0)
    return torch.cat([p.movedim(0, split_dim) for p in parts], concat_dim)


def _block_of(g, mesh, axes, dim):
    """This rank's block of ``g`` on ``dim`` along ``axes`` (row-major)."""
    n = g.shape[dim] // mesh.size(axes)
    return g.narrow(dim, mesh.index(axes) * n, n).contiguous()


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim, alike):
        ctx.args, ctx.alike = (mesh, axes, dim), alike
        return _all_gather(x, mesh, axes, dim)

    @staticmethod
    def backward(ctx, g):
        if ctx.alike:
            return _block_of(g, *ctx.args), None, None, None, None
        return _reduce_scatter(g, *ctx.args), None, None, None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.args = (mesh, axes, dim)
        return _reduce_scatter(x, mesh, axes, dim)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, *ctx.args), None, None, None


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        return _all_reduce(x, mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _Replicate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.args = (mesh, axes)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        mesh, axes = ctx.args
        return _all_reduce(g, mesh, axes, kind="replicate"), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, split_dim, concat_dim):
        ctx.args = (mesh, axes, concat_dim, split_dim)
        return _all_to_all(x, mesh, axes, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, *ctx.args), None, None, None, None


def _gather_cast(p, mesh, gathers, dtype):
    x = p.to(dtype)
    for dim, axes in gathers:
        x = _all_gather(x, mesh, axes, dim)
    return x


class _GatherCast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, p, mesh, gathers, dtype, alike):
        ctx.args = (mesh, gathers, p.dtype, alike)
        return _gather_cast(p, mesh, gathers, dtype)

    @staticmethod
    def backward(ctx, g):
        mesh, gathers, dtype, alike = ctx.args
        # summed in the parameter's dtype (f32): a bf16 sum over the ranks
        # would round each rank's partial gradient once more than one
        # rank's product over every row does
        g = g.to(dtype)
        for dim, axes in reversed(gathers):
            if not any(a in alike for a in axes):
                g = _reduce_scatter(g, mesh, axes, dim)
                continue
            # axis by axis, the major first: an alike axis keeps this
            # rank's block, the others sum theirs
            for a in axes:
                g = _block_of(g, mesh, (a,), dim) if a in alike else \
                    _reduce_scatter(g, mesh, (a,), dim)
        return g, None, None, None, None


def _recording(x, mesh, axes) -> bool:
    """Whether a call on ``x`` over ``axes`` moves data under autograd."""
    return torch.is_grad_enabled() and x.requires_grad and \
        mesh.size(_norm(mesh, axes)) > 1


def all_gather(x, mesh, axes, dim: int = 0, alike: bool = False):
    """The blocks of ``x`` from every rank along ``axes``, concatenated on
    ``dim`` in the axes' row-major order.  ``alike``: every rank along the
    axes does the same work with the result (backward keeps this rank's
    block of the gradient instead of summing it)."""
    if _recording(x, mesh, axes):
        return _AllGather.apply(x, mesh, axes, dim, alike)
    return _all_gather(x, mesh, axes, dim)


def replicate(x, mesh, axes):
    """``x`` itself, which every rank along ``axes`` holds alike, where it
    enters work that differs across them; in backward the ranks' partial
    gradients are summed over ``axes`` (Megatron's identity / all-reduce
    pair, the half that ``all_reduce`` lacks)."""
    if _recording(x, mesh, axes):
        return _Replicate.apply(x, mesh, axes)
    return x


def reduce_scatter(x, mesh, axes, dim: int = 0):
    """The sum of ``x`` over the ranks along ``axes``, of which this rank
    keeps its block on ``dim`` (the dim splits into as many blocks as the
    axes hold ranks)."""
    if _recording(x, mesh, axes):
        return _ReduceScatter.apply(x, mesh, axes, dim)
    return _reduce_scatter(x, mesh, axes, dim)


def all_reduce(x, mesh, axes, op: str = "sum"):
    """``x`` summed (``op="max"``: the maximum, not differentiable) over
    the ranks along ``axes``; a new tensor."""
    if _recording(x, mesh, axes):
        if op != "sum":
            raise ValueError(f"all_reduce: op {op!r} under autograd; "
                             f"reduce a detached tensor")
        return _AllReduce.apply(x, mesh, axes)
    return _all_reduce(x, mesh, axes, op)


def all_to_all(x, mesh, axes, split_dim: int, concat_dim: int):
    """Block j of ``x`` on ``split_dim`` goes to the j-th rank along
    ``axes``; the blocks received, in the ranks' order, are concatenated
    on ``concat_dim``."""
    if _recording(x, mesh, axes):
        return _AllToAll.apply(x, mesh, axes, split_dim, concat_dim)
    return _all_to_all(x, mesh, axes, split_dim, concat_dim)


def gather_cast(p, mesh, gathers, dtype, alike=()):
    """``p`` cast to ``dtype``, then all-gathered on each (dim, axes) of
    ``gathers`` in turn (the FSDP weight gather).  ``alike``: the axes
    whose ranks all do the same work with the gathered weight (backward
    keeps this rank's block over them, and sums over the others)."""
    if gathers and torch.is_grad_enabled() and p.requires_grad:
        return _GatherCast.apply(p, mesh, tuple(gathers), dtype,
                                 tuple(alike))
    return _gather_cast(p, mesh, gathers, dtype)


def reshard(x, mesh, src, dst):
    """This rank's block of a tensor under spec ``dst``, from its block
    under ``src``.  Per dim: the axes that ``dst`` keeps as the leading
    axes of ``src``'s entry stay; the rest of ``src``'s axes are gathered,
    then ``dst``'s further axes cut this rank's block.  A move between
    equal specs is free."""
    for d in range(x.dim()):
        a = axes_of(src[d]) if d < len(src) else ()
        b = axes_of(dst[d]) if d < len(dst) else ()
        if a == b:
            continue
        keep = 0
        while keep < min(len(a), len(b)) and a[keep] == b[keep]:
            keep += 1
        if a[keep:]:
            x = all_gather(x, mesh, a[keep:], d)
        if b[keep:]:
            parts = mesh.size(b[keep:])
            size = x.shape[d] // parts
            x = x.narrow(d, mesh.index(b[keep:]) * size, size)
    return x.contiguous()
