"""Step bundles shared by the training and serving launchers.

Each builder returns a ``StepBundle``: the step function, the batch it
takes (name -> shape and dtype) and the sharding policy.  The JAX package's
bundles also carry abstract arguments and shardings for its dry-run; the
port's model owns its parameters (placed by ``Model(..., policy=)`` on a
mesh), so a step takes the ``Model`` as its first argument.  On one card
the serving bundles serve every family that decodes and the train step
every family; on a mesh of several ranks (``launch.mesh``) the serving
bundles serve the dense, moe, ssm and hybrid families (prefill under the
config's ``parallelism``: ZeRO-3 for "fsdp", TP + FSDP for "tp"; decode
under TP + FSDP, the caches handed over to its layout), and the train step
trains them under the config's ``parallelism`` too
(``sharding.check_train`` refuses what it cannot shard).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from repro_torch.configs.base import SHAPES, ArchConfig, ShapeSpec
from repro_torch.models import collectives as coll
from repro_torch.models.model import TensorSpec, input_specs
from repro_torch.models.sharding import ShardingPolicy, check_family, \
    check_train, make_policy, mesh_ranks
from repro_torch.optim import adamw


@dataclasses.dataclass(frozen=True)
class StepBundle:
    fn: Any
    input_specs: Dict[str, TensorSpec]
    policy: ShardingPolicy


def train_step_bundle(cfg: ArchConfig, shape: ShapeSpec, mesh=None,
                      opt_cfg: adamw.AdamWConfig = None) -> StepBundle:
    """The full train step: ``fn(model, opt_state, batch)`` runs forward,
    backward, the clip and the AdamW update (the model's parameters and the
    moments in place) and returns (model, new opt state, metrics {"ce",
    "aux", "loss", "lr", "grad_norm"}, 0-d tensors).  It turns gradients on
    for the model it is given.

    With ``cfg.microbatches`` A > 1 the batch is cut into A slices along
    its batch axis, one backward a slice, the gradients accumulated in f32
    (the parameters' dtype) and divided by A with the loss and the
    metrics; the policy, and so the MoE's capacity, sees the micro-batch.

    On a mesh of several ranks the step takes the global batch on every
    rank and the model placed by this bundle's policy (``Model(...,
    policy=bundle.policy)``: ZeRO-3 blocks for ``parallelism="fsdp"``, the
    TP + FSDP blocks for "tp").  Micro-batch a is the global batch's a-th
    slice of B / A rows, of which each rank takes its block (the JAX
    package's reshape to (A, B / A, ...), then the policy's sharding);
    backward reduce-scatters each weight's gradient into its block, a
    leaf's gradient is summed over the token axes its spec does not split
    (``ShardingPolicy.replicated_axes``: under TP a leaf whole over
    "model" is summed over "data" only, its gradient already whole on
    every model rank), and the global norm sums each leaf's squares over
    the axes that split it, so a leaf whole over "model" counts once."""
    A = max(1, cfg.microbatches)
    policy = make_policy(mesh, shape.global_batch // A, "train",
                         head_fsdp=cfg.head_fsdp,
                         pure_fsdp=cfg.parallelism == "fsdp")
    check_train(cfg, policy)
    opt_cfg = opt_cfg or adamw.AdamWConfig()
    sharded = mesh_ranks(mesh) > 1

    def train_step(model, opt_state, batch):
        placed = model.placement
        if sharded and (placed is None or placed.mesh is not mesh or
                        placed.pure_fsdp != policy.pure_fsdp or
                        placed.head_fsdp != policy.head_fsdp):
            raise ValueError("train_step: place the model by the bundle's "
                             "policy (Model(..., policy=bundle.policy))")
        model.requires_grad_(True)
        params = dict(model.params.named_parameters())
        for p in params.values():
            p.grad = None
        B = next(iter(batch.values())).shape[0]
        if B % A:
            raise ValueError(f"train_step: a batch of {B} rows does not "
                             f"split into {A} micro-batches")
        b = B // A
        loss, metrics = None, None
        with torch.enable_grad():
            for a in range(A):
                mb = batch if A == 1 else {
                    k: v[a * b:(a + 1) * b] for k, v in batch.items()}
                l, m = model.loss(mb, policy)
                # backward adds each slice's gradients into p.grad, the
                # accumulator (f32), in slice order
                l.backward()
                l, m = l.detach(), {k: t.detach() for k, t in m.items()}
                loss = l if loss is None else loss + l
                metrics = m if metrics is None else {
                    k: metrics[k] + m[k] for k in m}
        grads = {n: p.grad if p.grad is not None else torch.zeros_like(p)
                 for n, p in params.items()}
        specs = None
        if sharded:
            specs = {n: p.spec for n, p in params.items()}
            for n, g in grads.items():
                axes = policy.replicated_axes(specs[n])
                if axes:
                    grads[n] = coll.all_reduce(g, mesh, axes)
        if A > 1:
            for g in grads.values():
                g.div_(A)
            loss = loss / A
            metrics = {k: t / A for k, t in metrics.items()}
        _, new_opt, om = adamw.update(opt_cfg, params, grads, opt_state,
                                      mesh=mesh if sharded else None,
                                      specs=specs)
        for p in params.values():
            p.grad = None
        return model, new_opt, dict(metrics, loss=loss, **om)

    return StepBundle(fn=train_step, input_specs=input_specs(cfg, shape),
                      policy=policy)


def prefill_bundle(cfg: ArchConfig, shape: ShapeSpec,
                   mesh=None) -> StepBundle:
    """Serving prefill: ``fn(model, batch, cache_len=None)`` takes full
    sequences of ``shape.seq_len`` positions and gives the last-token
    logits and caches of ``cache_len`` slots (default ``shape.seq_len``;
    a server that goes on to generate asks for room for its tokens).  On a
    mesh the caches come in the decode policy's layout
    (``kv_cache_spec``), the JAX bundle's ``dec_policy.cache_shardings``."""
    check_family(cfg, mesh)
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
    token per request through the caches.  Its policy is also the one to
    place a served model's parameters by (``Model(..., policy=)``)."""
    check_family(cfg, mesh)
    policy = make_policy(mesh, shape.global_batch, "decode",
                         head_fsdp=cfg.head_fsdp)

    def serve_step(model, caches, tokens, positions):
        return model.decode_step(caches, tokens, positions, policy)

    return StepBundle(fn=serve_step, input_specs=input_specs(cfg, shape),
                      policy=policy)


def bundle_for(cfg: ArchConfig, shape_name: str, mesh=None) -> StepBundle:
    shape = SHAPES[shape_name]
    if shape.kind == "train":
        return train_step_bundle(cfg, shape, mesh)
    if shape.kind == "prefill":
        return prefill_bundle(cfg, shape, mesh)
    return decode_step_bundle(cfg, shape, mesh)
