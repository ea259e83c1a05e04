"""Model facade: build once from an ArchConfig, then the training loss,
prefill, decode and encode, plus the input specs of a shape.

``Model`` is an ``nn.Module`` that owns its parameters (f32, drawn from an
explicit ``torch.Generator`` on the model's device) and its compute dtype
(bf16 by default; f32 for a check of the arithmetic), where the JAX
package's facade is stateless and takes a parameter tree in each call.
The parameters are built with ``requires_grad=False``, so serving builds
no graph; a training entry point turns gradients on for its own model
(``model.requires_grad_(True)``).

On a mesh of several ranks (``policy``: a ``ShardingPolicy`` on a
``launch.mesh.Mesh``) a rank holds one resident layout of the parameters:
its block of the given policy's ``param_spec``.  The serving launchers
name the decode policy's layout (TP + FSDP: weights split over "model" on
heads / d_ff / experts / vocab and over "data" on d_model), since a server
runs many decode steps; a decode step gathers each weight over "data"
just before use, and a ``pure_fsdp`` prefill gathers each over every axis
from the same blocks.  Training names the train policy's layout: ZeRO-3
for ``parallelism="fsdp"`` (``pure_fsdp``: every leaf split over ("data",
"model") on one dim, the vocab over "model"; a model placed so prefills
and trains, and refuses a decode step), TP + FSDP for "tp" (the decode
policy's layout).  The dense, moe, ssm and hybrid families are placed
(``sharding.MESH_FAMILIES``).  Each parameter carries its spec
(``p.spec``); a rank's parameter bytes are those of its blocks
(``param_bytes``).  Every rank draws every parameter from the same
generator, so the ranks' blocks tile
the parameters of a one-rank model of the same seed.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.device import resolve_device
from repro_torch.models import transformer as T
from repro_torch.models.sharding import ShardingPolicy, check_family, \
    make_policy, mesh_ranks


class TensorSpec(NamedTuple):
    shape: Tuple[int, ...]
    dtype: torch.dtype


def input_specs(cfg: ArchConfig, shape: ShapeSpec,
                dtype=torch.bfloat16) -> Dict[str, TensorSpec]:
    """The batch a step of ``shape`` takes: name -> (shape, dtype)."""
    B, S = shape.global_batch, shape.seq_len
    i32 = torch.int32

    def tok(b, s):
        return TensorSpec((b, s), i32)

    if shape.kind == "decode":
        return {"tokens": tok(B, 1), "positions": tok(B, 1)}
    if cfg.family == "vlm":
        s_txt = S - cfg.num_image_tokens
        spec = {"tokens": tok(B, s_txt),
                "image_embeds": TensorSpec(
                    (B, cfg.num_image_tokens, cfg.d_model), dtype)}
        if shape.kind == "train":
            spec["labels"] = tok(B, s_txt)
        return spec
    if cfg.frontend_stub:  # audio
        spec = {"frames": TensorSpec((B, S, cfg.d_model), dtype)}
        if shape.kind == "train":
            spec["labels"] = tok(B, S)
        return spec
    spec = {"tokens": tok(B, S)}
    if shape.kind == "train":
        spec["labels"] = tok(B, S)
    return spec


class Model(nn.Module):
    """One architecture's parameters, its training loss and its serving
    steps.

    ``generator`` draws every parameter; the model lives on its device
    unless ``device`` says otherwise.  ``dtype`` is the compute dtype: the
    activations, the KV caches and every matmul's operands (the
    parameters stay f32 and are cast at use)."""

    def __init__(self, cfg: ArchConfig, generator: torch.Generator,
                 device=None, dtype=torch.bfloat16,
                 policy: ShardingPolicy = None):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        self.placement = None
        if policy is not None and mesh_ranks(policy.mesh) > 1:
            check_family(cfg, policy.mesh)
            self.placement = policy
        self.params = T.Transformer(cfg, generator,
                                    device or generator.device,
                                    self.placement)

    @property
    def device(self) -> torch.device:
        return self.params.final_norm.device

    @property
    def mesh(self):
        return None if self.placement is None else self.placement.mesh

    def _policy(self, policy, batch_size, kind):
        if kind == "decode" and self.placement is not None and \
                self.placement.pure_fsdp:
            raise ValueError("Model: a decode step on parameters placed by a "
                             "ZeRO-3 (pure_fsdp) policy; place a served "
                             "model by the decode policy")
        if policy is None:
            return make_policy(self.mesh, batch_size, kind,
                               head_fsdp=self.cfg.head_fsdp,
                               pure_fsdp=kind != "decode" and
                               self.cfg.parallelism == "fsdp")
        if mesh_ranks(policy.mesh) > 1 and policy.mesh is not self.mesh:
            raise ValueError("Model: the step's policy is on another mesh "
                             "than the parameters' placement")
        return policy

    # -- steps -------------------------------------------------------------
    def loss(self, batch, policy: ShardingPolicy = None):
        """The training loss of a batch with ``labels``: (loss, {"ce",
        "aux"}), differentiable in the parameters that require grad."""
        policy = self._policy(policy, _batch_size(batch), "train")
        return T.loss_fn(self.params, batch, self.cfg, policy,
                         dtype=self.dtype)

    def prefill(self, batch, policy: ShardingPolicy = None, cache_len=None):
        """Full prompts in: (logits of the last position (B, 1, V), the
        caches).  On a mesh ``batch`` is the global batch; the logits are
        this rank's block of ``policy.logits_spec`` and the caches its
        block of the decode policy's layout."""
        policy = self._policy(policy, _batch_size(batch), "prefill")
        with torch.no_grad():
            hidden, caches, _ = T.forward(self.params, batch, self.cfg,
                                          policy, mode="prefill",
                                          cache_len=cache_len,
                                          dtype=self.dtype)
            logits = T.logits_fn(self.params,
                                 T.last_position(hidden, policy), self.cfg,
                                 policy)
        return logits, caches

    def decode_step(self, caches, tokens, positions,
                    policy: ShardingPolicy = None):
        """One token (B, 1) at ``positions`` (B, 1) through the caches:
        (logits (B, 1, V), new caches; the given caches are not written)."""
        policy = self._policy(policy, tokens.shape[0], "decode")
        with torch.no_grad():
            hidden, caches, _ = T.forward(self.params, {"tokens": tokens},
                                          self.cfg, policy, mode="decode",
                                          caches=caches, positions=positions,
                                          dtype=self.dtype)
            logits = T.logits_fn(self.params, hidden, self.cfg, policy)
        return logits, caches

    def greedy(self, logits, policy: ShardingPolicy):
        """The next ids (B, 1) int32 of the whole batch from a step's
        logits (``transformer.greedy``)."""
        return T.greedy(logits, self.cfg, policy)

    def encode(self, batch, policy: ShardingPolicy = None):
        """Encoder-only forward (hubert): per-frame logits."""
        policy = self._policy(policy, _batch_size(batch), "train")
        hidden, _, _ = T.forward(self.params, batch, self.cfg, policy,
                                 mode="train", dtype=self.dtype)
        return T.logits_fn(self.params, hidden, self.cfg, policy)

    # -- inputs --------------------------------------------------------------
    def init_caches(self, batch: int, cache_len: int):
        return T.init_caches(self.cfg, batch, cache_len, self.dtype,
                             self.device)


def _batch_size(batch) -> int:
    return next(iter(batch.values())).shape[0]


def build_model(cfg_or_name, generator: torch.Generator = None, device=None,
                dtype=torch.bfloat16, policy: ShardingPolicy = None) -> Model:
    """The model of an ArchConfig or an architecture's name, on the card
    unless ``device`` asks for the CPU; ``generator`` (default: seed 0 on
    that device) draws the parameters; ``policy`` places them on a
    mesh."""
    if isinstance(cfg_or_name, str):
        from repro_torch.configs.base import get_config
        cfg_or_name = get_config(cfg_or_name)
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    return Model(cfg_or_name, generator, device, dtype, policy)
