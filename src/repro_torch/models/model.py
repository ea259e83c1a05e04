"""Model facade: build once from an ArchConfig, then the training loss,
prefill, decode and encode, plus the input specs of a shape.

``Model`` is an ``nn.Module`` that owns its parameters (f32, drawn from an
explicit ``torch.Generator`` on the model's device) and its compute dtype
(bf16 by default; f32 for a check of the arithmetic), where the JAX
package's facade is stateless and takes a parameter tree in each call.
The parameters are built with ``requires_grad=False``, so serving builds
no graph; a training entry point turns gradients on for its own model
(``model.requires_grad_(True)``).
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.device import resolve_device
from repro_torch.models import transformer as T
from repro_torch.models.sharding import ShardingPolicy, make_policy


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
                 device=None, dtype=torch.bfloat16):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        self.params = T.Transformer(cfg, generator,
                                    device or generator.device)

    @property
    def device(self) -> torch.device:
        return self.params.final_norm.device

    def _policy(self, policy, batch_size, kind):
        return policy if policy is not None else make_policy(
            None, batch_size, kind)

    # -- steps -------------------------------------------------------------
    def loss(self, batch, policy: ShardingPolicy = None):
        """The training loss of a batch with ``labels``: (loss, {"ce",
        "aux"}), differentiable in the parameters that require grad."""
        policy = self._policy(policy, _batch_size(batch), "train")
        return T.loss_fn(self.params, batch, self.cfg, policy,
                         dtype=self.dtype)

    def prefill(self, batch, policy: ShardingPolicy = None, cache_len=None):
        """Full prompts in: (logits of the last position (B, 1, V), the
        caches)."""
        policy = self._policy(policy, _batch_size(batch), "prefill")
        hidden, caches, _ = T.forward(self.params, batch, self.cfg, policy,
                                      mode="prefill", cache_len=cache_len,
                                      dtype=self.dtype)
        logits = T.logits_fn(self.params, hidden[:, -1:], self.cfg, policy)
        return logits, caches

    def decode_step(self, caches, tokens, positions,
                    policy: ShardingPolicy = None):
        """One token (B, 1) at ``positions`` (B, 1) through the caches:
        (logits (B, 1, V), new caches; the given caches are not written)."""
        policy = self._policy(policy, tokens.shape[0], "decode")
        hidden, caches, _ = T.forward(self.params, {"tokens": tokens},
                                      self.cfg, policy, mode="decode",
                                      caches=caches, positions=positions,
                                      dtype=self.dtype)
        logits = T.logits_fn(self.params, hidden, self.cfg, policy)
        return logits, caches

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
                dtype=torch.bfloat16) -> Model:
    """The model of an ArchConfig or an architecture's name, on the card
    unless ``device`` asks for the CPU; ``generator`` (default: seed 0 on
    that device) draws the parameters."""
    if isinstance(cfg_or_name, str):
        from repro_torch.configs.base import get_config
        cfg_or_name = get_config(cfg_or_name)
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    return Model(cfg_or_name, generator, device, dtype)
