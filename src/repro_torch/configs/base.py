"""ArchConfig — the config system every architecture, launcher and dry-run
cell is driven by.  One file per assigned architecture lives next to this;
``get_config(name)`` resolves them, ``cfg.reduced()`` derives the CPU smoke
variant, and ``SHAPES`` defines the assigned input-shape set.

The port's own copy of the JAX package's ``repro.configs``: the same
shapes, counts and reductions, read by ``repro_torch.models`` and the
port's roofline."""

from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0              # 0 => d_model // n_heads
    qk_norm: bool = False
    sliding_window: int = 0        # >0 => SWA with this window
    attention_chunk: int = 0       # >0 => llama4-style chunked local attention
    global_attn_every: int = 0     # every Nth layer full attention (w/ chunked)
    rope_theta: float = 1e6
    # --- MoE ---
    n_experts: int = 0
    experts_per_token: int = 0
    n_shared_experts: int = 0
    d_ff_expert: int = 0
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    # --- SSM ---
    ssm_state: int = 0
    ssm_version: int = 0           # 1 = mamba1, 2 = mamba2
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_head_dim: int = 64         # mamba2
    # --- hybrid (zamba2) ---
    shared_attn_every: int = 0     # shared attn block every N ssm layers
    # --- encoder / frontend stubs ---
    is_encoder: bool = False
    num_image_tokens: int = 0      # vlm: patch-embedding stub length
    frontend_stub: bool = False    # audio/vlm: inputs are embeddings
    # --- misc ---
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    remat: bool = True
    scan_layers: bool = True
    kv_block: int = 1024           # blockwise-attention KV chunk
    q_block: int = 0               # >0: also scan query blocks (double-
                                   # blocked flash; bounds the f32 prob
                                   # buffer to q_block x kv_block)
    ssm_chunk: int = 128           # ssm chunked-scan length
    loss_chunk: int = 1024         # >0: compute CE over seq chunks (bounds
                                   # the (B, chunk, V/tp) f32 logits buffer;
                                   # 0 = single full-seq logits buffer)
    # --- sharding/CE ablation knobs (see EXPERIMENTS.md §Perf) ---
    head_fsdp: bool = True         # lm_head (D,V): split D over data.
                                   # False = vocab-parallel head (None, model)
                                   # — avoids partial-sum full-vocab AR
    ce_onehot: bool = False        # CE true-logit via one-hot contraction
                                   # (psum-friendly over sharded vocab)
                                   # instead of take_along_axis
    parallelism: str = "tp"        # "tp" (Megatron TP + FSDP weights) or
                                   # "fsdp" (ZeRO-3, batch over all axes) —
                                   # per-arch default, cf. §Perf it3
    microbatches: int = 1          # >1: gradient accumulation — the train
                                   # step scans microbatch slices, cutting
                                   # activation memory ~linearly
    # provenance
    source: str = ""

    # ------------------------------------------------------------------
    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.d_model // max(self.n_heads, 1)

    vocab_pad_multiple: int = 16   # pad embed/head rows to a multiple of
                                   # the model axis (Megatron-style) so odd
                                   # vocabs (granite 49155, internvl2 92553)
                                   # stay shardable; pad logits are masked

    @property
    def padded_vocab(self) -> int:
        p = self.vocab_pad_multiple
        return (self.vocab_size + p - 1) // p * p

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def supports_decode(self) -> bool:
        return not self.is_encoder

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for long_500k per the assignment: SSM / hybrid /
        sliding-window archs; pure full-attention archs are skipped
        (chunked-attention llama4 still has global layers => skipped)."""
        if self.family in ("ssm", "hybrid"):
            return True
        return self.sliding_window > 0

    def shapes(self) -> Tuple[str, ...]:
        out = ["train_4k", "prefill_32k"]
        if self.supports_decode:
            out.append("decode_32k")
            if self.sub_quadratic:
                out.append("long_500k")
        return tuple(out)

    def param_count(self) -> int:
        """Analytic parameter count (for roofline MODEL_FLOPS)."""
        D, F, V, L = self.d_model, self.d_ff, self.vocab_size, self.n_layers
        hd, H, KV = self.head_dim_, self.n_heads, self.n_kv_heads
        total = V * D * (1 if self.tie_embeddings else 2)

        def attn_params():
            p = D * H * hd + 2 * D * KV * hd + H * hd * D
            if self.qk_norm:
                p += 2 * hd
            return p + 2 * D  # norms

        def mlp_params(f):
            return 3 * D * f

        def moe_params():
            p = D * self.n_experts  # router
            p += self.n_experts * mlp_params(self.d_ff_expert)
            p += self.n_shared_experts * mlp_params(self.d_ff_expert) \
                if self.name.startswith("qwen2") else 0
            if self.family == "moe" and self.n_shared_experts and \
                    not self.name.startswith("qwen2"):
                p += mlp_params(self.d_ff)  # llama4 shared expert = d_ff
            return p

        def ssm_params():
            di, N = self.d_inner, self.ssm_state
            p = D * 2 * di + di * D + di * self.ssm_conv
            if self.ssm_version == 1:
                p += di * N + di * 3  # A, dt/B/C proj pieces (approx)
                p += di * (N * 2 + 1) + di  # x_proj, dt_proj
            else:
                nh = di // self.ssm_head_dim
                p += D * (2 * N + 2 * nh) + nh * 2  # B,C,dt,A per head-ish
            return p + D

        if self.family == "ssm":
            total += L * ssm_params()
        elif self.family == "hybrid":
            total += L * ssm_params()
            total += attn_params() + mlp_params(F)  # shared block (counted once)
        elif self.family == "moe":
            total += L * (attn_params() + moe_params())
        else:
            total += L * (attn_params() + mlp_params(F))
        return total

    def active_param_count(self) -> int:
        """Active-per-token params (MoE: routed top-k + shared only)."""
        if self.family != "moe":
            return self.param_count()
        D, L = self.d_model, self.n_layers
        dense = self.param_count()
        all_exp = self.n_experts * 3 * D * self.d_ff_expert
        act_exp = self.experts_per_token * 3 * D * self.d_ff_expert
        return dense - L * (all_exp - act_exp)

    # ------------------------------------------------------------------
    def reduced(self) -> "ArchConfig":
        """Tiny same-family config for CPU smoke tests."""
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            n_layers=min(self.n_layers,
                         2 * self.shared_attn_every if self.shared_attn_every
                         else (self.global_attn_every or 2)),
            d_model=128,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) or 2,
            head_dim=32,
            d_ff=256,
            d_ff_expert=64 if self.d_ff_expert else 0,
            n_experts=min(self.n_experts, 4) if self.n_experts else 0,
            experts_per_token=min(self.experts_per_token, 2)
            if self.experts_per_token else 0,
            vocab_size=512,
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_head_dim=32 if self.ssm_version == 2 else self.ssm_head_dim,
            sliding_window=min(self.sliding_window, 64)
            if self.sliding_window else 0,
            attention_chunk=min(self.attention_chunk, 64)
            if self.attention_chunk else 0,
            num_image_tokens=min(self.num_image_tokens, 16)
            if self.num_image_tokens else 0,
            kv_block=64,
            ssm_chunk=32,
        )


ARCH_IDS = (
    "zamba2-2.7b", "h2o-danube-1.8b", "granite-3-2b", "qwen3-14b",
    "qwen3-1.7b", "qwen2-moe-a2.7b", "llama4-scout-17b-a16e",
    "hubert-xlarge", "falcon-mamba-7b", "internvl2-26b",
)

_MODULES = {
    "zamba2-2.7b": "zamba2_2_7b",
    "h2o-danube-1.8b": "h2o_danube_1_8b",
    "granite-3-2b": "granite_3_2b",
    "qwen3-14b": "qwen3_14b",
    "qwen3-1.7b": "qwen3_1_7b",
    "qwen2-moe-a2.7b": "qwen2_moe_a2_7b",
    "llama4-scout-17b-a16e": "llama4_scout_17b_a16e",
    "hubert-xlarge": "hubert_xlarge",
    "falcon-mamba-7b": "falcon_mamba_7b",
    "internvl2-26b": "internvl2_26b",
    "paper-selector": "paper",
}


def get_config(name: str) -> ArchConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")
    return mod.CONFIG
