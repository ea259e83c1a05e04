"""Deterministic synthetic data pipeline.

The port of the JAX package's ``repro.data.pipeline``.  ``batch_at(step)``
is a pure function of (seed, step): each call draws from a fresh
``torch.Generator`` derived from those two numbers (never one generator
carried across steps), which is what makes checkpoint/restart exact — the
checkpoint stores only the cursor.  Documents get zipf-ish token
statistics, so selection has structure to exploit.  The batches are made
on the pipeline's device (the card unless the caller asks for the CPU);
the draws are torch's, not the JAX package's, so the two pipelines give
different tokens with the same statistics.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seed: int = 0
    global_batch: int = 8
    seq_len: int = 128
    # selection stage (the paper's technique in the input path)
    select_every: int = 0          # 0 = off; else re-select pool each N steps
    pool_factor: int = 4           # candidate pool = pool_factor * batch


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """A generator on ``device`` seeded from (seed, step) alone."""
    state = np.random.SeedSequence([seed, step]).generate_state(1, np.uint64)
    return torch.Generator(device=device).manual_seed(int(state[0]))


class SyntheticLM:
    """Zipf-ish token stream; labels are next-token shifted."""

    def __init__(self, cfg: ArchConfig, data: DataConfig, device=None):
        self.cfg, self.data = cfg, data
        self.device = resolve_device(device)

    def _tokens(self, gen, b, s):
        v = self.cfg.vocab_size
        # mixture: zipf body + doc-specific "topic" tokens (structure for
        # the selection oracle to find)
        u = torch.rand((b, s), generator=gen, device=self.device)
        body = (v * u ** 3).to(torch.int32)  # skewed to low ids
        topic = torch.randint(0, v, (b, 1), generator=gen, device=self.device,
                              dtype=torch.int32)
        is_topic = torch.rand((b, s), generator=gen, device=self.device) < 0.2
        return torch.where(is_topic, topic, torch.clamp(body, 0, v - 1))

    def batch_at(self, step: int) -> Dict[str, torch.Tensor]:
        cfg, d = self.cfg, self.data
        gen = step_generator(d.seed, step, self.device)
        B, S = d.global_batch, d.seq_len
        if cfg.family == "vlm":
            s_txt = S - cfg.num_image_tokens
            toks = self._tokens(gen, B, s_txt + 1)
            img = torch.randn((B, cfg.num_image_tokens, cfg.d_model),
                              generator=gen, device=self.device,
                              dtype=torch.bfloat16) * 0.02
            return {"tokens": toks[:, :-1].contiguous(),
                    "image_embeds": img,
                    "labels": toks[:, 1:].contiguous()}
        if cfg.frontend_stub:
            frames = torch.randn((B, S, cfg.d_model), generator=gen,
                                 device=self.device, dtype=torch.bfloat16)
            labels = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                                   device=self.device, dtype=torch.int32)
            return {"frames": frames, "labels": labels}
        toks = self._tokens(gen, B, S + 1)
        return {"tokens": toks[:, :-1].contiguous(),
                "labels": toks[:, 1:].contiguous()}


#: Knuth's multiplicative hash constant, split in 16-bit halves so that
#: every product below fits int64
_HASH = 2654435761
_HASH_HI, _HASH_LO = _HASH >> 16, _HASH & 0xFFFF


def doc_embeddings(batch, dim: int = 64) -> torch.Tensor:
    """Cheap per-document embeddings for the selection oracle: token-hash
    histogram features (nonneg, so FeatureCoverage applies directly).

    The hash is the JAX package's uint32 one, wrap-around included:
    ``(tok * 2654435761) mod 2**32``, then ``mod dim``, computed in int64
    as ``tok * lo + ((tok * hi) mod 2**16) * 2**16`` over the constant's
    16-bit halves."""
    if "tokens" not in batch:
        x = batch["frames"].float()
        return torch.abs(x.mean(dim=1))[:, :dim]
    tok = batch["tokens"].long() & 0xFFFFFFFF
    h = (tok * _HASH_LO + ((tok * _HASH_HI) & 0xFFFF) * 65536) & 0xFFFFFFFF
    h = h % dim
    counts = torch.zeros((tok.shape[0], dim), dtype=torch.float32,
                         device=tok.device)
    counts.scatter_add_(1, h, torch.ones(h.shape, dtype=torch.float32,
                                         device=tok.device))
    return counts / tok.shape[1]  # (B, dim) histogram
