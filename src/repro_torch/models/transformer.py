"""Model assembly for the families whose layer groups are attention + MLP.

Layers are organized into *groups*, as in the JAX package's
``repro.models.transformer``:

  dense / audio / vlm : group = 1 attention+FFN layer
  moe                 : group = 1 attention+MoE layer (llama4: 4 layers,
                        3 chunked-local + 1 global — iRoPE pattern)
  ssm                 : group = 1 mamba layer
  hybrid (zamba2)     : group = `shared_attn_every` mamba2 layers + ONE
                        shared attention+FFN block

The JAX package stacks the groups' parameters on a leading G axis and
scans over them; here each group is a module of its own in an
``nn.ModuleList`` and the forward pass loops over them (``interop.lm_params``
carries a stacked JAX tree across).  The caches keep the JAX layout: one
``{"sub": [KVCache, ...]}`` tree whose leaves carry the leading G axis.

Modes: "train" (a forward over full sequences, no caches), "prefill"
(returns ring caches), "decode" (one token through the caches).  The
``moe``, ``ssm`` and ``hybrid`` families are not ported yet.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.models import layers as L

#: the families this module runs; the others wait for the port of
#: ``models/moe.py`` and ``models/ssm.py``
FAMILIES = ("dense", "vlm", "audio")


def require_family(cfg):
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family} family needs models/moe.py and "
            f"models/ssm.py, which the port's next LM slice brings; this "
            f"one runs {FAMILIES}")


# ---------------------------------------------------------------------------
# group structure
# ---------------------------------------------------------------------------

def group_layout(cfg):
    """-> (n_groups, [kind-per-sublayer], has_shared_attn)."""
    if cfg.family == "hybrid":
        gs = cfg.shared_attn_every
        assert cfg.n_layers % gs == 0
        return cfg.n_layers // gs, ["ssm"] * gs, True
    if cfg.family == "ssm":
        return cfg.n_layers, ["ssm"], False
    if cfg.global_attn_every:
        ge = cfg.global_attn_every
        assert cfg.n_layers % ge == 0
        return cfg.n_layers // ge, ["attn"] * ge, False
    return cfg.n_layers, ["attn"], False


def sublayer_is_global(cfg, i, n_sub):
    if cfg.global_attn_every:
        return i == n_sub - 1
    return True


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

def _params(tree):
    return nn.ParameterDict({k: nn.Parameter(v, requires_grad=False)
                             for k, v in tree.items()})


class Block(nn.Module):
    """One attention + MLP sublayer: ``ln1``, ``attn`` (wq, wk, wv, wo and
    the q/k norms under qk_norm), ``ln2``, ``mlp`` (wg, wu, wd)."""

    def __init__(self, cfg, generator, device=None):
        super().__init__()
        ones = torch.ones(cfg.d_model, dtype=torch.float32, device=device)
        self.ln1 = nn.Parameter(ones.clone(), requires_grad=False)
        self.attn = _params(L.init_attention(cfg, generator, device))
        self.ln2 = nn.Parameter(ones, requires_grad=False)
        self.mlp = _params(L.init_mlp(cfg.d_model, cfg.d_ff, generator,
                                      device))


class Transformer(nn.Module):
    """Every parameter of one architecture, drawn from ``generator`` (f32):
    ``embed`` (the padded vocabulary's table, absent for audio), ``groups``
    (G groups of sublayer Blocks), ``final_norm`` and, unless the
    embeddings are tied, ``lm_head`` (D, padded vocab)."""

    def __init__(self, cfg, generator, device=None):
        super().__init__()
        require_family(cfg)
        n_groups, kinds, _ = group_layout(cfg)
        self.embed = None
        if not cfg.frontend_stub or cfg.family == "vlm":
            # padded rows keep odd vocabs a multiple of 16; the extra
            # logits are masked in logits_fn and never indexed by tokens
            self.embed = _params(L.init_embed(cfg.padded_vocab, cfg.d_model,
                                              generator, device))
        self.groups = nn.ModuleList(
            nn.ModuleList(Block(cfg, generator, device) for _ in kinds)
            for _ in range(n_groups))
        self.final_norm = nn.Parameter(
            torch.ones(cfg.d_model, dtype=torch.float32, device=device),
            requires_grad=False)
        self.lm_head = None
        if not cfg.tie_embeddings:
            self.lm_head = nn.Parameter(
                L.dense_init(generator, (cfg.d_model, cfg.padded_vocab),
                             device=device), requires_grad=False)


# ---------------------------------------------------------------------------
# sublayer application
# ---------------------------------------------------------------------------

def _apply_attn_block(p, x, positions, cfg, policy, is_global, cache, mode,
                      cache_len=None):
    h, kv = L.attention(p.attn, L.rms_norm(x, p.ln1, cfg.norm_eps),
                        positions, cfg, is_global=is_global,
                        cache=cache if mode == "decode" else None)
    x = x + h
    h2 = L.mlp(p.mlp, L.rms_norm(x, p.ln2, cfg.norm_eps))
    x = policy.constrain_tokens(x + h2)
    if mode == "train":
        new_cache = None
    elif mode == "prefill":
        k, v = kv
        new_cache = L.prefill_to_cache(
            cfg, k, v, positions,
            cache_len=cache_len or positions.shape[1],
            is_global_layer=is_global)
    else:  # decode: L.attention already returned the updated KVCache
        new_cache = kv
    return x, new_cache


def _apply_group(gp, x, positions, cfg, policy, caches, mode,
                 cache_len=None):
    """One group: its sublayers in order.  ``caches`` is the group's
    {"sub": [per-sublayer KVCache]} (decode) or None; returns (x, the
    group's new caches or None in train mode)."""
    _, kinds, _ = group_layout(cfg)
    new_sub = []
    for i, blk in enumerate(gp):
        c = caches["sub"][i] if caches is not None else None
        x, nc = _apply_attn_block(blk, x, positions, cfg, policy,
                                  sublayer_is_global(cfg, i, len(kinds)), c,
                                  mode, cache_len=cache_len)
        new_sub.append(nc)
    return x, (None if mode == "train" else {"sub": new_sub})


# ---------------------------------------------------------------------------
# full forward
# ---------------------------------------------------------------------------

def _embed_inputs(params, batch, cfg, policy, dtype):
    """-> (x (B,S,D) in ``dtype``, positions (B,S) int32)."""
    if cfg.family == "vlm":
        tok_emb = L.embed(params.embed, batch["tokens"], dtype)
        x = torch.cat([batch["image_embeds"].to(dtype), tok_emb], dim=1)
    elif cfg.frontend_stub:  # audio
        x = batch["frames"].to(dtype)
    else:
        x = L.embed(params.embed, batch["tokens"], dtype)
    B, S = x.shape[0], x.shape[1]
    positions = torch.arange(S, dtype=torch.int32,
                             device=x.device)[None].expand(B, S)
    return policy.constrain_tokens(x), positions


def _group_caches(caches, g):
    """Group ``g``'s slice of a stacked cache tree."""
    return {"sub": [L.KVCache(*(t[g] for t in c)) for c in caches["sub"]]}


def _stack_caches(per_group):
    """Stack the groups' cache trees on a leading G axis."""
    return {"sub": [L.KVCache(*(torch.stack(ts) for ts in zip(*cs)))
                    for cs in zip(*(c["sub"] for c in per_group))]}


def forward(params, batch, cfg, policy, mode="train", caches=None,
            positions=None, cache_len=None, dtype=torch.bfloat16):
    """mode train/prefill: batch holds full sequences.
    mode decode: batch {"tokens": (B,1)} (+ caches, positions (B,1)).
    ``dtype`` is the compute dtype.  Returns (hidden (B,S,D), new_caches);
    the JAX package's third result, the MoE router loss, comes with the
    moe family."""
    require_family(cfg)
    if mode == "decode":
        if cfg.frontend_stub and cfg.family != "vlm":
            raise ValueError("encoder-only arch has no decode step")
        x = L.embed(params.embed, batch["tokens"], dtype)
        pos = positions
    else:
        x, pos = _embed_inputs(params, batch, cfg, policy, dtype)

    new_list = []
    for g, gp in enumerate(params.groups):
        cc = _group_caches(caches, g) if mode == "decode" else None
        x, nc = _apply_group(gp, x, pos, cfg, policy, cc, mode,
                             cache_len=cache_len)
        new_list.append(nc)
    new_caches = None if mode == "train" else _stack_caches(new_list)
    return L.rms_norm(x, params.final_norm, cfg.norm_eps), new_caches


def logits_fn(params, hidden, cfg, policy):
    head = params.embed["table"].T if cfg.tie_embeddings else params.lm_head
    logits = hidden @ head.to(hidden.dtype)
    if cfg.padded_vocab != cfg.vocab_size:
        # mask pad columns (large-negative, not -inf: keeps lse finite)
        logits[..., cfg.vocab_size:] = -1e30
    return logits


# ---------------------------------------------------------------------------
# cache construction (decode inputs / serve init)
# ---------------------------------------------------------------------------

def init_caches(cfg, batch, cache_len, dtype=torch.bfloat16, device=None):
    """Empty caches for all groups (leaves stacked on a leading G)."""
    require_family(cfg)
    n_groups, kinds, _ = group_layout(cfg)
    sub = []
    for i in range(len(kinds)):
        c = L.init_kv_cache(cfg, batch, cache_len,
                            sublayer_is_global(cfg, i, len(kinds)), dtype,
                            device)
        sub.append(L.KVCache(*(t[None].repeat((n_groups,) + (1,) * t.dim())
                               for t in c)))
    return {"sub": sub}


def cache_bytes(caches) -> int:
    """Bytes held by a cache tree (every leaf of every group)."""
    return sum(t.numel() * t.element_size()
               for c in caches["sub"] for t in c)


def param_bytes(params) -> int:
    """Bytes held by the parameters as stored (f32)."""
    return sum(p.numel() * p.element_size() for p in params.parameters())
