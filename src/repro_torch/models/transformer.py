"""Model assembly for all the families.

Layers are organized into *groups*, as in the JAX package's
``repro.models.transformer``:

  dense / audio / vlm : group = 1 attention+FFN layer
  moe                 : group = 1 attention+MoE layer (llama4: 4 layers,
                        3 chunked-local + 1 global — iRoPE pattern)
  ssm                 : group = 1 mamba layer
  hybrid (zamba2)     : group = `shared_attn_every` mamba2 layers + ONE
                        shared attention+FFN block (the same parameters in
                        every group — zamba's parameter-sharing trick)

The JAX package stacks the groups' parameters on a leading G axis and
scans over them; here each group is a module of its own in an
``nn.ModuleList`` and the forward pass loops over them (``interop.lm_params``
carries a stacked JAX tree across).  The caches keep the JAX layout: one
``{"sub": [KVCache | Mamba1Cache | Mamba2Cache, ...], "shared": KVCache}``
tree whose leaves carry the leading G axis (``"shared"`` for the hybrid
family only: each group's copy of the shared block's cache).

Modes: "train" (a forward over full sequences, no caches; each group
checkpointed under ``cfg.remat`` while autograd records), "prefill"
(returns ring caches), "decode" (one token through the caches).
``loss_fn`` is the training loss over a train-mode forward.

On a mesh of several ranks (the dense, moe, ssm and hybrid families,
serving and training) the batch a forward is given is the global one, on
every rank; it is placed (``sharding.place``: batch over the batch axes,
the sequence over ``seq_shard``) and every activation after it is this
rank's block.  The caches come out of prefill, and go into decode, as the
decode policy places them (the KV caches and the Mamba caches alike,
each group's copy of the hybrid family's shared block's too); the logits
leave vocab-sharded (``ShardingPolicy.logits_spec``) and ``greedy`` picks
the next ids with a max and an argmax over the model axis.  ``loss_fn``'s
CE is vocab-parallel and every rank holds the global loss; backward runs
through the collectives' own backward (``collectives``), remat's
recomputation included; under tensor parallelism the hidden rows enter
the vocab-parallel head through ``collectives.replicate``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.models import collectives as coll
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models import ssm as SSM
from repro_torch.models.sharding import place


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

def _param(name, t, placement=None):
    """A parameter of ``t``; with a ``placement`` policy, this rank's block
    of it, its spec as ``.spec`` (``param_spec`` of the leaf's name)."""
    if placement is None:
        return nn.Parameter(t, requires_grad=False)
    spec = placement.param_spec(name, t.shape)
    p = nn.Parameter(place(t, spec, placement.mesh), requires_grad=False)
    p.spec = spec
    return p


def _params(tree, placement=None):
    """A parameter dict of ``tree`` (nested dicts become nested
    ParameterDicts), each leaf placed by ``_param``."""
    return nn.ParameterDict({
        k: _params(v, placement) if isinstance(v, dict)
        else _param(k, v, placement) for k, v in tree.items()})


def _ones(cfg, device, placement=None):
    return _param("norm", torch.ones(cfg.d_model, dtype=torch.float32,
                                     device=device), placement)


class Block(nn.Module):
    """One attention sublayer: ``ln1``, ``attn`` (wq, wk, wv, wo and the
    q/k norms under qk_norm), ``ln2`` and its FFN: ``moe`` (router,
    we_gate, we_up, we_down and the ``shared`` MLP) in the moe family, else
    ``mlp`` (wg, wu, wd)."""

    def __init__(self, cfg, generator, device=None, placement=None):
        super().__init__()
        self.ln1 = _ones(cfg, device, placement)
        self.attn = _params(L.init_attention(cfg, generator, device),
                            placement)
        self.ln2 = _ones(cfg, device, placement)
        if cfg.family == "moe":
            self.moe = _params(MOE.init_moe(cfg, generator, device),
                               placement)
        else:
            self.mlp = _params(L.init_mlp(cfg.d_model, cfg.d_ff, generator,
                                          device), placement)


class SSMBlock(nn.Module):
    """One SSM sublayer: ``ln1`` and ``ssm`` (Mamba1 or Mamba2), no
    ``ln2``."""

    def __init__(self, cfg, generator, device=None, placement=None):
        super().__init__()
        self.ln1 = _ones(cfg, device, placement)
        init = SSM.init_mamba1 if cfg.ssm_version == 1 else SSM.init_mamba2
        self.ssm = _params(init(cfg, generator, device), placement)


def _sublayer(cfg, kind, generator, device, placement):
    if kind == "ssm":
        return SSMBlock(cfg, generator, device, placement)
    return Block(cfg, generator, device, placement)


class Transformer(nn.Module):
    """Every parameter of one architecture, drawn from ``generator`` (f32):
    ``embed`` (the padded vocabulary's table, absent for audio), ``groups``
    (G groups of sublayers), ``shared_block`` (the hybrid family's one
    attention + MLP Block, else None), ``final_norm`` and, unless the
    embeddings are tied, ``lm_head`` (D, padded vocab).

    With a ``placement`` policy each parameter is drawn whole, in the same
    order, and only this rank's block of it is kept (``_param``): a
    sublayer's leaves are the most that is alive at once."""

    def __init__(self, cfg, generator, device=None, placement=None):
        super().__init__()
        n_groups, kinds, has_shared = group_layout(cfg)
        self.embed = None
        if not cfg.frontend_stub or cfg.family == "vlm":
            # padded rows keep odd vocabs a multiple of 16; the extra
            # logits are masked in logits_fn and never indexed by tokens
            self.embed = _params(L.init_embed(cfg.padded_vocab, cfg.d_model,
                                              generator, device), placement)
        self.groups = nn.ModuleList(
            nn.ModuleList(_sublayer(cfg, kind, generator, device, placement)
                          for kind in kinds)
            for _ in range(n_groups))
        self.shared_block = Block(cfg, generator, device, placement) \
            if has_shared else None
        self.final_norm = _ones(cfg, device, placement)
        self.lm_head = None
        if not cfg.tie_embeddings:
            self.lm_head = _param(
                "lm_head", L.dense_init(generator,
                                        (cfg.d_model, cfg.padded_vocab),
                                        device=device), placement)


# ---------------------------------------------------------------------------
# sublayer application
# ---------------------------------------------------------------------------

def _apply_attn_block(p, x, positions, cfg, policy, is_global, cache, mode,
                      cache_len=None):
    h, kv = L.attention(p.attn, L.rms_norm(x, L.weight(p.ln1, policy),
                                           cfg.norm_eps),
                        positions, cfg, is_global=is_global,
                        cache=cache if mode == "decode" else None,
                        policy=policy)
    x = x + h
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    xn = L.rms_norm(x, L.weight(p.ln2, policy), cfg.norm_eps)
    if hasattr(p, "moe"):
        h2, aux = MOE.moe_ffn(p.moe, xn, cfg, policy)
    else:
        h2 = L.mlp(p.mlp, xn, policy)
    x = policy.constrain_tokens(x + h2)
    if mode == "train":
        new_cache = None
    elif mode == "prefill":
        k, v = kv
        new_cache = L.prefill_to_cache(
            cfg, k, v, positions,
            cache_len=cache_len or k.shape[1],
            is_global_layer=is_global, policy=policy)
    else:  # decode: L.attention already returned the updated KVCache
        new_cache = kv
    return x, new_cache, aux


def _apply_ssm_block(p, x, cfg, policy, cache, mode):
    fn = SSM.mamba1 if cfg.ssm_version == 1 else SSM.mamba2
    h, new_cache = fn(p.ssm, L.rms_norm(x, L.weight(p.ln1, policy),
                                        cfg.norm_eps), cfg, cache, policy)
    x = policy.constrain_tokens(x + h)
    if mode == "train":
        new_cache = None
    elif mode == "prefill" and L.on_mesh(policy):
        new_cache = SSM.decode_layout(p.ssm, new_cache, cfg, policy)
    return x, new_cache, torch.zeros((), dtype=torch.float32,
                                     device=x.device)


def _apply_group(gp, shared_p, x, positions, cfg, policy, caches, mode,
                 cache_len=None):
    """One group: its sublayers in order, then the shared attention block
    where the family has one.  ``caches`` is the group's {"sub": [...],
    "shared": KVCache} (decode) or None; returns (x, the group's new caches
    or None in train mode, the sublayers' summed router aux loss)."""
    _, kinds, has_shared = group_layout(cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    new_sub = []
    for i, (kind, blk) in enumerate(zip(kinds, gp)):
        c = caches["sub"][i] if caches is not None else None
        if kind == "ssm":
            x, nc, a = _apply_ssm_block(blk, x, cfg, policy, c, mode)
        else:
            x, nc, a = _apply_attn_block(
                blk, x, positions, cfg, policy,
                sublayer_is_global(cfg, i, len(kinds)), c, mode,
                cache_len=cache_len)
        aux = aux + a
        new_sub.append(nc)
    if mode == "train":
        new_caches = None
    else:
        new_caches = {"sub": new_sub}
    if has_shared:
        c = caches["shared"] if caches is not None else None
        x, nshared, a = _apply_attn_block(shared_p, x, positions, cfg,
                                          policy, True, c, mode,
                                          cache_len=cache_len)
        aux = aux + a
        if new_caches is not None:
            new_caches["shared"] = nshared
    return x, new_caches, aux


# ---------------------------------------------------------------------------
# full forward
# ---------------------------------------------------------------------------

def place_tokens(t, policy):
    """This rank's block of a global (B, S, ...) input under
    ``batch_first``; ``t`` itself off a mesh."""
    if not L.on_mesh(policy):
        return t
    return place(t, policy.batch_first(t.shape), policy.mesh)


def _embed_inputs(params, batch, cfg, policy, dtype, table=None):
    """-> (x (B,S,D) in ``dtype``, positions (B,S) int32); on a mesh this
    rank's blocks of both (``table``: ``forward``'s ``embed_table``)."""
    if cfg.family == "vlm":
        tok_emb = L.embed(params.embed, batch["tokens"], dtype)
        x = torch.cat([batch["image_embeds"].to(dtype), tok_emb], dim=1)
    elif cfg.frontend_stub:  # audio
        x = batch["frames"].to(dtype)
    else:
        tokens = batch["tokens"]
        B, S = tokens.shape
        positions = torch.arange(S, dtype=torch.int32,
                                 device=tokens.device)[None].expand(B, S)
        x = L.embed(params.embed if table is None else {"table": table},
                    place_tokens(tokens, policy), dtype, policy)
        return policy.constrain_tokens(x), place_tokens(positions, policy)
    B, S = x.shape[0], x.shape[1]
    positions = torch.arange(S, dtype=torch.int32,
                             device=x.device)[None].expand(B, S)
    return policy.constrain_tokens(x), positions


def _map_caches(fn, caches):
    """``fn`` over every cache of a group tree ({"sub": [...], "shared"}):
    KVCache and the Mamba caches alike, leaf by leaf."""
    out = {"sub": [type(c)(*map(fn, c)) for c in caches["sub"]]}
    if "shared" in caches:
        out["shared"] = type(caches["shared"])(*map(fn, caches["shared"]))
    return out


def _group_caches(caches, g):
    """Group ``g``'s slice of a stacked cache tree."""
    return _map_caches(lambda t: t[g], caches)


def _stack_caches(per_group):
    """Stack the groups' cache trees on a leading G axis."""
    first = per_group[0]
    out = {"sub": [type(c)(*(torch.stack(ts) for ts in zip(*cs)))
                   for c, cs in zip(first["sub"],
                                    zip(*(t["sub"] for t in per_group)))]}
    if "shared" in first:
        out["shared"] = type(first["shared"])(*(
            torch.stack(ts) for ts in zip(*(t["shared"] for t in per_group))))
    return out


def _train_group(gp, shared_p, x, positions, cfg, policy):
    """One group in train mode: (x, its router aux loss)."""
    x, _, aux = _apply_group(gp, shared_p, x, positions, cfg, policy, None,
                             "train")
    return x, aux


def forward(params, batch, cfg, policy, mode="train", caches=None,
            positions=None, cache_len=None, dtype=torch.bfloat16,
            embed_table=None):
    """mode train/prefill: batch holds full sequences.
    mode decode: batch {"tokens": (B,1)} (+ caches, positions (B,1)).
    ``dtype`` is the compute dtype; ``embed_table`` on a mesh, the table
    ``_gathered_table`` gives, for a caller that uses it again (the tied
    head of ``loss_fn``).  Returns (hidden (B,S,D), new_caches, aux):
    aux is the router loss summed over sublayers and groups (zero in
    decode, as the JAX package's)."""
    if mode == "decode":
        if cfg.frontend_stub and cfg.family != "vlm":
            raise ValueError("encoder-only arch has no decode step")
        x = L.embed(params.embed, place_tokens(batch["tokens"], policy),
                    dtype, policy)
        pos = place_tokens(positions, policy)
    else:
        x, pos = _embed_inputs(params, batch, cfg, policy, dtype,
                               embed_table)

    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    new_list = []
    # remat per group, as the JAX package's jax.checkpoint of each group:
    # backward keeps only the groups' inputs and recomputes one group at a
    # time (the recompute routes the MoE's tokens on the same values, so
    # alike)
    remat = mode == "train" and cfg.remat and torch.is_grad_enabled()
    for g, gp in enumerate(params.groups):
        if remat:
            x, a = checkpoint(_train_group, gp, params.shared_block, x, pos,
                              cfg, policy, use_reentrant=False)
            aux = aux + a
            continue
        cc = _group_caches(caches, g) if mode == "decode" else None
        x, nc, a = _apply_group(gp, params.shared_block, x, pos, cfg, policy,
                                cc, mode, cache_len=cache_len)
        if mode != "decode":
            aux = aux + a
        new_list.append(nc)
    new_caches = None if mode == "train" else _stack_caches(new_list)
    return L.rms_norm(x, L.weight(params.final_norm, policy), cfg.norm_eps), \
        new_caches, aux


def logits_fn(params, hidden, cfg, policy):
    if L.on_mesh(policy):
        return _mesh_logits(params, hidden, cfg, policy)
    head = params.embed["table"].T if cfg.tie_embeddings else params.lm_head
    logits = hidden @ head.to(hidden.dtype)
    if cfg.padded_vocab != cfg.vocab_size:
        # mask pad columns (large-negative, not -inf: keeps lse finite)
        logits[..., cfg.vocab_size:] = -1e30
    return logits


def _mesh_head(params, cfg, policy, dtype, table=None):
    """The head (D, V) as this rank's logits use it, in ``dtype``: gathered
    over every axis but "model" (its vocab block, or its D block), and the
    model-axis entries of its D and V dims.  ``table``: a tied table as
    ``_gathered_table`` gives it (then only cast here)."""
    m = policy.model_axis
    if cfg.tie_embeddings:
        raw = params.embed["table"] if table is None else table
        dv, dd = raw.spec                       # the head (D, V) is its .T
        head = L.weight(raw, policy, (m,), dtype).T
    else:
        raw = params.lm_head
        dd, dv = raw.spec
        head = L.weight(raw, policy, (m,), dtype)
    return (head,) + tuple(e if e == m else None for e in (dd, dv))


def _mesh_logits(params, hidden, cfg, policy, head=None):
    """Logits of this rank's block of ``logits_spec``: the hidden rows
    gathered off the model axis (under ``pure_fsdp`` the batch is on it),
    then this rank's vocab block of the head (a D-sharded tied table gives
    partial sums, reduce-scattered over "model").  The CE passes its
    ``head`` (``_mesh_head``), gathered once for all its chunks, with the
    rows already handed back (``_ce_rows``)."""
    mesh, m = policy.mesh, policy.model_axis
    if head is None:
        if m in policy.batch_axes:
            hidden = coll.all_gather(hidden, mesh, m, 0)
        head = _mesh_head(params, cfg, policy, hidden.dtype)
    head, dd, dv = head
    B, S = hidden.shape[:2]
    spec = policy.logits_spec((policy.global_batch, S, cfg.padded_vocab))
    if dd == m:       # partial sums of this rank's D block
        n = head.shape[0]
        h = hidden.narrow(-1, mesh.coords[m] * n, n)
        part = h @ head.to(hidden.dtype)
        logits = coll.reduce_scatter(part, mesh, m, 2) if spec[2] == m \
            else coll.all_reduce(part, mesh, m)
    else:
        logits = hidden @ head.to(hidden.dtype)
        if spec[2] == m and dv != m:
            n = logits.shape[-1] // policy.model_size
            logits = logits.narrow(-1, mesh.coords[m] * n, n).contiguous()
    if cfg.padded_vocab != cfg.vocab_size:
        lo = mesh.coords[m] * logits.shape[-1] if spec[2] == m else 0
        logits[..., max(cfg.vocab_size - lo, 0):] = -1e30
    return logits


def last_position(hidden, policy):
    """The last position's hidden state (B, 1, D): under ``seq_shard`` it
    lives on the sequence axis's last rank, so the last positions are
    all-gathered over that axis first."""
    last = hidden[:, -1:]
    if L.on_mesh(policy) and policy.seq_shard:
        last = coll.all_gather(last.contiguous(), policy.mesh,
                               policy.seq_shard, 1)[:, -1:]
    return last


def greedy(logits, cfg, policy):
    """The argmax ids (B, 1) int32 of the last position's logits, for the
    whole batch on every rank.  Off a mesh, ``argmax``; on a mesh the
    vocab is sharded over "model": each rank's max and argmax, then the
    first maximum over the model axis (the lowest id among ties, as
    ``argmax``), and the batch blocks all-gathered."""
    last = logits[:, -1]
    if not L.on_mesh(policy):
        return last.argmax(-1, keepdim=True).to(torch.int32)
    mesh, m = policy.mesh, policy.model_axis
    spec = policy.logits_spec((policy.global_batch, 1, cfg.padded_vocab))
    idx = last.argmax(-1, keepdim=True)
    val = last.gather(-1, idx)
    idx = idx.to(torch.int32)
    if spec[2] == m:
        idx = idx + mesh.coords[m] * last.shape[-1]
        vals = coll.all_gather(val.float(), mesh, m, 1)     # (B_loc, n)
        idxs = coll.all_gather(idx, mesh, m, 1)
        idx = idxs.gather(1, vals.argmax(1, keepdim=True))
    ba = tuple(a for a in policy.batch_axes if a != m)
    return coll.all_gather(idx, mesh, ba, 0) if ba else idx


def _ce_rows(hidden, labels, mask, policy):
    """The CE's blocks on a mesh, as the JAX package's ``loss_fn`` lays
    them out: the model axis handed back to the vocab, so this rank's
    hidden rows are gathered off it (the batch's block under ZeRO-3 over
    every axis, the sequence under ``seq_shard``; under TP they are
    already whole over it, and enter its vocab blocks through
    ``replicate``), and its labels and mask are its block of the global
    ones (the batch over the other batch axes, the whole sequence)."""
    mesh, m = policy.mesh, policy.model_axis
    if m in policy.batch_axes:
        hidden = coll.all_gather(hidden, mesh, m, 0)
    elif policy.seq_shard == m:
        hidden = coll.all_gather(hidden, mesh, m, 1)
    elif policy.tensor_parallel:
        # the rows every model rank holds alike meet its own vocab block
        hidden = coll.replicate(hidden, mesh, m)
    ba = _ce_axes(policy)
    spec = policy.spec(ba if len(ba) > 1 else (ba[0] if ba else None), None,
                       shape=labels.shape)
    return hidden, place(labels, spec, mesh), place(mask, spec, mesh)


def _ce_axes(policy):
    """The batch axes of the CE's rows (all but the model axis)."""
    return tuple(a for a in policy.batch_axes if a != policy.model_axis)


def _vocab_parallel(lg, y, policy):
    """(log-sum-exp, the label's logit) of f32 logits whose vocab is split
    over the model axis: the max and the sum over "model" (the max held
    constant in backward: the value does not depend on it), and the
    label's logit from the rank whose block holds it, summed."""
    mesh, m = policy.mesh, policy.model_axis
    vloc = lg.shape[-1]
    mx = coll.all_reduce(lg.detach().amax(-1), mesh, m, op="max")
    se = coll.all_reduce(torch.exp(lg - mx[..., None]).sum(-1), mesh, m)
    loc = y - policy.mesh.coords[m] * vloc
    ok = (loc >= 0) & (loc < vloc)
    pick = torch.gather(lg, -1, loc.clamp(0, vloc - 1)[..., None])[..., 0]
    return mx + torch.log(se), coll.all_reduce(torch.where(ok, pick, 0.0),
                                               mesh, m)


def _gathered_table(params, policy):
    """The tied table gathered over every axis but "model" once, for the
    lookup and the head alike (so its gradient is reduce-scattered once);
    it carries the spec of what stays split, so ``L.weight`` only casts
    it."""
    raw, keep = params.embed["table"], (policy.model_axis,)
    table = L.weight(raw, policy, keep)
    table.spec = L.use_spec(raw, keep)
    return table


def loss_fn(params, batch, cfg, policy, dtype=torch.bfloat16):
    """Token-level CE over f32 logits, plus ``router_aux_coef`` times the
    router aux loss: (loss, {"ce", "aux"}).  The vlm's image positions
    carry no label; ``batch["loss_mask"]`` (B, S) weighs the tokens when
    given.  Over ``cfg.loss_chunk`` positions at a time when the chunk
    divides the sequence and is shorter, each chunk's CE checkpointed, so
    one (B, chunk, V) f32 logits buffer is alive at a time in backward
    too (the JAX package's ``jax.checkpoint`` of the scanned body).

    On a mesh ``batch`` is the global one; the CE is vocab-parallel
    (``_ce_rows``, ``_vocab_parallel``; the head gathered once for every
    chunk, a tied one once with the lookup's table, so its gradient is
    reduce-scattered once) and the token sum and
    count are summed over the CE's batch axes, so every rank holds the
    global mean loss (and every rank recomputes its checkpointed chunks in
    the same order, collectives included)."""
    on_mesh = L.on_mesh(policy)
    split = on_mesh and policy.model_size > 1
    table = _gathered_table(params, policy) \
        if on_mesh and cfg.tie_embeddings else None
    hidden, _, aux = forward(params, batch, cfg, policy, mode="train",
                             dtype=dtype, embed_table=table)
    if cfg.family == "vlm":
        hidden = hidden[:, batch["image_embeds"].shape[1]:]
    labels = batch["labels"].long()
    mask = batch.get("loss_mask")
    if mask is None:
        mask = torch.ones(labels.shape, dtype=torch.float32,
                          device=labels.device)
    if on_mesh:
        hidden, labels, mask = _ce_rows(hidden, labels, mask, policy)
        head = _mesh_head(params, cfg, policy, hidden.dtype, table)

    def ce(h, y, msk):
        lg = (_mesh_logits(params, h, cfg, policy, head) if on_mesh
              else logits_fn(params, h, cfg, policy)).float()
        if split:
            lse, true = _vocab_parallel(lg, y, policy)
        else:
            lse = torch.logsumexp(lg, dim=-1)
            if cfg.ce_onehot:
                onehot = F.one_hot(y, lg.shape[-1]).to(lg.dtype)
                true = torch.einsum("bsv,bsv->bs", lg, onehot)
            else:
                true = torch.gather(lg, -1, y[..., None])[..., 0]
        return torch.sum((lse - true) * msk), torch.sum(msk)

    S, chunk = hidden.shape[1], cfg.loss_chunk
    if chunk and S % chunk == 0 and S > chunk:
        tot = cnt = torch.zeros((), dtype=torch.float32, device=hidden.device)
        grad = torch.is_grad_enabled()
        for c0 in range(0, S, chunk):
            part = (hidden[:, c0:c0 + chunk], labels[:, c0:c0 + chunk],
                    mask[:, c0:c0 + chunk])
            ds, dc = checkpoint(ce, *part, use_reentrant=False) if grad \
                else ce(*part)
            tot, cnt = tot + ds, cnt + dc
    else:
        tot, cnt = ce(hidden, labels, mask)
    if on_mesh and _ce_axes(policy):
        both = coll.all_reduce(torch.stack([tot, cnt]), policy.mesh,
                               _ce_axes(policy))
        tot, cnt = both[0], both[1]
    loss = tot / torch.clamp(cnt, min=1.0)
    return loss + cfg.router_aux_coef * aux, {"ce": loss, "aux": aux}


# ---------------------------------------------------------------------------
# cache construction (decode inputs / serve init)
# ---------------------------------------------------------------------------

def init_caches(cfg, batch, cache_len, dtype=torch.bfloat16, device=None):
    """Empty caches for all groups (leaves stacked on a leading G): a
    KVCache for an attention sublayer, a Mamba cache for an SSM one (the
    conv window in ``dtype``, the state f32), and the hybrid family's
    shared block's global KVCache under ``"shared"``."""
    n_groups, kinds, has_shared = group_layout(cfg)
    sub = []
    for i, kind in enumerate(kinds):
        if kind == "ssm":
            sub.append(SSM.init_ssm_cache(cfg, batch, dtype, device))
        else:
            sub.append(L.init_kv_cache(
                cfg, batch, cache_len, sublayer_is_global(cfg, i, len(kinds)),
                dtype, device))
    one = {"sub": sub}
    if has_shared:
        one["shared"] = L.init_kv_cache(cfg, batch, cache_len, True, dtype,
                                        device)
    return _map_caches(
        lambda t: t[None].repeat((n_groups,) + (1,) * t.dim()), one)


def cache_bytes(caches) -> int:
    """Bytes held by a cache tree (every leaf of every group)."""
    leaves = [t for c in caches["sub"] for t in c]
    leaves += list(caches.get("shared", ()))
    return sum(t.numel() * t.element_size() for t in leaves)


def param_bytes(params) -> int:
    """Bytes held by the parameters as stored (f32)."""
    return sum(p.numel() * p.element_size() for p in params.parameters())
