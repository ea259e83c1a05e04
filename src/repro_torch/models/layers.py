"""Shared neural layers: RMSNorm, RoPE, GQA attention (full / sliding-window
/ chunked-local, with qk_norm), blockwise flash-style attention for long
sequences, gated MLP, embeddings.

Conventions, as in the JAX package's ``repro.models.layers``:
  * parameters are f32 tensors in a mapping (``p["wq"]``), cast to the
    compute dtype at every matmul; ``init_*(cfg, generator, device)``
    draws them from an explicit ``torch.Generator``;
  * activations (B, S, D); attention heads (B, S, H, hd);
  * the compute dtype is the activations' dtype (bf16 by default, chosen by
    the caller); softmax statistics and attention accumulators are f32,
    and every attention product multiplies the compute-dtype operands in
    f32 (the JAX package's ``preferred_element_type=float32``: a product
    of two bf16 values is exact in f32);
  * decode uses ring KV caches: SWA archs keep a ``window``-sized ring,
    chunked-local layers an ``attention_chunk``-sized ring, global layers
    the full sequence.

On a mesh of several ranks (a ``ShardingPolicy`` whose mesh holds more than
one rank) every tensor is this rank's block of its spec (``sharding``) and
the layers call the collectives that GSPMD inserts for the JAX package
(``collectives``):
  * a parameter carries its resident spec (``p.spec``); ``weight`` gathers
    its FSDP axes just before use (every axis but "model" under tensor
    parallelism, every axis under ``pure_fsdp``: ZeRO-3, the norms too),
    and the gathered copy is dropped after the product; in backward the
    gather's gradient is reduce-scattered into the rank's block;
  * tensor parallelism: wq/wk/wv/wg/wu column-parallel, wo/wd
    row-parallel followed by an ``all_reduce`` over "model"; where the
    heads (or d_ff) do not split over the model axis the layer gathers its
    weights whole instead; in training the activations enter the
    column-parallel products through ``collectives.replicate`` (its
    backward sums their gradients over "model"), and so do the q/k norms
    that each rank applies to its own heads, while a weight gathered whole
    over "model" keeps this rank's block of its gradient (every rank of
    the axis did the same work with it);
  * sequence sharding (``seq_shard``): attention all-gathers K/V over the
    sequence axis, everything else stays local;
  * decode reads the cache in the decode policy's layout (batch over the
    batch axes or the sequence over "data", head_dim over "model"): the
    scores are summed over "model", the softmax merged over "data";
  * ``embed``: the vocab-parallel table's masked local lookup, summed
    (``reduce_scatter`` where the tokens differ across the model axis),
    or the D-sharded table's lookup reassembled over "model".
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.models import collectives as coll
from repro_torch.models.sharding import axes_of, mesh_ranks


def dense_init(generator, shape, in_dim=None, device=None):
    in_dim = in_dim or shape[0]
    return torch.randn(shape, generator=generator, dtype=torch.float32,
                       device=device) * (in_dim ** -0.5)


def rms_norm(x, w, eps=1e-6):
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps) * w.float()
    return out.to(x.dtype)


def rope(x, positions, theta):
    """x: (B, S, H, hd); positions: (B, S) int32."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = positions[..., None].float() * freqs               # (B, S, half)
    cos = torch.cos(ang)[:, :, None, :].to(x.dtype)
    sin = torch.sin(ang)[:, :, None, :].to(x.dtype)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


# ---------------------------------------------------------------------------
# parameters on a mesh
# ---------------------------------------------------------------------------

def on_mesh(policy) -> bool:
    """Whether ``policy`` places tensors on more than one rank."""
    return policy is not None and mesh_ranks(policy.mesh) > 1


def weight(p, policy, keep=(), dtype=None):
    """Parameter ``p`` as a layer uses it, in ``dtype`` (default its own):
    its blocks all-gathered over every axis of its resident spec but those
    in ``keep`` (the FSDP gather).  The cast comes first, so the gather
    moves the compute dtype's bytes (the same values: a cast is per
    element); under autograd its backward sums every rank's gradient of
    the gathered copy into this rank's block, in f32
    (``collectives.gather_cast``).  Under tensor parallelism the model
    axis carries no tokens, so a weight gathered over it is used alike on
    its ranks."""
    spec = getattr(p, "spec", None)
    dtype = dtype or p.dtype
    if spec is None or not on_mesh(policy):
        return p.to(dtype)
    gathers = []
    for d, entry in enumerate(spec):
        gather = tuple(a for a in axes_of(entry) if a not in keep)
        if gather:
            gathers.append((d, gather))
    alike = (policy.model_axis,) if policy.tensor_parallel else ()
    return coll.gather_cast(p, policy.mesh, gathers, dtype, alike)


def use_spec(p, keep) -> tuple:
    """The spec of ``weight(p, policy, keep)``'s result."""
    spec = getattr(p, "spec", None) or (None,) * p.dim()
    return tuple(e if e in keep else None for e in spec)


def split_over(policy, *dims) -> bool:
    """Whether the layer runs tensor-parallel: the policy splits over the
    model axis (not ``pure_fsdp``) and so does every (parameter, dim)
    pair's resident spec."""
    keep = (policy.model_axis,)
    return policy.tensor_parallel and all(
        use_spec(p, keep)[d] == policy.model_axis for p, d in dims)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def init_attention(cfg, generator, device=None):
    D, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    p = {
        "wq": dense_init(generator, (D, H * hd), device=device),
        "wk": dense_init(generator, (D, KV * hd), device=device),
        "wv": dense_init(generator, (D, KV * hd), device=device),
        "wo": dense_init(generator, (H * hd, D), in_dim=H * hd,
                         device=device),
    }
    if cfg.qk_norm:
        p["q_norm"] = torch.ones(hd, dtype=torch.float32, device=device)
        p["k_norm"] = torch.ones(hd, dtype=torch.float32, device=device)
    return p


def _mask(pos_q, pos_kv, *, causal, window, chunk):
    """(..., Sq, Skv) boolean validity from positions."""
    pq, pk = pos_q[..., :, None], pos_kv[..., None, :]
    m = torch.ones(torch.broadcast_shapes(pq.shape, pk.shape),
                   dtype=torch.bool, device=pos_q.device)
    if causal:
        m &= pk <= pq
    if window:
        m &= pk > pq - window
    if chunk:
        m &= torch.div(pk, chunk, rounding_mode="floor") == \
            torch.div(pq, chunk, rounding_mode="floor")
    m &= pos_kv[..., None, :] >= 0  # ring slots not yet written
    return m


def _scores(q, kc, scale):
    """(B, Sq, KV, G, C) f32 scores of compute-dtype q (B, Sq, KV, G, hd)
    against k (B, C, KV, hd), the products in f32."""
    return torch.einsum("bqkgh,bckh->bqkgc", q.float(), kc.float()) * scale


def _weighted(p, vc):
    """(B, Sq, KV, G, hd) f32: probabilities rounded to v's dtype, then the
    product in f32."""
    return torch.einsum("bqkgc,bckh->bqkgh", p.to(vc.dtype).float(),
                        vc.float())


def blockwise_attention(q, k, v, pos_q, pos_kv, *, causal, window, chunk,
                        kv_block, q_block=0):
    """Flash-style online-softmax attention, a loop over KV blocks.

    q: (B, Sq, KV, G, hd); k, v: (B, Skv, KV, hd); pos_*: (B, S*).
    Never materializes the (Sq, Skv) score matrix: peak extra memory is
    O(Sq * kv_block) per (batch, head), and with ``q_block`` > 0 (when it
    divides Sq) the query blocks run one at a time, O(q_block * kv_block).
    The blocks are visited in the JAX package's order, so the softmax sums
    in its order too.
    """
    B, Sq, KVh, G, hd = q.shape
    if q_block and Sq > q_block and Sq % q_block == 0:
        return torch.cat([
            blockwise_attention(q[:, s:s + q_block], k, v,
                                pos_q[:, s:s + q_block], pos_kv,
                                causal=causal, window=window, chunk=chunk,
                                kv_block=kv_block, q_block=0)
            for s in range(0, Sq, q_block)], dim=1)
    Skv = k.shape[1]
    kv_block = min(kv_block, Skv)
    pad = (-Skv) % kv_block
    if pad:  # padded slots carry pos=-1 and are masked out
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        pos_kv = F.pad(pos_kv, (0, pad), value=-1)
        Skv += pad
    scale = hd ** -0.5

    m = torch.full((B, Sq, KVh, G), float("-inf"), dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((B, Sq, KVh, G), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, Sq, KVh, G, hd), dtype=torch.float32,
                      device=q.device)
    for c0 in range(0, Skv, kv_block):
        kc, vc = k[:, c0:c0 + kv_block], v[:, c0:c0 + kv_block]
        s = _scores(q, kc, scale)
        msk = _mask(pos_q, pos_kv[:, c0:c0 + kv_block], causal=causal,
                    window=window, chunk=chunk)
        s = torch.where(msk[:, :, None, None, :], s, float("-inf"))
        m_new = torch.maximum(m, s.amax(-1))
        # guard all -inf rows
        m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
        p = torch.exp(s - m_safe[..., None])
        p = torch.where(torch.isfinite(s), p, 0.0)
        corr = torch.where(torch.isfinite(m), torch.exp(m - m_safe), 0.0)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + _weighted(p, vc)
        m = m_new
    out = acc / torch.clamp(l, min=1e-20)[..., None]
    return out.to(q.dtype)


class KVCache(NamedTuple):
    k: torch.Tensor          # (B, C, KV, hd)
    v: torch.Tensor          # (B, C, KV, hd)
    slot_pos: torch.Tensor   # (C,) int32 — position held by each ring slot, -1 empty


def init_kv_cache(cfg, batch, cache_len, is_global_layer=True,
                  dtype=torch.bfloat16, device=None):
    KVh, hd = cfg.n_kv_heads, cfg.head_dim_
    C = cache_len
    if cfg.sliding_window:
        C = min(C, cfg.sliding_window)
    elif cfg.attention_chunk and not is_global_layer:
        C = min(C, cfg.attention_chunk)
    return KVCache(
        k=torch.zeros((batch, C, KVh, hd), dtype=dtype, device=device),
        v=torch.zeros((batch, C, KVh, hd), dtype=dtype, device=device),
        slot_pos=torch.full((C,), -1, dtype=torch.int32, device=device))


def attention(p, x, positions, cfg, *, is_global=True, cache=None,
              policy=None):
    """Returns (out, new_cache).

    cache None        -> training/prefill full-sequence path (blockwise);
                         the second result is the (k, v) pair.
    cache KVCache     -> single-token decode: x is (B, 1, D), positions
                         (B, 1); the second result is the updated ring
                         (new tensors: the given cache is not written).

    On a mesh (``policy``) the blocks of ``_mesh_attention``.
    """
    if on_mesh(policy):
        return _mesh_attention(p, x, positions, cfg, is_global, cache,
                               policy)
    B, S, D = x.shape
    H, KVh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    G = H // KVh
    cd = x.dtype

    q = (x @ p["wq"].to(cd)).reshape(B, S, H, hd)
    k = (x @ p["wk"].to(cd)).reshape(B, S, KVh, hd)
    v = (x @ p["wv"].to(cd)).reshape(B, S, KVh, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    window = cfg.sliding_window
    chunk = 0 if (is_global or not cfg.attention_chunk) else cfg.attention_chunk

    if cache is None:
        qg = q.reshape(B, S, KVh, G, hd)
        out = blockwise_attention(
            qg, k, v, positions, positions,
            causal=not cfg.is_encoder, window=window, chunk=chunk,
            kv_block=cfg.kv_block, q_block=cfg.q_block)
        out = out.reshape(B, S, H * hd)
        return out @ p["wo"].to(cd), (k, v)

    # ---- decode: one new token into a ring cache ----
    C = cache.k.shape[1]
    pos = positions[:, 0]                      # (B,) current position
    slot = (pos[:1] % C).long()                # same position across batch
    ck = cache.k.index_copy(1, slot, k.to(cache.k.dtype))
    cv = cache.v.index_copy(1, slot, v.to(cache.v.dtype))
    spos = cache.slot_pos.index_copy(0, slot, pos[:1].to(torch.int32))

    qg = q.reshape(B, 1, KVh, G, hd)
    s = _scores(qg, ck, hd ** -0.5)
    msk = _mask(pos[:, None], spos[None, :], causal=True, window=window,
                chunk=chunk)  # (B, 1, C)
    s = torch.where(msk[:, :, None, None, :], s, float("-inf"))
    m = s.amax(-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, 0.0)
    pr = torch.exp(s - m)
    pr = torch.where(torch.isfinite(s), pr, 0.0)
    o = _weighted(pr, cv)
    o = o / torch.clamp(pr.sum(-1), min=1e-20)[..., None]
    out = o.to(cd).reshape(B, 1, H * hd)
    return out @ p["wo"].to(cd), KVCache(ck, cv, spos)


def _heads_split(p, cfg, policy) -> bool:
    """Whether the attention runs tensor-parallel: wq/wk/wv split on their
    columns and wo on its rows over the model axis, and the query and KV
    heads divide it."""
    n = policy.model_size
    return split_over(policy, (p["wq"], 1), (p["wk"], 1), (p["wv"], 1),
                      (p["wo"], 0)) and cfg.n_heads % n == 0 and \
        cfg.n_kv_heads % n == 0


def _mesh_attention(p, x, positions, cfg, is_global, cache, policy):
    """Attention on this rank's tokens (B_loc, S_loc, D).  Under tensor
    parallelism q/k/v hold this rank's heads and wo's partial sums are
    all-reduced over "model"; else every head is local.  Prefill returns
    K/V over the whole sequence (all-gathered over ``seq_shard``) in the
    compute layout; decode reads and returns the cache in the decode
    layout (``ShardingPolicy.kv_cache_spec``)."""
    mesh, m = policy.mesh, policy.model_axis
    tp = _heads_split(p, cfg, policy)
    keep = (m,) if tp else ()
    B, S, D = x.shape
    H, KVh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    if tp:
        H, KVh = H // policy.model_size, KVh // policy.model_size
    G = H // KVh
    cd = x.dtype

    def rank_work(t):             # every rank's copy enters its own heads
        return coll.replicate(t, mesh, m) if tp else t
    x = rank_work(x)
    q = (x @ weight(p["wq"], policy, keep, cd)).reshape(B, S, H, hd)
    k = (x @ weight(p["wk"], policy, keep, cd)).reshape(B, S, KVh, hd)
    v = (x @ weight(p["wv"], policy, keep, cd)).reshape(B, S, KVh, hd)
    if cfg.qk_norm:
        q = rms_norm(q, rank_work(weight(p["q_norm"], policy)), cfg.norm_eps)
        k = rms_norm(k, rank_work(weight(p["k_norm"], policy)), cfg.norm_eps)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    window = cfg.sliding_window
    chunk = cfg.attention_chunk if not is_global else 0
    wo = weight(p["wo"], policy, keep, cd)

    def project(o):                    # (B, S, H * hd) -> (B, S, D)
        out = o @ wo
        return coll.all_reduce(out, mesh, m) if tp else out

    if cache is None:
        pos_kv = positions
        if policy.seq_shard:
            k = coll.all_gather(k, mesh, policy.seq_shard, 1)
            v = coll.all_gather(v, mesh, policy.seq_shard, 1)
            pos_kv = coll.all_gather(positions, mesh, policy.seq_shard, 1)
        out = blockwise_attention(
            q.reshape(B, S, KVh, G, hd), k, v, positions, pos_kv,
            causal=not cfg.is_encoder, window=window, chunk=chunk,
            kv_block=cfg.kv_block, q_block=cfg.q_block)
        return project(out.reshape(B, S, H * hd)), (k, v)

    # ---- decode: the cache's block is (B_loc, C_loc, KV, hd_loc) ----
    Cg = cache.slot_pos.shape[0]
    cspec = policy.kv_cache_spec((policy.global_batch, Cg, cfg.n_kv_heads,
                                  hd))
    c_ax, d_ax = cspec[1], cspec[3]
    if tp and d_ax:        # this rank's heads -> every head, its hd block
        def to_cache(t):
            return coll.all_to_all(t, mesh, m, 3, 2)
    elif tp:
        def to_cache(t):
            return coll.all_gather(t, mesh, m, 2)
    elif d_ax:
        def to_cache(t):
            n = t.shape[3] // policy.model_size
            return t.narrow(3, mesh.coords[m] * n, n)
    else:
        def to_cache(t):
            return t
    q, k, v = to_cache(q), to_cache(k), to_cache(v)

    Cl = cache.k.shape[1]
    pos = positions[:, 0]
    slot = (pos[:1] % Cg).long()
    spos = cache.slot_pos.index_copy(0, slot, pos[:1].to(torch.int32))
    lo = mesh.coords[c_ax] * Cl if c_ax else 0
    local = slot - lo
    inside = (local >= 0) & (local < Cl)
    local = local.clamp(0, Cl - 1)
    # the rank whose block holds the slot writes it; the others rewrite
    # the slot's old value
    ck = cache.k.index_copy(1, local, torch.where(
        inside, k.to(cache.k.dtype), cache.k.index_select(1, local)))
    cv = cache.v.index_copy(1, local, torch.where(
        inside, v.to(cache.v.dtype), cache.v.index_select(1, local)))

    s = _scores(q.reshape(B, 1, cfg.n_kv_heads, -1, q.shape[-1]), ck,
                hd ** -0.5)
    if d_ax:
        s = coll.all_reduce(s, mesh, d_ax)
    msk = _mask(pos[:, None], spos[lo:lo + Cl][None, :], causal=True,
                window=window, chunk=chunk)
    s = torch.where(msk[:, :, None, None, :], s, float("-inf"))
    mx = s.amax(-1, keepdim=True)
    if c_ax:
        mx = coll.all_reduce(mx, mesh, c_ax, op="max")
    mx = torch.where(torch.isfinite(mx), mx, 0.0)
    pr = torch.exp(s - mx)
    pr = torch.where(torch.isfinite(s), pr, 0.0)
    o, l = _weighted(pr, cv), pr.sum(-1)
    if c_ax:
        o = coll.all_reduce(o, mesh, c_ax)
        l = coll.all_reduce(l, mesh, c_ax)
    o = (o / torch.clamp(l, min=1e-20)[..., None]).to(cd)
    o = o.reshape(B, 1, cfg.n_heads, o.shape[-1])
    if tp and d_ax:        # every head's hd block -> this rank's heads
        o = coll.all_to_all(o, mesh, m, 2, 3)
    elif tp:
        o = o.narrow(2, mesh.coords[m] * H, H)
    elif d_ax:
        o = coll.all_gather(o, mesh, d_ax, 3)
    return project(o.reshape(B, 1, H * hd)), KVCache(ck, cv, spos)


def prefill_to_cache(cfg, k, v, positions, cache_len, is_global_layer=True,
                     policy=None):
    """Convert full-sequence K/V from prefill into a (ring) KVCache in k's
    dtype.  On a mesh, K/V come in ``_mesh_attention``'s layout and the
    cache leaves in the decode policy's (``ShardingPolicy.for_decode``)."""
    if on_mesh(policy):
        return _mesh_prefill_cache(cfg, k, v, positions, cache_len,
                                   is_global_layer, policy)
    B, S, KVh, hd = k.shape
    cache = init_kv_cache(cfg, B, cache_len, is_global_layer, dtype=k.dtype,
                          device=k.device)
    C = cache.k.shape[1]
    if C >= S:
        cache.k[:, :S] = k
        cache.v[:, :S] = v
        cache.slot_pos[:S] = positions[0]
        return cache
    # keep the last C positions, placed at their ring slots
    last_pos = positions[0, -1]
    keep_pos = last_pos - C + 1 + torch.arange(C, device=k.device)
    src = (keep_pos - positions[0, 0]).long()            # indices into S
    slots = (keep_pos % C).long()
    cache.k[:, slots] = k[:, src]
    cache.v[:, slots] = v[:, src]
    cache.slot_pos[slots] = keep_pos.to(torch.int32)
    return cache


def _mesh_prefill_cache(cfg, k, v, positions, cache_len, is_global_layer,
                        policy):
    mesh = policy.mesh
    if policy.seq_shard:
        positions = coll.all_gather(positions, mesh, policy.seq_shard, 1)
    # under tensor parallelism this rank's K/V hold its heads only
    heads = policy.model_axis if k.shape[2] < cfg.n_kv_heads else None
    cache = prefill_to_cache(dataclasses.replace(cfg, n_kv_heads=k.shape[2]),
                             k, v, positions, cache_len, is_global_layer)
    ba = policy.batch_axes
    src = (ba if len(ba) > 1 else (ba[0] if ba else None), None, heads, None)
    full = (policy.global_batch, cache.k.shape[1], cfg.n_kv_heads,
            cfg.head_dim_)
    dst = policy.for_decode().kv_cache_spec(full)
    return KVCache(coll.reshard(cache.k, mesh, src, dst),
                   coll.reshard(cache.v, mesh, src, dst), cache.slot_pos)


# ---------------------------------------------------------------------------
# MLP & embeddings
# ---------------------------------------------------------------------------

def init_mlp(d_model, d_ff, generator, device=None):
    return {"wg": dense_init(generator, (d_model, d_ff), device=device),
            "wu": dense_init(generator, (d_model, d_ff), device=device),
            "wd": dense_init(generator, (d_ff, d_model), in_dim=d_ff,
                             device=device)}


def mlp(p, x, policy=None):
    """The gated MLP; on a mesh column-parallel wg/wu and row-parallel wd
    (then an ``all_reduce`` over "model") when d_ff splits over the model
    axis, else on the whole gathered weights."""
    cd = x.dtype
    if not on_mesh(policy):
        g = F.silu(x @ p["wg"].to(cd))
        return (g * (x @ p["wu"].to(cd))) @ p["wd"].to(cd)
    tp = split_over(policy, (p["wg"], 1), (p["wu"], 1), (p["wd"], 0))
    keep = (policy.model_axis,) if tp else ()
    if tp:
        x = coll.replicate(x, policy.mesh, policy.model_axis)
    g = F.silu(x @ weight(p["wg"], policy, keep, cd))
    out = (g * (x @ weight(p["wu"], policy, keep, cd))) @ \
        weight(p["wd"], policy, keep, cd)
    return coll.all_reduce(out, policy.mesh, policy.model_axis) if tp else out


def init_embed(vocab, d_model, generator, device=None):
    return {"table": torch.randn((vocab, d_model), generator=generator,
                                 dtype=torch.float32, device=device) * 0.02}


def embed(p, tokens, dtype=torch.bfloat16, policy=None):
    """The table's rows of ``tokens`` in ``dtype`` (gathered, then cast:
    the values of the JAX package's cast-then-gather).  On a mesh
    ``tokens`` is this rank's block of ``batch_first`` and so is the
    result."""
    table = p["table"]
    if not on_mesh(policy) or getattr(table, "spec", None) is None:
        return table[tokens].to(dtype)
    mesh, m = policy.mesh, policy.model_axis
    tv, td = table.spec
    table = weight(table, policy, (m,))
    if tv != m and td != m:
        return table[tokens].to(dtype)
    # the dim of the tokens that differs across the model axis, if any
    tok_dim = 0 if m in policy.batch_axes else (
        1 if policy.seq_shard == m else None)
    ids = tokens if tok_dim is None else coll.all_gather(tokens, mesh, m,
                                                      tok_dim)
    if tv == m:
        # vocab-parallel: this rank's rows, zero elsewhere, summed over
        # the model axis (one non-zero term: exact)
        vloc = table.shape[0]
        loc = ids - mesh.coords[m] * vloc
        ok = (loc >= 0) & (loc < vloc)
        emb = torch.where(ok[..., None], table[loc.clamp(0, vloc - 1)],
                          0).to(dtype)
        if tok_dim is None:
            return coll.all_reduce(emb, mesh, m)
        return coll.reduce_scatter(emb, mesh, m, tok_dim)
    emb = table[ids].to(dtype)                 # this rank's D block
    if tok_dim is None:        # tensor parallelism: the ranks' tokens alike
        return coll.all_gather(emb, mesh, m, emb.dim() - 1, alike=True)
    return coll.all_to_all(emb, mesh, m, tok_dim, emb.dim() - 1)
