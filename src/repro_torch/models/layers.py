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
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F


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


def attention(p, x, positions, cfg, *, is_global=True, cache=None):
    """Returns (out, new_cache).

    cache None        -> training/prefill full-sequence path (blockwise);
                         the second result is the (k, v) pair.
    cache KVCache     -> single-token decode: x is (B, 1, D), positions
                         (B, 1); the second result is the updated ring
                         (new tensors: the given cache is not written).
    """
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


def prefill_to_cache(cfg, k, v, positions, cache_len, is_global_layer=True):
    """Convert full-sequence K/V from prefill into a (ring) KVCache in k's
    dtype."""
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


# ---------------------------------------------------------------------------
# MLP & embeddings
# ---------------------------------------------------------------------------

def init_mlp(d_model, d_ff, generator, device=None):
    return {"wg": dense_init(generator, (d_model, d_ff), device=device),
            "wu": dense_init(generator, (d_model, d_ff), device=device),
            "wd": dense_init(generator, (d_ff, d_model), in_dim=d_ff,
                             device=device)}


def mlp(p, x):
    cd = x.dtype
    g = F.silu(x @ p["wg"].to(cd))
    return (g * (x @ p["wu"].to(cd))) @ p["wd"].to(cd)


def init_embed(vocab, d_model, generator, device=None):
    return {"table": torch.randn((vocab, d_model), generator=generator,
                                 dtype=torch.float32, device=device) * 0.02}


def embed(p, tokens, dtype=torch.bfloat16):
    """The table's rows of ``tokens`` in ``dtype`` (gathered, then cast:
    the values of the JAX package's cast-then-gather)."""
    return p["table"][tokens].to(dtype)
