"""Capacity-based top-k routed MoE with shared expert(s), on one card.

The port of the JAX package's ``repro.models.moe``.  Token→slot assignment
is the one-hot-cumsum capacity scheme (GShard/Switch): static shapes, each
expert takes at most C tokens of the call, the overflow is dropped
(``capacity_factor`` sets the drop rate; the router aux loss keeps loads
balanced).  The expert FFN runs over the whole (E, C, D) slot buffer, the
empty slots too, as three batched products.

The JAX package parallelizes the expert FFN over its ``model`` mesh axis in
one of three modes (``ep``: experts divide the axis; ``tp``: every peer
computes all experts on a d_ff shard; all-to-all dispatch under ZeRO).
On one card the model axis has one peer, which is the ``ep`` branch with no
collective; the other modes need the multi-rank ShardingPolicy.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import dense_init, init_mlp, mlp


def init_moe(cfg, generator, device=None):
    D, E, Fe = cfg.d_model, cfg.n_experts, cfg.d_ff_expert
    p = {
        "router": dense_init(generator, (D, E), device=device),
        "we_gate": dense_init(generator, (E, D, Fe), in_dim=D, device=device),
        "we_up": dense_init(generator, (E, D, Fe), in_dim=D, device=device),
        "we_down": dense_init(generator, (E, Fe, D), in_dim=Fe,
                              device=device),
    }
    if cfg.n_shared_experts:
        # qwen2-moe: shared expert of width n_shared*Fe (== cfg.d_ff);
        # llama4: one shared expert of width d_ff
        p["shared"] = init_mlp(D, cfg.d_ff, generator, device)
    return p


def _capacity(cfg, tokens_local: int) -> int:
    """Slots per expert for a call of ``tokens_local`` tokens."""
    c = int(tokens_local * cfg.experts_per_token * cfg.capacity_factor /
            max(cfg.n_experts, 1))
    return max(8, min(c, tokens_local))


def _route(logits, cfg):
    """logits (T, E) f32 -> gate (T,k) f32, idx (T,k), aux-loss scalar."""
    E, k = cfg.n_experts, cfg.experts_per_token
    probs = torch.softmax(logits, dim=-1)
    gate, idx = torch.topk(probs, k, dim=-1)
    if k > 1:  # qwen-style renorm
        gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
    # switch-style load-balance loss
    assign = F.one_hot(idx, E).sum(1).float()               # (T, E)
    frac = assign.mean(0) / k
    mean_p = probs.mean(0)
    aux = E * torch.sum(frac * mean_p)
    return gate.float(), idx, aux


def _slots(flat_e, E):
    """Each (token, choice)'s slot in its expert: how many earlier rows of
    the token-major ``flat_e`` (T*k,) chose the same expert (exact integer
    counts)."""
    onehot = F.one_hot(flat_e, E)                           # (T*k, E) int64
    before = torch.cumsum(onehot, dim=0) - onehot
    return (before * onehot).sum(1)


def _dispatch_combine(x, router, wg, wu, wd, cfg):
    """The ``ep`` branch on one model peer. x: (B, S, D).  Returns (routed
    out (B, S, D), aux, dropped: the (token, choice) rows past capacity)."""
    B, S, D = x.shape
    T = B * S
    k = cfg.experts_per_token
    E = cfg.n_experts
    C = _capacity(cfg, T)
    cd = x.dtype

    xt = x.reshape(T, D)
    logits = xt.float() @ router.float()
    gate, idx, aux = _route(logits, cfg)

    flat_e = idx.reshape(T * k)                             # token-major
    pos = _slots(flat_e, E)
    keep = pos < C
    pos_c = torch.clamp(pos, max=C - 1)

    # the dropped rows add zeros at a clamped slot: the sums of JAX's
    # mode="drop" scatter, with no host sync for a boolean index
    xt_rep = xt.repeat_interleave(k, dim=0) if k > 1 else xt
    buf = torch.zeros((E, C, D), dtype=cd, device=x.device)
    buf.index_put_((flat_e, pos_c),
                   torch.where(keep[:, None], xt_rep, 0), accumulate=True)

    h = torch.bmm(buf, wg.to(cd))
    u = torch.bmm(buf, wu.to(cd))
    y = torch.bmm(F.silu(h) * u, wd.to(cd))                 # (E, C, D)

    got = y[flat_e, pos_c]                                  # (T*k, D)
    got = torch.where(keep[:, None], got, 0)
    out = torch.sum(got.reshape(T, k, D) * gate[:, :, None].to(cd), dim=1)
    return out.reshape(B, S, D), aux, (~keep).sum()


def moe_ffn(p, x, cfg, policy):
    """Routed + shared expert FFN. Returns (out, aux_loss scalar)."""
    if policy.model_size > 1:
        raise NotImplementedError(
            "moe_ffn on a model axis of more than one peer: the tp and "
            "all-to-all dispatch modes need the multi-rank ShardingPolicy "
            "(ROADMAP queue 1, item 4)")
    out, aux, _ = _dispatch_combine(
        x, p["router"], p["we_gate"], p["we_up"], p["we_down"], cfg)
    if "shared" in p:
        out = out + mlp(p["shared"], x)
    return out, aux
