"""Capacity-based top-k routed MoE with shared expert(s).

The port of the JAX package's ``repro.models.moe``.  Token→slot assignment
is the one-hot-cumsum capacity scheme (GShard/Switch): static shapes, each
expert takes at most C tokens of the call, the overflow is dropped
(``capacity_factor`` sets the drop rate; the router aux loss keeps loads
balanced).  The expert FFN runs over the whole (E, C, D) slot buffer, the
empty slots too, as three batched products.

On a mesh every rank routes its own block of tokens (the JAX package's
``shard_map`` over the batch axes: capacity is per block,
``_capacity(cfg, T_loc)``) and the expert FFN runs in one of the JAX
package's modes, chosen as its ``moe_ffn`` chooses them:
  * ``ep``: experts divide the model axis; each peer computes its expert
    slice of the slot buffer, the outputs are all-gathered;
  * ``tp``: experts don't divide; every peer computes all experts on its
    d_ff shard, the down-projection is all-reduced;
  * ``pure_fsdp`` with experts dividing the model axis: the slot buffers
    go to the experts' home peers and back with two ``all_to_all``s;
  * ``pure_fsdp`` otherwise: every expert local on gathered weights.
The aux loss is the mean over the token blocks (``jnp.mean(aux)`` of the
JAX package's per-shard values), so on a mesh it is not the aux of the
whole batch that one rank computes.  In training the ``pure_fsdp`` modes
send the slot buffers' gradients back through the inverse
``all_to_all``s, and gathered expert weights sum their gradients into
each rank's block (``collectives``); the ``ep`` and ``tp`` modes (a
tensor-parallel policy) take the slot buffer, which the model axis's
ranks hold alike, through ``collectives.replicate`` into their own
experts or d_ff shard, and ``ep``'s gathered outputs hand each rank its
experts' gradient.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import collectives as coll
from repro_torch.models.layers import dense_init, init_mlp, mlp, on_mesh, \
    split_over, weight


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


def _ffn(buf, wg, wu, wd):
    """The gated expert FFN over a slot buffer (E, C, D)."""
    cd = buf.dtype
    h = torch.bmm(buf, wg.to(cd))
    u = torch.bmm(buf, wu.to(cd))
    return torch.bmm(F.silu(h) * u, wd.to(cd))


def _dispatch_combine(x, router, wg, wu, wd, cfg, experts=None):
    """Route the tokens of ``x`` (B, S, D) into the slot buffer, run the
    experts over it (``experts(buf)`` -> (E, C, D); by default all of them
    here on ``wg``/``wu``/``wd``) and combine.  Returns (routed out (B, S,
    D), aux, dropped: the (token, choice) rows past capacity)."""
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

    y = experts(buf) if experts is not None else _ffn(buf, wg, wu, wd)

    got = y[flat_e, pos_c]                                  # (T*k, D)
    got = torch.where(keep[:, None], got, 0)
    out = torch.sum(got.reshape(T, k, D) * gate[:, :, None].to(cd), dim=1)
    return out.reshape(B, S, D), aux, (~keep).sum()


def _mesh_experts(p, cfg, policy, dtype):
    """(wg, wu, wd, experts) of this rank's mode (module docstring), the
    weights in ``dtype``."""
    mesh, m, n = policy.mesh, policy.model_axis, policy.model_size
    E = cfg.n_experts
    ws = (p["we_gate"], p["we_up"], p["we_down"])
    if n > 1 and E % n == 0:
        # the experts' home peers: the resident blocks (m, None, None)
        wg, wu, wd = (weight(w, policy, (m,), dtype) for w in ws)
        eloc = E // n
        if policy.pure_fsdp:
            def experts(buf):
                Cc, D = buf.shape[1:]
                recv = coll.all_to_all(buf.reshape(n, eloc, Cc, D), mesh,
                                       m, 0, 0)             # (P, eloc, C, D)
                toks = recv.transpose(0, 1).reshape(eloc, n * Cc, D)
                y = _ffn(toks, wg, wu, wd)
                y = y.reshape(eloc, n, Cc, D).transpose(0, 1)
                return coll.all_to_all(y, mesh, m, 0, 0).reshape(E, Cc, D)
        else:
            def experts(buf):
                mi = mesh.coords[m]
                buf = coll.replicate(buf, mesh, m)
                y = _ffn(buf[mi * eloc:(mi + 1) * eloc], wg, wu, wd)
                return coll.all_gather(y, mesh, m, 0, alike=True)
        return wg, wu, wd, experts
    tp = not policy.pure_fsdp and split_over(
        policy, (ws[0], 2), (ws[1], 2), (ws[2], 1))
    wg, wu, wd = (weight(w, policy, (m,) if tp else (), dtype)
                  for w in ws)
    if not tp:
        return wg, wu, wd, None

    def experts(buf):
        return coll.all_reduce(_ffn(coll.replicate(buf, mesh, m), wg, wu,
                                    wd), mesh, m)
    return wg, wu, wd, experts


def moe_ffn(p, x, cfg, policy):
    """Routed + shared expert FFN. Returns (out, aux_loss scalar)."""
    if not on_mesh(policy):
        out, aux, _ = _dispatch_combine(
            x, p["router"], p["we_gate"], p["we_up"], p["we_down"], cfg)
        if "shared" in p:
            out = out + mlp(p["shared"], x)
        return out, aux
    wg, wu, wd, experts = _mesh_experts(p, cfg, policy, x.dtype)
    router = weight(p["router"], policy)
    out, aux, _ = _dispatch_combine(x, router, wg, wu, wd, cfg, experts)
    axes = policy.token_axes
    if axes:
        aux = coll.all_reduce(aux.reshape(1), policy.mesh, axes)[0] / \
            policy.mesh.size(axes)
    if "shared" in p:
        out = out + mlp(p["shared"], x, policy)
    return out, aux
