"""Mamba1 (falcon-mamba) and Mamba2/SSD (zamba2) blocks.

The port of the JAX package's ``repro.models.ssm``, which itself stands in
for the CUDA selective-scan kernel with *chunked* formulations:
  * Mamba1: a scan of the diagonal recurrence h_t = a_t ⊙ h_{t-1} + b_t
    inside a chunk, sequential across chunks;
  * Mamba2: the SSD block decomposition (intra-chunk "attention-like"
    products + inter-chunk state passing), scalar-per-head decay.

The JAX package scans inside a chunk with ``lax.associative_scan``;
PyTorch has none, so :func:`_mamba1_chunk_scan` runs a log-depth doubling
scan of whole-tensor ops over the chunk axis.  Prefill loops over chunks,
never over tokens; decode is one step of the recurrence.  The projections,
the depthwise conv and the einsums run as PyTorch ops, as the JAX package
runs them outside any Pallas kernel.

On a mesh (a ``ShardingPolicy`` of several ranks) every tensor is this
rank's block, and the blocks take one of two layouts:
  * tensor parallelism (the decode policy, and "tp" prefill and training),
    by the JAX rule table: ``in_proj`` column-parallel, ``x_proj``
    row-parallel (its partial sums all-reduced over "model"), ``dt_proj``
    column-parallel, ``conv_w``, ``A_log``, ``dt_bias`` and ``D_skip``
    over "model", ``out_proj`` row-parallel and then an ``all_reduce``.
    ``in_proj``'s contiguous column blocks do not line up with the pieces
    the block cuts its projection into (Mamba1's x | z, Mamba2's z | xBC |
    dt, whose conv channels split at (d_inner + 2N) / m, off the heads), so
    the layers gather activations, never weights, where the layouts
    differ: the projection's block is all-gathered over "model", the
    depthwise conv runs on the rank's own channel block of ``conv_w`` and
    of the conv cache (per channel, so any block is valid), and Mamba2
    all-gathers the conv's output to take its head-aligned x and the whole
    B and C; its gated norm over d_inner all-reduces the sum of squares.
    ``conv_b``, ``norm_w`` and ``A_log2`` have no rule: whole on every
    rank, each rank slices its block;
  * otherwise (ZeRO-3, or a TP policy whose axis does not split the
    block) every weight is gathered whole just before use and the block
    computes on this rank's tokens; under ``seq_shard`` the sequence is
    all-gathered first (the scan and the conv cross the split) and the
    rank keeps its positions of the output.
Caches leave prefill, and enter decode, in the decode policy's layout
(``ShardingPolicy.ssm_cache_spec``).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.models import collectives as coll
from repro_torch.models.layers import dense_init, on_mesh, rms_norm, \
    split_over, weight


def _causal_conv(x, w, b):
    """Depthwise causal conv. x: (B, S, C), w: (C, cw), b: (C,).

    ``out[t] = sum_j x[t - (cw - 1) + j] * w[:, j]`` (zeros before the
    first token): a cross-correlation whose last tap meets the current
    token, as the JAX package's ``conv_general_dilated`` with kernel
    ``w.T[:, None, :]`` computes it."""
    C, cw = w.shape
    xp = F.pad(x.transpose(1, 2), (cw - 1, 0))            # (B, C, S + cw - 1)
    out = F.conv1d(xp, w[:, None, :].to(x.dtype), groups=C)
    return out.transpose(1, 2) + b.to(x.dtype)


def _conv_step(x_t, conv_state, w, b):
    """Single-token causal conv in f32, cast back to x_t's dtype.
    x_t: (B, 1, C); conv_state: (B, cw-1, C).  Returns (out (B, 1, C), the
    new window (B, cw-1, C))."""
    win = torch.cat([conv_state, x_t], dim=1)               # (B, cw, C)
    out = torch.einsum("bwc,cw->bc", win.float(), w.float()) + b
    return out[:, None, :].to(x_t.dtype), win[:, 1:]


def _conv_tail(x, cw):
    """The last cw - 1 positions of x (B, S, C), left-padded with zeros
    when S < cw - 1: the conv state a prefill leaves for decode (a copy:
    a view would keep the whole projection alive with the cache)."""
    S = x.shape[1]
    if S >= cw - 1:
        return x[:, S - (cw - 1):].clone()
    return F.pad(x, (0, 0, cw - 1 - S, 0))


def _pad_seq(t, pad):
    """Zero-pad the sequence axis (1) of t by ``pad`` positions at the end."""
    return F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))


def _dt_init(generator, n, device):
    """dt log-uniform in [1e-3, 0.1]; returns softplus^{-1}(dt)."""
    u = torch.rand((n,), generator=generator, dtype=torch.float32,
                   device=device)
    dt = torch.exp(u * (math.log(0.1) - math.log(0.001)) + math.log(0.001))
    return torch.log(torch.expm1(dt))


# ---------------------------------------------------------------------------
# Mamba1
# ---------------------------------------------------------------------------

class Mamba1Cache(NamedTuple):
    conv: torch.Tensor   # (B, cw-1, di)
    h: torch.Tensor      # (B, di, N) f32


def init_mamba1(cfg, generator, device=None):
    D, di, N, cw = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_conv
    R = max(D // 16, 1)  # dt_rank
    return {
        "in_proj": dense_init(generator, (D, 2 * di), device=device),
        "conv_w": torch.randn((di, cw), generator=generator,
                              dtype=torch.float32, device=device) * 0.2,
        "conv_b": torch.zeros((di,), dtype=torch.float32, device=device),
        "x_proj": dense_init(generator, (di, R + 2 * N), in_dim=di,
                             device=device),
        "dt_proj": dense_init(generator, (R, di), in_dim=R, device=device),
        "dt_bias": _dt_init(generator, di, device),
        "A_log": torch.log(torch.arange(
            1, N + 1, dtype=torch.float32, device=device)).expand(
                di, N).contiguous(),
        "D_skip": torch.ones((di,), dtype=torch.float32, device=device),
        "out_proj": dense_init(generator, (di, D), in_dim=di, device=device),
    }


def _doubling_scan(a, b):
    """Inclusive scan of h_t = a_t * h_{t-1} + b_t over axis 1, as the
    pairs (prod a, h from zero): log2(length) steps of whole-tensor ops,
    each combining position t with t - off (off = 1, 2, 4, ...)."""
    n, off = a.shape[1], 1
    while off < n:
        a_hi, b_hi = a[:, off:], b[:, off:]
        b = torch.cat([b[:, :off], a_hi * b[:, :-off] + b_hi], dim=1)
        a = torch.cat([a[:, :off], a_hi * a[:, :-off]], dim=1)
        off *= 2
    return a, b


def _mamba1_chunk(dt_c, x_c, B_c, C_c, A, h):
    """One chunk of the scan: (y (B,cl,di), the chunk's last state)."""
    a = torch.exp(dt_c[..., None] * A)                      # (B,cl,di,N)
    b = (dt_c * x_c)[..., None] * B_c[:, :, None, :]
    aa, bb = _doubling_scan(a, b)
    del a, b
    hs = aa * h[:, None] + bb                               # (B,cl,di,N)
    del aa, bb
    y = torch.einsum("bcdn,bcn->bcd", hs, C_c)
    return y, hs[:, -1].clone()  # a view would keep the chunk's expansion


def _mamba1_chunk_scan(xc, dt, Bm, Cm, A, h0, chunk):
    """xc, dt: (B,S,di) f32; Bm, Cm: (B,S,N) f32; A: (di,N); h0: (B,di,N).
    Returns (y (B,S,di) f32, h_last).  One chunk's (B, cl, di, N)
    expansion lives at a time; under autograd each chunk is checkpointed,
    since its doubling scan would otherwise keep every level's expansions
    of every chunk alive for backward (the values are the same)."""
    B, S, di = xc.shape
    cl = min(chunk, S)
    pad = (-S) % cl
    if pad:  # dt=0 padding is a no-op on the state (a=1, b=0)
        xc, dt, Bm, Cm = (_pad_seq(t, pad) for t in (xc, dt, Bm, Cm))
    grad = torch.is_grad_enabled() and any(
        t.requires_grad for t in (xc, dt, Bm, Cm, A, h0))
    h, ys = h0, []
    for c0 in range(0, S + pad, cl):
        sl = slice(c0, c0 + cl)
        part = (dt[:, sl], xc[:, sl], Bm[:, sl], Cm[:, sl], A, h)
        y, h = checkpoint(_mamba1_chunk, *part, use_reentrant=False) \
            if grad else _mamba1_chunk(*part)
        ys.append(y)
    y = torch.cat(ys, dim=1)
    return y[:, :S], h


def mamba1(p, x, cfg, cache=None, policy=None):
    """x: (B, S, D). cache None -> full-seq (returns prefill cache);
    else single-token decode. Returns (out, new_cache).  On a mesh
    (``policy``) the blocks of the module docstring."""
    if on_mesh(policy):
        return _on_mesh(_mamba1_tp, mamba1, p, x, cfg, cache, policy)
    di = cfg.d_inner
    cd = x.dtype
    xz = x @ p["in_proj"].to(cd)
    y, new_cache = _mamba1_inner(p, xz[..., :di], xz[..., di:], cfg, cache)
    return y @ p["out_proj"].to(cd), new_cache


def _mamba1_inner(p, xi, z, cfg, cache, rows=None):
    """The block between its two projections, on the channels of ``xi``
    and ``z`` (B, S, di_loc) with ``p``'s leaves of them: (y (B, S,
    di_loc) before ``out_proj``, the new cache).  ``rows`` takes
    ``x_proj``'s product (the partial sums of a rank's channels under
    tensor parallelism) to the whole (dt_r | B | C)."""
    B, S, di = xi.shape
    N, cw = cfg.ssm_state, cfg.ssm_conv
    R = max(cfg.d_model // 16, 1)
    cd = xi.dtype

    if cache is None:
        xc = _causal_conv(xi, p["conv_w"], p["conv_b"])
        conv_tail = _conv_tail(xi, cw)
        h0 = torch.zeros((B, di, N), dtype=torch.float32, device=xi.device)
    else:
        xc, conv_tail = _conv_step(xi, cache.conv, p["conv_w"], p["conv_b"])
        h0 = cache.h
    xc = F.silu(xc)

    dbc = xc @ p["x_proj"].to(cd)
    if rows is not None:
        dbc = rows(dbc)
    dt_r, Bm, Cm = dbc[..., :R], dbc[..., R:R + N], dbc[..., R + N:]
    dt = F.softplus((dt_r @ p["dt_proj"].to(cd)).float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])

    xc32, Bm32, Cm32 = xc.float(), Bm.float(), Cm.float()
    if cache is None:
        y, h_last = _mamba1_chunk_scan(xc32, dt, Bm32, Cm32, A, h0,
                                       cfg.ssm_chunk)
    else:
        a = torch.exp(dt[:, 0, :, None] * A)                # (B,di,N)
        b = (dt[:, 0] * xc32[:, 0])[..., None] * Bm32[:, 0][:, None, :]
        h_last = a * h0 + b
        y = torch.einsum("bdn,bn->bd", h_last, Cm32[:, 0])[:, None, :]

    y = y + p["D_skip"] * xc32
    return y.to(cd) * F.silu(z), Mamba1Cache(conv=conv_tail, h=h_last)


# ---------------------------------------------------------------------------
# Mamba2 (SSD)
# ---------------------------------------------------------------------------

class Mamba2Cache(NamedTuple):
    conv: torch.Tensor   # (B, cw-1, di + 2N)
    h: torch.Tensor      # (B, H, hd, N) f32


def mamba2_heads(cfg):
    return cfg.d_inner // cfg.ssm_head_dim


def init_mamba2(cfg, generator, device=None):
    D, di, N, cw = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_conv
    H = mamba2_heads(cfg)
    return {
        "in_proj": dense_init(generator, (D, 2 * di + 2 * N + H),
                              device=device),
        "conv_w": torch.randn((di + 2 * N, cw), generator=generator,
                              dtype=torch.float32, device=device) * 0.2,
        "conv_b": torch.zeros((di + 2 * N,), dtype=torch.float32,
                              device=device),
        "dt_bias": _dt_init(generator, H, device),
        "A_log2": torch.log(torch.arange(1, H + 1, dtype=torch.float32,
                                         device=device)),
        "D_skip": torch.ones((H,), dtype=torch.float32, device=device),
        "norm_w": torch.ones((di,), dtype=torch.float32, device=device),
        "out_proj": dense_init(generator, (di, D), in_dim=di, device=device),
    }


def _ssd_chunk_scan(xh, la, dt, Bm, Cm, h0, chunk):
    """SSD: xh (B,S,H,hd) f32, la/dt (B,S,H) f32, Bm/Cm (B,S,N) f32,
    h0 (B,H,hd,N).  Returns (y (B,S,H,hd), h_last)."""
    B, S, H, hd = xh.shape
    cl = min(chunk, S)
    pad = (-S) % cl
    if pad:  # dt=0 padding is a no-op on the state
        xh, la, dt, Bm, Cm = (_pad_seq(t, pad) for t in (xh, la, dt, Bm, Cm))
    # the upper triangle is -inf before the exp: after it, inf * 0 = NaN
    upper = ~torch.tril(torch.ones((cl, cl), dtype=torch.bool,
                                   device=xh.device))
    h, ys = h0, []
    for c0 in range(0, S + pad, cl):
        sl = slice(c0, c0 + cl)
        x_c, dt_c, B_c, C_c = xh[:, sl], dt[:, sl], Bm[:, sl], Cm[:, sl]
        cum = torch.cumsum(la[:, sl], dim=1)                # (B,cl,H), <= 0
        cb = torch.einsum("btn,bsn->bts", C_c, B_c)         # (B,cl,cl)
        expo = cum[:, :, None, :] - cum[:, None, :, :]      # (B,t,s,H)
        expo = expo.masked_fill(upper[None, :, :, None], float("-inf"))
        w = cb[..., None] * torch.exp(expo) * dt_c[:, None, :, :]
        y_intra = torch.einsum("btsh,bshd->bthd", w, x_c)
        y_inter = torch.einsum("btn,bhdn->bthd", C_c, h) * \
            torch.exp(cum)[..., None]
        dec_end = torch.exp(cum[:, -1:, :] - cum)           # (B,cl,H)
        h_inc = torch.einsum("bshd,bsn->bhdn",
                             (dec_end * dt_c)[..., None] * x_c, B_c)
        h = torch.exp(cum[:, -1])[:, :, None, None] * h + h_inc
        ys.append(y_intra + y_inter)
    y = torch.cat(ys, dim=1)
    return y[:, :S], h


def mamba2(p, x, cfg, cache=None, policy=None):
    """Mamba2 block. x: (B, S, D) -> (out, new_cache).  On a mesh
    (``policy``) the blocks of the module docstring."""
    if on_mesh(policy):
        return _on_mesh(_mamba2_tp, mamba2, p, x, cfg, cache, policy)
    di, N = cfg.d_inner, cfg.ssm_state
    cd = x.dtype

    zxbcdt = x @ p["in_proj"].to(cd)
    z, xBC, dt_in = (zxbcdt[..., :di], zxbcdt[..., di:2 * di + 2 * N],
                     zxbcdt[..., 2 * di + 2 * N:])

    def split(c):
        return c[..., :di], c[..., di:di + N], c[..., di + N:]

    def norm(g):
        return rms_norm(g, p["norm_w"], cfg.norm_eps)
    y, new_cache = _mamba2_inner(p, z, xBC, dt_in, cfg, cache, split, norm)
    return y @ p["out_proj"].to(cd), new_cache


def _mamba2_inner(p, z, xBC, dt_in, cfg, cache, split, norm):
    """The block between its two projections: ``xBC`` the conv channels
    that ``p``'s ``conv_w`` / ``conv_b`` and the conv cache hold,
    ``split`` of their conv output -> (x of ``z``'s channels, the whole B,
    the whole C), ``dt_in`` and ``p``'s ``dt_bias`` / ``A_log2`` /
    ``D_skip`` on x's heads, ``norm`` the gated RMSNorm over d_inner of
    the f32 (B, S, di_loc) product.  Returns (y before ``out_proj``, the
    new cache)."""
    B, S, _ = z.shape
    N, cw, hd = cfg.ssm_state, cfg.ssm_conv, cfg.ssm_head_dim
    cd = z.dtype

    if cache is None:
        xBC_c = _causal_conv(xBC, p["conv_w"], p["conv_b"])
        conv_tail = _conv_tail(xBC, cw)
    else:
        xBC_c, conv_tail = _conv_step(xBC, cache.conv, p["conv_w"],
                                      p["conv_b"])
    xi, Bm, Cm = split(F.silu(xBC_c))
    di = xi.shape[-1]
    H = di // hd
    h0 = cache.h if cache is not None else torch.zeros(
        (B, H, hd, N), dtype=torch.float32, device=z.device)

    dt = F.softplus(dt_in.float() + p["dt_bias"])          # (B,S,H)
    A = -torch.exp(p["A_log2"])                             # (H,)
    la = dt * A

    xh = xi.float().reshape(B, S, H, hd)
    Bm32, Cm32 = Bm.float(), Cm.float()
    if cache is None:
        y, h_last = _ssd_chunk_scan(xh, la, dt, Bm32, Cm32, h0, cfg.ssm_chunk)
    else:
        a = torch.exp(la[:, 0])                             # (B,H)
        h_last = a[:, :, None, None] * h0 + torch.einsum(
            "bh,bn,bhd->bhdn", dt[:, 0], Bm32[:, 0], xh[:, 0])
        y = torch.einsum("bn,bhdn->bhd", Cm32[:, 0], h_last)[:, None]

    y = y + p["D_skip"][None, None, :, None] * xh
    y = y.reshape(B, S, di).to(cd)
    y = norm(y.float() * F.silu(z.float())).to(cd)
    return y, Mamba2Cache(conv=conv_tail, h=h_last)


# ---------------------------------------------------------------------------
# on a mesh
# ---------------------------------------------------------------------------

def _split(p, cfg, policy) -> bool:
    """Whether the block runs tensor-parallel: the policy splits over the
    model axis and every leaf of the rule table splits there (so do
    d_inner, Mamba2's heads and its conv channels)."""
    if cfg.ssm_version == 1:
        dims = ((p["in_proj"], 1), (p["conv_w"], 0), (p["x_proj"], 0),
                (p["dt_proj"], 1), (p["A_log"], 0), (p["dt_bias"], 0),
                (p["D_skip"], 0), (p["out_proj"], 0))
    else:
        dims = ((p["in_proj"], 1), (p["conv_w"], 0), (p["dt_bias"], 0),
                (p["D_skip"], 0), (p["out_proj"], 0))
    return split_over(policy, *dims)


def _cache_shapes(cfg, batch):
    """The global (conv, h) shapes of one layer's cache."""
    di, N, cw = cfg.d_inner, cfg.ssm_state, cfg.ssm_conv
    if cfg.ssm_version == 1:
        return (batch, cw - 1, di), (batch, di, N)
    return (batch, cw - 1, di + 2 * N), \
        (batch, mamba2_heads(cfg), cfg.ssm_head_dim, N)


def _layouts(cfg, policy, split):
    """(the cache specs (conv, h) the block computes in, the decode
    policy's): batch over the policy's batch axes and, when ``split``, the
    channels (Mamba1's d_inner, Mamba2's heads) over "model"."""
    conv, h = _cache_shapes(cfg, policy.global_batch)
    ba = policy.batch_axes
    be = ba if len(ba) > 1 else (ba[0] if ba else None)
    c = policy.model_axis if split else None
    comp = ((be, None, c), (be, c) + (None,) * (len(h) - 2))
    dec = policy.for_decode()
    kind = "h1" if cfg.ssm_version == 1 else "h2"
    return comp, (dec.ssm_cache_spec(conv, "conv"),
                  dec.ssm_cache_spec(h, kind))


def _relayout(cache, mesh, src, dst):
    return type(cache)(*(coll.reshard(t, mesh, a, b)
                         for t, a, b in zip(cache, src, dst)))


def decode_layout(p, cache, cfg, policy):
    """A prefill's cache (the layout the block computed it in) in the
    decode policy's layout."""
    comp, dec = _layouts(cfg, policy, _split(p, cfg, policy))
    return _relayout(cache, policy.mesh, comp, dec)


_IN_DTYPE = ("in_proj", "x_proj", "dt_proj", "out_proj")


def _on_mesh(tp_fn, one_fn, p, x, cfg, cache, policy):
    """A block on this rank's tokens: ``tp_fn`` under tensor parallelism,
    else ``one_fn`` on the weights gathered whole (the projections in the
    compute dtype, as one rank casts them); a decode cache is taken from
    the decode layout into the one the block computes in and back."""
    mesh, seq = policy.mesh, policy.seq_shard
    S = x.shape[1]
    if seq:
        x = coll.all_gather(x, mesh, seq, 1)
    split = _split(p, cfg, policy)
    comp, dec = _layouts(cfg, policy, split)
    if cache is not None:
        cache = _relayout(cache, mesh, dec, comp)
    if split:
        out, new = tp_fn(p, x, cfg, cache, policy)
    else:
        w = {k: weight(v, policy, dtype=x.dtype if k in _IN_DTYPE else None)
             for k, v in p.items()}
        out, new = one_fn(w, x, cfg, cache)
    if cache is not None:
        new = _relayout(new, mesh, comp, dec)
    if seq:
        out = out.narrow(1, mesh.index(seq) * S, S)
    return out, new


def _rank_slice(t, policy, size):
    """This rank's ``size`` entries of a leaf every rank holds whole: its
    block over "model" (the gradient summed over the axis's ranks)."""
    m = policy.model_axis
    j = policy.mesh.coords[m]
    return coll.replicate(t, policy.mesh, m).narrow(0, j * size, size)


def _mamba1_tp(p, x, cfg, cache, policy):
    mesh, m = policy.mesh, policy.model_axis
    di = cfg.d_inner
    dl = di // policy.model_size
    j = mesh.coords[m]
    cd = x.dtype
    keep = (m,)

    def w(k, dtype=None):
        return weight(p[k], policy, keep, dtype)

    x = coll.replicate(x, mesh, m)
    xz = coll.all_gather(x @ w("in_proj", cd), mesh, m, 2)
    q = {"conv_w": w("conv_w"), "conv_b": _rank_slice(p["conv_b"], policy, dl),
         "x_proj": w("x_proj", cd), "dt_proj": w("dt_proj", cd),
         "dt_bias": w("dt_bias"), "A_log": w("A_log"), "D_skip": w("D_skip")}

    def rows(dbc):       # the channels' partial sums, whole on every rank
        return coll.replicate(coll.all_reduce(dbc, mesh, m), mesh, m)
    y, new = _mamba1_inner(q, xz[..., j * dl:(j + 1) * dl],
                           xz[..., di + j * dl:di + (j + 1) * dl], cfg,
                           cache, rows)
    return coll.all_reduce(y @ w("out_proj", cd), mesh, m), new


def _mamba2_tp(p, x, cfg, cache, policy):
    mesh, m, n = policy.mesh, policy.model_axis, policy.model_size
    di, N = cfg.d_inner, cfg.ssm_state
    H = mamba2_heads(cfg)
    dl, hl, cl = di // n, H // n, (di + 2 * N) // n
    j = mesh.coords[m]
    cd = x.dtype
    keep = (m,)

    def w(k, dtype=None):
        return weight(p[k], policy, keep, dtype)

    x = coll.replicate(x, mesh, m)
    zx = coll.all_gather(x @ w("in_proj", cd), mesh, m, 2)
    z = zx[..., j * dl:(j + 1) * dl]
    xBC = zx[..., di + j * cl:di + (j + 1) * cl]
    dt_in = zx[..., 2 * di + 2 * N + j * hl:2 * di + 2 * N + (j + 1) * hl]
    q = {"conv_w": w("conv_w"), "conv_b": _rank_slice(p["conv_b"], policy, cl),
         "dt_bias": w("dt_bias"), "A_log2": _rank_slice(p["A_log2"], policy,
                                                        hl),
         "D_skip": w("D_skip")}
    norm_w = _rank_slice(p["norm_w"], policy, dl)

    def split(c):        # the conv's channel blocks -> x on this rank's heads
        c = coll.all_gather(c, mesh, m, 2)
        return c[..., j * dl:(j + 1) * dl], c[..., di:di + N], c[..., di + N:]

    def norm(g):         # RMSNorm over d_inner: the squares' sum over "model"
        ss = coll.all_reduce(torch.sum(g * g, dim=-1, keepdim=True), mesh, m)
        var = coll.replicate(ss, mesh, m) / di
        return g * torch.rsqrt(var + cfg.norm_eps) * norm_w.float()
    y, new = _mamba2_inner(q, z, xBC, dt_in, cfg, cache, split, norm)
    return coll.all_reduce(y @ w("out_proj", cd), mesh, m), new


def init_ssm_cache(cfg, batch, dtype=torch.bfloat16, device=None):
    """Empty SSM caches: the conv window in ``dtype``, the state in f32."""
    di, N, cw = cfg.d_inner, cfg.ssm_state, cfg.ssm_conv
    if cfg.ssm_version == 1:
        return Mamba1Cache(
            conv=torch.zeros((batch, cw - 1, di), dtype=dtype, device=device),
            h=torch.zeros((batch, di, N), dtype=torch.float32, device=device))
    H, hd = mamba2_heads(cfg), cfg.ssm_head_dim
    return Mamba2Cache(
        conv=torch.zeros((batch, cw - 1, di + 2 * N), dtype=dtype,
                         device=device),
        h=torch.zeros((batch, H, hd, N), dtype=torch.float32, device=device))
