"""The port's LM layers (``repro_torch.models.layers``) against the JAX
package's (``repro.models.layers``) on the CPU, in f32.

The same numpy inputs go through both; outputs agree within 2e-5 (sums in
another order), cache copies and ``slot_pos`` exactly.  The JAX side runs
eagerly with its compute dtype set to f32, as its own test of the SSM
models does.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget_config
from repro.models import layers as JL
from repro_torch import interop
from repro_torch.configs.base import get_config
from repro_torch.models import layers as TL

torch.set_num_threads(2)
jax.config.update("jax_platform_name", "cpu")

TOL = dict(rtol=2e-5, atol=2e-5)


@pytest.fixture(autouse=True)
def _f32_compute(monkeypatch):
    monkeypatch.setattr(JL, "COMPUTE_DTYPE", jnp.float32)


def _t(a):
    return interop.tensor(np.asarray(a))


def _close(got, want, **tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **(tol or TOL))


def test_rms_norm_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 64)).astype(np.float32) * 3
    w = (1 + 0.1 * rng.normal(size=64)).astype(np.float32)
    _close(TL.rms_norm(_t(x), _t(w), 1e-6), JL.rms_norm(x, w, 1e-6))


@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_rope_matches_jax(theta):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 7, 3, 32)).astype(np.float32)
    pos = rng.integers(0, 5000, size=(2, 7)).astype(np.int32)
    _close(TL.rope(_t(x), _t(pos), theta), JL.rope(x, pos, theta))


@pytest.mark.parametrize("q_block", [0, 32])
@pytest.mark.parametrize("window,chunk", [(0, 0), (24, 0), (0, 32)])
def test_blockwise_attention_matches_jax(window, chunk, q_block):
    """96 keys in blocks of 40: the last block is padded (pos -1); with
    q_block 32 the queries run in three blocks."""
    rng = np.random.default_rng(2)
    B, S, KV, G, hd = 2, 96, 2, 3, 16
    q = rng.normal(size=(B, S, KV, G, hd)).astype(np.float32)
    k = rng.normal(size=(B, S, KV, hd)).astype(np.float32)
    v = rng.normal(size=(B, S, KV, hd)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    kw = dict(causal=True, window=window, chunk=chunk, kv_block=40,
              q_block=q_block)
    got = TL.blockwise_attention(_t(q), _t(k), _t(v), _t(pos), _t(pos), **kw)
    want = JL.blockwise_attention(q, k, v, pos, pos, **kw)
    _close(got, want)


def test_blockwise_attention_rows_with_no_key():
    """Ring slots not yet written (pos -1) and a query row that sees none
    of the keys: the guard keeps such rows finite (zero), as in JAX."""
    rng = np.random.default_rng(3)
    B, S, KV, G, hd = 1, 8, 1, 2, 8
    q = rng.normal(size=(B, S, KV, G, hd)).astype(np.float32)
    k = rng.normal(size=(B, S, KV, hd)).astype(np.float32)
    v = rng.normal(size=(B, S, KV, hd)).astype(np.float32)
    pos_q = np.arange(S, dtype=np.int32)[None]
    pos_kv = np.array([[-1, -1, 3, 4, 5, -1, 6, 7]], np.int32)
    kw = dict(causal=True, window=0, chunk=0, kv_block=3)
    got = TL.blockwise_attention(_t(q), _t(k), _t(v), _t(pos_q), _t(pos_kv),
                                 **kw)
    want = JL.blockwise_attention(q, k, v, pos_q, pos_kv, **kw)
    assert torch.isfinite(got).all()
    assert float(got[0, :3].abs().max()) == 0.0
    _close(got, want)


def _attn_params(cfg, seed):
    """f32 attention weights drawn with numpy, and their JAX twin."""
    rng = np.random.default_rng(seed)
    D, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    p = {"wq": rng.normal(size=(D, H * hd)) / np.sqrt(D),
         "wk": rng.normal(size=(D, KV * hd)) / np.sqrt(D),
         "wv": rng.normal(size=(D, KV * hd)) / np.sqrt(D),
         "wo": rng.normal(size=(H * hd, D)) / np.sqrt(H * hd)}
    if cfg.qk_norm:
        p["q_norm"] = 1 + 0.1 * rng.normal(size=hd)
        p["k_norm"] = 1 + 0.1 * rng.normal(size=hd)
    p = {k: v.astype(np.float32) for k, v in p.items()}
    return p, {k: _t(v) for k, v in p.items()}


@pytest.mark.parametrize("name,S,cache_len", [
    ("qwen3-1.7b", 32, 40),        # C >= S: the prompt at slots 0..S-1
    ("h2o-danube-1.8b", 96, 104),  # window 64 < S: the last 64 positions
])
def test_prefill_to_cache_matches_jax(name, S, cache_len):
    jcfg, cfg = jget_config(name).reduced(), get_config(name).reduced()
    rng = np.random.default_rng(4)
    B, KV, hd = 2, cfg.n_kv_heads, cfg.head_dim_
    k = rng.normal(size=(B, S, KV, hd)).astype(np.float32)
    v = rng.normal(size=(B, S, KV, hd)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    got = TL.prefill_to_cache(cfg, _t(k), _t(v), _t(pos), cache_len)
    want = JL.prefill_to_cache(jcfg, jnp.asarray(k), jnp.asarray(v),
                               jnp.asarray(pos), cache_len)
    C = min(cache_len, cfg.sliding_window or cache_len)
    assert got.k.shape == (B, C, KV, hd)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert (C >= S) == (int((got.slot_pos >= 0).sum()) == S)


@pytest.mark.parametrize("name,S,cache_len", [
    ("qwen3-1.7b", 32, 40),
    ("h2o-danube-1.8b", 96, 104),  # the decode slot wraps to 96 % 64 = 32
])
def test_attention_prefill_and_decode_match_jax(name, S, cache_len):
    """The full-sequence path of ``attention`` and one decode step into the
    cache that prefill_to_cache made of its K/V, at position S."""
    jcfg = dataclasses.replace(jget_config(name).reduced(), kv_block=32)
    cfg = dataclasses.replace(get_config(name).reduced(), kv_block=32)
    p_np, p_t = _attn_params(cfg, 5)
    rng = np.random.default_rng(6)
    B, D = 2, cfg.d_model
    x = rng.normal(size=(B, S, D)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    out_t, (k_t, v_t) = TL.attention(p_t, _t(x), _t(pos), cfg)
    out_j, (k_j, v_j) = JL.attention(p_np, jnp.asarray(x), jnp.asarray(pos),
                                     jcfg)
    _close(out_t, out_j)
    _close(k_t, k_j)
    _close(v_t, v_j)

    cache_t = TL.prefill_to_cache(cfg, k_t, v_t, _t(pos), cache_len)
    cache_j = JL.prefill_to_cache(jcfg, k_j, v_j, jnp.asarray(pos),
                                  cache_len)
    x1 = rng.normal(size=(B, 1, D)).astype(np.float32)
    pos1 = np.full((B, 1), S, np.int32)
    dec_t, new_t = TL.attention(p_t, _t(x1), _t(pos1), cfg, cache=cache_t)
    dec_j, new_j = JL.attention(p_np, jnp.asarray(x1), jnp.asarray(pos1),
                                jcfg, cache=cache_j)
    _close(dec_t, dec_j)
    _close(new_t.k, new_j.k)
    _close(new_t.v, new_j.v)
    np.testing.assert_array_equal(new_t.slot_pos.numpy(),
                                  np.asarray(new_j.slot_pos))
    slot = S % new_t.k.shape[1]
    assert int(new_t.slot_pos[slot]) == S
    assert int(cache_t.slot_pos[slot]) == (S - new_t.k.shape[1]
                                           if S >= new_t.k.shape[1] else -1)


def test_mlp_and_embed_match_jax():
    rng = np.random.default_rng(7)
    D, Fd, V = 16, 40, 50
    p = {"wg": rng.normal(size=(D, Fd)), "wu": rng.normal(size=(D, Fd)),
         "wd": rng.normal(size=(Fd, D))}
    p = {k: (v / np.sqrt(v.shape[0])).astype(np.float32)
         for k, v in p.items()}
    x = rng.normal(size=(2, 3, D)).astype(np.float32)
    _close(TL.mlp({k: _t(v) for k, v in p.items()}, _t(x)), JL.mlp(p, x))
    table = rng.normal(size=(V, D)).astype(np.float32)
    toks = rng.integers(0, V, size=(2, 5)).astype(np.int32)
    np.testing.assert_array_equal(
        TL.embed({"table": _t(table)}, _t(toks), torch.float32).numpy(),
        np.asarray(JL.embed({"table": table}, toks)))
