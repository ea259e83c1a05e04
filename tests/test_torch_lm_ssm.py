"""The port's Mamba1 and Mamba2 blocks (``repro_torch.models.ssm``) against
the JAX package's ``repro.models.ssm``, on the CPU at the reduced sizes of
falcon-mamba-7b (Mamba1: d_inner 256, N 16) and zamba2-2.7b (Mamba2: 8
heads of 32, N 16), chunk 32.

Parameters are the JAX init's (its dt, A and D leaves, asymmetric random
conv taps); inputs are numpy draws.  Bars: f32 compute within rtol = atol
= 1e-4, cache leaves included; bf16 within 0.08.  Prompt lengths cover a
prompt shorter than the conv window (S = 2 < cw - 1), one chunk that is not
a power of two (20), exactly one chunk (32) and a padded tail (70).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget_config
from repro.models import ssm as JS
from repro_torch import interop
from repro_torch.configs.base import get_config
from repro_torch.models import ssm as TS

torch.set_num_threads(2)
jax.config.update("jax_platform_name", "cpu")

ARCH = {1: "falcon-mamba-7b", 2: "zamba2-2.7b"}
DTYPES = {"f32": (jnp.float32, torch.float32, 1e-4),
          "bf16": (jnp.bfloat16, torch.bfloat16, 0.08)}
B = 2


def _cfgs(version):
    return (jget_config(ARCH[version]).reduced(),
            get_config(ARCH[version]).reduced())


def _fns(version):
    if version == 1:
        return JS.mamba1, TS.mamba1
    return JS.mamba2, TS.mamba2


@pytest.fixture(scope="module")
def params():
    """The JAX init's parameters of each version, as numpy."""
    out = {}
    for version in ARCH:
        jcfg, _ = _cfgs(version)
        init = JS.init_mamba1 if version == 1 else JS.init_mamba2
        out[version] = jax.tree.map(np.asarray,
                                    init(jax.random.PRNGKey(version), jcfg))
    return out


def _inputs(jcfg, S, dtype, seed):
    x = np.random.default_rng(seed).normal(size=(B, S, jcfg.d_model))
    return np.asarray(jnp.asarray(x, DTYPES[dtype][0]))


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def _port_params(p):
    return {k: interop.tensor(v) for k, v in p.items()}


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("S", [2, 20, 32, 70])
@pytest.mark.parametrize("version", list(ARCH))
def test_prefill_and_decode_match_jax(version, S, dtype, params):
    """Prefill over S positions (out and the cache it leaves), then one
    decode step from the JAX prefill's cache."""
    jcfg, cfg = _cfgs(version)
    jfn, tfn = _fns(version)
    p = params[version]
    x = _inputs(jcfg, S, dtype, S)
    xt = _inputs(jcfg, 1, dtype, S + 1)

    def run(p, x, xt):
        y, cache = jfn(p, x, jcfg)
        y2, cache2 = jfn(p, xt, jcfg, cache)
        return y, cache, y2, cache2

    y, cache, y2, cache2 = jax.tree.map(np.asarray,
                                        jax.jit(run)(p, x, xt))
    tol = DTYPES[dtype][2]
    tp = _port_params(p)
    got, got_cache = tfn(tp, interop.tensor(x), cfg)
    assert got.dtype == DTYPES[dtype][1] and got.shape == (B, S, cfg.d_model)
    _close(got, y, tol)
    assert type(got_cache).__name__ == type(cache).__name__
    for g, w in zip(got_cache, cache):
        assert tuple(g.shape) == w.shape
        _close(g, w, tol)
    assert got_cache.h.dtype == torch.float32
    if S < cfg.ssm_conv - 1:  # the conv tail is left-padded with zeros
        assert bool((got_cache.conv[:, :cfg.ssm_conv - 1 - S] == 0).all())
    jcache = type(got_cache)(*(interop.tensor(t) for t in cache))
    got2, got_cache2 = tfn(tp, interop.tensor(xt), cfg, jcache)
    _close(got2, y2, tol)
    for g, w in zip(got_cache2, cache2):
        _close(g, w, tol)


@pytest.mark.parametrize("version", list(ARCH))
def test_chunked_prefill_matches_stepwise_decode(version, params):
    """In the port alone, f32: a prefill over 70 positions (three chunks,
    the last one padded) gives the outputs and state of 70 decode steps
    from the empty cache."""
    jcfg, cfg = _cfgs(version)
    _, tfn = _fns(version)
    tp = _port_params(params[version])
    S = 70
    x = interop.tensor(_inputs(jcfg, S, "f32", 7))
    y_full, cache_full = tfn(tp, x, cfg)
    cache = TS.init_ssm_cache(cfg, B, torch.float32)
    ys = []
    for t in range(S):
        y_t, cache = tfn(tp, x[:, t:t + 1], cfg, cache)
        ys.append(y_t)
    _close(torch.cat(ys, 1), y_full.numpy(), 1e-4)
    _close(cache.h, cache_full.h.numpy(), 1e-4)
    _close(cache.conv, cache_full.conv.numpy(), 1e-4)


def test_causal_conv_taps_match_jax():
    """Asymmetric taps (1, 10, 100, 1000 by channel scale) on random input:
    the port's conv1d is the JAX cross-correlation, the last tap on the
    current token, and the one-token step gives the prefill's positions."""
    rng = np.random.default_rng(3)
    C, cw, S = 6, 4, 9
    w = (np.array([1.0, 10.0, 100.0, 1000.0])[None, :]
         * (1 + np.arange(C))[:, None]).astype(np.float32)
    b = rng.normal(size=(C,)).astype(np.float32)
    x = rng.normal(size=(B, S, C)).astype(np.float32)
    want = np.asarray(JS._causal_conv(jnp.asarray(x), jnp.asarray(w),
                                      jnp.asarray(b)))
    got = TS._causal_conv(interop.tensor(x), interop.tensor(w),
                          interop.tensor(b))
    _close(got, want, 1e-5)
    # out[t] = sum_j x[t - 3 + j] * w[:, j] + b, by hand
    t = 5
    by_hand = sum(x[:, t - 3 + j] * w[:, j] for j in range(cw)) + b
    np.testing.assert_allclose(got[:, t].numpy(), by_hand, rtol=1e-5)
    # the step from a zero window, token by token, gives every position
    state = torch.zeros((B, cw - 1, C))
    for t in range(S):
        out, state = TS._conv_step(interop.tensor(x[:, t:t + 1]), state,
                                   interop.tensor(w), interop.tensor(b))
        np.testing.assert_allclose(out[:, 0].numpy(), want[:, t], rtol=1e-5,
                                   atol=1e-3)


@pytest.mark.parametrize("n", [1, 2, 3, 7, 20, 32, 33])
def test_doubling_scan_matches_the_recurrence(n):
    """The doubling scan's (prod a, h from zero) against the loop
    h_t = a_t * h_{t-1} + b_t, in f64."""
    g = torch.Generator().manual_seed(n)
    a = torch.rand((2, n, 3, 4), generator=g, dtype=torch.float64)
    b = torch.randn((2, n, 3, 4), generator=g, dtype=torch.float64)
    aa, bb = TS._doubling_scan(a, b)
    h, p = torch.zeros_like(a[:, 0]), torch.ones_like(a[:, 0])
    for t in range(n):
        h = a[:, t] * h + b[:, t]
        p = p * a[:, t]
        assert torch.allclose(bb[:, t], h, rtol=1e-12, atol=1e-12)
        assert torch.allclose(aa[:, t], p, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("version", list(ARCH))
def test_cache_leaves_match_jax(version):
    """init_ssm_cache: the JAX package's type, field order, shapes and
    dtypes (bf16 conv window, f32 state)."""
    jcfg, cfg = _cfgs(version)
    want = jax.eval_shape(lambda: JS.init_ssm_cache(jcfg, B))
    got = TS.init_ssm_cache(cfg, B)
    assert type(got).__name__ == type(want).__name__
    assert type(got)._fields == type(want)._fields == ("conv", "h")
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        assert str(g.dtype).split(".")[-1] == str(w.dtype)
        assert not bool(g.any())


@pytest.mark.parametrize("version", list(ARCH))
def test_init_draws_the_jax_distributions(version):
    """The port's init: dt log-uniform in [1e-3, 0.1] (dt_bias its softplus
    inverse), A_log = log(1..N) by channel (A_log2 = log(1..H)), D = 1,
    conv bias 0, conv taps 0.2 N(0, 1), the JAX package's leaf names and
    shapes."""
    jcfg, cfg = _cfgs(version)
    init = TS.init_mamba1 if version == 1 else TS.init_mamba2
    jinit = JS.init_mamba1 if version == 1 else JS.init_mamba2
    p = init(cfg, torch.Generator().manual_seed(0))
    want = jax.eval_shape(lambda: jinit(jax.random.PRNGKey(0), jcfg))
    assert set(p) == set(want)
    for k, v in p.items():
        assert tuple(v.shape) == want[k].shape and v.dtype == torch.float32
    dt = torch.nn.functional.softplus(p["dt_bias"])
    assert float(dt.min()) >= 1e-3 * (1 - 1e-5)
    assert float(dt.max()) <= 0.1 * (1 + 1e-5)
    N = cfg.ssm_state
    if version == 1:
        assert torch.allclose(p["A_log"], torch.log(
            torch.arange(1, N + 1, dtype=torch.float32)).expand(
                cfg.d_inner, N))
    else:
        H = TS.mamba2_heads(cfg)
        assert torch.allclose(p["A_log2"], torch.log(
            torch.arange(1, H + 1, dtype=torch.float32)))
        assert bool((p["norm_w"] == 1).all())
    assert bool((p["D_skip"] == 1).all()) and not bool(p["conv_b"].any())
    assert 0.15 < float(p["conv_w"].std()) < 0.25
