"""The port's ``Model`` (prefill, decode_step, encode) against the JAX
package's, on the CPU at reduced sizes (2 layers, d_model 128, vocab 512).

Parameters are drawn with numpy into the JAX package's tree (its shapes from
``jax.eval_shape`` of its init) and carried into the port with
``interop.lm_params``; prompts, image embeddings and frames are numpy draws
too.  The JAX side runs on a mesh with Auto axes (with the Explicit axes
that ``jax.make_mesh`` gives by default under JAX 0.9, its prefill raises a
sharding type error), one jitted program per architecture and compute
dtype: prefill over S tokens, then one decode step at position S.

Bars: f32 compute on both sides (the JAX side's compute dtype patched, as
its own model test does for the SSM archs), logits and caches within
rtol = atol = 1e-4; bf16 compute, within 0.08 with argmax agreement >= 0.95
(the JAX package's decode-vs-prefill bar); ``slot_pos`` equal exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AxisType

import repro.models.transformer as JT
from repro.configs.base import get_config as jget_config
from repro.models import layers as JL
from repro.models.model import build_model as jbuild_model
from repro.models.sharding import make_policy as jmake_policy
from repro_torch import interop
from repro_torch.configs.base import get_config
from repro_torch.models.model import build_model

torch.set_num_threads(2)
jax.config.update("jax_platform_name", "cpu")

B, S = 2, 32
#: (arch, prompt positions S); danube's window is 64 at the reduced size,
#: so its 96-position prompt leaves a ring that has wrapped
ARCHS = {"qwen3-1.7b": 32, "granite-3-2b": 32, "h2o-danube-1.8b": 96,
         "internvl2-26b": 32}
DTYPES = {"f32": (jnp.float32, torch.float32, 1e-4),
          "bf16": (jnp.bfloat16, torch.bfloat16, 0.08)}


def mesh():
    return jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto, AxisType.Auto))


def numpy_params(cfg, seed):
    """A parameter tree of the JAX package's structure, drawn with numpy:
    tables N(0, 0.02^2), matrices N(0, 1/fan_in), norms 1 + N(0, 0.1^2)."""
    shapes = jax.eval_shape(jbuild_model(cfg).init, jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)

    def draw(path, s):
        name = str(getattr(path[-1], "key", path[-1]))
        if name == "table":
            a = 0.02 * rng.normal(size=s.shape)
        elif name in ("ln1", "ln2", "q_norm", "k_norm", "final_norm"):
            a = 1 + 0.1 * rng.normal(size=s.shape)
        else:
            a = rng.normal(size=s.shape) / np.sqrt(s.shape[-2])
        return a.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def numpy_batch(cfg, n, seed):
    """(B, n) positions of input: tokens, and for the vlm its image prefix
    (bf16), or frames (bf16) for an encoder."""
    rng = np.random.default_rng(seed)
    if cfg.frontend_stub and cfg.family != "vlm":
        x = rng.normal(size=(B, n, cfg.d_model)).astype(np.float32)
        return {"frames": np.asarray(jnp.asarray(x, jnp.bfloat16))}
    n_img = cfg.num_image_tokens if cfg.family == "vlm" else 0
    out = {"tokens": rng.integers(0, cfg.vocab_size,
                                  size=(B, n + 1 - n_img)).astype(np.int32)}
    if n_img:
        img = 0.02 * rng.normal(size=(B, n_img, cfg.d_model))
        out["image_embeds"] = np.asarray(jnp.asarray(img, jnp.bfloat16))
    return out


def _compute_dtype(dtype):
    """The JAX package's compute dtype, set for the duration of a trace."""
    mp = pytest.MonkeyPatch()
    for mod in (JL, JT):
        mp.setattr(mod, "COMPUTE_DTYPE", dtype)
    return mp


@pytest.fixture(scope="module")
def jax_runs():
    """JAX results by (arch, dtype), each computed once: one jitted
    program of prefill + one decode step."""
    cache = {}

    def get(name, dtype):
        if (name, dtype) not in cache:
            cache[(name, dtype)] = _jax_run(name, dtype)
        return cache[(name, dtype)]
    return get


def _jax_run(name, dtype):
    cfg = jget_config(name).reduced()
    n = ARCHS[name]
    params = numpy_params(cfg, 0)
    data = numpy_batch(cfg, n, 1)
    toks = data.pop("tokens")
    n_img = cfg.num_image_tokens if cfg.family == "vlm" else 0
    m, policy = jbuild_model(cfg), jmake_policy(mesh(), B, "train")

    def run(p, batch, tok, pos):
        lp, caches = m.prefill(p, batch, policy, cache_len=n + 8)
        ld, new = m.decode_step(p, caches, tok, pos, policy)
        return lp, caches, ld, new

    mp = _compute_dtype(DTYPES[dtype][0])
    try:
        with mesh():
            out = jax.jit(run)(params, dict(data, tokens=toks[:, :n - n_img]),
                               toks[:, n - n_img:], np.full((B, 1), n,
                                                            np.int32))
            out = jax.tree.map(np.asarray, out)
    finally:
        mp.undo()
    return params, data, toks, out


def _port(name, dtype, params):
    cfg = get_config(name).reduced()
    return cfg, interop.lm_params(params, cfg, dtype=DTYPES[dtype][1])


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def _argmax_agree(got, want):
    a = got.float().numpy().argmax(-1)
    b = np.asarray(want, np.float32).argmax(-1)
    return float((a == b).mean())


def _caches_close(got, want, tol):
    assert len(got["sub"]) == len(want["sub"])
    for g, w in zip(got["sub"], want["sub"]):
        _close(g.k, w.k, tol)
        _close(g.v, w.v, tol)
        np.testing.assert_array_equal(g.slot_pos.numpy(),
                                      np.asarray(w.slot_pos))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("name", list(ARCHS))
def test_prefill_matches_jax(name, dtype, jax_runs):
    params, data, toks, (lp, caches, _, _) = jax_runs(name, dtype)
    cfg, model = _port(name, dtype, params)
    n = ARCHS[name]
    n_img = cfg.num_image_tokens if cfg.family == "vlm" else 0
    batch = {k: interop.tensor(v) for k, v in data.items()}
    batch["tokens"] = interop.tensor(toks[:, :n - n_img])
    got, got_caches = model.prefill(batch, cache_len=n + 8)
    tol = DTYPES[dtype][2]
    assert got.shape == (B, 1, cfg.padded_vocab)
    _close(got, lp, tol)
    _caches_close(got_caches, caches, tol)
    if dtype == "bf16":
        assert _argmax_agree(got, lp) >= 0.95
    if cfg.padded_vocab != cfg.vocab_size:
        assert float(got[..., cfg.vocab_size:].max()) == -1e30


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("name", list(ARCHS))
def test_decode_step_matches_jax(name, dtype, jax_runs):
    """One decode step at position S from the JAX prefill's caches, carried
    across with ``interop.lm_caches``."""
    params, _, toks, (_, caches, ld, new) = jax_runs(name, dtype)
    cfg, model = _port(name, dtype, params)
    n = ARCHS[name]
    n_img = cfg.num_image_tokens if cfg.family == "vlm" else 0
    got, got_new = model.decode_step(
        interop.lm_caches(caches), interop.tensor(toks[:, n - n_img:]),
        torch.full((B, 1), n, dtype=torch.int32))
    tol = DTYPES[dtype][2]
    _close(got, ld, tol)
    _caches_close(got_new, new, tol)
    if dtype == "bf16":
        assert _argmax_agree(got, ld) >= 0.95
    if name == "h2o-danube-1.8b":   # the ring wrapped: slot n % 64 now
        C = got_new["sub"][0].k.shape[-3]   # holds position n
        assert C == 64 < n
        assert int(got_new["sub"][0].slot_pos[0, n % C]) == n


@pytest.mark.parametrize("name", list(ARCHS))
def test_decode_matches_prefill_over_s_plus_1(name):
    """In the port alone, bf16: prefill over S positions then a decode step
    at S gives the logits of a prefill over S + 1 positions (the JAX
    package's test_decode_matches_prefill bar)."""
    cfg = get_config(name).reduced()
    model = build_model(cfg, torch.Generator().manual_seed(3), "cpu")
    n = ARCHS[name]
    n_img = cfg.num_image_tokens if cfg.family == "vlm" else 0
    data = {k: interop.tensor(v) for k, v in numpy_batch(cfg, n, 4).items()}
    toks = data.pop("tokens")
    _, caches = model.prefill(dict(data, tokens=toks[:, :n - n_img]),
                              cache_len=n + 8)
    dec, _ = model.decode_step(caches, toks[:, n - n_img:],
                               torch.full((B, 1), n, dtype=torch.int32))
    ref, _ = model.prefill(dict(data, tokens=toks))
    _close(dec, ref.float().numpy(), 0.08)
    assert _argmax_agree(dec, ref.float().numpy()) >= 0.95


@pytest.fixture(scope="module")
def hubert_runs():
    """hubert-xlarge's encode in JAX at f32 and bf16 compute (one program
    each) on the same numpy frames and parameters."""
    cfg = jget_config("hubert-xlarge").reduced()
    params = numpy_params(cfg, 5)
    frames = numpy_batch(cfg, 16, 6)
    m, policy = jbuild_model(cfg), jmake_policy(mesh(), B, "train")
    out = {}
    for dtype in DTYPES:
        mp = _compute_dtype(DTYPES[dtype][0])
        try:
            with mesh():
                out[dtype] = np.asarray(jax.jit(
                    lambda p, b: m.encode(p, b, policy))(params, frames))
        finally:
            mp.undo()
    return params, frames, out


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_encode_matches_jax(dtype, hubert_runs):
    params, frames, out = hubert_runs
    cfg, model = _port("hubert-xlarge", dtype, params)
    got = model.encode({"frames": interop.tensor(frames["frames"])})
    assert got.shape == (B, 16, cfg.padded_vocab)
    _close(got, out[dtype], DTYPES[dtype][2])
    if dtype == "f32":
        assert _argmax_agree(got, out[dtype]) == 1.0
        return
    # 32 frames of 504 random logits each hold near-ties: top-2 values one
    # bf16 ulp apart, which bf16 rounding upstream may order either way.
    # Every frame whose argmax differs must be such a tie, and the frames
    # whose reference top-2 gap is wider than two ulps must agree >= 0.95.
    a = got.float().numpy().argmax(-1)
    want = np.asarray(out[dtype], np.float32)
    top2 = np.sort(want, -1)[..., -2:]
    ulp = 2.0 ** (np.floor(np.log2(np.abs(top2[..., 1]))) - 7)
    tie = top2[..., 1] - top2[..., 0] <= 2 * ulp
    same = a == want.argmax(-1)
    assert bool((same | tie).all()), (same.mean(), tie.mean())
    assert same[~tie].mean() >= 0.95, (same.mean(), tie.mean())


def test_encoder_has_no_causal_mask():
    """Changing a late frame changes early logits (bidirectional), and an
    encoder has no decode step."""
    cfg = get_config("hubert-xlarge").reduced()
    model = build_model(cfg, torch.Generator().manual_seed(7), "cpu")
    frames = torch.randn((B, 16, cfg.d_model),
                         generator=torch.Generator().manual_seed(8))
    lg = model.encode({"frames": frames})
    frames2 = frames.clone()
    frames2[:, -1] += 1.0
    lg2 = model.encode({"frames": frames2})
    assert not torch.allclose(lg[:, 0], lg2[:, 0])
    with pytest.raises(ValueError, match="encoder-only"):
        model.decode_step(model.init_caches(B, 8),
                          torch.zeros((B, 1), dtype=torch.int32),
                          torch.zeros((B, 1), dtype=torch.int32))


@pytest.mark.parametrize("name", ["qwen2-moe-a2.7b", "falcon-mamba-7b",
                                  "zamba2-2.7b"])
def test_unported_families_raise(name):
    cfg = get_config(name).reduced()
    with pytest.raises(NotImplementedError, match="moe.py"):
        build_model(cfg, torch.Generator().manual_seed(0), "cpu")


def test_init_caches_match_jax_shapes():
    """The port's empty caches have the JAX package's tree, shapes and
    dtypes (bf16 K/V, int32 slot_pos, -1 everywhere), the window clamp
    included."""
    for name in ARCHS:
        cfg = get_config(name).reduced()
        jcfg = jget_config(name).reduced()
        want = jax.eval_shape(lambda: JT.init_caches(jcfg, B, 100))
        got = build_model(cfg, torch.Generator().manual_seed(0),
                          "cpu").init_caches(B, 100)
        assert len(got["sub"]) == len(want["sub"])
        for g, w in zip(got["sub"], want["sub"]):
            for gl, wl in zip(g, w):
                assert tuple(gl.shape) == tuple(wl.shape)
                assert str(gl.dtype).split(".")[-1] == str(wl.dtype)
            assert bool((g.slot_pos == -1).all())
