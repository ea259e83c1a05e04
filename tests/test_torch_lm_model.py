"""The port's ``Model`` (prefill, decode_step, encode) against the JAX
package's, on the CPU at reduced sizes (d_model 128, vocab 512; 2 layers,
llama4 one group of 4, zamba2 two groups of 6 Mamba2 layers + the shared
block).

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
(the JAX package's decode-vs-prefill bar; for the SSM and hybrid archs
over the rows whose top-2 gap exceeds 0.08, as chip_smoke's bf16 checks
count it); ``slot_pos`` equal exactly.  The hybrid family in bf16 holds
>= 99 % of each leaf's elements to the 0.08 bar and all to twice it (see
``HYBRID_BF16_SHARE``).  The MoE archs run at their configured capacity;
every routing decision of the two packages is recorded and the count that
differs is printed: none in f32, and in bf16 only near-ties, after which
the values are compared on the JAX package's routing (``_port_routed``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AxisType

import repro.models.transformer as JT
from repro.configs.base import get_config as jget_config
from repro.models import layers as JL
from repro.models import moe as JM
from repro.models.model import build_model as jbuild_model
from repro.models.sharding import make_policy as jmake_policy
from repro_torch import interop
from repro_torch.configs.base import get_config
from repro_torch.models import moe as TM
from repro_torch.models.model import build_model

torch.set_num_threads(2)
jax.config.update("jax_platform_name", "cpu")

B, S = 2, 32
#: (arch, prompt positions S); danube's window and llama4's attention chunk
#: are 64 at the reduced size, so their 96-position prompts leave rings that
#: have wrapped; 40 is not a multiple of the SSM chunk (32): the pad branch
ARCHS = {"qwen3-1.7b": 32, "granite-3-2b": 32, "h2o-danube-1.8b": 96,
         "internvl2-26b": 32, "qwen2-moe-a2.7b": 32,
         "llama4-scout-17b-a16e": 96, "falcon-mamba-7b": 40,
         "zamba2-2.7b": 40}
#: the SSM leaves taken from the JAX init's own values (dt, A, D, biases
#: and norms), not from numpy draws
SSM_INIT = ("A_log", "A_log2", "dt_bias", "D_skip", "conv_b", "norm_w")
DTYPES = {"f32": (jnp.float32, torch.float32, 1e-4),
          "bf16": (jnp.bfloat16, torch.bfloat16, 0.08)}


def mesh():
    return jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto, AxisType.Auto))


def numpy_params(cfg, seed):
    """A parameter tree of the JAX package's structure, drawn with numpy:
    tables N(0, 0.02^2), matrices N(0, 1/fan_in), norms 1 + N(0, 0.1^2),
    conv taps 0.2 N(0, 1); the SSM leaves of ``SSM_INIT`` are the JAX
    init's."""
    init = jbuild_model(cfg).init
    shapes = jax.eval_shape(init, jax.random.PRNGKey(0))
    if cfg.family in ("ssm", "hybrid"):
        shapes = jax.jit(init)(jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)

    def draw(path, s):
        name = str(getattr(path[-1], "key", path[-1]))
        if name in SSM_INIT:
            return np.asarray(s)
        if name == "conv_w":
            a = 0.2 * rng.normal(size=s.shape)
        elif name == "table":
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


def _record_routes(mp, routes):
    """Patch the JAX package's ``_route`` to append each call's expert ids
    (T, k) to ``routes`` in call order, through a debug callback, which
    runs as the program runs."""
    route = JM._route

    def recorded(logits, cfg):
        gate, idx, aux = route(logits, cfg)
        jax.debug.callback(lambda i: routes.append(np.asarray(i)), idx)
        return gate, idx, aux
    mp.setattr(JM, "_route", recorded)


#: a routing decision that differs between the packages in bf16 must be a
#: near-tie: the port's router logits of its own choice and of the JAX
#: package's within this gap (the bf16 router inputs differ by ~1 ulp)
ROUTE_TIE = 2.0 ** -5


def _port_routed(call, cfg, dtype, want, label):
    """Run ``call`` on the port, its routing decisions against ``want``
    (the JAX package's, in call order).  Every differing decision is
    counted and printed; in f32 there must be none, in bf16 each must be a
    near-tie (``ROUTE_TIE``), and then ``call`` runs again with the JAX
    package's expert ids (the port's own gates at those ids), so that the
    values are compared on the same routing."""
    if cfg.family != "moe":
        return call()
    route, got = TM._route, []

    def recorded(logits, cfg):
        gate, idx, aux = route(logits, cfg)
        got.append((logits, idx))
        return gate, idx, aux
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TM, "_route", recorded)
        out = call()
    want = want[:len(got)] if label == "prefill" else want[-len(got):]
    assert [tuple(i.shape) for _, i in got] == [w.shape for w in want]
    differ, gaps = 0, []
    for (logits, idx), w in zip(got, want):
        for t in np.nonzero((idx.numpy() != w).any(-1))[0]:
            mine = set(idx[t].tolist()) - set(w[t].tolist())
            theirs = set(w[t].tolist()) - set(idx[t].tolist())
            differ += len(mine)
            lg = logits[t]
            gaps.append(float(min(lg[list(mine)]) - max(lg[list(theirs)])))
    n = sum(w.size for w in want)
    print(f"{cfg.name} {dtype} {label}: {differ} of {n} routing decisions "
          f"differ; the port's logit gaps there {gaps}")
    if dtype == "f32":
        assert differ == 0
    if not differ:
        return out
    assert max(gaps) <= ROUTE_TIE, gaps
    queue = list(want)

    def forced(logits, cfg):
        idx = torch.tensor(queue.pop(0), dtype=torch.long)
        probs = torch.softmax(logits, dim=-1)
        gate = probs.gather(-1, idx)
        if cfg.experts_per_token > 1:
            gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
        return gate, idx, route(logits, cfg)[2]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TM, "_route", forced)
        return call()


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
    """(params, data, tokens, (prefill logits, caches, decode logits, new
    caches), the routing decisions: prefill's by layer, then decode's)."""
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

    routes = []
    mp = _compute_dtype(DTYPES[dtype][0])
    _record_routes(mp, routes)
    try:
        with mesh():
            out = jax.jit(run)(params, dict(data, tokens=toks[:, :n - n_img]),
                               toks[:, n - n_img:], np.full((B, 1), n,
                                                            np.int32))
            out = jax.tree.map(np.asarray, out)
    finally:
        mp.undo()
    return params, data, toks, out, routes


def _port(name, dtype, params):
    cfg = get_config(name).reduced()
    return cfg, interop.lm_params(params, cfg, dtype=DTYPES[dtype][1])


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def _argmax_agree(got, want, tol=None):
    """The share of rows whose argmax agrees; with ``tol``, over the rows
    whose reference top-2 gap exceeds it."""
    a = got.float().numpy().argmax(-1)
    want = np.asarray(want, np.float32)
    same = a == want.argmax(-1)
    if tol is not None:
        top2 = np.sort(want, -1)[..., -2:]
        same = same[top2[..., 1] - top2[..., 0] > tol]
    return float(same.mean())


def _argmax_bar(cfg, got, want):
    tol = 0.08 if cfg.family in ("ssm", "hybrid") else None
    assert _argmax_agree(got, want, tol) >= 0.95


def _cache_list(caches):
    return list(caches["sub"]) + ([caches["shared"]] if "shared" in caches
                                  else [])


def _caches_close(got, want, tol):
    assert set(got) == set(want)
    got, want = _cache_list(got), _cache_list(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert type(g).__name__ == type(w).__name__
        for field, gl, wl in zip(g._fields, g, w):
            if field == "slot_pos":
                np.testing.assert_array_equal(gl.numpy(), np.asarray(wl))
            else:
                _close(gl, wl, tol)


#: the hybrid family in bf16 (12 Mamba2 layers and the shared block twice
#: at the reduced size): each package's bf16 run drifts up to ~0.2 from
#: its f32 run over the recurrent depth (the JAX package's own decode test
#: runs the SSM archs in f32 for this reason), so two bf16 runs meet the
#: 0.08 bar in all but a few elements of a leaf: >= 99 % of each leaf's
#: elements within the bar and all within twice the bar
HYBRID_BF16_SHARE = 0.99


def _values_close(cfg, dtype, got, want, got_caches, want_caches):
    """The logits and every cache leaf within the dtype's bar; bf16 argmax
    agreement >= 0.95 (SSM and hybrid: over the rows whose top-2 gap
    exceeds the bar)."""
    tol = DTYPES[dtype][2]
    if cfg.family == "hybrid" and dtype == "bf16":
        pairs = [(got, want)] + [
            (g, w) for gc, wc in zip(_cache_list(got_caches),
                                     _cache_list(want_caches))
            for g, w in zip(gc, wc)]
        for g, w in pairs:
            g, w = g.float().numpy(), np.asarray(w, np.float32)
            err = np.abs(g - w) - tol * np.abs(w)
            share = float((err <= tol).mean())
            print(f"{cfg.name} bf16: {share:.5f} of {err.size} within the "
                  f"bar, worst excess {float(err.max()):.4f}")
            assert share >= HYBRID_BF16_SHARE and float(err.max()) <= 2 * tol
    else:
        _close(got, want, tol)
        _caches_close(got_caches, want_caches, tol)
    if dtype == "bf16":
        _argmax_bar(cfg, got, want)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("name", list(ARCHS))
def test_prefill_matches_jax(name, dtype, jax_runs):
    params, data, toks, (lp, caches, _, _), routes = jax_runs(name, dtype)
    cfg, model = _port(name, dtype, params)
    n = ARCHS[name]
    n_img = cfg.num_image_tokens if cfg.family == "vlm" else 0
    batch = {k: interop.tensor(v) for k, v in data.items()}
    batch["tokens"] = interop.tensor(toks[:, :n - n_img])
    got, got_caches = _port_routed(
        lambda: model.prefill(batch, cache_len=n + 8), cfg, dtype, routes,
        "prefill")
    assert got.shape == (B, 1, cfg.padded_vocab)
    _values_close(cfg, dtype, got, lp, got_caches, caches)
    if cfg.padded_vocab != cfg.vocab_size:
        assert float(got[..., cfg.vocab_size:].max()) == -1e30


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("name", list(ARCHS))
def test_decode_step_matches_jax(name, dtype, jax_runs):
    """One decode step at position S from the JAX prefill's caches, carried
    across with ``interop.lm_caches``."""
    params, _, toks, (_, caches, ld, new), routes = jax_runs(name, dtype)
    cfg, model = _port(name, dtype, params)
    n = ARCHS[name]
    n_img = cfg.num_image_tokens if cfg.family == "vlm" else 0
    got, got_new = _port_routed(
        lambda: model.decode_step(
            interop.lm_caches(caches), interop.tensor(toks[:, n - n_img:]),
            torch.full((B, 1), n, dtype=torch.int32)), cfg, dtype, routes,
        "decode")
    _values_close(cfg, dtype, got, ld, got_new, new)
    if name in ("h2o-danube-1.8b", "llama4-scout-17b-a16e"):
        # the ring wrapped: slot n % 64 now holds position n (llama4: the
        # chunked-local sublayers 0-2; sublayer 3 is global, no ring)
        C = got_new["sub"][0].k.shape[-3]
        assert C == 64 < n
        assert int(got_new["sub"][0].slot_pos[0, n % C]) == n
        if name.startswith("llama4"):
            assert got_new["sub"][3].k.shape[-3] == n + 8
            assert int(got_new["sub"][3].slot_pos[0, n]) == n


@pytest.mark.parametrize("name", list(ARCHS))
def test_decode_matches_prefill_over_s_plus_1(name):
    """In the port alone: prefill over S positions then a decode step at S
    gives the logits of a prefill over S + 1 positions (the JAX package's
    test_decode_matches_prefill): bf16 within 0.08, argmax >= 0.95; the MoE
    archs with capacity E / k, so that neither run drops a token; the SSM
    and hybrid archs in f32 compute, within 1e-4 and every argmax equal
    (in bf16 the two evaluation orders drift apart over depth)."""
    cfg = get_config(name).reduced()
    if cfg.family == "moe":
        cfg = dataclasses.replace(
            cfg, capacity_factor=cfg.n_experts / cfg.experts_per_token)
    f32 = cfg.family in ("ssm", "hybrid")
    model = build_model(cfg, torch.Generator().manual_seed(3), "cpu",
                        dtype=torch.float32 if f32 else torch.bfloat16)
    n = ARCHS[name]
    n_img = cfg.num_image_tokens if cfg.family == "vlm" else 0
    data = {k: interop.tensor(v) for k, v in numpy_batch(cfg, n, 4).items()}
    toks = data.pop("tokens")
    _, caches = model.prefill(dict(data, tokens=toks[:, :n - n_img]),
                              cache_len=n + 8)
    dec, _ = model.decode_step(caches, toks[:, n - n_img:],
                               torch.full((B, 1), n, dtype=torch.int32))
    ref, _ = model.prefill(dict(data, tokens=toks))
    _close(dec, ref.float().numpy(), 1e-4 if f32 else 0.08)
    assert _argmax_agree(dec, ref.float().numpy()) >= (1.0 if f32 else 0.95)


@pytest.mark.parametrize("name", ["qwen2-moe-a2.7b", "llama4-scout-17b-a16e"])
def test_router_aux_matches_jax(name):
    """The router aux loss that ``transformer.forward`` returns: summed over
    the sublayers and groups of a train-mode forward (f32), and zero in
    decode, as the JAX package's."""
    from repro_torch.models import transformer as T
    from repro_torch.models.sharding import make_policy
    cfg, jcfg = get_config(name).reduced(), jget_config(name).reduced()
    params = numpy_params(jcfg, 6)
    toks = numpy_batch(jcfg, 32, 7)["tokens"][:, :32]
    mp = _compute_dtype(jnp.float32)
    try:
        with mesh():
            want = jax.jit(lambda p, t: JT.forward(
                p, {"tokens": t}, jcfg, jmake_policy(mesh(), B, "train"),
                mode="train")[2])(params, toks)
    finally:
        mp.undo()
    model = interop.lm_params(params, cfg, dtype=torch.float32)
    _, _, got = T.forward(model.params, {"tokens": interop.tensor(toks)},
                          cfg, make_policy(None, B), dtype=torch.float32)
    assert abs(float(got) - float(want)) <= 1e-5 * max(1.0, float(want))
    assert float(got) > 0.9 * T.group_layout(cfg)[0] * len(
        T.group_layout(cfg)[1])   # each sublayer's Switch loss is >= ~1
    _, caches = model.prefill({"tokens": interop.tensor(toks)},
                              cache_len=40)
    _, _, aux = T.forward(model.params, {"tokens": interop.tensor(
        toks[:, :1])}, cfg, make_policy(None, B), mode="decode",
        caches=caches, positions=torch.full((B, 1), 32, dtype=torch.int32),
        dtype=torch.float32)
    assert float(aux) == 0.0


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


def test_init_caches_match_jax_shapes():
    """The port's empty caches have the JAX package's tree, shapes and
    dtypes (bf16 K/V and conv windows, f32 SSM states, int32 slot_pos, -1
    everywhere), the window and chunk clamps included, for every
    architecture that decodes; zamba2's shared block keeps one cache a
    group."""
    for name in ARCHS:
        cfg = get_config(name).reduced()
        jcfg = jget_config(name).reduced()
        want = jax.eval_shape(lambda: JT.init_caches(jcfg, B, 100))
        got = build_model(cfg, torch.Generator().manual_seed(0),
                          "cpu").init_caches(B, 100)
        assert set(got) == set(want)
        for g, w in zip(_cache_list(got), _cache_list(want)):
            assert type(g).__name__ == type(w).__name__
            for gl, wl in zip(g, w):
                assert tuple(gl.shape) == tuple(wl.shape)
                assert str(gl.dtype).split(".")[-1] == str(wl.dtype)
            if hasattr(g, "slot_pos"):
                assert bool((g.slot_pos == -1).all())
            else:
                assert not any(bool(t.any()) for t in g)
        if cfg.family == "hybrid":
            assert got["shared"].k.shape[0] == cfg.n_layers // \
                cfg.shared_attn_every
