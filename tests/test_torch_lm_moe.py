"""The port's routed MoE (``repro_torch.models.moe``) against the JAX
package's ``repro.models.moe``, on the CPU at the reduced sizes of
qwen2-moe-a2.7b (4 experts top-2, renormalized, with a shared expert) and
llama4-scout-17b-a16e (4 experts top-1, the raw probability).

The JAX side runs ``moe_ffn`` on a one-peer mesh with Auto axes, where its
shard_map island takes the ``ep`` branch with no collective, as the port
does on one card.  Parameters are the JAX init's, inputs numpy draws.
Bars: f32 within rtol = atol = 1e-4, bf16 within 0.08; the aux loss within
1e-5.  Each routing decision that differs between the two packages is
counted and printed; none is excused.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AxisType

from repro.configs.base import get_config as jget_config
from repro.models import moe as JM
from repro.models.sharding import make_policy as jmake_policy
from repro_torch import interop
from repro_torch.configs.base import ShapeSpec, get_config
from repro_torch.launch.steps import decode_step_bundle
from repro_torch.models.model import Model as TModel
from repro_torch.models import moe as TM
from repro_torch.models.layers import mlp
from repro_torch.models.sharding import make_policy

torch.set_num_threads(2)
jax.config.update("jax_platform_name", "cpu")

ARCHS = ("qwen2-moe-a2.7b", "llama4-scout-17b-a16e")
DTYPES = {"f32": (jnp.float32, torch.float32, 1e-4),
          "bf16": (jnp.bfloat16, torch.bfloat16, 0.08)}
B, S = 2, 32
#: capacity factors: the configured 1.25, 0.5 (drops tokens at T = 64) and
#: E / k, where C = T and nothing drops
FACTORS = ("configured", "tight", "no_drop")


def mesh():
    return jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto, AxisType.Auto))


def _cfgs(name, factor):
    jcfg, cfg = jget_config(name).reduced(), get_config(name).reduced()
    if factor != "configured":
        cf = 0.5 if factor == "tight" else \
            cfg.n_experts / cfg.experts_per_token
        jcfg = dataclasses.replace(jcfg, capacity_factor=cf)
        cfg = dataclasses.replace(cfg, capacity_factor=cf)
    return jcfg, cfg


@pytest.fixture(scope="module")
def params():
    out = {}
    for i, name in enumerate(ARCHS):
        jcfg = jget_config(name).reduced()
        out[name] = jax.tree.map(np.asarray,
                                 JM.init_moe(jax.random.PRNGKey(i), jcfg))
    return out


def _x(cfg, dtype, seed=0):
    x = np.random.default_rng(seed).normal(size=(B, S, cfg.d_model))
    return np.asarray(jnp.asarray(x, DTYPES[dtype][0]))


def _port_params(p):
    return jax.tree.map(interop.tensor, p)


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("tokens", [1, 4, 7, 64, 100, 8256])
@pytest.mark.parametrize("name", ARCHS)
def test_capacity_matches_jax(name, tokens):
    for factor in FACTORS:
        jcfg, cfg = _cfgs(name, factor)
        assert TM._capacity(cfg, tokens) == JM._capacity(jcfg, tokens)
    full = get_config(name)
    assert TM._capacity(full, tokens) == JM._capacity(jget_config(name),
                                                     tokens)


@pytest.mark.parametrize("name", ARCHS)
def test_route_matches_jax(name):
    """Gates, expert ids and the Switch aux loss from the same f32 logits;
    llama4 (k = 1) keeps the raw probability, qwen2-moe renormalizes."""
    jcfg, cfg = _cfgs(name, "configured")
    logits = np.random.default_rng(1).normal(
        size=(B * S, cfg.n_experts)).astype(np.float32)
    jg, ji, ja = (np.asarray(a) for a in JM._route(jnp.asarray(logits),
                                                    jcfg))
    tg, ti, ta = TM._route(interop.tensor(logits), cfg)
    differ = int((ti.numpy() != ji).sum())
    print(f"{name}: {differ} of {ji.size} routing decisions differ")
    assert differ == 0
    _close(tg, jg, 1e-6)
    assert abs(float(ta) - float(ja)) <= 1e-5
    probs = torch.softmax(interop.tensor(logits), -1)
    if cfg.experts_per_token == 1:
        assert torch.equal(tg[:, 0], probs.max(-1).values)
    else:
        _close(tg.sum(-1), np.ones(B * S), 1e-6)


def _jax_routes(jcfg, p, x):
    """The JAX package's expert ids for x, from its own router product."""
    xt = jnp.asarray(x).reshape(B * S, -1).astype(jnp.float32)
    return np.asarray(JM._route(xt @ jnp.asarray(p["router"]), jcfg)[1])


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("factor", FACTORS)
@pytest.mark.parametrize("name", ARCHS)
def test_moe_ffn_matches_jax(name, factor, dtype, params):
    """out and aux of moe_ffn at the configured capacity, at one that
    drops tokens and at one that drops none."""
    jcfg, cfg = _cfgs(name, factor)
    p = params[name]
    x = _x(cfg, dtype)
    with mesh():
        jo, ja = jax.jit(lambda p, x: JM.moe_ffn(
            p, x, jcfg, jmake_policy(mesh(), B, "train")))(p, x)
    tp = _port_params(p)
    tx = interop.tensor(x)
    to, ta = TM.moe_ffn(tp, tx, cfg, make_policy(None, B))
    _, idx, _ = TM._route(tx.reshape(B * S, -1).float()
                          @ tp["router"].float(), cfg)
    differ = int((idx.numpy() != _jax_routes(jcfg, p, x)).sum())
    _, _, dropped = TM._dispatch_combine(tx, tp["router"], tp["we_gate"],
                                         tp["we_up"], tp["we_down"], cfg)
    print(f"{name} {factor} {dtype}: {differ} routing decisions differ, "
          f"{int(dropped)} (token, choice) rows dropped")
    assert differ == 0
    if factor != "configured":
        assert (int(dropped) > 0) == (factor == "tight")
    assert to.dtype == DTYPES[dtype][1] and to.shape == (B, S, cfg.d_model)
    _close(to, jo, DTYPES[dtype][2])
    assert abs(float(ta) - float(ja)) <= 1e-5


@pytest.mark.parametrize("name", ARCHS)
def test_moe_ffn_matches_a_dense_reference(name, params):
    """With nothing dropped, the slot dispatch is the dense per-expert sum:
    out = sum over the chosen experts of gate * FFN_e(x), + the shared MLP
    (f32)."""
    _, cfg = _cfgs(name, "no_drop")
    tp = _port_params(params[name])
    x = interop.tensor(_x(cfg, "f32", 3))
    got, _ = TM.moe_ffn(tp, x, cfg, make_policy(None, B))
    xt = x.reshape(B * S, -1)
    gate, idx, _ = TM._route(xt @ tp["router"], cfg)
    want = torch.zeros_like(xt)
    for e in range(cfg.n_experts):
        ye = mlp({"wg": tp["we_gate"][e], "wu": tp["we_up"][e],
                  "wd": tp["we_down"][e]}, xt)
        w = (gate * (idx == e)).sum(-1, keepdim=True)
        want = want + w * ye
    want = want + mlp(tp["shared"], xt)
    _close(got.reshape(B * S, -1), want.numpy(), 1e-4)


def test_moe_ffn_needs_one_model_peer(params):
    """The moe family runs on a multi-rank mesh (its tp, ep and all-to-all
    modes, ``test_torch_lm_mesh.py``), as the ssm and hybrid families do
    since their slice (``test_torch_lm_ssm_mesh.py``); the vlm and audio
    families on one raise, naming the next slice, before a parameter is
    drawn, and a one-peer policy keeps the one-card path."""
    class Mesh22:
        shape = {"data": 2, "model": 2}
    for name in ("internvl2-26b", "hubert-xlarge"):
        cfg = get_config(name).reduced()
        policy = make_policy(Mesh22(), 4, "decode")
        with pytest.raises(NotImplementedError, match="next slice"):
            TModel(cfg, torch.Generator().manual_seed(0), "cpu",
                   policy=policy)
        with pytest.raises(NotImplementedError, match="next slice"):
            decode_step_bundle(cfg, ShapeSpec("t", 8, 4, "decode"), Mesh22())
    cfg = get_config("qwen2-moe-a2.7b").reduced()
    x = torch.zeros((B, S, cfg.d_model))
    out, aux = TM.moe_ffn(_port_params(params["qwen2-moe-a2.7b"]), x, cfg,
                          make_policy(None, B, "decode"))
    assert out.shape == x.shape and torch.isfinite(aux)


@pytest.mark.parametrize("name", ARCHS)
def test_init_moe_matches_jax_shapes(name):
    """init_moe: the JAX package's leaves and shapes; matrices N(0, 1/fan
    in)."""
    _, cfg = _cfgs(name, "configured")
    jcfg = jget_config(name).reduced()
    got = TM.init_moe(cfg, torch.Generator().manual_seed(0))
    want = jax.eval_shape(lambda: JM.init_moe(jax.random.PRNGKey(0), jcfg))
    assert set(got) == set(want) and set(got["shared"]) == set(
        want["shared"])
    for k in ("router", "we_gate", "we_up", "we_down"):
        assert tuple(got[k].shape) == want[k].shape
    fan_in = got["we_down"].shape[1]
    assert abs(float(got["we_down"].std()) * fan_in ** 0.5 - 1) < 0.05
