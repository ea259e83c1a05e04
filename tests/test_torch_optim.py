"""The port's AdamW (``optim/adamw.py``) and gradient compression
(``optim/compression.py``) against the JAX package's, on the CPU.

AdamW runs several steps on the same numpy parameters and per-step numpy
gradients in both packages: the reduced falcon-mamba and zamba2 trees
(their Mamba ``conv_b`` leaves are 1-D in the port and (G, C) in the JAX
package, which decays them), with the clip on and off and weight decay 0.1
and 0, over steps 1, the warm-up's end, mid-cosine and past
``total_steps``.  Bar: parameters, m and v within rtol 1e-6 (the JAX
update jitted, as its train step runs it; an absolute floor of 1e-6 of
each leaf's max |.| for the elements that cancel, see ``_close``), and
equal step counters and learning rates.
Compression: the int8 and top-k round trips and their error feedback equal
the JAX package's on the same tensors (a tie at the top-k threshold
included), and the error-feedback property of the JAX package's own test.
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_train_common import numpy_params
from repro.configs.base import get_config as jget_config
from repro.optim import adamw as jadamw
from repro.optim import compression as jcomp
from repro_torch import interop
from repro_torch.configs.base import get_config
from repro_torch.optim import adamw
from repro_torch.optim import compression as comp

torch.set_num_threads(2)
jax.config.update("jax_platform_name", "cpu")

#: warm-up ends at step 2, the cosine at step 5; 7 steps pass it
SCHED = dict(lr=1e-3, warmup_steps=2, total_steps=5)
STEPS = 7
OPT_CASES = {"clip-decay": dict(clip_norm=1.0, weight_decay=0.1),
             "no-clip-no-decay": dict(clip_norm=0.0, weight_decay=0.0)}
ARCHS = ("falcon-mamba-7b", "zamba2-2.7b")


def _grads(params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda p: (0.01 * rng.normal(size=p.shape)).astype(np.float32),
        params)


def _by_name(tree, cfg):
    """A JAX-layout numpy tree as the port's {name: tensor}."""
    model = interop.lm_params(tree, cfg, dtype=torch.float32)
    return {n: p.detach() for n, p in model.params.named_parameters()}


def _close(got, want, rtol=1e-6):
    """Each element within ``rtol``, with an absolute floor of ``rtol``
    times its leaf's max |.|: the JAX update is one XLA program that
    contracts multiply-adds into FMAs, torch's ops round each product, so
    the two differ in the last bits, and an element that cancels (a moment
    whose sign flips, a parameter that crosses zero) is relatively far off
    by those bits alone."""
    assert set(got) == set(want)
    for n in want:
        w = want[n].numpy()
        np.testing.assert_allclose(got[n].numpy(), w, rtol=rtol,
                                   atol=rtol * float(np.abs(w).max()),
                                   err_msg=n)


_CACHE = {}


def _cached(key, make):
    if key not in _CACHE:
        _CACHE[key] = make()
    return _CACHE[key]


def _params(arch):
    return _cached(("params", arch),
                   lambda: numpy_params(jget_config(arch).reduced(), 0))


def _steps_grads(arch):
    return _cached(("grads", arch), lambda: [
        _grads(_params(arch), 100 + step) for step in range(STEPS)])


def _jax_run(arch, knobs):
    """The JAX update's STEPS steps (jitted): (params, state, each step's
    metrics), run once in the module."""
    def run():
        cfg = jadamw.AdamWConfig(**SCHED, **OPT_CASES[knobs])
        update = jax.jit(lambda p, g, s: jadamw.update(cfg, p, g, s))
        p = _params(arch)
        st, ms = jadamw.init(p), []
        for g in _steps_grads(arch):
            p, st, m = update(p, g, st)
            ms.append(m)
        return p, st, ms
    return _cached(("jax", arch, knobs), run)


def _port_run(arch, knobs):
    """The port's update over the same steps: (cfg, model, state), each
    step's lr and grad_norm held to JAX's on the way."""
    cfg = get_config(arch).reduced()
    opt_cfg = adamw.AdamWConfig(**SCHED, **OPT_CASES[knobs])
    model = interop.lm_params(_params(arch), cfg, dtype=torch.float32)
    params = dict(model.params.named_parameters())
    st = adamw.init(params)
    for g, jm in zip(_steps_grads(arch), _jax_run(arch, knobs)[2]):
        _, st, m = adamw.update(opt_cfg, params, _by_name(g, cfg), st)
        np.testing.assert_allclose(float(m["lr"]), float(jm["lr"]),
                                   rtol=1e-6)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
    return cfg, model, st


@pytest.mark.parametrize("knobs", list(OPT_CASES))
@pytest.mark.parametrize("arch", ARCHS)
def test_adamw_matches_jax(arch, knobs):
    jp, jst, _ = _jax_run(arch, knobs)
    cfg, model, st = _port_run(arch, knobs)
    assert int(st.step) == int(jst.step) == STEPS
    want = interop.adamw_state(jst, model)
    _close({n: p.detach() for n, p in model.params.named_parameters()},
           _by_name(jax.tree.map(np.asarray, jp), cfg))
    _close(st.m, want.m)
    _close(st.v, want.v)


def test_conv_b_is_decayed_as_the_stacked_reference_does():
    """The JAX package decays a leaf of ndim >= 2 whose name names no norm,
    bias or SSM dynamics; its stacked Mamba ``conv_b`` (G, C) is decayed,
    so the port's 1-D ``conv_b`` of a group is too.  A literal copy of the
    rule on the port's shapes would leave it undecayed and drift."""
    conv_b = torch.zeros(8)
    assert adamw.decays("groups.0.0.ssm.conv_b", conv_b)
    assert not adamw.decays("groups.0.0.ssm.dt_bias", conv_b)
    assert not adamw.decays("groups.0.0.ln1", conv_b)
    assert not adamw.decays("final_norm", conv_b)
    assert not adamw.decays("shared_block.ln1", conv_b)
    assert adamw.decays("shared_block.attn.wq", torch.zeros(4, 4))

    literal = adamw.decays

    def unstacked(name, p):
        return literal("top." + name, p)
    jp = _jax_run("zamba2-2.7b", "clip-decay")[0]
    want = np.array(jp["groups"][0]["ssm"]["conv_b"][1])
    _, model, _ = _port_run("zamba2-2.7b", "clip-decay")
    got = model.params.groups[1][0].ssm["conv_b"].detach()
    _close({"conv_b": got}, {"conv_b": torch.from_numpy(want)})
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(adamw, "decays", unstacked)
        _, model, _ = _port_run("zamba2-2.7b", "clip-decay")
    drift = model.params.groups[1][0].ssm["conv_b"].detach().numpy()
    assert np.abs(drift - want).max() > 100 * 1e-6 * np.abs(want).max()


def test_schedule_matches_jax():
    for knobs in (SCHED, dict(lr=3e-4, warmup_steps=100, total_steps=10_000,
                              min_lr_frac=0.1)):
        jcfg, cfg = jadamw.AdamWConfig(**knobs), adamw.AdamWConfig(**knobs)
        steps = np.array([0, 1, 2, 3, 5, 7, 50, 100, 101, 5_000, 9_999,
                          10_000, 12_345], np.int32)
        want = np.asarray(jax.jit(lambda s: jadamw.schedule(jcfg, s))(steps))
        got = adamw.schedule(cfg, torch.from_numpy(steps)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6)


def test_carried_opt_state_continues_alike():
    """Three JAX steps, the state carried across with
    ``interop.adamw_state``, then a step in each package: the same
    result."""
    arch = "falcon-mamba-7b"
    cfg = get_config(arch).reduced()
    ocfg = dict(SCHED, clip_norm=1.0, weight_decay=0.1)
    jopt_cfg, opt_cfg = jadamw.AdamWConfig(**ocfg), adamw.AdamWConfig(**ocfg)
    jupdate = jax.jit(lambda p, g, s: jadamw.update(jopt_cfg, p, g, s))
    jp = _params(arch)
    jst = jadamw.init(jp)
    for step in range(3):
        jp, jst, _ = jupdate(jp, _grads(jp, step), jst)
    jp = jax.tree.map(np.asarray, jp)
    model = interop.lm_params(jp, cfg, dtype=torch.float32)
    st = interop.adamw_state(jst, model)
    g = _grads(jp, 9)
    jp2, jst2, _ = jupdate(jp, g, jst)
    tparams = dict(model.params.named_parameters())
    _, st2, _ = adamw.update(opt_cfg, tparams, _by_name(g, cfg), st)
    _close({n: p.detach() for n, p in tparams.items()},
           _by_name(jax.tree.map(np.asarray, jp2), cfg))
    _close(st2.m, interop.adamw_state(jst2, model).m)
    assert int(st2.step) == 4


# ---------------------------------------------------------------------------
# compression
# ---------------------------------------------------------------------------

def _comp_grads(seed):
    rng = np.random.default_rng(seed)
    g = {"w": rng.normal(size=(64, 33)).astype(np.float32),
         "b": rng.normal(size=(33,)).astype(np.float32)}
    # a tie at the top-k threshold: with topk_frac 0.01 of 2112 elements
    # k = 21, and the 21st and 22nd largest |g| are the same value
    flat = np.sort(np.abs(g["w"]).reshape(-1))[::-1]
    g["w"][np.abs(g["w"]) == flat[21]] = np.float32(flat[20])
    # an exact half-way point of the int8 grid (round half to even)
    g["b"][0] = np.float32(np.abs(g["b"]).max())
    g["b"][1] = np.float32(g["b"][0] * 2.5 / 127)
    return g


@pytest.mark.parametrize("kind", ["int8", "topk"])
def test_compression_matches_jax(kind):
    jcfg = jcomp.CompressionConfig(kind=kind)
    cfg = comp.CompressionConfig(kind=kind)
    g = _comp_grads(0)
    jst = jcomp.init(g)
    st = comp.init({k: torch.from_numpy(v) for k, v in g.items()})
    for step in range(4):
        g = _comp_grads(step) if step else g
        jout, jst, jf = jcomp.compress(jcfg, jax.tree.map(jnp.asarray, g),
                                       jst)
        out, st, f = comp.compress(
            cfg, {k: torch.from_numpy(v) for k, v in g.items()}, st)
        assert f == jf
        if kind == "topk" and step == 0:
            # no error carried yet: the tie at the threshold is kept whole
            k = max(1, int(out["w"].numel() * 0.01))
            assert int((out["w"] != 0).sum()) == k + 1
        for k in g:
            np.testing.assert_array_equal(out[k].numpy(),
                                          np.asarray(jout[k]))
            np.testing.assert_allclose(st.error[k].numpy(),
                                       np.asarray(jst.error[k]),
                                       rtol=1e-6, atol=1e-7)


def test_compression_error_feedback():
    """int8 EF compression: biased per step, but the error carries over so
    the accumulated update tracks the true gradient sum."""
    g = {"w": torch.from_numpy(np.random.default_rng(0).normal(size=(64,))
                               .astype(np.float32))}
    st = comp.init(g)
    cfg = comp.CompressionConfig(kind="int8")
    total = torch.zeros_like(g["w"])
    for _ in range(20):
        sent, st, factor = comp.compress(cfg, g, st)
        assert factor == 0.25
        total += sent["w"]
    np.testing.assert_allclose((total / 20).numpy(), g["w"].numpy(),
                               atol=1e-2)
    same, st2, f = comp.compress(comp.CompressionConfig(), g, st)
    assert same is g and st2 is st and f == 1.0
