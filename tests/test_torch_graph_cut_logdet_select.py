"""GraphCut, LogDetDiversity and MutualInformationGaussian selections of
the port against the JAX package, on the CPU: GraphCut's MapReduce drivers
(two_round and multi_epoch, every engine, f32 and bf16), mutual information
at noise 1 against log-det, the selector and the CLI.  The log-det and MI
drivers are held against the JAX package in test_torch_logdet_drivers.py.

The JAX keys' sample draws are injected into the port (``jax_uniforms``),
so both packages see the same samples.  GraphCut runs on dyadic rows (a/8,
a in 0..8) with lam = 0.5 and total = X.sum(0): every sum is exact in f32,
so ids and values must be equal, and the RoundLogs record for record.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_mapreduce import jax_uniforms

from repro.core import GraphCut as JGraphCut
from repro.core import LogDetDiversity as JLogDet
from repro.core import MRConfig as JMRConfig
from repro.core import MutualInformationGaussian as JMI
from repro.core import multi_epoch_sim as j_multi_epoch_sim
from repro.core.selector import DistributedSelector as JDistributedSelector
from repro.core.selector import SelectorSpec as JSelectorSpec
from repro.launch.mesh import make_mesh_for
from repro_torch import interop
from repro_torch.core import mapreduce as tmr
from repro_torch.core import selector as tsel

torch.set_num_threads(2)
jax.config.update("jax_platform_name", "cpu")

REPO = Path(__file__).resolve().parents[1]
N, M, K, D = 512, 4, 6, 16
ORACLES = ("graph_cut", "log_det", "mutual_information")


def _corpus(name, seed):
    rng = np.random.default_rng(seed)
    if name == "graph_cut":
        return (rng.integers(0, 9, (N, D)) / 8.0).astype(np.float32)
    return (rng.standard_normal((N, D)) * 0.5).astype(np.float32)


def _pair(name, X, use_kernel, noise=0.7):
    if name == "graph_cut":
        total = X.sum(0)
        return (JGraphCut(feat_dim=D, total=jnp.asarray(total), lam=0.5,
                          use_kernel=use_kernel),
                interop.graph_cut(D, total, 0.5, use_kernel=use_kernel))
    if name == "log_det":
        return (JLogDet(feat_dim=D, k_max=K, alpha=1.0, use_kernel=use_kernel),
                interop.log_det(D, K, 1.0, use_kernel=use_kernel))
    return (JMI(feat_dim=D, k_max=K, noise=noise, use_kernel=use_kernel),
            interop.mutual_information(D, K, noise, use_kernel=use_kernel))


def run_both(name, X, epochs, engine, precision, key):
    """The JAX driver on its plain route and the port's on its kernel route
    (the plain versions, on the CPU), over the same shards and sample
    draws; checks that sizes, overflow and fallback counts and RoundLogs
    are equal.  Returns (JAX result, port result, port oracle)."""
    fm = X.reshape(M, N // M, D)
    ids = np.arange(N, dtype=np.int32).reshape(M, -1)
    valid = np.ones((M, N // M), bool)
    knobs = dict(k=K, n_total=N, n_machines=M, engine=engine, chunk=16,
                 precision=precision)
    jo, _ = _pair(name, X, False)
    _, to = _pair(name, X, True)
    jres, jlog = j_multi_epoch_sim(
        jo, jnp.asarray(fm), jnp.asarray(ids), jnp.asarray(valid),
        JMRConfig(**knobs), key, epochs=epochs)
    tres, tlog = tmr.multi_epoch_sim(
        to, *interop.shard(fm, ids, valid), tmr.MRConfig(**knobs),
        uniforms=interop.uniforms(jax_uniforms(key, epochs, M, N // M)),
        epochs=epochs)
    assert int(tres.sol_size) == int(jres.sol_size) >= 1
    assert int(tres.n_dropped) == int(jres.n_dropped)
    assert int(tres.tau_fallback) == int(jres.tau_fallback)
    assert [(r.name, r.bytes_per_machine, r.bytes_total, r.detail)
            for r in tlog.records] == \
        [(r.name, r.bytes_per_machine, r.bytes_total, r.detail)
         for r in jlog.records]
    assert tlog.n_rounds == 2 * epochs
    return jres, tres, to


@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("engine", ["dense", "lazy", "fused"])
@pytest.mark.parametrize("epochs", [1, 2])
def test_graph_cut_drivers_match_jax(epochs, engine, precision):
    """two_round (E = 1) and multi_epoch (E = 2) on dyadic rows: equal ids,
    sizes, values and RoundLogs."""
    X = _corpus("graph_cut", 30 + epochs)
    jres, tres, _ = run_both("graph_cut", X, epochs, engine, precision,
                             jax.random.PRNGKey(epochs))
    np.testing.assert_array_equal(tres.sol_ids.numpy(),
                                  np.asarray(jres.sol_ids))
    assert float(tres.value) == float(jres.value)


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("epochs", [1, 2])
def test_mi_at_noise_one_is_half_of_log_det(epochs, use_kernel):
    """At noise 1, MI is log-det at alpha 1 scaled by 0.5, a power of two:
    every gain, threshold and comparison scales exactly, so the same ids and
    exactly half the value, on every engine."""
    X = _corpus("log_det", 50)
    fm = X.reshape(M, N // M, D)
    shard = interop.shard(fm, np.arange(N, dtype=np.int32).reshape(M, -1),
                          np.ones((M, N // M), bool))
    u = interop.uniforms(np.random.default_rng(51).random(
        (epochs, M, N // M)).astype(np.float32))
    for engine in ("dense", "lazy", "fused"):
        cfg = tmr.MRConfig(k=K, n_total=N, n_machines=M, engine=engine,
                           chunk=16)
        ld, _ = tmr.multi_epoch_sim(
            interop.log_det(D, K, 1.0, use_kernel=use_kernel), *shard, cfg,
            uniforms=u, epochs=epochs)
        mi, _ = tmr.multi_epoch_sim(
            interop.mutual_information(D, K, 1.0, use_kernel=use_kernel),
            *shard, cfg, uniforms=u, epochs=epochs)
        assert torch.equal(mi.sol_ids, ld.sol_ids) and int(ld.sol_size) >= 1
        assert float(mi.value) == 0.5 * float(ld.value)


@pytest.mark.parametrize("name", ORACLES)
def test_selector_matches_jax_selector(name):
    """The port's DistributedSelector on the CPU against the JAX selector on
    a 1-device mesh (one machine, whose sample draws are the key folded in
    with machine index 0), both with their spec defaults for lam, alpha and
    noise except MI at noise 0.7."""
    X = _corpus(name, 40)
    total = X.sum(0) if name == "graph_cut" else None
    key = jax.random.PRNGKey(5)
    kw = dict(mi_noise=0.7) if name == "mutual_information" else {}
    jspec = JSelectorSpec(k=K, oracle=name, engine="fused", **kw)
    jsel = JDistributedSelector(jspec, make_mesh_for(1, model_parallel=1),
                                n_total=N, feat_dim=D,
                                total=None if total is None
                                else jnp.asarray(total))
    jres = jsel.select(jnp.asarray(X), key=key)
    spec = tsel.SelectorSpec(k=K, oracle=name, engine="fused",
                             use_kernel=True, **kw)
    assert (spec.graph_cut_lam, spec.logdet_alpha, spec.mi_noise) == \
        (jspec.graph_cut_lam, jspec.logdet_alpha, jspec.mi_noise)
    sel = tsel.DistributedSelector(spec, n_total=N, feat_dim=D,
                                   device="cpu", total=total)
    if name != "graph_cut":
        assert sel.oracle.k_max == K
    draws = np.asarray(jax.random.uniform(jax.random.fold_in(key, 0), (N,)))
    res = sel.select(X, uniforms=draws[None, None])
    np.testing.assert_array_equal(res.sol_ids.numpy(), np.asarray(jres.sol_ids))
    np.testing.assert_allclose(float(res.value), float(jres.value), rtol=1e-5)
    assert int(res.n_dropped) == int(jres.n_dropped)
    assert [r.bytes_total for r in sel.round_log.records] == \
        [r.bytes_total for r in jsel.round_log.records]
    assert float(sel.opt_upper_bound(X)) >= float(res.value)
    if total is not None:
        # a bf16 selector keeps total (an accumulator statistic) in f32
        bf = tsel.DistributedSelector(
            tsel.SelectorSpec(k=K, oracle=name, precision="bf16"),
            n_total=N, feat_dim=D, device="cpu", total=total)
        assert bf.oracle.total.dtype == torch.float32
        with pytest.raises(ValueError, match="feature sum"):
            tsel.DistributedSelector(spec, n_total=N, feat_dim=D,
                                     device="cpu")


@pytest.mark.parametrize("extra", [["--oracle", "graph_cut"],
                                   ["--oracle", "log_det"],
                                   ["--oracle", "mutual_information",
                                    "--mi-noise", "0.7"]])
def test_cli_runs_on_cpu(extra):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO / "src") + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.select", "--device", "cpu",
         "--use-kernel", "--n", "1024", "--k", "8", "--d", "16",
         "--machines", "4", "--engine", "fused", *extra],
        capture_output=True, text=True, env=env, timeout=120, cwd=REPO)
    assert out.returncode == 0, out.stderr
    assert f"oracle={extra[1]}" in out.stdout
    assert "device=cpu" in out.stdout and "tau_fallback=0" in out.stdout
