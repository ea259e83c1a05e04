"""The port's OPT-free MapReduce drivers against the JAX package, on the CPU.

The sample rounds draw with ``jax.random`` in the JAX package; the harness
computes those draws from the same keys (``jax_uniforms``) and injects them
into the port, so both packages see the same samples.  ``sol_ids``,
``sol_size``, ``n_dropped`` and ``tau_fallback`` must be equal, ``value``
within rtol 1e-5 (sums over d in another order), and the RoundLogs equal
record for record.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import FeatureCoverage as JFeatureCoverage
from repro.core import MRConfig as JMRConfig
from repro.core import multi_epoch_sim as j_multi_epoch_sim
from repro_torch import interop
from repro_torch.core import mapreduce as tmr

torch.set_num_threads(2)
jax.config.update("jax_platform_name", "cpu")

N, D, M, K = 1024, 12, 8, 8


def jax_uniforms(key, epochs, m, n_local):
    """The (E, m, n/m) draws of the JAX sim drivers' sample rounds:
    multi_epoch_sim splits the key, epoch keys split that E ways (E > 1),
    and SimRounds.sample splits each epoch key over the m machines."""
    kd, _ = jax.random.split(key)
    eks = [kd] if epochs == 1 else list(jax.random.split(kd, epochs))
    draw = jax.vmap(lambda kk: jax.random.uniform(kk, (n_local,)))
    return np.stack([np.asarray(draw(jax.random.split(ek, m))) for ek in eks])


def jax_mesh_uniforms(epoch_keys, m, n_local):
    """The (E, m, n/m) draws of the JAX mesh drivers' sample rounds, given
    their epoch keys: machine c folds its index into the key
    (``MeshRounds.sample``), where the sim splits the key over the
    machines."""
    return interop.mesh_uniforms(
        [[np.asarray(jax.random.uniform(jax.random.fold_in(ek, c),
                                        (n_local,))) for c in range(m)]
         for ek in epoch_keys])


def _corpus(seed, zero=False, weighted=False):
    rng = np.random.default_rng(seed)
    X = (rng.random((N, D), dtype=np.float32)) ** 2
    if zero:
        X = np.zeros_like(X)
    w = rng.random(D).astype(np.float32) + 0.5 if weighted else None
    return (X.reshape(M, N // M, D),
            np.arange(N, dtype=np.int32).reshape(M, -1),
            np.ones((M, N // M), bool), w)


def _run_both(seed, engine, precision, epochs, accept="first",
              use_kernel=False, zero=False, weighted=False):
    fm, ids, valid, w = _corpus(seed, zero, weighted)
    key = jax.random.PRNGKey(seed)
    knobs = dict(k=K, n_total=N, n_machines=M, engine=engine, chunk=16,
                 precision=precision, accept=accept)
    jres, jlog = j_multi_epoch_sim(
        JFeatureCoverage(feat_dim=D, weights=None if w is None else jnp.asarray(w)),
        jnp.asarray(fm), jnp.asarray(ids), jnp.asarray(valid),
        JMRConfig(**knobs), key, epochs=epochs)
    tres, tlog = tmr.multi_epoch_sim(
        interop.feature_coverage(D, w, use_kernel=use_kernel),
        *interop.shard(fm, ids, valid), tmr.MRConfig(**knobs),
        uniforms=interop.uniforms(jax_uniforms(key, epochs, M, N // M)),
        epochs=epochs)
    return jres, jlog, tres, tlog


def _assert_same(jres, jlog, tres, tlog, rtol=1e-5):
    np.testing.assert_array_equal(tres.sol_ids.numpy(), np.asarray(jres.sol_ids))
    assert int(tres.sol_size) == int(jres.sol_size)
    assert int(tres.n_dropped) == int(jres.n_dropped)
    assert int(tres.tau_fallback) == int(jres.tau_fallback)
    np.testing.assert_allclose(float(tres.value), float(jres.value), rtol=rtol)
    assert [(r.name, r.bytes_per_machine, r.bytes_total, r.detail)
            for r in tlog.records] == \
        [(r.name, r.bytes_per_machine, r.bytes_total, r.detail)
         for r in jlog.records]


@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("engine", ["dense", "lazy", "fused"])
def test_two_round_matches_jax(engine, precision):
    jres, jlog, tres, tlog = _run_both(0, engine, precision, 1)
    _assert_same(jres, jlog, tres, tlog)
    assert tlog.n_rounds == 2 and int(tres.sol_size) == K


@pytest.mark.parametrize("engine,precision",
                         [("dense", "bf16"), ("lazy", "f32"), ("fused", "f32")])
def test_multi_epoch_matches_jax(engine, precision):
    jres, jlog, tres, tlog = _run_both(2, engine, precision, 2)
    _assert_same(jres, jlog, tres, tlog)
    assert tlog.n_rounds == 4


def test_kernel_route_matches_jax():
    """use_kernel=True runs the kernels' plain versions on the CPU; with
    FeatureCoverage weights."""
    _assert_same(*_run_both(1, "fused", "f32", 1, use_kernel=True,
                            weighted=True))


def test_best_accept_matches_jax_value():
    jres, _, tres, _ = _run_both(3, "lazy", "f32", 1, accept="best")
    np.testing.assert_allclose(float(tres.value), float(jres.value),
                               rtol=1e-5)


def test_all_zero_corpus_falls_back():
    jres, jlog, tres, tlog = _run_both(4, "fused", "f32", 1, zero=True)
    _assert_same(jres, jlog, tres, tlog)
    assert int(tres.tau_fallback) == 2 and int(tres.sol_size) == 0


def test_generator_draws_are_reproducible_and_sized():
    fm, ids, valid, _ = _corpus(5)
    cfg = tmr.MRConfig(k=K, n_total=N, n_machines=M, engine="fused", chunk=16)
    oracle = interop.feature_coverage(D)
    runs = [tmr.two_round_sim(oracle, *interop.shard(fm, ids, valid), cfg,
                              generator=torch.Generator().manual_seed(9))[0]
            for _ in range(2)]
    assert torch.equal(runs[0].sol_ids, runs[1].sol_ids)
    assert int(runs[0].sol_size) == K
    with pytest.raises(ValueError, match="uniforms"):
        tmr.two_round_sim(oracle, *interop.shard(fm, ids, valid), cfg,
                          uniforms=np.zeros((2, M, N // M), np.float32))


def test_mrconfig_matches_jax_caps_and_validates():
    for knobs in (dict(k=64, n_total=1 << 20, n_machines=16),
                  dict(k=8, n_total=1000, n_machines=3, eps=0.3)):
        t, j = tmr.MRConfig(**knobs), JMRConfig(**knobs)
        assert t.caps() == j.caps() and t.grid_size() == j.grid_size()
        assert t.sample_p == j.sample_p and t.n_epochs() == j.n_epochs()
    full = tmr.MRConfig(k=64, n_total=1 << 20, n_machines=16)
    assert full.caps() == (6160, 2128, 144) and full.grid_size() == 37
    with pytest.raises(ValueError, match="divisible"):
        tmr.MRConfig(k=8, n_total=1000, n_machines=3).require_even_shards()
    with pytest.raises(ValueError, match="precision"):
        tmr.MRConfig(k=8, n_total=64, n_machines=2, precision="fp8")
