"""The accept sweeps past the widths their narrow CUDA instances hold.

The JAX package's Pallas kernels keep their state in VMEM scratch and check
no size; the port's narrow sweep instances hold theirs in registers (at most
2048 features, 4096 reference rows) or, for log-det, in shared memory (a
(k, d) basis within 227 KiB), and a wide instance takes every shape past
them.  On the CPU the port's wrappers run their plain versions, held here
against the JAX kernel route in interpret mode, as the JAX package's own
tests run it, at shapes past each old cap with small B and L.  The
instance each wrapper picks is a pure function of the shape, checked here
over every width.  The CUDA instances themselves are held against the plain
versions by tests/test_torch_cuda_kernels.py (skipped without a card) and
by chip_smoke.py.

Tolerances: dyadic data (multiples of 1/8, squared for FacilityLocation)
makes every coverage, facility and exemplar sum exact, so masks, states
and gains must be equal; log-det holds masks and sizes equal on taus of 0
and +inf (decisions that depend on eligibility and budget alone) and its
basis, logdet and gains to rtol 1e-5 / atol 1e-4, the JAX package's own
tolerance for log-det gains.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import FeatureCoverage as JFeatureCoverage
from repro.core import MRConfig as JMRConfig
from repro.core import two_round_sim as j_two_round_sim
from repro.kernels import ops as jops
from repro_torch import interop
from repro_torch.core import selector as tsel
from repro_torch.kernels import _wrap
from repro_torch.kernels import logdet_accept as tla
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref

torch.set_num_threads(2)
jax.config.update("jax_platform_name", "cpu")

LD_RTOL, LD_ATOL = 1e-5, 1e-4


def _t(a):
    return None if a is None else interop.tensor(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


def _cost(rng, B, mode, budget=3.0):
    """Dyadic costs in [0.5, 2) and a budget (by default one that binds
    inside the chunk), or None for the cardinality mode."""
    if mode == "cardinality":
        return None, None
    return ((4 + rng.integers(0, 12, B)) / 8.0).astype(np.float32), \
        np.float32(budget)


def _equal(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("mode", ["cardinality", "cost"])
@pytest.mark.parametrize("name", ["coverage", "weighted", "saturated",
                                  "graph_cut"])
def test_feature_sweep_past_2048_features_matches_jax(name, mode):
    """d = 2304 is past the narrow instance's 2048 features per CTA."""
    d, B = 2304, 8
    assert _wrap.feature_sweep_per(d) == 0
    rng = np.random.default_rng(21)
    elig = rng.random(B) < 0.9
    cost, cb = _cost(rng, B, mode)
    if name == "weighted":
        x = (rng.random((B, d)) < 0.3).astype(np.float32)
        state = (rng.integers(0, 16, d) / 8.0).astype(np.float32)
    else:
        x = ((rng.integers(0, 8, (B, d)) / 8.0) ** 2).astype(np.float32)
        state = (rng.integers(0, 64, d) / 8.0).astype(np.float32)
    cap = (rng.integers(4, 24, d) / 8.0).astype(np.float32)
    if name == "graph_cut":
        # x a/8, t and s small enough that every term and sum is exact
        x = (rng.integers(0, 9, (B, d)) / 8.0).astype(np.float32)
        state = (rng.integers(0, 32, d) / 8.0).astype(np.float32)
    total = (4 + rng.integers(0, 9, d) / 2.0).astype(np.float32)
    kw = dict(cost=_j(cost), cost_budget=_j(cb))
    tkw = dict(cost=_t(cost), cost_budget=None if cb is None else float(cb))
    if name == "coverage":
        # square roots are not exact: compare the gains to a float tolerance
        # and take tau far below every gain, so the masks cannot part
        args = (x, state, None, elig, np.float32(0.0), np.int32(5))
        got = ops.coverage_accept(*map(_t, args[:4]), 0.0, 5, **tkw)
        want = jops.coverage_accept(*map(_j, args), **kw)
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        for g, w in zip(got[1:], want[1:]):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                       atol=1e-5)
        return
    if name == "weighted":
        args = (x, state, elig)
        jfn, tfn = jops.weighted_coverage_accept, ops.weighted_coverage_accept
    elif name == "saturated":
        args = (x, state, cap, None, elig)
        jfn, tfn = jops.saturated_coverage_accept, ops.saturated_coverage_accept
    else:
        args = (x, total, state, elig)
        jfn, tfn = jops.graph_cut_accept, ops.graph_cut_accept
    tau = np.float32(4.0)
    got = tfn(*map(_t, args), tau, 5, **tkw)
    assert 0 < int(got[0].sum()) < B
    _equal(got, jfn(*map(_j, args), _j(tau), jnp.int32(5), **kw))


def _dyadic_reference(rng, name, B, r, d):
    if name == "facility":
        cand = ((rng.integers(0, 8, (B, d)) / 8.0) ** 2).astype(np.float32)
        ref = (rng.integers(0, 8, (r, d)) / 8.0).astype(np.float32)
        state = (rng.integers(0, 4 * d, r) / 64.0).astype(np.float32)
        return cand, ref, state, np.float32(0.5)
    cand = (rng.integers(0, 8, (B, d)) / 8.0).astype(np.float32)
    ref = (rng.integers(0, 8, (r, d)) / 8.0).astype(np.float32)
    m0 = (ref.astype(np.float64) ** 2).sum(-1)
    state = (m0 * rng.integers(2, 9, r) / 8.0).astype(np.float32)
    return cand, ref, state, np.float32(2.0)


@pytest.mark.parametrize("mode", ["cardinality", "cost"])
@pytest.mark.parametrize("name", ["facility", "exemplar"])
def test_reference_sweep_past_4096_rows_matches_jax(name, mode):
    """r = 4224 reference rows is past the narrow instance's 4096."""
    r, B, d = 4224, 6, 8
    assert _wrap.reference_sweep_per(r) == 0
    rng = np.random.default_rng(22)
    cand, ref, state, tau = _dyadic_reference(rng, name, B, r, d)
    elig = rng.random(B) < 0.9
    cost, cb = _cost(rng, B, mode)
    tfn = ops.facility_accept if name == "facility" else ops.exemplar_accept
    jfn = jops.facility_accept if name == "facility" else jops.exemplar_accept
    got = tfn(_t(cand), _t(ref), _t(state), _t(elig), float(tau), 4,
              _t(cost), None if cb is None else float(cb))
    assert int(got[0].sum()) > 0
    _equal(got, jfn(_j(cand), _j(ref), _j(state), _j(elig), _j(tau),
                    jnp.int32(4), cost=_j(cost), cost_budget=_j(cb)))


@pytest.mark.parametrize("mode", ["cardinality", "cost"])
def test_logdet_sweep_past_shared_memory_matches_jax(mode):
    """(k, d) = (64, 1024): the basis needs 264 KiB, past the 227 KiB of
    shared memory a block may use."""
    k, d, B = 64, 1024, 6
    assert tla.instance(k, d) == "global"
    rng = np.random.default_rng(23)
    rows = torch.tensor((rng.random((k, 1, d)) ** 2).astype(np.float32))
    U, ld, size = (t[0].numpy() for t in tref.logdet_basis(
        rows, torch.tensor([k - 3], dtype=torch.int32)))
    x = (rng.random((B, d)) ** 2).astype(np.float32)
    elig = np.ones(B, bool)
    cost, cb = _cost(rng, B, mode, budget=12.0)
    got = ops.logdet_accept(_t(x), _t(U), _t(ld), _t(size), _t(elig), 0.0, 5,
                            cost=_t(cost),
                            cost_budget=None if cb is None else float(cb))
    want = jops.logdet_accept(_j(x), _j(U), _j(ld), _j(size), _j(elig),
                              jnp.float32(0.0), jnp.int32(5), cost=_j(cost),
                              cost_budget=_j(cb))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
    assert int(got[3]) > k   # an append past k_max was dropped
    for g, w in zip((got[1], got[2], got[4]), (want[1], want[2], want[4])):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=LD_RTOL,
                                   atol=LD_ATOL)


@pytest.mark.parametrize("kind", ["feature", "reference"])
def test_every_width_maps_to_one_instance(kind):
    """The wrappers' choice of instance, a pure function of the width: the
    narrow instance whose per-thread slice is the smallest that covers the
    width, and the wide instance past the widest (none raises on width)."""
    per_of, threads = ((_wrap.feature_sweep_per, _wrap.FEATURE_SWEEP_THREADS)
                       if kind == "feature" else
                       (_wrap.reference_sweep_per,
                        _wrap.REFERENCE_SWEEP_THREADS))
    widest = max(_wrap.NARROW_PER) * threads
    for width in range(1, 3 * widest):
        per = per_of(width)
        if width > widest:
            assert per == 0
            continue
        assert per in _wrap.NARROW_PER and width <= per * threads
        smaller = [p for p in _wrap.NARROW_PER if p < per]
        assert not smaller or width > max(smaller) * threads
    assert per_of(1 << 20) == 0


def test_logdet_instance_is_a_function_of_the_basis():
    for k in range(1, 300, 7):
        for d in range(1, 4100, 37):
            fits = tla.smem_bytes(k, d) <= tla.SMEM_LIMIT
            assert tla.instance(k, d) == ("shared" if fits else "global")
    assert tla.instance(64, 256) == "shared"
    assert tla.instance(64, 1024) == "global"
    assert tla.instance(256, 256) == "global"


def test_fused_select_past_2048_features_matches_jax():
    """A fused two_round FeatureCoverage select on 2304 features through
    DistributedSelector (its sweep past the narrow instance) picks the ids
    of the JAX package's fused select on its kernel route."""
    n, d, m, k = 128, 2304, 2, 4
    rng = np.random.default_rng(24)
    X = ((rng.integers(0, 8, (n, d)) / 8.0) ** 2).astype(np.float32)
    key = jax.random.PRNGKey(5)
    jres, _ = j_two_round_sim(
        JFeatureCoverage(feat_dim=d, use_kernel=True),
        jnp.asarray(X.reshape(m, n // m, d)),
        jnp.arange(n, dtype=jnp.int32).reshape(m, -1),
        jnp.ones((m, n // m), bool),
        JMRConfig(k=k, n_total=n, n_machines=m, engine="fused"), key)
    kd, _ = jax.random.split(key)
    uniforms = np.array(jax.vmap(lambda kk: jax.random.uniform(
        kk, (n // m,)))(jax.random.split(kd, m)))[None]
    spec = tsel.SelectorSpec(k=k, engine="fused", use_kernel=True)
    sel = tsel.DistributedSelector(spec, n_total=n, feat_dim=d, n_machines=m,
                                   device="cpu")
    res = sel.select(X, uniforms=uniforms)
    np.testing.assert_array_equal(res.sol_ids.numpy(),
                                  np.asarray(jres.sol_ids))
    np.testing.assert_allclose(float(res.value), float(jres.value),
                               rtol=1e-5)
