"""The port's streaming sieve against the JAX package, on the CPU.

* The four lane helpers (``grids.lane_count`` / ``lane_window_lo`` /
  ``lane_exponents`` / ``lane_taus``) over a sweep of v that includes
  quotients log(v) / log1p(eps) a few ulps from an integer.
* ``sieve_update`` chunk by chunk: exps, sol_ids, sol_sizes, top_ids and
  the carried rows equal to JAX's; v_max and top_vals within rtol 1e-6.
* ``sieve_run`` / ``sieve_finish`` for the seven oracles of the JAX
  streaming tests and MutualInformationGaussian, on the dense, lazy and
  fused engines: JAX's ids and size, values within rtol 1e-5, and the
  (1/2 - eps) floor against sequential greedy.
* The constraints (Cardinality gives the unconstrained bits; knapsack and
  partition matroid give JAX's ids and stay feasible), bf16 pools,
  ``k_dyn`` budgets, replay determinism, reseeding as v grows, reservoir
  ties on duplicate rows, the sort-based dedupe against the P x P form,
  ``greedy(k_dyn=)``, and a stream that starts in JAX and goes on in both
  packages from one state (``interop.sieve_state``).

Data: the coverage family, facility location and exemplar run on dyadic
rows (and references), where every sum is exact; graph cut on a/8 rows with
lam 0.5; log-det and MI on Gaussian rows, where the ids are compared
directly after the float64 margins of the lane-window exponents are
asserted (``lane_window_lo`` is the one place a one-ulp difference of
``log`` would change a decision of the stream, by reseeding a lane).
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import constraints as jcons
from repro.core import functions as jF
from repro.core import grids as jgrids
from repro.core import sequential as jseq
from repro.streaming import sieve as jsieve
from repro_torch import interop
from repro_torch.core import constraints as tcons
from repro_torch.core import grids as tgrids
from repro_torch.core import sequential as tseq
from repro_torch.streaming import sieve as tsieve

torch.set_num_threads(2)
jax.config.update("jax_platform_name", "cpu")

N, D, K, B = 256, 8, 8, 64
EPS = 0.1
ORACLES = ("feature_coverage", "weighted_coverage", "saturated_coverage",
           "facility_location", "graph_cut", "log_det", "exemplar",
           "mutual_information")
ENGINES = ("dense", "lazy", "fused")


def instance(name, seed=0, n=N, d=D, k=K):
    """(rows (n, d) f32 numpy, the JAX oracle, the port's oracle on its
    kernel route, which runs the plain versions on the CPU)."""
    rng = np.random.default_rng(seed)
    if name in ("log_det", "mutual_information"):
        X = rng.standard_normal((n, d)).astype(np.float32)
    elif name == "weighted_coverage":
        X = (rng.random((n, d)) < 0.3).astype(np.float32)
    elif name == "graph_cut":
        X = (rng.integers(0, 9, (n, d)) / 8.0).astype(np.float32)
    elif name == "exemplar":
        X = (rng.integers(0, 9, (n, d)) / 8.0).astype(np.float32)
    else:
        X = ((rng.integers(0, 9, (n, d)) / 8.0) ** 2).astype(np.float32)
    ref = (rng.integers(0, 8, (24, d)) / 8.0).astype(np.float32)
    total = X.sum(0)
    if name == "feature_coverage":
        return X, jF.FeatureCoverage(feat_dim=d), \
            interop.feature_coverage(d, use_kernel=True)
    if name == "weighted_coverage":
        return X, jF.WeightedCoverage(feat_dim=d), \
            interop.weighted_coverage(d, use_kernel=True)
    if name == "saturated_coverage":
        return X, jF.SaturatedCoverage(feat_dim=d, total=jnp.asarray(total),
                                       alpha=0.25), \
            interop.saturated_coverage(d, total, 0.25, use_kernel=True)
    if name == "facility_location":
        return X, jF.FacilityLocation(feat_dim=d, reference=jnp.asarray(ref)), \
            interop.facility_location(d, ref, use_kernel=True)
    if name == "exemplar":
        return X, jF.ExemplarClustering(feat_dim=d,
                                        reference=jnp.asarray(ref)), \
            interop.exemplar(d, ref, use_kernel=True)
    if name == "graph_cut":
        return X, jF.GraphCut(feat_dim=d, total=jnp.asarray(total), lam=0.5), \
            interop.graph_cut(d, total, 0.5, use_kernel=True)
    if name == "log_det":
        return X, jF.LogDetDiversity(feat_dim=d, k_max=k, alpha=1.0), \
            interop.log_det(d, k, 1.0, use_kernel=True)
    return X, jF.MutualInformationGaussian(feat_dim=d, k_max=k, noise=1.0), \
        interop.mutual_information(d, k, 1.0, use_kernel=True)


def stream_inputs(X):
    n = X.shape[0]
    return (torch.from_numpy(X), torch.arange(n, dtype=torch.int32),
            torch.ones(n, dtype=torch.bool))


def jax_stream_inputs(X):
    n = X.shape[0]
    return jnp.asarray(X), jnp.arange(n, dtype=jnp.int32), jnp.ones(n, bool)


def jax_sieve_run(jo, jspec, X, chunk_elems=B):
    """JAX's sieve_run, compiled as one program."""
    return jax.jit(lambda f, i, v: jsieve.sieve_run(
        jo, jspec, f, i, v, chunk_elems=chunk_elems))(*jax_stream_inputs(X))


def leaves(state):
    """A SieveState's leaves as numpy arrays (bf16 as its int16 bits), in
    field order: JAX's or the port's."""
    if isinstance(state.sol_ids, torch.Tensor):
        return list(_torch_leaves(state))
    out = [np.asarray(x) for x in jax.tree.leaves(state)]
    return [a.view(np.int16) if a.dtype.name == "bfloat16" else a
            for a in out]


def _torch_leaves(state):
    for x in state:
        if isinstance(x, tuple):
            yield from _torch_leaves(x)
        elif x.dtype == torch.bfloat16:
            yield x.view(torch.int16).numpy()
        else:
            yield x.numpy()


def assert_result(jres, tres, rtol=1e-5):
    np.testing.assert_array_equal(tres.sol_ids.numpy(), np.asarray(jres.sol_ids))
    assert int(tres.sol_size) == int(jres.sol_size)
    assert int(tres.tau_fallback) == int(jres.tau_fallback)
    np.testing.assert_allclose(float(tres.value), float(jres.value), rtol=rtol)


def window_margins(state_v_max, eps=EPS):
    """Float64 distance of log(v_max) / log1p(eps) from the nearest
    integer: where it is below a few float32 ulps, XLA's and torch's
    ``log`` may round the exponent window differently."""
    q = math.log(max(float(state_v_max), 1e-30)) / math.log1p(
        float(np.float32(eps)))
    return abs(q - round(q))


# ---------------------------------------------------------------------------
# the lane helpers
# ---------------------------------------------------------------------------

def _near_integer_sweep(eps):
    """v values whose quotient log(v) / log1p(eps) lies within a few ulps of
    an integer, plus random ones."""
    l1 = np.float32(np.log1p(np.float32(eps)))
    vals = []
    for e in range(-60, 61):
        v = np.float32(np.exp(np.float64(e) * np.float64(l1)))
        for s in range(-3, 4):
            w = v
            for _ in range(abs(s)):
                w = np.nextafter(w, np.float32(np.inf if s > 0 else -np.inf))
            vals.append(w)
    rng = np.random.default_rng(0)
    vals += list((rng.random(400) * 100).astype(np.float32))
    return np.asarray(vals, np.float32)


@pytest.mark.parametrize("eps", [0.1, 0.12, 0.15])
def test_lane_helpers_match_jax(eps):
    """lane_window_lo in float32, in the order of the JAX package's
    compiled sieve (XLA multiplies log(v) by the float32 reciprocal of
    log1p(eps)): equal to JAX's compiled helper bit for bit wherever both
    packages' float32 log(v) agree.  Where the two log implementations
    differ by an ulp, the exponents may part only when the float64 quotient
    sits within two ulps of log(v), over log1p(eps), of an integer
    (asserted).  The division itself, or a
    float64 log1p(eps) rounded to float32, parts from JAX on cases the
    port's order holds."""
    assert tgrids.lane_count(64, 0.15) == jgrids.lane_count(64, 0.15) == 37
    for k in (4, 8, 64, 120):
        assert tgrids.lane_count(k, eps) == jgrids.lane_count(k, eps)
    l1_jax = np.asarray(jnp.log1p(eps))
    assert tgrids._log1p32(eps, "cpu").numpy().tobytes() == l1_jax.tobytes()
    vals = _near_integer_sweep(eps)
    j_lo = np.asarray(jax.jit(jax.vmap(
        lambda v: jgrids.lane_window_lo(v, eps)))(jnp.asarray(vals)))
    t_lo = tgrids.lane_window_lo(torch.from_numpy(vals), eps).numpy()
    j_log = np.asarray(jnp.log(jnp.asarray(vals)))
    t_log = torch.log(torch.from_numpy(vals)).numpy()
    same_log = j_log.view(np.uint32) == t_log.view(np.uint32)
    np.testing.assert_array_equal(t_lo[same_log], j_lo[same_log])
    q64 = np.log(vals.astype(np.float64)) / np.log1p(np.float64(np.float32(eps)))
    margin = np.abs(q64 - np.round(q64))
    parted = t_lo != j_lo
    band = 2 * np.spacing(np.abs(j_log)).astype(np.float64) / l1_jax
    assert (margin[parted] <= band[parted]).all(), margin[parted]
    near = same_log & (margin < 1e-5)
    assert near.sum() >= 50          # the sweep holds near-integer cases
    logs = t_log[near]
    divided = np.ceil(logs / l1_jax).astype(np.int32)
    f64 = np.ceil(logs / np.float32(math.log1p(eps))).astype(np.int32)
    assert (divided != j_lo[near]).any() or (f64 != j_lo[near]).any()

    lo = torch.tensor([-7, 0, 3, 41], dtype=torch.int32)
    for L in (1, 5, 32, 37):
        got = torch.stack([tgrids.lane_exponents(x, L) for x in lo]).numpy()
        want = np.stack([np.asarray(jgrids.lane_exponents(jnp.int32(int(x)),
                                                          L)) for x in lo])
        np.testing.assert_array_equal(got, want)
    exps = jnp.arange(-40, 40, dtype=jnp.int32)
    for k, active in ((K, True), (6, True), (K, False)):
        want = np.asarray(jax.jit(lambda e, a: jgrids.lane_taus(
            e, k, eps, a))(exps, jnp.bool_(active)))
        got = tgrids.lane_taus(torch.arange(-40, 40, dtype=torch.int32), k,
                               eps, torch.tensor(active)).numpy()
        # exp may differ by an ulp between the two packages
        np.testing.assert_allclose(got, want, rtol=2.4e-7)


# ---------------------------------------------------------------------------
# sieve_update chunk by chunk
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,engine", [("feature_coverage", "dense"),
                                         ("facility_location", "fused"),
                                         ("log_det", "lazy")])
def test_sieve_update_per_chunk_matches_jax(name, engine):
    X, jo, to = instance(name, seed=3)
    jspec = jsieve.SieveSpec(k=K, eps=EPS, engine=engine, chunk=16)
    tspec = interop.sieve_spec(jspec)
    jupd = jax.jit(lambda st, f, i, v: jsieve.sieve_update(jo, jspec, st, f,
                                                           i, v))
    jst = jsieve.sieve_init(jo, jspec, D)
    tst = tsieve.sieve_init(to, tspec, D)
    jf, ji, jv = (a.reshape((-1, B) + a.shape[1:])
                  for a in jax_stream_inputs(X))
    tf, ti, tv = (a.reshape((-1, B) + a.shape[1:])
                  for a in stream_inputs(X))
    for c in range(N // B):
        jst = jupd(jst, jf[c], ji[c], jv[c])
        tst = tsieve.sieve_update(to, tspec, tst, tf[c], ti[c], tv[c])
        assert window_margins(jst.v_max) > 1e-5
        for field in ("exps", "sol_ids", "sol_sizes", "top_ids", "sol_feats",
                      "top_feats", "n_seen"):
            np.testing.assert_array_equal(getattr(tst, field).numpy(),
                                          np.asarray(getattr(jst, field)),
                                          err_msg=f"chunk {c} {field}")
        np.testing.assert_allclose(float(tst.v_max), float(jst.v_max),
                                   rtol=1e-6)
        np.testing.assert_allclose(tst.top_vals.numpy(),
                                   np.asarray(jst.top_vals), rtol=1e-6)


# ---------------------------------------------------------------------------
# sieve_run: every oracle, every engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("name", ORACLES)
def test_sieve_run_matches_jax(name, engine):
    X, jo, to = instance(name, seed=1)
    jspec = jsieve.SieveSpec(k=K, eps=EPS, engine=engine, chunk=16)
    jres, jst = jax_sieve_run(jo, jspec, X)
    tres, tst = tsieve.sieve_run(to, interop.sieve_spec(jspec),
                                 *stream_inputs(X), chunk_elems=B)
    assert window_margins(jst.v_max) > 1e-5
    assert_result(jres, tres)
    np.testing.assert_array_equal(tst.sol_ids.numpy(), np.asarray(jst.sol_ids))
    np.testing.assert_array_equal(tst.exps.numpy(), np.asarray(jst.exps))
    # the one-pass floor against sequential greedy (<= OPT)
    _, _, gval = tseq.greedy(to, torch.from_numpy(X),
                             torch.ones(N, dtype=torch.bool), K)
    assert float(tres.value) >= (0.5 - EPS) * float(gval) - 1e-5
    sel = tres.sol_ids[:int(tres.sol_size)].tolist()
    assert len(set(sel)) == len(sel) and min(sel) >= 0 and max(sel) < N


@pytest.mark.parametrize("engine", ["dense", "fused"])
def test_mi_finish_is_half_of_log_det(engine):
    """MI at noise 1 is exactly half of log-det, and the sieve's finish is
    scale-equivariant: MI finishing log-det's live state (its v_max and
    logdet halved, exactly) gives log-det's finish ids at exactly half the
    value.  The streams themselves run other thresholds (the lane grid sits
    at absolute powers of 1 + eps), so they need not agree; v_max does."""
    X, _, ld = instance("log_det", seed=1)
    _, _, mi = instance("mutual_information", seed=1)
    spec = tsieve.SieveSpec(k=K, eps=EPS, engine=engine, chunk=16)
    r_ld, st = tsieve.sieve_run(ld, spec, *stream_inputs(X), chunk_elems=B)
    _, st_mi = tsieve.sieve_run(mi, spec, *stream_inputs(X), chunk_elems=B)
    assert float(st_mi.v_max) == 0.5 * float(st.v_max)
    U, logdet, size = st.oracle_states
    half = st._replace(v_max=st.v_max * 0.5,
                       oracle_states=(U, logdet * 0.5, size))
    r_half = tsieve.sieve_finish(mi, spec, half)
    assert torch.equal(r_half.sol_ids, r_ld.sol_ids)
    assert float(r_half.value) == 0.5 * float(r_ld.value)


# ---------------------------------------------------------------------------
# constraints, precision, budgets
# ---------------------------------------------------------------------------

def _constraint(kind, n=N, seed=5):
    rng = np.random.default_rng(seed)
    if kind == "knapsack":
        costs = (rng.integers(4, 17, n) / 8.0).astype(np.float32)
        return (jcons.Knapsack(costs=jnp.asarray(costs), budget=5.0),
                interop.knapsack(costs, 5.0), costs)
    if kind == "partition":
        parts = rng.integers(0, 3, n).astype(np.int32)
        caps = np.array([2, 3, 1], np.int32)
        return (jcons.PartitionMatroid(parts=jnp.asarray(parts),
                                       capacities=jnp.asarray(caps)),
                interop.partition_matroid(parts, caps), (parts, caps))
    return jcons.Cardinality(), tcons.Cardinality(), None


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("kind", ["cardinality", "knapsack", "partition"])
def test_constrained_sieve_matches_jax(kind, engine):
    X, jo, to = instance("feature_coverage", seed=4)
    jcn, tcn, data = _constraint(kind)
    jspec = jsieve.SieveSpec(k=K, eps=EPS, engine=engine, chunk=16,
                             constraint=jcn)
    jres, _ = jax_sieve_run(jo, jspec, X)
    tres, tst = tsieve.sieve_run(to, interop.sieve_spec(jspec, tcn),
                                 *stream_inputs(X), chunk_elems=B)
    assert_result(jres, tres)
    ids = tres.sol_ids[:int(tres.sol_size)].numpy()
    if kind == "knapsack":
        assert float(data[ids].astype(np.float64).sum()) <= 5.0
    elif kind == "partition":
        parts, caps = data
        assert (np.bincount(parts[ids], minlength=3) <= caps).all()
    else:
        plain, pst = tsieve.sieve_run(
            to, tsieve.SieveSpec(k=K, eps=EPS, engine=engine, chunk=16),
            *stream_inputs(X), chunk_elems=B)
        assert torch.equal(plain.sol_ids, tres.sol_ids)
        assert plain.value.numpy().tobytes() == tres.value.numpy().tobytes()
        assert tst.cstates == () and pst.cstates == ()
        for a, b in zip(leaves(pst), leaves(tst)):
            assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("name", ["feature_coverage", "facility_location"])
def test_bf16_pools_match_jax(name):
    """bf16 storage: the carried pools are bf16 and bit for bit JAX's, the
    selection JAX's."""
    X, jo, to = instance(name, seed=6)
    jspec = jsieve.SieveSpec(k=K, eps=EPS, precision="bf16")
    if name == "facility_location":
        ref = np.asarray(jo.reference)
        jo = jF.FacilityLocation(feat_dim=D,
                                 reference=jnp.asarray(ref, jnp.bfloat16))
        to = interop.facility_location(D, np.asarray(jo.reference),
                                       use_kernel=True)
    jres, jst = jax_sieve_run(jo, jspec, X)
    tres, tst = tsieve.sieve_run(to, interop.sieve_spec(jspec),
                                 *stream_inputs(X), chunk_elems=B)
    assert tst.sol_feats.dtype == tst.top_feats.dtype == torch.bfloat16
    assert_result(jres, tres)
    for field in ("sol_feats", "top_feats"):
        np.testing.assert_array_equal(
            getattr(tst, field).view(torch.int16).numpy(),
            np.asarray(getattr(jst, field)).view(np.int16))


@pytest.mark.parametrize("engine", ["dense", "fused"])
def test_k_dyn_budgets_match_jax(engine):
    X, jo, to = instance("feature_coverage", seed=7)
    jspec = jsieve.SieveSpec(k=K, eps=EPS, engine=engine, chunk=16)
    _, jst = jax_sieve_run(jo, jspec, X)
    jfinish = jax.jit(lambda st, kq: jsieve.sieve_finish(jo, jspec, st,
                                                         k_dyn=kq))
    tspec = interop.sieve_spec(jspec)
    _, tst = tsieve.sieve_run(to, tspec, *stream_inputs(X), chunk_elems=B)
    for kq in (0, 1, 3, K - 1, K):
        jres = jfinish(jst, jnp.int32(kq))
        tres = tsieve.sieve_finish(to, tspec, tst,
                                   k_dyn=torch.tensor(kq, dtype=torch.int32))
        assert_result(jres, tres)
        assert int(tres.sol_size) <= kq
        assert_result(jres, tsieve.sieve_finish(to, tspec, tst, k_dyn=kq))


def test_greedy_k_dyn_matches_jax():
    X, jo, to = instance("graph_cut", seed=8)
    valid = np.ones(N, bool)
    valid[::5] = False
    ids = np.arange(1000, 1000 + N, dtype=np.int32)
    for kq in (None, 0, 2, 5, K):
        jout = jseq.greedy(jo, jnp.asarray(X), jnp.asarray(valid), K,
                           ids=jnp.asarray(ids), k_dyn=kq)
        tout = tseq.greedy(to, torch.from_numpy(X), torch.from_numpy(valid),
                           K, ids=torch.from_numpy(ids), k_dyn=kq)
        np.testing.assert_array_equal(tout[0].numpy(), np.asarray(jout[0]))
        assert int(tout[1]) == int(jout[1])
        np.testing.assert_allclose(float(tout[2]), float(jout[2]), rtol=1e-6)


# ---------------------------------------------------------------------------
# determinism, reseeding, ties, dedupe
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["feature_coverage", "log_det"])
def test_replay_is_bit_identical(name):
    X, _, to = instance(name, seed=2, n=192)
    spec = tsieve.SieveSpec(k=6, eps=0.12, engine="fused", chunk=16)
    ra, sa = tsieve.sieve_run(to, spec, *stream_inputs(X), chunk_elems=48)
    rb, sb = tsieve.sieve_run(to, spec, *stream_inputs(X), chunk_elems=48)
    assert torch.equal(ra.sol_ids, rb.sol_ids)
    assert ra.value.numpy().tobytes() == rb.value.numpy().tobytes()
    for a, b in zip(leaves(sa), leaves(sb)):
        assert a.tobytes() == b.tobytes()


def test_sieve_reseeds_as_v_grows():
    """An increasing stream (each element's singleton dwarfs everything
    before it) slides the lane window, reseeding lanes, and still ends with
    a full solution: JAX's ids, exponents and value."""
    n, d, k = 64, 4, 4
    X = (np.ones((n, d), np.float32)
         * (2.0 ** np.arange(n, dtype=np.float32) / 8.0)[:, None])
    jo, to = jF.FeatureCoverage(feat_dim=d), interop.feature_coverage(d)
    jspec = jsieve.SieveSpec(k=k, eps=0.1)
    jres, jst = jax_sieve_run(jo, jspec, X, chunk_elems=8)
    tspec = interop.sieve_spec(jspec)
    tst = tsieve.sieve_init(to, tspec, d)
    seen = set()
    for f, i, v in zip(*tsieve.sieve_chunks(*stream_inputs(X), 8)):
        tst = tsieve.sieve_update(to, tspec, tst, f, i, v)
        seen |= set(tst.exps.tolist())
    tres = tsieve.sieve_finish(to, tspec, tst)
    assert len(seen) > tspec.lanes        # lanes were reseeded
    assert_result(jres, tres)
    np.testing.assert_array_equal(tst.exps.numpy(), np.asarray(jst.exps))
    assert int(tres.sol_size) == k and float(tst.v_max) > 0
    _, _, gval = tseq.greedy(to, torch.from_numpy(X),
                             torch.ones(n, dtype=torch.bool), k)
    assert float(tres.value) >= (0.5 - 0.1) * float(gval) - 1e-5


def test_reservoir_ties_on_duplicate_rows():
    """Duplicate rows tie exactly: the reservoir keeps the lower id first,
    JAX's ``lax.top_k`` rule, chunk after chunk."""
    rng = np.random.default_rng(9)
    base = ((rng.integers(0, 9, (8, D)) / 8.0) ** 2).astype(np.float32)
    X = base[rng.integers(0, 8, N)]
    jo, to = jF.FeatureCoverage(feat_dim=D), interop.feature_coverage(D)
    jspec = jsieve.SieveSpec(k=K, eps=EPS, top_cap=24)
    jres, jst = jax_sieve_run(jo, jspec, X)
    tres, tst = tsieve.sieve_run(to, interop.sieve_spec(jspec),
                                 *stream_inputs(X), chunk_elems=B)
    np.testing.assert_array_equal(tst.top_ids.numpy(), np.asarray(jst.top_ids))
    np.testing.assert_array_equal(tst.top_vals.numpy(),
                                  np.asarray(jst.top_vals))
    assert_result(jres, tres)
    # the tied values are kept in id order
    v, i = tst.top_vals.numpy(), tst.top_ids.numpy()
    for a in range(len(v) - 1):
        if v[a] == v[a + 1]:
            assert i[a] < i[a + 1]


@pytest.mark.parametrize("seed", range(6))
def test_sort_dedupe_equals_pairwise(seed):
    rng = np.random.default_rng(seed)
    P = int(rng.integers(1, 400))
    ids = torch.from_numpy(rng.integers(-1, max(2, P // 3), P)
                           .astype(np.int32))
    valid = torch.from_numpy(rng.random(P) < 0.7) & (ids >= 0)
    if seed % 2:
        valid = torch.from_numpy(rng.random(P) < 0.7)   # any validity
    assert torch.equal(tsieve.duplicate_mask(ids, valid),
                       tsieve.duplicate_mask_pairwise(ids, valid))


# ---------------------------------------------------------------------------
# one stream, begun in JAX, continued in both packages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("precision,kind", [("f32", "knapsack"),
                                            ("bf16", "cardinality"),
                                            ("f32", "log_det")])
def test_mid_stream_state_carried_from_jax(precision, kind):
    """interop.sieve_state carries a JAX SieveState into the port (bf16
    pools bit for bit); both packages then absorb the rest of the stream
    from that one state and finish alike."""
    name = "log_det" if kind == "log_det" else "feature_coverage"
    X, jo, to = instance(name, seed=11)
    jcn, tcn, _ = (_constraint("knapsack") if kind == "knapsack"
                   else (None, None, None))
    jspec = jsieve.SieveSpec(k=K, eps=EPS, precision=precision,
                             engine="lazy", chunk=16, constraint=jcn)
    tspec = interop.sieve_spec(jspec, tcn)
    jupd = jax.jit(lambda st, f, i, v: jsieve.sieve_update(jo, jspec, st, f,
                                                           i, v))
    jf, ji, jv = (a.reshape((-1, B) + a.shape[1:])
                  for a in jax_stream_inputs(X))
    tf, ti, tv = (a.reshape((-1, B) + a.shape[1:])
                  for a in stream_inputs(X))
    jst = jsieve.sieve_init(jo, jspec, D)
    for c in range(2):
        jst = jupd(jst, jf[c], ji[c], jv[c])
    tst = interop.sieve_state(jax.tree.map(np.asarray, jst), tspec)
    for a, b in zip(leaves(jst), leaves(tst)):
        assert a.tobytes() == b.tobytes()
    for c in range(2, N // B):
        jst = jupd(jst, jf[c], ji[c], jv[c])
        tst = tsieve.sieve_update(to, tspec, tst, tf[c], ti[c], tv[c])
    np.testing.assert_array_equal(tst.sol_ids.numpy(), np.asarray(jst.sol_ids))
    assert_result(jsieve.sieve_finish(jo, jspec, jst),
                  tsieve.sieve_finish(to, tspec, tst))
    with pytest.raises(ValueError, match="sieve_state"):
        interop.sieve_state(jax.tree.map(np.asarray, jst),
                            dataclasses.replace(tspec, k=K + 1))
