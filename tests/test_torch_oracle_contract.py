"""Submodularity conformance of the port's oracles: the checks of
tests/test_oracle_contract.py (monotonicity, diminishing returns, chunk
parity, add consistency, nonnegative marginals) at fixed seeds, on the
inputs the shared registry's builders draw (tests/oracle_contract.py), and
the port's ``brute_force`` against the JAX package's.

Both routes of each oracle are checked; on the CPU the kernel route runs
the kernels' plain versions.  Tolerances are those of the JAX suite.
"""

import numpy as np
import pytest
import torch
from oracle_contract import (K_CAP, build_facility_location,
                             build_feature_coverage, build_graph_cut,
                             build_log_det, build_mutual_information,
                             build_saturated_coverage,
                             build_weighted_coverage, distinct_subsets)

from repro.core import sequential as jseq
from repro_torch import interop
from repro_torch.core import sequential as tseq
from repro_torch.states import tree_map

torch.set_num_threads(2)

N, D = 14, 6
NAMES = ("feature_coverage", "facility_location", "weighted_coverage",
         "saturated_coverage", "graph_cut", "log_det", "mutual_information")
BUILDERS = {"feature_coverage": build_feature_coverage,
            "facility_location": build_facility_location,
            "weighted_coverage": build_weighted_coverage,
            "saturated_coverage": build_saturated_coverage,
            "graph_cut": build_graph_cut,
            "log_det": build_log_det,
            "mutual_information": build_mutual_information}


def _build(name, seed, use_kernel=False):
    """The registry's JAX oracle and inputs at ``seed``, with the port's
    oracle over the same data."""
    rng = np.random.default_rng(seed)
    j_oracle, feats = BUILDERS[name](rng, N, D)
    if name == "feature_coverage":
        t_oracle = interop.feature_coverage(D, use_kernel=use_kernel)
    elif name == "facility_location":
        t_oracle = interop.facility_location(
            D, np.asarray(j_oracle.reference), use_kernel=use_kernel)
    elif name == "weighted_coverage":
        t_oracle = interop.weighted_coverage(
            D, np.asarray(j_oracle.weights), use_kernel=use_kernel)
    elif name == "graph_cut":
        t_oracle = interop.graph_cut(D, np.asarray(j_oracle.total),
                                     j_oracle.lam, use_kernel=use_kernel)
    elif name == "log_det":
        t_oracle = interop.log_det(D, j_oracle.k_max, j_oracle.alpha,
                                   use_kernel=use_kernel)
    elif name == "mutual_information":
        t_oracle = interop.mutual_information(D, j_oracle.k_max,
                                              j_oracle.noise,
                                              use_kernel=use_kernel)
    else:
        t_oracle = interop.saturated_coverage(
            D, np.asarray(j_oracle.total), j_oracle.alpha,
            np.asarray(j_oracle.weights), use_kernel=use_kernel)
    return rng, j_oracle, t_oracle, interop.tensor(np.asarray(feats))


def state_of(oracle, feats, subset):
    """The state for S = subset through the chain prep, add, add, ..."""
    st = oracle.init_state()
    if len(subset):
        aux = oracle.prep(st, feats[list(subset)])
        for i in range(len(subset)):
            st = oracle.add(st, aux[i])
    return st


def f_of(oracle, feats, subset):
    return float(oracle.value(state_of(oracle, feats, subset)))


def _tol(*values):
    return 2e-4 * max(1.0, *(abs(v) for v in values))


@pytest.mark.parametrize("name", NAMES)
def test_torch_monotone_submodular_fixed_seeds(name):
    for seed in range(6):
        rng, _, oracle, feats = _build(name, seed)
        A, B, e = distinct_subsets(rng, N, 2, K_CAP - 3)
        fA, fB = f_of(oracle, feats, A), f_of(oracle, feats, B)
        fAe, fBe = f_of(oracle, feats, A + [e]), f_of(oracle, feats, B + [e])
        tol = _tol(fB, fBe)
        assert fAe - fA >= -tol and fBe - fB >= -tol, \
            f"{name}: monotonicity broken (seed={seed})"
        assert (fAe - fA) - (fBe - fB) >= -tol, \
            f"{name}: diminishing returns broken (seed={seed})"


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("name", NAMES)
def test_torch_add_consistency(name, use_kernel):
    """The state-based marginal equals f(S + e) - f(S) for every e, and
    ``add`` lands on a state whose value is f(S) + marginal."""
    _, _, oracle, feats = _build(name, 0, use_kernel)
    S = [1, 4, 9]
    st = state_of(oracle, feats, S)
    aux = oracle.prep(st, feats)
    gains = oracle.marginals(st, aux).numpy()
    fS = f_of(oracle, feats, S)
    for e in range(N):
        if e in S:
            continue
        direct = f_of(oracle, feats, S + [e]) - fS
        np.testing.assert_allclose(gains[e], direct, rtol=3e-4, atol=3e-4)
        st_e = oracle.add(st, aux[e])
        np.testing.assert_allclose(float(oracle.value(st_e)), fS + gains[e],
                                   rtol=3e-4, atol=3e-4)
        # the same shapes and dtypes, leaf by leaf (a tuple for log-det)
        spec = lambda t: (t.shape, t.dtype)  # noqa: E731
        assert tree_map(spec, st_e) == tree_map(spec, st)


@pytest.mark.parametrize("chunk", [1, 5, N])
@pytest.mark.parametrize("name", NAMES)
def test_torch_marginals_chunk_parity(name, chunk):
    """chunk_marginals (the kernel route's fused path) agrees with the
    plain prep + marginals path, on the whole block and on every slice."""
    _, _, plain, feats = _build(name, 3)
    kern = _build(name, 3, use_kernel=True)[2]
    st = state_of(plain, feats, [0, 3])
    dense = plain.marginals(st, plain.prep(st, feats)).numpy()
    np.testing.assert_allclose(kern.chunk_marginals(st, feats).numpy(), dense,
                               rtol=1e-5, atol=1e-5)
    sliced = np.concatenate([kern.chunk_marginals(st, feats[i:i + chunk])
                             .numpy() for i in range(0, N, chunk)])
    np.testing.assert_allclose(sliced, dense, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", NAMES)
def test_torch_marginals_nonnegative(name):
    _, _, oracle, feats = _build(name, 5, use_kernel=True)
    for S in ([], [2], [0, 5, 7, 10]):
        st = state_of(oracle, feats, S)
        gains = oracle.marginals(st, oracle.prep(st, feats)).numpy()
        keep = np.setdiff1d(np.arange(N), S)
        assert gains[keep].min() >= -1e-5


@pytest.mark.parametrize("name", NAMES)
def test_torch_brute_force_matches_jax(name):
    """Exact OPT over the first 8 rows at k = 3: the same subset and value
    as the JAX package's brute_force, and every subset value of the state
    chain equal to the JAX chain's."""
    _, j_oracle, oracle, feats = _build(name, 7)
    best, best_v = tseq.brute_force(oracle, feats[:8], 3)
    j_best, j_best_v = jseq.brute_force(j_oracle, feats[:8].numpy(), 3)
    assert best == tuple(j_best) and len(best) == 3
    np.testing.assert_allclose(best_v, j_best_v, rtol=1e-5)
    assert best_v >= f_of(oracle, feats, [0, 1, 2])
