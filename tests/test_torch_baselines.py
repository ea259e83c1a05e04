"""The port's distributed baselines against the JAX package, on the CPU:
``rand_greedi`` over a partition, and ``mz_coresets`` with duplication 1
and 2, its permutations derived from the JAX key as the JAX function
derives them.  The same ids and sizes, values within rtol 1e-5, and
equal RoundLog records.  Under duplication both packages may select one
element twice (their central greedy excludes rows, not ids); the port
keeps that, as the reference does.  FeatureCoverage runs on dyadic rows
(a/8)^2, FacilityLocation on (a/8)^2 against b/8, WeightedCoverage on
binary rows.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_mesh import _records, assert_same

from repro.core import FacilityLocation as JFacilityLocation
from repro.core import FeatureCoverage as JFeatureCoverage
from repro.core import WeightedCoverage as JWeightedCoverage
from repro.core import distributed_baselines as jdb
from repro_torch import interop
from repro_torch.core import distributed_baselines as tdb

torch.set_num_threads(2)
jax.config.update("jax_platform_name", "cpu")

N, D, M, K = 512, 8, 4, 6
ORACLES = ("feature_coverage", "facility_location", "weighted_coverage")


def _pair(name, seed):
    """(X, JAX oracle, port oracle) for ``name``."""
    rng = np.random.default_rng(seed)
    if name == "weighted_coverage":
        X = (rng.random((N, D)) < 0.3).astype(np.float32)
        return X, JWeightedCoverage(feat_dim=D), interop.weighted_coverage(
            D, use_kernel=True)
    X = ((rng.integers(0, 9, (N, D)) / 8.0) ** 2).astype(np.float32)
    if name == "feature_coverage":
        return X, JFeatureCoverage(feat_dim=D), interop.feature_coverage(
            D, use_kernel=True)
    R = (rng.integers(0, 9, (24, D)) / 8.0).astype(np.float32)
    return (X, JFacilityLocation(feat_dim=D, reference=jnp.asarray(R)),
            interop.facility_location(D, R, use_kernel=True))


def _consistent(res):
    """ids, size and value from the same solution: |ids >= 0| == size."""
    assert int((res.sol_ids >= 0).sum()) == int(res.sol_size) > 0


@pytest.mark.parametrize("name", ORACLES)
def test_rand_greedi_matches_jax(name):
    X, jo, to = _pair(name, 1)
    fm = X.reshape(M, N // M, D)
    ids = np.arange(N, dtype=np.int32).reshape(M, -1)
    valid = np.ones((M, N // M), bool)
    jres, jlog = jdb.rand_greedi(jo, jnp.asarray(fm), jnp.asarray(ids),
                                 jnp.asarray(valid), K)
    tres, tlog = tdb.rand_greedi(to, *interop.shard(fm, ids, valid), K)
    assert_same(jres, tres)
    assert _records(tlog) == _records(jlog)
    _consistent(tres)


@pytest.mark.parametrize("dup", [1, 2])
@pytest.mark.parametrize("name", ORACLES)
def test_mz_coresets_matches_jax(name, dup):
    X, jo, to = _pair(name, 2)
    ids = np.arange(N, dtype=np.int32)
    valid = np.ones(N, bool)
    key = jax.random.PRNGKey(4)
    jres, jlog = jdb.mz_coresets(jo, jnp.asarray(X), jnp.asarray(ids),
                                 jnp.asarray(valid), K, M, key,
                                 duplication=dup)
    perms, k = [], key
    for _ in range(dup):
        k, kp = jax.random.split(k)
        perms.append(np.asarray(jax.random.permutation(kp, N)))
    tres, tlog = tdb.mz_coresets(to, torch.from_numpy(X),
                                 torch.from_numpy(ids),
                                 torch.from_numpy(valid), K, M, perms=perms,
                                 duplication=dup)
    assert_same(jres, tres)
    assert _records(tlog) == _records(jlog)
    _consistent(tres)
    if name == "feature_coverage" and dup == 2:
        # both packages' central greedy tells rows apart, not ids, so a
        # duplicated element can be picked twice (and counted twice)
        ids = tres.sol_ids.numpy()
        assert len(set(ids.tolist())) < len(ids)


def test_mz_coresets_draws_its_permutations():
    """Without permutations it draws them from the generator: the same
    seed, the same selection; a wrong count of permutations raises."""
    X, _, to = _pair("feature_coverage", 3)
    args = (to, torch.from_numpy(X), torch.arange(N, dtype=torch.int32),
            torch.ones(N, dtype=torch.bool), K, M)
    a, _ = tdb.mz_coresets(*args, generator=torch.Generator().manual_seed(1),
                           duplication=2)
    b, _ = tdb.mz_coresets(*args, generator=torch.Generator().manual_seed(1),
                           duplication=2)
    assert_same(a, b, bits=True)
    _consistent(a)
    with pytest.raises(ValueError, match="permutations"):
        tdb.mz_coresets(*args, perms=[np.arange(N)], duplication=2)
