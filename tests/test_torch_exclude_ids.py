"""The port's ``exclude_ids`` (a sorted search over tiles of C) against the
broadcast test it replaced and against the JAX package, on the CPU.

The mask must be the broadcast's bit for bit: ids absent, duplicated in a
solution and negative (padding), the (C,) and (L, C) forms of the
candidates, and a tile small enough that several tiles run.  Through the
survivor filter it must give what the JAX package gives when it maps its
one-lane filter over the lanes with ``jax.vmap``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import FeatureCoverage as JFeatureCoverage
from repro.core import rounds as jrounds
from repro.core import threshold as jth
from repro_torch import interop
from repro_torch.core import rounds as trounds
from repro_torch.core import threshold as tth

torch.set_num_threads(2)
jax.config.update("jax_platform_name", "cpu")

L, C, K = 5, 3000, 17


def broadcast_mask(cand_ids, cand_valid, sol_ids):
    """The broadcast test that ``exclude_ids`` replaced: an (..., C, k)
    comparison."""
    hit = (cand_ids.unsqueeze(-1) == sol_ids.unsqueeze(-2)).any(-1)
    return cand_valid & ~hit


def _case(seed, per_lane, dtype=np.int32):
    """Candidate ids with negative padding and repeats, and (L, K)
    solutions that hold ids present, absent (beyond the range), repeated
    and -1."""
    rng = np.random.default_rng(seed)
    shape = (L, C) if per_lane else (C,)
    ids = rng.integers(-3, 2 * C, size=shape).astype(dtype)
    valid = rng.random(shape) < 0.8
    sol = rng.integers(-1, 2 * C, size=(L, K)).astype(dtype)
    sol[:, -3:] = -1                      # empty slots
    sol[1, :6] = sol[1, 6]                # one id six times
    sol[2] = 10 * C                       # none present
    sol[3, 0] = ids.reshape(-1)[0]        # the first candidate's id
    return ids, valid, sol


@pytest.mark.parametrize("tile", [1 << 22, 4096, 1])
@pytest.mark.parametrize("per_lane", [False, True])
def test_exclude_ids_equals_the_broadcast(per_lane, tile, monkeypatch):
    monkeypatch.setattr(tth, "EXCLUDE_TILE", tile)
    ids, valid, sol = _case(11, per_lane)
    if tile == 1:   # one candidate a tile: keep the loop short
        ids, valid = ids[..., :40], valid[..., :40]
    args = (torch.from_numpy(ids), torch.from_numpy(valid),
            torch.from_numpy(sol))
    got = tth.exclude_ids(*args)
    want = broadcast_mask(*args)
    assert got.shape == want.shape == (L, ids.shape[-1])
    assert got.dtype == torch.bool
    assert torch.equal(got, want)
    # and one lane's (k,) solution against (C,) candidates
    one = tth.exclude_ids(args[0][..., :], args[1], args[2][1])
    assert torch.equal(one, broadcast_mask(args[0], args[1], args[2][1]))


@pytest.mark.parametrize("case", ["int64 solution", "empty solution",
                                  "no candidates"])
def test_exclude_ids_edge_shapes(case):
    ids, valid, sol = _case(12, False)
    ids_t, valid_t = torch.from_numpy(ids), torch.from_numpy(valid)
    sol_t = torch.from_numpy(sol)
    if case == "int64 solution":
        sol_t = sol_t.to(torch.int64)
    elif case == "empty solution":
        sol_t = sol_t[:, :0]
    else:
        ids_t, valid_t = ids_t[:0], valid_t[:0]
    got = tth.exclude_ids(ids_t, valid_t, sol_t)
    assert torch.equal(got, broadcast_mask(ids_t, valid_t, sol_t))


@pytest.mark.parametrize("per_lane", [False, True])
def test_exclude_ids_matches_jax_vmap(per_lane, monkeypatch):
    """The port's (L, C) mask against ``jax.vmap`` of the JAX package's
    one-lane test, with several tiles."""
    monkeypatch.setattr(tth, "EXCLUDE_TILE", 2048)
    ids, valid, sol = _case(13, per_lane)
    got = tth.exclude_ids(interop.tensor(ids), interop.tensor(valid),
                          interop.tensor(sol))
    want = jax.vmap(jth.exclude_ids, in_axes=(0 if per_lane else None,
                                              0 if per_lane else None, 0))(
        jnp.asarray(ids), jnp.asarray(valid), jnp.asarray(sol))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_survivor_filter_matches_jax_vmap(monkeypatch):
    """rounds.local_filter, whose id test takes the whole flattened shard
    against (L, k) solutions, against the JAX filter mapped over the m
    machines and then over the L lanes (its rounds.py vmaps)."""
    monkeypatch.setattr(tth, "EXCLUDE_TILE", 1024)
    m, n, d, cap, k = 4, 600, 8, 64, 12
    rng = np.random.default_rng(14)
    feats = rng.random((m, n, d)).astype(np.float32) ** 2
    ids = np.arange(m * n, dtype=np.int32).reshape(m, n)
    valid = rng.random((m, n)) < 0.9
    sol = np.full((L, k), -1, np.int32)
    size = np.zeros(L, np.int32)
    st = np.zeros((L, d), np.float32)
    for lane in range(L):
        s = int(rng.integers(0, k + 1)) if lane else k   # lane 0 is full
        pick = rng.choice(m * n, size=s, replace=False).astype(np.int32)
        sol[lane, :s] = pick
        size[lane] = s
        st[lane] = feats.reshape(-1, d)[pick].sum(0)
    tau = np.linspace(0.05, 0.6, L).astype(np.float32)

    joracle = JFeatureCoverage(feat_dim=d)

    def one_lane(st_l, sol_l, size_l, tau_l):
        return jax.vmap(lambda f, i, v: jrounds.local_filter(
            joracle, st_l, sol_l, f, i, v, tau_l, cap, size=size_l, k=k))(
            jnp.asarray(feats), jnp.asarray(ids), jnp.asarray(valid))

    want = jax.vmap(one_lane)(jnp.asarray(st), jnp.asarray(sol),
                              jnp.asarray(size), jnp.asarray(tau))
    got = trounds.local_filter(
        interop.feature_coverage(d), interop.tensor(st), interop.tensor(sol),
        interop.tensor(size), interop.tensor(feats), interop.tensor(ids),
        interop.tensor(valid), interop.tensor(tau), cap, k)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert int(got[2][0].sum()) == 0            # a full lane sends nothing
    assert int(got[2].sum()) > 0
