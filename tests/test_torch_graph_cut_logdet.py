"""The GraphCut, LogDetDiversity and MutualInformationGaussian slice of the
port against the JAX package, on the CPU: the kernels' plain versions, the
oracles and the engines.

On the CPU the port's kernel wrappers run their plain PyTorch versions
(repro_torch.kernels.ref); they are held here against the JAX reference
(repro.kernels.ref) and the Pallas kernels in interpret mode
(repro.kernels.ops), in f32 and bf16 and in every lane mode.

Tolerances.
- GraphCut on dyadic rows (a/8, a in 0..8) with lam = 0.5 and a dyadic
  total and state: every product and sum is exact in f32 in any order, so
  gains, states and ids must be equal.  On random floats rtol/atol 1e-5.
- Log-det gains, bases and values: rtol 1e-5, atol 1e-4 (the JAX package's
  own, tests/test_kernels.py:352-353).  Ids must be equal, and each engine
  run is replayed in float64 (``replay_first``): every accepted gain clears
  tau, and every row passed over falls short of it, by more than MARGIN, so
  that an id mismatch cannot be put down to rounding.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import GraphCut as JGraphCut
from repro.core import LogDetDiversity as JLogDet
from repro.core import MutualInformationGaussian as JMI
from repro.core import threshold as jth
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch import interop
from repro_torch.core import threshold as tth
from repro_torch.kernels import graph_cut_accept as tga
from repro_torch.kernels import graph_cut_marginals as tgm
from repro_torch.kernels import logdet_accept as tla
from repro_torch.kernels import logdet_marginals as tlm
from repro_torch.kernels import ops

torch.set_num_threads(2)
jax.config.update("jax_platform_name", "cpu")

GC_TOL = 1e-5                   # GraphCut on random floats
LD_RTOL, LD_ATOL = 1e-5, 1e-4   # log-det gains, bases, values
MARGIN = 1e-5                   # float64 margin of every id decision
L, C, D, K = 4, 40, 16, 8
ORACLES = ("graph_cut", "log_det", "mutual_information")


def _bf16(a):
    return np.asarray(jnp.asarray(a, jnp.bfloat16))


def _t(a):
    return None if a is None else interop.tensor(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


def _dyadic(rng, shape, dtype="f32"):
    x = (rng.integers(0, 9, shape) / 8.0).astype(np.float32)
    return _bf16(x) if dtype == "bf16" else x


def _normal(rng, shape, dtype="f32"):
    x = (rng.standard_normal(shape) * 0.5).astype(np.float32)
    return _bf16(x) if dtype == "bf16" else x


def _lanes_of(mode, x, state):
    """The (x, state) of each lane's unbatched call."""
    if mode == "unbatched":
        return [(x, state)]
    return [(x[lane] if mode == "per_lane" else x, state[lane])
            for lane in range(L)]


def jax_basis(rng, sizes, k, d, alpha=1.0, scale=1.0):
    """JAX log-det states (U, logdet, size), one per entry of ``sizes``,
    built by the JAX oracle's own ``add`` from random rows; stacked over
    lanes as numpy arrays."""
    cls = JLogDet if scale == 1.0 else JMI
    kw = dict(alpha=alpha) if scale == 1.0 else dict(noise=alpha ** -0.5)
    jo = cls(feat_dim=d, k_max=k, **kw)
    states = []
    for n in sizes:
        st = jo.init_state()
        for _ in range(n):
            st = jo.add(st, jnp.asarray(_normal(rng, d)))
        states.append([np.asarray(a) for a in st])
    return tuple(np.stack(a) for a in zip(*states))


# ---------------------------------------------------------------------------
# kernel twins
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("mode", ["unbatched", "shared", "per_lane"])
def test_graph_cut_marginals_twin_matches_jax(mode, dtype):
    rng = np.random.default_rng(1)
    x = _dyadic(rng, (L, C, D) if mode == "per_lane" else (C, D), dtype)
    total = (rng.integers(0, 64, D) / 2.0).astype(np.float32)
    # 2 lam s from 0 to 1.25 t: the redundancy term cancels none, part, all
    # or more than all of the linear one
    frac = (rng.integers(3, 6, D) if mode == "unbatched"
            else np.array([0, 2, 4, 5])[:, None]) / 4.0
    state = (total * frac).astype(np.float32)
    got = ops.graph_cut_marginals(_t(x), _t(total), _t(state), 0.5).numpy()
    assert mode == "unbatched" or ((got < 0).any() and (got > 0).any())
    got = got.reshape(-1, C)
    for lane, (a, s) in enumerate(_lanes_of(mode, x, state)):
        for fn in (jref.graph_cut_marginals, jops.graph_cut_marginals):
            np.testing.assert_array_equal(
                got[lane], np.asarray(fn(_j(a), _j(total), _j(s), 0.5)))
    # random floats: to rtol/atol 1e-5
    xr = (rng.random(x.shape) ** 2).astype(np.float32)
    got = ops.graph_cut_marginals(_t(xr), _t(total), _t(state), 0.3).numpy()
    got = got.reshape(-1, C)
    for lane, (a, s) in enumerate(_lanes_of(mode, xr, state)):
        np.testing.assert_allclose(
            got[lane], np.asarray(jref.graph_cut_marginals(
                _j(a), _j(total), _j(s), 0.3)), rtol=GC_TOL, atol=GC_TOL)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("budget", [64, 3])
def test_graph_cut_accept_twin_matches_jax(dtype, budget):
    rng = np.random.default_rng(2)
    B, d = 24, 12
    x = _dyadic(rng, (B, d), dtype)
    total = (rng.integers(0, 64, d) / 2.0).astype(np.float32)
    state = (rng.integers(0, 32, d) / 4.0).astype(np.float32)
    elig = rng.random(B) < 0.8
    tau = np.float32(np.median(jref.graph_cut_marginals(
        _j(x), _j(total), _j(state), 0.5)))
    got = ops.graph_cut_accept(_t(x), _t(total), _t(state), _t(elig),
                               torch.tensor(tau),
                               torch.tensor(budget, dtype=torch.int32))
    assert got[0].any()
    if budget == 3:
        assert int(got[0].sum()) == 3   # the budget cut the sweep
    args = (_j(x), _j(total), _j(state), _j(elig), _j(tau),
            jnp.asarray(budget, jnp.int32))
    for want in (jref.graph_cut_accept(*args, 0.5),
                 jops.graph_cut_accept(*args, 0.5)):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _check_ld(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=LD_RTOL, atol=LD_ATOL)


@pytest.mark.parametrize("scale", [1.0, 0.5])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("mode", ["unbatched", "shared", "per_lane"])
def test_logdet_marginals_twin_matches_jax(mode, dtype, scale):
    """Mid-selection bases carried from the JAX oracle (sizes 0, some and
    k_max), gains against the JAX reference and the Pallas kernel."""
    rng = np.random.default_rng(3)
    x = _normal(rng, (L, C, D) if mode == "per_lane" else (C, D), dtype)
    U, _, _ = jax_basis(rng, [K, 0, 3, K - 1], K, D, alpha=1.5)
    if mode == "unbatched":
        U = U[0]
    got = ops.logdet_marginals(_t(x), _t(U), 1.5, scale).numpy()
    got = got.reshape(-1, C)
    for lane, (a, u) in enumerate(_lanes_of(mode, x, U)):
        _check_ld(got[lane], jref.logdet_marginals(_j(a), _j(u), 1.5,
                                                   scale=scale))
        _check_ld(got[lane], jops.logdet_marginals(_j(a), _j(u), 1.5,
                                                   scale=scale))
        # each lane of a batched call equals the unbatched call
        one = ops.logdet_marginals(_t(a), _t(u), 1.5, scale).numpy()
        np.testing.assert_array_equal(got[lane], one)


def _logdet_accept_case(seed, lanes, B, d, k, sizes):
    rng = np.random.default_rng(seed)
    x = _normal(rng, (lanes, B, d))
    U, ld, sz = jax_basis(rng, sizes, k, d)
    elig = rng.random((lanes, B)) < 0.8
    return x, U, ld, sz, elig


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("scale", [1.0, 0.5])
def test_logdet_accept_twin_matches_jax(dtype, scale):
    """Lane by lane against the JAX reference sweep and the Pallas kernel,
    from bases of size 0, 2, k - 2 and k, with budgets that let the
    appends run into k_max (k = 8, so the Pallas kernel's scratch has no
    padded rows either and drops them too)."""
    B = 20
    x, U, ld, sz, elig = _logdet_accept_case(4, L, B, D, K,
                                             [0, 2, K - 2, K])
    if dtype == "bf16":
        x = _bf16(x)
    tau = np.array([0.0, 0.5, 0.0, 0.2], np.float32) * scale
    bud = np.array([64, 3, 64, 64], np.int32)
    got = ops.logdet_accept(_t(x), *interop.logdet_state(U, ld, sz),
                            _t(elig), _t(tau), _t(bud), 1.0, scale)
    mask, size = got[0].numpy(), got[3].numpy()
    assert mask[0].any() and int(mask[1].sum()) == 3
    assert size[2] > K and size[3] > K    # appends past k_max were dropped
    for lane in range(L):
        args = (_j(x[lane]), _j(U[lane]), _j(ld[lane]), _j(sz[lane]),
                _j(elig[lane]), _j(tau[lane]), _j(bud[lane]))
        for want in (jref.logdet_accept(*args, alpha=1.0, scale=scale),
                     jops.logdet_accept(*args, alpha=1.0, scale=scale)):
            np.testing.assert_array_equal(mask[lane], np.asarray(want[0]))
            assert int(size[lane]) == int(want[3])
            for g, w in zip((got[1], got[2], got[4]),
                            (want[1], want[2], want[4])):
                _check_ld(g[lane].numpy(), w)
    # an unbatched call equals its lane of the batched one
    one = ops.logdet_accept(_t(x[2]), *interop.logdet_state(U[2], ld[2], sz[2]),
                            _t(elig[2]), tau[2], bud[2], 1.0, scale)
    for g, o in zip(got, one):
        np.testing.assert_array_equal(g[2].numpy(), o.numpy())
    # the full lane's basis is the one it started with
    np.testing.assert_array_equal(got[1][3].numpy(), U[3])


def test_wrappers_refuse_cpu_and_count_nothing_on_cpu():
    ops.reset_launch_counts()
    x, st, t = torch.rand(8, 4), torch.rand(4), torch.rand(4)
    U, ld, sz = torch.zeros(3, 4), torch.zeros(()), torch.zeros((),
                                                              dtype=torch.int32)
    elig = torch.ones(8, dtype=torch.bool)
    with pytest.raises(ValueError, match="CUDA"):
        tgm.graph_cut_marginals(x, t, st)
    with pytest.raises(ValueError, match="CUDA"):
        tga.graph_cut_accept(x, t, st, elig, 0.1, 2)
    with pytest.raises(ValueError, match="CUDA"):
        tlm.logdet_marginals(x, U)
    with pytest.raises(ValueError, match="CUDA"):
        tla.logdet_accept(x, U, ld, sz, elig, 0.1, 2)
    for oracle in (interop.graph_cut(4, t.numpy(), use_kernel=True),
                   interop.log_det(4, 3, use_kernel=True),
                   interop.mutual_information(4, 3, use_kernel=True)):
        s2 = oracle.init_state(2)
        oracle.marginals(s2, oracle.prep(s2, x))
        oracle.chunk_marginals(s2, x[None].expand(2, 8, 4))
        oracle.chunk_accept(s2, x[None].expand(2, 8, 4),
                            torch.ones(2, 8, dtype=torch.bool),
                            torch.tensor([0.1, 0.2]),
                            torch.tensor([4, 4], dtype=torch.int32))
    assert set(ops.launch_counts().values()) == {0}
    # the sweep's basis lives in shared memory: 64 x 256 fits, 256 x 256
    # does not (the wrapper refuses it before it launches)
    assert tla.smem_bytes(64, 256) <= tla.SMEM_LIMIT
    assert tla.smem_bytes(256, 256) > tla.SMEM_LIMIT


@pytest.mark.parametrize("lam", [0.5, np.float32(0.5), torch.tensor(0.5)],
                         ids=["float", "np_float32", "tensor_0d"])
def test_graph_cut_scalar_lam_keeps_the_kernel_route(lam, monkeypatch):
    """Any one-number lam becomes a Python float, and use_kernel sends both
    hot calls through ops (which takes the plain version only because the
    tensors lie on the CPU)."""
    seen = []
    for fn in ("graph_cut_marginals", "graph_cut_accept"):
        def spy(*args, _fn=getattr(ops, fn), _name=fn, **kw):
            seen.append((_name, args[-1]))
            return _fn(*args, **kw)
        monkeypatch.setattr(ops, fn, spy)
    x, t = torch.rand(8, 4), torch.rand(4)
    oracle = interop.graph_cut(4, t.numpy(), lam, use_kernel=True)
    assert type(oracle.lam) is float and oracle.lam == 0.5
    s2 = oracle.init_state(2)
    oracle.marginals(s2, oracle.prep(s2, x))
    oracle.chunk_accept(s2, x[None].expand(2, 8, 4),
                        torch.ones(2, 8, dtype=torch.bool),
                        torch.tensor([0.1, 0.2]),
                        torch.tensor([4, 4], dtype=torch.int32))
    assert seen == [("graph_cut_marginals", 0.5), ("graph_cut_accept", 0.5)]


@pytest.mark.parametrize("lam", [torch.tensor([0.5, 0.25]),
                                 np.array([0.5, 0.25]), None],
                         ids=["tensor_2", "array_2", "none"])
def test_graph_cut_refuses_a_lam_that_is_not_one_scalar(lam):
    with pytest.raises(ValueError, match="one scalar"):
        interop.graph_cut(4, np.ones(4, np.float32), lam)


# ---------------------------------------------------------------------------
# the oracles
# ---------------------------------------------------------------------------

def _oracle_pair(name, d, use_kernel, total=None, k_max=K, noise=0.7,
                 alpha=1.0):
    """The JAX oracle (on the same route) and the port's."""
    if name == "graph_cut":
        return (JGraphCut(feat_dim=d, total=jnp.asarray(total), lam=0.5,
                          use_kernel=use_kernel),
                interop.graph_cut(d, total, 0.5, use_kernel=use_kernel))
    if name == "log_det":
        return (JLogDet(feat_dim=d, k_max=k_max, alpha=alpha,
                        use_kernel=use_kernel),
                interop.log_det(d, k_max, alpha, use_kernel=use_kernel))
    return (JMI(feat_dim=d, k_max=k_max, noise=noise, use_kernel=use_kernel),
            interop.mutual_information(d, k_max, noise,
                                       use_kernel=use_kernel))


def _np_state(st):
    return (tuple(np.asarray(a) for a in st) if isinstance(st, tuple)
            else np.asarray(st))


def _port_state(st):
    return (interop.logdet_state(*st) if isinstance(st, tuple)
            else _t(np.asarray(st)))


def _stack(states):
    if isinstance(states[0], tuple):
        return tuple(np.stack(a) for a in zip(*states))
    return np.stack(states)


def _assert_state(name, got, want, exact):
    if name == "graph_cut":
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        return
    U, ld, sz = got
    np.testing.assert_array_equal(sz.numpy(), np.asarray(want[2]))
    for g, w in ((U, want[0]), (ld, want[1])):
        if exact:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        else:
            _check_ld(g.numpy(), w)


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("name", ORACLES)
def test_oracle_matches_jax(name, use_kernel):
    """init_state, add (unbatched and over lanes), marginals,
    chunk_marginals and value against the JAX oracle at mid-selection
    states."""
    rng = np.random.default_rng(6)
    x = _dyadic(rng, (C, D)) if name == "graph_cut" else _normal(rng, (C, D))
    jo, to = _oracle_pair(name, D, use_kernel, total=x.sum(0))
    j0 = _np_state(jo.init_state())
    _assert_state(name, to.init_state(), j0, exact=True)
    _assert_state(name, to.init_state(L), _stack([j0] * L), exact=True)
    states = []
    for lane in range(L):
        s = jo.init_state()
        for i in rng.choice(C, 2 * lane if name == "graph_cut" else
                            [0, 3, K - 1, K][lane], replace=False):
            s = jo.add(s, jnp.asarray(x[i]))
        states.append(_np_state(s))
    tst = _port_state(_stack(states))
    for lane in range(L):
        i = int(rng.integers(C))
        want = _np_state(jo.add(jax.tree.map(jnp.asarray, states[lane]),
                                jnp.asarray(x[i])))
        _assert_state(name, to.add(_port_state(states[lane]), _t(x[i])),
                      want, exact=name == "graph_cut")
        rows = torch.stack([_t(x[i])] * L)
        _assert_state(name, jax_lane(to.add(tst, rows), lane), want,
                      exact=name == "graph_cut")
    want = np.stack([np.asarray(jo.marginals(
        jax.tree.map(jnp.asarray, s), jnp.asarray(x))) for s in states])
    for got in (to.marginals(tst, to.prep(tst, _t(x))),
                to.chunk_marginals(tst, _t(x))):
        if name == "graph_cut":
            np.testing.assert_array_equal(got.numpy(), want)
        else:
            _check_ld(got.numpy(), want)
    np.testing.assert_allclose(
        to.value(tst).numpy(),
        [float(jo.value(jax.tree.map(jnp.asarray, s))) for s in states],
        rtol=LD_RTOL)


def jax_lane(state, lane):
    """Lane ``lane`` of a lane-batched port state."""
    if isinstance(state, tuple):
        return tuple(a[lane] for a in state)
    return state[lane]


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("name", ORACLES)
def test_oracle_chunk_accept_matches_jax(name, use_kernel):
    """chunk_accept against the JAX oracle's sweep on the same route, lane
    by lane; the log-det lanes start mid-selection and one runs its
    appends into k_max."""
    B, d = 16, 12
    rng = np.random.default_rng(7)
    if name == "graph_cut":
        x = _dyadic(rng, (L, B, d))
        total = (rng.integers(0, 64, d) / 2.0).astype(np.float32)
        jo, to = _oracle_pair(name, d, use_kernel, total=total)
        states = (rng.integers(0, 16, (L, d)) / 4.0).astype(np.float32)
        g0 = np.asarray(jref.graph_cut_marginals(_j(x[0]), _j(total),
                                                 _j(states[0])))
        tau = np.float32(np.median(g0)) * np.array([0.0, 0.5, 1.0, 1.5],
                                                   np.float32)
        jstates = [jnp.asarray(s) for s in states]
    else:
        x = _normal(rng, (L, B, d))
        scale = 1.0 if name == "log_det" else 0.5
        alpha = 1.0 if name == "log_det" else 1 / 0.49
        jo, to = _oracle_pair(name, d, use_kernel)
        states = jax_basis(rng, [0, 2, K - 2, K], K, d, alpha, scale)
        tau = np.array([0.3, 1.0, 0.0, 0.5], np.float32) * scale
        jstates = [tuple(jnp.asarray(a[lane]) for a in states)
                   for lane in range(L)]
    elig = rng.random((L, B)) < 0.85
    bud = np.array([64, 3, 64, 64], np.int32)
    got = to.chunk_accept(_port_state(states), _t(x), _t(elig), _t(tau),
                          _t(bud))
    assert got[0].any() and int(got[0][1].sum()) <= 3
    for lane in range(L):
        want = jo.chunk_accept(jstates[lane], jnp.asarray(x[lane]),
                               jnp.asarray(elig[lane]), tau[lane], bud[lane])
        np.testing.assert_array_equal(got[0][lane].numpy(),
                                      np.asarray(want[0]))
        _assert_state(name, jax_lane(got[1], lane), want[1],
                      exact=name == "graph_cut")
        if name == "graph_cut":
            np.testing.assert_array_equal(got[2][lane].numpy(),
                                          np.asarray(want[2]))
        else:
            _check_ld(got[2][lane].numpy(), want[2])


@pytest.mark.parametrize("name", ["log_det", "mutual_information"])
def test_add_at_k_max_is_dropped(name):
    """An append at size == k_max writes no row of U, as the JAX package's
    out-of-bounds scatter writes none; logdet and size move as there.
    Unbatched, and over lanes of which some are full."""
    rng = np.random.default_rng(8)
    jo, to = _oracle_pair(name, D, False)
    full = jax_basis(rng, [K], K, D, jo.alpha, to.scale)
    part = jax_basis(rng, [K - 3], K, D, jo.alpha, to.scale)
    row = _normal(rng, D)
    jfull = tuple(jnp.asarray(a[0]) for a in full)
    want = _np_state(jo.add(jfull, jnp.asarray(row)))
    got = to.add(interop.logdet_state(*(a[0] for a in full)), _t(row))
    np.testing.assert_array_equal(got[0].numpy(), full[0][0])   # U as it was
    _assert_state(name, got, want, exact=False)
    assert int(got[2]) == K + 1
    lanes = _stack([tuple(a[0] for a in full), tuple(a[0] for a in part)])
    got = to.add(interop.logdet_state(*lanes), _t(np.stack([row, row])))
    np.testing.assert_array_equal(got[0][0].numpy(), full[0][0])
    assert not np.array_equal(got[0][1].numpy(), part[0][0])   # appended
    _assert_state(name, jax_lane(got, 0), want, exact=False)


# ---------------------------------------------------------------------------
# engines (accept="first"): the JAX ids, sizes, values and counts
# ---------------------------------------------------------------------------

EC, ED, EK, ECHUNK = 90, 16, 10, 16   # EC % ECHUNK != 0


def logdet_gains64(rows_S, cands, alpha, scale):
    """Exact (float64) log-det marginals of ``cands`` (C, d) given the
    selected rows (s, d): scale log(1 + alpha x'x - alpha^2 x' X_S'
    (I + alpha X_S X_S')^-1 X_S x)."""
    c = np.asarray(cands, np.float64)
    base = 1.0 + alpha * (c * c).sum(-1)
    if len(rows_S):
        S = np.asarray(rows_S, np.float64)
        P = S @ c.T
        G = np.eye(len(S)) + alpha * S @ S.T
        base = base - alpha * alpha * (P * np.linalg.solve(G, P)).sum(0)
    return scale * np.log(base)


def replay_first(rows_S, cands, cand_ids, eligible, tau, k, gains_fn):
    """Algorithm 1 with accept="first", in float64, from the selected rows
    ``rows_S``: repeatedly accept the first eligible row whose gain clears
    tau.  Asserts that every accepted gain clears tau, and every row passed
    over (earlier in the scan, or left when the lane stops short of k) falls
    short of it, by more than MARGIN * max(1, |tau|).  Returns the ids
    accepted, in order."""
    rows_S = list(rows_S)
    elig = np.asarray(eligible, bool).copy()
    tol = MARGIN * max(1.0, abs(float(tau)))
    picks = []
    while len(rows_S) < k:
        g = gains_fn(rows_S, cands)
        ok = np.flatnonzero(elig & (g >= tau))
        stop = len(g) if not len(ok) else ok[0]
        passed = elig[:stop]
        assert (tau - g[:stop][passed] > tol).all(), "near tie passed over"
        if not len(ok):
            break
        i = ok[0]
        assert g[i] - tau > tol, f"accepted gain {g[i]} within {tol} of tau"
        picks.append(int(cand_ids[i]))
        rows_S.append(np.asarray(cands[i], np.float64))
        elig[i] = False
    return picks


def _engine_case(name, rng, per_lane):
    shape = (L, EC, ED) if per_lane else (EC, ED)
    if name == "graph_cut":
        x = _dyadic(rng, shape)
        return x, dict(total=x.reshape(-1, ED).sum(0))
    return _normal(rng, shape), {}


@pytest.mark.parametrize("engine", ["dense", "lazy", "fused"])
@pytest.mark.parametrize("name", ORACLES)
def test_engines_first_match_jax_ids(name, engine):
    """Every engine, both lane modes, both routes of the port against the
    JAX engine.  The dense engine adds every lane's row before it selects,
    so the lanes that have filled k_max = k see appends at size == k_max
    while the others go on."""
    for per_lane in (False, True):
        rng = np.random.default_rng(20 + per_lane)
        x, kw = _engine_case(name, rng, per_lane)
        ids = np.arange(EC, dtype=np.int32) * 3 + 7
        valid = rng.random(EC) < 0.9
        if per_lane:
            ids = np.stack([np.roll(ids, lane) for lane in range(L)])
            valid = rng.random((L, EC)) < 0.9
        jo, _ = _oracle_pair(name, ED, False, k_max=EK, **kw)
        g0 = np.asarray(jo.marginals(jo.init_state(),
                                     jnp.asarray(x.reshape(-1, ED))))
        taus = (np.median(g0) * np.array([0.0, 0.3, 0.7, 1.2])
                ).astype(np.float32)

        def one(tau, xf, i, v):
            st, sol, size, stats = jth.threshold_greedy(
                jo, jo.init_state(), jnp.full((EK,), -1, jnp.int32),
                jnp.zeros((), jnp.int32), xf, i, v, tau, EK, engine=engine,
                chunk=ECHUNK, with_stats=True)
            return sol, size, jo.value(st), stats

        ax = 0 if per_lane else None
        j_sol, j_size, j_val, j_stats = jax.vmap(one, in_axes=(0, ax, ax, ax))(
            jnp.asarray(taus), jnp.asarray(x), jnp.asarray(ids),
            jnp.asarray(valid))
        for use_kernel in (False, True):
            _, to = _oracle_pair(name, ED, use_kernel, k_max=EK, **kw)
            st, sol, size, stats = tth.threshold_greedy(
                to, to.init_state(L), torch.full((L, EK), -1,
                                                 dtype=torch.int32),
                torch.zeros(L, dtype=torch.int32), _t(x), _t(ids), _t(valid),
                _t(taus), EK, engine=engine, chunk=ECHUNK, with_stats=True)
            np.testing.assert_array_equal(sol.numpy(), np.asarray(j_sol))
            np.testing.assert_array_equal(size.numpy(), np.asarray(j_size))
            np.testing.assert_array_equal(stats.n_evals.numpy(),
                                          np.asarray(j_stats.n_evals))
            np.testing.assert_array_equal(stats.n_iters.numpy(),
                                          np.asarray(j_stats.n_iters))
            if name == "graph_cut":
                np.testing.assert_array_equal(to.value(st).numpy(),
                                              np.asarray(j_val))
                continue
            np.testing.assert_allclose(to.value(st).numpy(),
                                       np.asarray(j_val), rtol=LD_RTOL)
            assert (st[2].numpy() <= EK).all()
        if name != "graph_cut":
            # the ids are no accident of rounding: replay in float64
            for lane in range(L):
                picks = replay_first(
                    [], x[lane] if per_lane else x,
                    ids[lane] if per_lane else ids,
                    valid[lane] if per_lane else valid, taus[lane], EK,
                    lambda S, c: logdet_gains64(S, c, to.alpha, to.scale))
                assert picks == sol[lane, :int(size[lane])].tolist()
        # the lanes span the outcomes: a full buffer and an early exit; on
        # the dense engine a full lane's appends are dropped while the
        # other lanes go on looping
        assert int(size.max()) == EK and int(size.min()) < EK
        if engine == "dense":
            assert len(set(stats.n_iters.tolist())) > 1
