"""The ``size`` argument of the log-det marginals, on the CPU.

The CUDA kernel multiplies only each lane's first ``size`` rows of its
whitened basis U (the oracle's |S|; the other rows are zero by the state's
contract), so ``kernels.ops.logdet_marginals`` and its plain version take
``size``.  Here the plain version with ``size`` is held against the JAX
package's Pallas kernel (interpret mode) on bases built by the JAX oracle,
where the rows past size are zero; it must zero the rows past size itself
when they are not; and the oracles must pass their state's size on the
kernel route, on every engine, with the rows past it zero.

Tolerance: rtol 1e-5 / atol 1e-4 for log-det gains (the JAX package's own,
tests/test_kernels.py); the twin with and without ``size`` must agree bit
for bit where the rows past size are zero (it multiplies the same U).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import LogDetDiversity as JLogDet
from repro.core import MutualInformationGaussian as JMI
from repro.kernels.logdet_marginals import logdet_marginals as pallas_logdet
from repro_torch import interop
from repro_torch.core import threshold as tth
from repro_torch.kernels import ops, ref

torch.set_num_threads(2)
jax.config.update("jax_platform_name", "cpu")

LD_RTOL, LD_ATOL = 1e-5, 1e-4
L, C, D, K = 4, 40, 16, 8
SIZES = [K, 0, 3, K - 1]   # full, empty, partial, one short of full
ALPHA = 1.5


def _t(a):
    return interop.tensor(a)


def _x(rng, shape, dtype):
    x = (rng.standard_normal(shape) * 0.5).astype(np.float32)
    return np.asarray(jnp.asarray(x, jnp.bfloat16)) if dtype == "bf16" else x


def jax_basis(rng, sizes, scale=1.0):
    """(U (L, K, D), size (L,)) of JAX oracle states that appended
    ``sizes[l]`` random rows with the oracle's own ``add``: the rows past a
    lane's size are zero."""
    jo = (JLogDet(feat_dim=D, k_max=K, alpha=ALPHA) if scale == 1.0 else
          JMI(feat_dim=D, k_max=K, noise=ALPHA ** -0.5))
    Us, szs = [], []
    for n in sizes:
        st = jo.init_state()
        for _ in range(n):
            st = jo.add(st, jnp.asarray(_x(rng, D, "f32")))
        Us.append(np.asarray(st[0]))
        szs.append(int(st[2]))
    return np.stack(Us), np.asarray(szs, np.int32)


@pytest.mark.parametrize("scale", [1.0, 0.5])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("mode", ["unbatched", "shared", "per_lane"])
def test_logdet_twin_with_size_matches_pallas(mode, dtype, scale):
    """The plain version with the lanes' sizes against the Pallas kernel
    (interpret mode) lane by lane, and bit for bit against itself without
    sizes: the rows past size are zero, so they add nothing."""
    rng = np.random.default_rng(31)
    U, sz = jax_basis(rng, SIZES, scale)
    assert (sz == SIZES).all()
    for lane, n in enumerate(SIZES):
        assert not U[lane, n:].any()
    x = _x(rng, (L, C, D) if mode == "per_lane" else (C, D), dtype)
    size = _t(sz)
    if mode == "unbatched":
        U, size = U[2], size[2]          # a partial basis, a 0-d size
    got = ops.logdet_marginals(_t(x), _t(U), ALPHA, scale, size=size)
    np.testing.assert_array_equal(
        got.numpy(), ops.logdet_marginals(_t(x), _t(U), ALPHA, scale).numpy())
    got = got.numpy().reshape(-1, C)
    lanes = range(1) if mode == "unbatched" else range(L)
    for lane in lanes:
        a = x[lane] if mode == "per_lane" else x
        u = U if mode == "unbatched" else U[lane]
        want = pallas_logdet(jnp.asarray(a), jnp.asarray(u), ALPHA,
                             interpret=True, scale=scale)
        np.testing.assert_allclose(got[lane], np.asarray(want),
                                   rtol=LD_RTOL, atol=LD_ATOL)


@pytest.mark.parametrize("mode", ["unbatched", "shared", "per_lane"])
def test_logdet_twin_zeroes_rows_past_size(mode):
    """With rows past size that are not zero, the plain version reads U as
    the CUDA kernel does: only the first size rows, size clamped to
    [0, k] (so -2 is 0 and k + 5 is k)."""
    rng = np.random.default_rng(32)
    U = (rng.standard_normal((L, K, D)) * 0.3).astype(np.float32)
    sz = np.array([-2, 0, 3, K + 5], np.int32)
    x = _x(rng, (L, C, D) if mode == "per_lane" else (C, D), "f32")
    live = np.clip(sz, 0, K)
    Uz = U.copy()
    for lane, n in enumerate(live):
        Uz[lane, n:] = 0.0
    size = _t(sz)
    if mode == "unbatched":
        U, Uz, size, live = U[2], Uz[2], size[2], live[2:3]
    got = ref.logdet_marginals(_t(x), _t(U), ALPHA, size=size)
    np.testing.assert_array_equal(
        got.numpy(), ref.logdet_marginals(_t(x), _t(Uz), ALPHA).numpy())
    # the lanes cut short differ from the whole basis
    full = ref.logdet_marginals(_t(x), _t(U), ALPHA).numpy().reshape(-1, C)
    for lane, n in enumerate(live):
        assert (n == K) == np.array_equal(got.numpy().reshape(-1, C)[lane],
                                          full[lane])


def _spy(monkeypatch, calls):
    """Record every ops.logdet_marginals call's U and size, and copies of
    them as they were at the call, then call it."""
    real = ops.logdet_marginals

    def spy(x, U, alpha=1.0, scale=1.0, size=None):
        calls.append((U, size, U.clone(),
                      None if size is None else size.clone()))
        return real(x, U, alpha, scale, size)
    monkeypatch.setattr(ops, "logdet_marginals", spy)


@pytest.mark.parametrize("name", ["log_det", "mutual_information"])
def test_oracle_passes_its_size_on_the_kernel_route(name, monkeypatch):
    """LogDetDiversity and MutualInformationGaussian with use_kernel hand
    their state's size (the same tensor) to ops.logdet_marginals, batched
    and unbatched, and the gains equal the plain route's bit for bit."""
    calls = []
    _spy(monkeypatch, calls)
    make = interop.log_det if name == "log_det" else interop.mutual_information
    kern, plain = make(D, K, use_kernel=True), make(D, K, use_kernel=False)
    rng = np.random.default_rng(33)
    rows = _t(_x(rng, (K, D), "f32"))
    x = _t(_x(rng, (C, D), "f32"))
    batched = kern.init_state(L)
    for step in range(3):
        grow = torch.arange(L) > step
        batched = tuple(torch.where(grow.reshape((L,) + (1,) * (a.dim() - 1)),
                                    b, a) for a, b in zip(
            batched, kern.add(batched, rows[step].expand(L, D))))
    single = kern.add(kern.add(kern.init_state(), rows[0]), rows[1])
    for st in (batched, single):
        got = kern.marginals(st, kern.prep(st, x))
        assert calls[-1][1] is st[2] and calls[-1][0] is st[0]
        np.testing.assert_array_equal(
            got.numpy(), plain.marginals(st, plain.prep(st, x)).numpy())
    assert batched[2].tolist() == [0, 1, 2, 3] and int(single[2]) == 2


@pytest.mark.parametrize("engine", ["dense", "lazy", "fused"])
def test_engines_pass_a_size_with_zero_rows_past_it(engine, monkeypatch):
    """On every engine, each marginals call on the kernel route carries one
    size per lane, every row of U at or past it is zero (the contract the
    kernel's skipping relies on), and the picks equal the plain route's."""
    calls = []
    _spy(monkeypatch, calls)
    rng = np.random.default_rng(34)
    x = _t(_x(rng, (C, D), "f32"))
    ids = torch.arange(C, dtype=torch.int32)
    valid = torch.ones(C, dtype=torch.bool)
    picks = []
    for use_kernel in (True, False):
        oracle = interop.log_det(D, K, use_kernel=use_kernel)
        g0 = oracle.marginals(oracle.init_state(), x)
        taus = (g0.median() * torch.tensor([0.0, 0.3, 0.7, 1.2])).float()
        st, sol, size, _ = tth.threshold_greedy(
            oracle, oracle.init_state(L), torch.full((L, K), -1,
                                                     dtype=torch.int32),
            torch.zeros(L, dtype=torch.int32), x, ids, valid, taus, K,
            engine=engine, chunk=8, with_stats=True)
        picks.append((sol, size))
    assert calls
    for _, _, U, size in calls:
        assert size is not None and size.shape == U.shape[:-2]
        live = torch.arange(K) < size.clamp(0, K).unsqueeze(-1)
        assert not U[~live].any()
    assert torch.equal(picks[0][0], picks[1][0])
    assert torch.equal(picks[0][1], picks[1][1])
    assert int(picks[0][1].max()) == K and int(picks[0][1].min()) < K
