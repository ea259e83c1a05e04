"""The port's kernel modules against the JAX package's kernels.

On the CPU the port's wrappers run their plain PyTorch versions
(repro_torch.kernels.ref); they are held here against the JAX reference
(repro.kernels.ref) and the Pallas kernels in interpret mode
(repro.kernels.ops).  Tolerance: rtol 1e-5 / atol 1e-5, because the sums
over d are taken in another order.  The CUDA kernels themselves are held
against the plain versions by tests/test_torch_cuda_kernels.py (skipped
without a card) and by chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch import interop
from repro_torch.core.functions import FeatureCoverage
from repro_torch.kernels import _build
from repro_torch.kernels import coverage_accept as tca
from repro_torch.kernels import coverage_marginals as tcm
from repro_torch.kernels import ops

torch.set_num_threads(2)
jax.config.update("jax_platform_name", "cpu")

RTOL = ATOL = 1e-5


def _inputs(seed, C, d, dtype, weighted, L=None):
    rng = np.random.default_rng(seed)
    x = (rng.random((C, d) if L is None else (L, C, d)) ** 2).astype(np.float32)
    if dtype == "bf16":
        x = np.asarray(jnp.asarray(x, jnp.bfloat16))
    state = (rng.random(d if L is None else (L, d)) * 3).astype(np.float32)
    w = rng.random(d).astype(np.float32) if weighted else None
    return x, state, w


def _t(a):
    return None if a is None else interop.tensor(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("weighted", [False, True])
def test_coverage_marginals_matches_jax(dtype, weighted):
    x, state, w = _inputs(0, 50, 40, dtype, weighted)
    got = ops.coverage_marginals(_t(x), _t(state), _t(w)).numpy()
    np.testing.assert_allclose(
        got, np.asarray(jref.coverage_marginals(_j(x), _j(state), _j(w))),
        rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(
        got, np.asarray(jops.coverage_marginals(_j(x), _j(state), _j(w))),
        rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("per_lane", [False, True])
def test_coverage_marginals_lanes_match_per_lane_loop(per_lane):
    L, C, d = 5, 33, 17
    x, state, w = _inputs(1, C, d, "f32", True, L=L if per_lane else None)
    state = np.random.default_rng(2).random((L, d)).astype(np.float32)
    got = ops.coverage_marginals(_t(x), _t(state), _t(w))
    assert got.shape == (L, C)
    for lane in range(L):
        xl = x[lane] if per_lane else x
        want = jref.coverage_marginals(_j(xl), _j(state[lane]), _j(w))
        np.testing.assert_allclose(got[lane].numpy(), np.asarray(want),
                                   rtol=RTOL, atol=ATOL)


def _accept_case(seed, B, d, dtype, weighted, budget, all_ineligible=False):
    x, state, w = _inputs(seed, B, d, dtype, weighted)
    rng = np.random.default_rng(seed + 100)
    elig = (rng.random(B) < 0.8) & (not all_ineligible)
    g0 = np.asarray(jref.coverage_marginals(_j(x), _j(state), _j(w)))
    tau = np.float32(np.median(g0) * 0.7)
    return x, state, w, elig, tau, np.int32(budget)


def _check_accept(got, want):
    mask, st, gains = got
    np.testing.assert_array_equal(mask.numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(st.numpy(), np.asarray(want[1]), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(gains.numpy(), np.asarray(want[2]), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("budget", [64, 3])
def test_coverage_accept_matches_jax(dtype, weighted, budget):
    x, state, w, elig, tau, bud = _accept_case(3, 24, 20, dtype, weighted,
                                               budget)
    got = ops.coverage_accept(_t(x), _t(state), _t(w), _t(elig),
                              torch.tensor(tau), torch.tensor(bud))
    if budget == 3:
        assert int(got[0].sum()) == 3   # the budget cut the sweep
    args = (_j(x), _j(state), _j(w), _j(elig), _j(tau), _j(bud))
    _check_accept(got, jref.coverage_accept(*args))
    _check_accept(got, jops.coverage_accept(*args))


def test_coverage_accept_all_ineligible():
    x, state, w, elig, tau, bud = _accept_case(4, 16, 12, "f32", True, 64,
                                               all_ineligible=True)
    got = ops.coverage_accept(_t(x), _t(state), _t(w), _t(elig), float(tau),
                              int(bud))
    assert not got[0].any()
    np.testing.assert_array_equal(got[1].numpy(), state)
    _check_accept(got, jref.coverage_accept(_j(x), _j(state), _j(w),
                                            _j(elig), _j(tau), _j(bud)))


def test_coverage_accept_lanes_match_per_lane_loop():
    L, B, d = 4, 20, 9
    rng = np.random.default_rng(5)
    x = (rng.random((L, B, d)) ** 2).astype(np.float32)
    state = rng.random((L, d)).astype(np.float32)
    w = rng.random(d).astype(np.float32)
    elig = rng.random((L, B)) < 0.9
    tau = np.array([0.05, 0.2, 0.4, 10.0], np.float32)
    bud = np.array([64, 2, 5, 64], np.int32)
    mask, st, gains = ops.coverage_accept(_t(x), _t(state), _t(w), _t(elig),
                                          _t(tau), _t(bud))
    for lane in range(L):
        want = jref.coverage_accept(_j(x[lane]), _j(state[lane]), _j(w),
                                    _j(elig[lane]), _j(tau[lane]),
                                    _j(bud[lane]))
        _check_accept((mask[lane], st[lane], gains[lane]), want)


def test_cpu_tensors_leave_launch_counters_at_zero():
    tcm.launches = 0
    tca.launches = 0
    x, state, w = _inputs(6, 16, 8, "f32", True)
    oracle = FeatureCoverage(feat_dim=8, weights=_t(w), use_kernel=True,
                             device="cpu")
    ops.coverage_marginals(_t(x), _t(state), _t(w))
    oracle.marginals(_t(state)[None], _t(x))
    oracle.chunk_accept(_t(state)[None], _t(x)[None],
                        torch.ones(1, 16, dtype=torch.bool),
                        torch.tensor([0.1]), torch.tensor([4], dtype=torch.int32))
    assert tcm.launches == 0 and tca.launches == 0


def test_kernel_wrappers_refuse_cpu_tensors():
    x = torch.rand(8, 4)
    with pytest.raises(ValueError, match="CUDA"):
        tcm.coverage_marginals(x, torch.zeros(4))
    with pytest.raises(ValueError, match="CUDA"):
        tca.coverage_accept(x, torch.zeros(4), None,
                            torch.ones(8, dtype=torch.bool), 0.1, 2)
    assert tcm.launches == 0 and tca.launches == 0


def test_oracle_routes_agree_and_value_is_consistent():
    """The kernel route (plain versions on the CPU) and the oracle's own
    plain route give the same gains and sweeps, and a marginal is the
    value difference f(S + e) - f(S)."""
    x, state, w = _inputs(7, 30, 10, "f32", True)
    plain = FeatureCoverage(feat_dim=10, weights=_t(w), device="cpu")
    kern = FeatureCoverage(feat_dim=10, weights=_t(w), use_kernel=True,
                           device="cpu")
    st = _t(state)[None]
    g = plain.marginals(st, _t(x))
    torch.testing.assert_close(kern.marginals(st, _t(x)), g)
    diff = plain.value(st + _t(x)) - plain.value(st)
    torch.testing.assert_close(g[0], diff, rtol=1e-4, atol=1e-4)
    elig = torch.ones(1, 30, dtype=torch.bool)
    tau = torch.tensor([float(g.median())])
    bud = torch.tensor([64], dtype=torch.int32)
    a = plain.chunk_accept(st, _t(x)[None], elig, tau, bud)
    b = kern.chunk_accept(st, _t(x)[None], elig, tau, bud)
    assert torch.equal(a[0], b[0])
    torch.testing.assert_close(a[1], b[1])
    torch.testing.assert_close(a[2], b[2])


def test_build_refuses_without_nvcc_and_hashes_the_sources(monkeypatch):
    h = _build.source_hash()
    assert len(h) == 16 and h == _build.source_hash()
    assert set(_build.SOURCES) == {
        p.stem for p in _build.CSRC.glob("*.cu")} == set(_build.SIGNATURES)
    assert "--use_fast_math" not in _build.NVCC_FLAGS
    monkeypatch.setattr(_build, "nvcc_path", lambda: "/nonexistent/nvcc")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build_all()


class _StubLibrary:
    """Every entry point returns cudaSuccess and launches nothing."""

    def __getattr__(self, name):
        return lambda *args: 0


@pytest.fixture
def stubbed_launch(monkeypatch):
    """The wrappers on CPU tensors with their launch stubbed out: their own
    checks and counting run as on the card (there is no card here)."""
    from repro_torch.kernels import _wrap
    monkeypatch.setattr(_build, "library", lambda name: _StubLibrary())
    monkeypatch.setattr(_wrap, "check_rows", lambda *args, **kw: None)
    monkeypatch.setattr(_wrap, "launch",
                        lambda name, fn, device, *args: fn(*args, None))
    ops.reset_launch_counts()
    yield
    ops.reset_launch_counts()


@pytest.mark.parametrize("rows,shape", [(1, "row"), (2, "chunk"),
                                        (128, "chunk"), (129, "filter"),
                                        (4096, "filter")])
def test_launch_counts_split_by_rows_a_lane(stubbed_launch, rows, shape):
    """A launch counts under the rows a lane it took: one row (the
    partition matroid's scan), up to the engines' chunk, or more (the
    filter, the singleton passes)."""
    from repro_torch.core.threshold import DEFAULT_CHUNK
    from repro_torch.kernels import _wrap
    assert _wrap.CHUNK_ROWS == DEFAULT_CHUNK
    state = torch.rand(3, 8)
    tcm.coverage_marginals(torch.rand(rows, 8), state)       # shared x
    tcm.coverage_marginals(torch.rand(3, rows, 8), state)    # per-lane x
    want = dict.fromkeys(_wrap.SHAPES, 0)
    want[shape] = 2
    assert ops.shape_launch_counts()["coverage_marginals"] == want


def test_launch_count_split_sums_to_the_counts(stubbed_launch):
    """The split covers every entry point and sums to launch_counts; the
    plain route (CPU tensors through ops) counts nothing; a reset clears
    both."""
    from repro_torch.kernels import logdet_accept as tla
    from repro_torch.kernels import weighted_coverage_marginals as twm
    L, B, d, k = 3, 128, 8, 4
    state = torch.rand(L, d)
    ops.coverage_marginals(torch.rand(300, d), state)
    ops.weighted_coverage_marginals(torch.rand(300, d), state)
    assert set(ops.launch_counts().values()) == {0}
    tcm.coverage_marginals(torch.rand(300, d), state)
    tcm.coverage_marginals(torch.rand(1, d), state)
    twm.weighted_coverage_marginals(torch.rand(L, 5, d), state)
    tla.logdet_accept(torch.rand(L, B, d), torch.zeros(L, k, d),
                      torch.zeros(L), torch.zeros(L, dtype=torch.int32),
                      torch.ones(L, B, dtype=torch.bool), torch.zeros(L),
                      torch.full((L,), k, dtype=torch.int32))
    split, counts = ops.shape_launch_counts(), ops.launch_counts()
    assert set(split) == set(counts)
    for name, n in counts.items():
        assert sum(split[name].values()) == n
    assert split["coverage_marginals"] == {"filter": 1, "chunk": 0, "row": 1}
    assert split["weighted_coverage_marginals"]["chunk"] == 1
    assert split["logdet_accept"]["chunk"] == 1
    ops.reset_launch_counts()
    assert set(ops.launch_counts().values()) == {0}
    assert all(set(s.values()) == {0}
               for s in ops.shape_launch_counts().values())


@pytest.mark.parametrize("name", ["coverage_marginals",
                                  "saturated_coverage_marginals",
                                  "rectified_residual_sum"])
def test_filter_launches_split_by_lanes_and_x(stubbed_launch, name):
    """The "filter" class of coverage_marginals,
    saturated_coverage_marginals and rectified_residual_sum (whose x is
    the aux block) splits by lanes, shared or per-lane x and rows a lane,
    and the split sums to the class; other classes and a reset leave it
    empty."""
    from repro_torch.kernels import facility_marginals as tfm
    from repro_torch.kernels import saturated_coverage_marginals as tsm
    d = 8
    cap = torch.rand(d)

    def launch(x, state):
        if name == "coverage_marginals":
            return tcm.coverage_marginals(x, state)
        if name == "rectified_residual_sum":
            return tfm.rectified_residual_sum(x, state)
        return tsm.saturated_coverage_marginals(x, state, cap)

    launch(torch.rand(1000, d), torch.rand(d))          # one lane
    launch(torch.rand(1000, d), torch.rand(1, d))       # one lane, batched
    launch(torch.rand(300, d), torch.rand(37, d))       # shared x
    launch(torch.rand(300, d), torch.rand(37, d))
    launch(torch.rand(37, 200, d), torch.rand(37, d))   # per-lane x
    launch(torch.rand(37, 128, d), torch.rand(37, d))   # a chunk
    split = ops.filter_launch_counts()[name]
    assert split == {"1 lane, shared x, 1000 rows": 2,
                     "37 lanes, shared x, 300 rows": 2,
                     "37 lanes, per-lane x, 200 rows": 1}
    assert sum(split.values()) == ops.shape_launch_counts()[name]["filter"]
    ops.reset_launch_counts()
    assert ops.filter_launch_counts() == {}
