"""The CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``cuda`` and skips without a card.  The file
imports neither JAX nor the JAX package, so it runs on a machine that has
only PyTorch and the CUDA toolkit:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_kernels.py

Tolerance: rtol 1e-5 / atol 1e-5 for the coverage-family kernels
(coverage, weighted and saturated coverage: they sum over d in another
order); for the facility kernels the f32 rounding bound of
``ref.gemm_gain_tol`` on the similarity products, and 2 r 2^-24 times the
summed magnitudes for the rectified residual sum.  Every facility kernel
and the weighted and saturated kernels must also return the same bits when
launched twice.  The accept sweeps of weighted and saturated coverage run
on exact data (binary rows with dyadic weights; (a/8)^2 rows with a dyadic
cap), where masks, states and gains must be equal.  The GraphCut kernels
run on dyadic rows (a/8) with dyadic totals and states (2 lam s up to
1.25 t), where every sum is exact: gains, masks and states must be equal.
The log-det kernels run on bases built by the plain append (empty,
partial, full), to rtol 1e-5 / atol 1e-4 for gains, bases and logdet; their
sweeps take tau = 0 or +inf, so masks depend on eligibility and budget
alone and must be equal, and appends run into k_max.
"""

import pytest
import torch

from repro_torch.kernels import coverage_accept as tca
from repro_torch.kernels import coverage_marginals as tcm
from repro_torch.kernels import facility_accept as tfa
from repro_torch.kernels import facility_marginals as tfm
from repro_torch.kernels import graph_cut_accept as tga
from repro_torch.kernels import graph_cut_marginals as tgm
from repro_torch.kernels import logdet_accept as tla
from repro_torch.kernels import logdet_marginals as tlm
from repro_torch.kernels import ref
from repro_torch.kernels import saturated_coverage_accept as tsa
from repro_torch.kernels import saturated_coverage_marginals as tsm
from repro_torch.kernels import weighted_coverage_accept as twa
from repro_torch.kernels import weighted_coverage_marginals as twm

RTOL = ATOL = 1e-5


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("per_lane", [False, True])
def test_cuda_coverage_marginals_matches_plain(cuda_device, dtype, per_lane):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    L, C, d = 11, 1000, 300
    shape = (L, C, d) if per_lane else (C, d)
    x = (torch.rand(shape, generator=g, device=cuda_device) ** 2).to(dtype)
    state = torch.rand((L, d), generator=g, device=cuda_device) * 3
    w = torch.rand(d, generator=g, device=cuda_device)
    before = tcm.launches
    got = tcm.coverage_marginals(x, state, w)
    torch.cuda.synchronize()
    assert tcm.launches == before + 1
    torch.testing.assert_close(got, ref.coverage_marginals(x, state, w),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_coverage_accept_matches_plain(cuda_device, dtype):
    g = torch.Generator(device=cuda_device).manual_seed(1)
    L, B, d = 7, 128, 256
    x = (torch.rand((L, B, d), generator=g, device=cuda_device) ** 2).to(dtype)
    state = torch.rand((L, d), generator=g, device=cuda_device) * 3
    elig = torch.rand((L, B), generator=g, device=cuda_device) < 0.9
    tau = ref.coverage_marginals(x, state).median(dim=1).values.contiguous()
    bud = torch.randint(0, B, (L,), generator=g, device=cuda_device,
                        dtype=torch.int32)
    got = tca.coverage_accept(x, state, None, elig, tau, bud)
    torch.cuda.synchronize()
    want = ref.coverage_accept(x, state, None, elig, tau, bud)
    assert torch.equal(got[0], want[0])
    torch.testing.assert_close(got[1], want[1], rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(got[2], want[2], rtol=RTOL, atol=ATOL)


def _within(got, want, tol):
    assert got.shape == want.shape
    err = (got - want).abs()
    assert bool((err <= tol).all()), f"max err {err.max().item()}"


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode,L,C,r,d", [
    ("unbatched", 1, 1000, 256, 256), ("shared", 37, 700, 256, 256),
    ("per_lane", 37, 128, 256, 256), ("shared", 100, 333, 45, 17),
    ("per_lane", 1, 65, 33, 70), ("shared", 130, 70, 70, 8)])
def test_cuda_facility_marginals_matches_plain(cuda_device, dtype, mode, L, C,
                                               r, d):
    g = torch.Generator(device=cuda_device).manual_seed(2)
    shape = (L, C, d) if mode == "per_lane" else (C, d)
    cand = (torch.rand(shape, generator=g, device=cuda_device) ** 2).to(dtype)
    R = torch.rand((r, d), generator=g, device=cuda_device).to(dtype)
    state = torch.rand((r,) if mode == "unbatched" else (L, r), generator=g,
                       device=cuda_device) * d / 4
    before = tfm.launches["facility_marginals"]
    got = tfm.facility_marginals(cand, R, state)
    torch.cuda.synchronize()
    assert tfm.launches["facility_marginals"] == before + 1
    tol = ref.gemm_gain_tol(cand, R)
    _within(got, ref.facility_marginals(cand, R, state),
            tol if mode != "shared" else tol.expand(L, C))
    assert torch.equal(got, tfm.facility_marginals(cand, R, state))


@pytest.mark.cuda
@pytest.mark.parametrize("mode,L,C,r", [
    ("unbatched", 1, 5000, 256), ("shared", 37, 3000, 256),
    ("per_lane", 37, 500, 256), ("shared", 100, 77, 45),
    ("per_lane", 3, 65, 1000)])
def test_cuda_rectified_residual_sum_matches_plain(cuda_device, mode, L, C, r):
    g = torch.Generator(device=cuda_device).manual_seed(3)
    aux = torch.rand((L, C, r) if mode == "per_lane" else (C, r), generator=g,
                     device=cuda_device) * 40
    state = torch.rand((r,) if mode == "unbatched" else (L, r), generator=g,
                       device=cuda_device) * 40
    got = tfm.rectified_residual_sum(aux, state)
    torch.cuda.synchronize()
    st = state.unsqueeze(-2)
    tol = 2 * r * 2.0 ** -24 * (aux.abs() + st.abs()).sum(-1)
    _within(got, ref.rectified_residual_sum(aux, state), tol)
    assert torch.equal(got, tfm.rectified_residual_sum(aux, state))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("L,B,r,d", [(37, 128, 256, 256), (5, 128, 1024, 64),
                                     (3, 70, 45, 17), (1, 1, 1, 1)])
def test_cuda_facility_accept_matches_plain(cuda_device, dtype, L, B, r, d):
    """Dyadic inputs (cand (a/8)^2, ref b/8), exact in f32 in any order, so
    masks, states and gains must be equal."""
    g = torch.Generator(device=cuda_device).manual_seed(4)
    cand = ((torch.randint(0, 8, (L, B, d), generator=g, device=cuda_device)
             / 8.0) ** 2).to(dtype)
    R = (torch.randint(0, 8, (r, d), generator=g, device=cuda_device)
         / 8.0).to(dtype)
    state = torch.randint(0, 4 * d, (L, r), generator=g,
                          device=cuda_device) / 64.0
    elig = torch.rand((L, B), generator=g, device=cuda_device) < 0.9
    g0 = ref.facility_marginals(cand, R, state)
    tau = (g0.median(dim=1).values * 0.05).contiguous()
    bud = torch.randint(1, B + 1, (L,), generator=g, device=cuda_device,
                        dtype=torch.int32)
    before = tfa.launches
    got = tfa.facility_accept(cand, R, state, elig, tau, bud)
    torch.cuda.synchronize()
    assert tfa.launches == before + 1
    want = ref.facility_accept(cand, R, state, elig, tau, bud)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    again = tfa.facility_accept(cand, R, state, elig, tau, bud)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


LANE_MODES = [("unbatched", 1, 5000, 256), ("shared", 37, 3000, 256),
              ("per_lane", 37, 128, 256), ("shared", 130, 333, 70),
              ("per_lane", 1, 65, 45), ("shared", 2, 100, 3)]


def _lane_inputs(g, dev, mode, L, C, d, dtype):
    x = (torch.rand((L, C, d) if mode == "per_lane" else (C, d), generator=g,
                    device=dev) ** 2).to(dtype)
    shape = (d,) if mode == "unbatched" else (L, d)
    return x, shape


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode,L,C,d", LANE_MODES)
def test_cuda_weighted_coverage_marginals_matches_plain(cuda_device, dtype,
                                                        mode, L, C, d):
    g = torch.Generator(device=cuda_device).manual_seed(5)
    x, shape = _lane_inputs(g, cuda_device, mode, L, C, d, dtype)
    state = torch.rand(shape, generator=g, device=cuda_device) * 2
    before = twm.launches
    got = twm.weighted_coverage_marginals(x, state)
    torch.cuda.synchronize()
    assert twm.launches == before + 1
    torch.testing.assert_close(got, ref.weighted_coverage_marginals(x, state),
                               rtol=RTOL, atol=ATOL)
    assert torch.equal(got, twm.weighted_coverage_marginals(x, state))


@pytest.mark.cuda
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode,L,C,d", LANE_MODES)
def test_cuda_saturated_coverage_marginals_matches_plain(cuda_device, dtype,
                                                         weighted, mode, L, C,
                                                         d):
    """States straddle the cap: 0, below it, at it, above it, and just
    below it so that s + x crosses it."""
    g = torch.Generator(device=cuda_device).manual_seed(6)
    x, shape = _lane_inputs(g, cuda_device, mode, L, C, d, dtype)
    cap = torch.rand(d, generator=g, device=cuda_device) * 2 + 0.25
    f = torch.tensor([0.0, 0.5, 0.9, 1.0, 1.5], device=cuda_device)
    state = f[torch.randint(0, 5, shape, generator=g, device=cuda_device)] * cap
    w = torch.rand(d, generator=g, device=cuda_device) + 0.5 if weighted else None
    before = tsm.launches
    got = tsm.saturated_coverage_marginals(x, state, cap, w)
    torch.cuda.synchronize()
    assert tsm.launches == before + 1
    torch.testing.assert_close(
        got, ref.saturated_coverage_marginals(x, state, cap, w),
        rtol=RTOL, atol=ATOL)
    assert torch.equal(got, tsm.saturated_coverage_marginals(x, state, cap, w))


def _sweep_case(g, dev, L, B, d, dtype, kind):
    shape = (L, B, d)
    if kind == "binary":
        x = (torch.rand(shape, generator=g, device=dev) < 0.3).float()
        state = torch.randint(0, 16, (L, d), generator=g, device=dev) / 8.0
    else:
        x = (torch.randint(0, 8, shape, generator=g, device=dev) / 8.0) ** 2
        cap = torch.randint(4, 24, (d,), generator=g, device=dev) / 8.0
        f = torch.tensor([0.0, 0.5, 0.75, 1.0, 1.5], device=dev)
        state = f[torch.randint(0, 5, (L, d), generator=g, device=dev)] * cap
    elig = torch.rand((L, B), generator=g, device=dev) < 0.9
    bud = torch.randint(1, B + 1, (L,), generator=g, device=dev,
                        dtype=torch.int32)
    return x.to(dtype), state.contiguous(), elig, bud, (
        cap if kind != "binary" else None)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("L,B,d", [(37, 128, 256), (3, 70, 45), (1, 1, 1),
                                   (130, 128, 300)])
def test_cuda_weighted_coverage_accept_matches_plain(cuda_device, dtype, L, B,
                                                     d):
    g = torch.Generator(device=cuda_device).manual_seed(7)
    x, state, elig, bud, _ = _sweep_case(g, cuda_device, L, B, d, dtype,
                                         "binary")
    tau = (ref.weighted_coverage_marginals(x, state).median(dim=1).values
           * 0.5).contiguous()
    before = twa.launches
    got = twa.weighted_coverage_accept(x, state, elig, tau, bud)
    torch.cuda.synchronize()
    assert twa.launches == before + 1
    want = ref.weighted_coverage_accept(x, state, elig, tau, bud)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    again = twa.weighted_coverage_accept(x, state, elig, tau, bud)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.cuda
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("L,B,d", [(37, 128, 256), (3, 70, 45), (1, 1, 1),
                                   (130, 128, 300)])
def test_cuda_saturated_coverage_accept_matches_plain(cuda_device, dtype,
                                                      weighted, L, B, d):
    g = torch.Generator(device=cuda_device).manual_seed(8)
    x, state, elig, bud, cap = _sweep_case(g, cuda_device, L, B, d, dtype,
                                           "dyadic")
    w = (torch.randint(1, 8, (d,), generator=g, device=cuda_device) / 4.0
         if weighted else None)
    tau = (ref.saturated_coverage_marginals(x, state, cap, w)
           .median(dim=1).values * 0.5).contiguous()
    before = tsa.launches
    got = tsa.saturated_coverage_accept(x, state, cap, w, elig, tau, bud)
    torch.cuda.synchronize()
    assert tsa.launches == before + 1
    want = ref.saturated_coverage_accept(x, state, cap, w, elig, tau, bud)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    again = tsa.saturated_coverage_accept(x, state, cap, w, elig, tau, bud)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


LD_RTOL, LD_ATOL = 1e-5, 1e-4


def _graph_cut_case(g, dev, mode, L, C, d, dtype):
    x = (torch.randint(0, 9, (L, C, d) if mode == "per_lane" else (C, d),
                       generator=g, device=dev) / 8.0).to(dtype)
    total = torch.randint(0, 64, (d,), generator=g, device=dev) / 2.0
    frac = torch.randint(0, 6, (d,) if mode == "unbatched" else (L, 1),
                         generator=g, device=dev) / 4.0
    return x, total, (total * frac).contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode,L,C,d", LANE_MODES)
def test_cuda_graph_cut_marginals_matches_plain(cuda_device, dtype, mode, L,
                                                C, d):
    g = torch.Generator(device=cuda_device).manual_seed(9)
    x, total, state = _graph_cut_case(g, cuda_device, mode, L, C, d, dtype)
    before = tgm.launches
    got = tgm.graph_cut_marginals(x, total, state, 0.5)
    torch.cuda.synchronize()
    assert tgm.launches == before + 1
    assert torch.equal(got, ref.graph_cut_marginals(x, total, state, 0.5))
    assert torch.equal(got, tgm.graph_cut_marginals(x, total, state, 0.5))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("L,B,d", [(37, 128, 256), (3, 70, 45), (1, 1, 1),
                                   (130, 128, 300)])
def test_cuda_graph_cut_accept_matches_plain(cuda_device, dtype, L, B, d):
    g = torch.Generator(device=cuda_device).manual_seed(10)
    x, total, state = _graph_cut_case(g, cuda_device, "per_lane", L, B, d,
                                      dtype)
    state = state.expand(L, d).contiguous()
    elig = torch.rand((L, B), generator=g, device=cuda_device) < 0.9
    bud = torch.randint(1, B + 1, (L,), generator=g, device=cuda_device,
                        dtype=torch.int32)
    tau = ref.graph_cut_marginals(x, total, state).median(dim=1).values
    before = tga.launches
    got = tga.graph_cut_accept(x, total, state, elig, tau, bud, 0.5)
    torch.cuda.synchronize()
    assert tga.launches == before + 1
    want = ref.graph_cut_accept(x, total, state, elig, tau, bud, 0.5)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    again = tga.graph_cut_accept(x, total, state, elig, tau, bud, 0.5)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def _bases(g, dev, L, k, d, sizes):
    """Lane bases (U, logdet, size) holding ``sizes`` rows of U[0, 1)^2,
    appended one by one with the plain append."""
    rows = torch.stack([torch.rand((L, d), generator=g, device=dev) ** 2
                        for _ in range(k)])
    return ref.logdet_basis(rows, sizes)


def _sizes(dev, L, k):
    s = torch.arange(L, device=dev) * 5 % (k + 1)
    s[0] = k
    return s.to(torch.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("scale", [1.0, 0.5])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode,L,C,d,k", [
    ("unbatched", 1, 5000, 256, 64), ("shared", 37, 3000, 256, 64),
    ("per_lane", 37, 128, 256, 64), ("shared", 130, 333, 70, 7),
    ("shared", 100, 200, 45, 1), ("shared", 4, 300, 70, 100),
    ("per_lane", 3, 65, 45, 7)])
def test_cuda_logdet_marginals_matches_plain(cuda_device, dtype, scale, mode,
                                             L, C, d, k):
    g = torch.Generator(device=cuda_device).manual_seed(11)
    x = (torch.rand((L, C, d) if mode == "per_lane" else (C, d), generator=g,
                    device=cuda_device) ** 2).to(dtype)
    U = _bases(g, cuda_device, L, k, d, _sizes(cuda_device, L, k))[0]
    if mode == "unbatched":
        U = U[0].contiguous()
    before = tlm.launches
    got = tlm.logdet_marginals(x, U, 1.0, scale)
    torch.cuda.synchronize()
    assert tlm.launches == before + 1
    torch.testing.assert_close(
        got, ref.logdet_marginals(x, U, 1.0, scale=scale), rtol=LD_RTOL,
        atol=LD_ATOL)
    assert torch.equal(got, tlm.logdet_marginals(x, U, 1.0, scale))


@pytest.mark.cuda
@pytest.mark.parametrize("scale", [1.0, 0.5])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("L,B,d,k", [(37, 128, 256, 64), (3, 70, 45, 7),
                                     (1, 1, 1, 1), (130, 128, 70, 1)])
def test_cuda_logdet_accept_matches_plain(cuda_device, dtype, scale, L, B, d,
                                          k):
    g = torch.Generator(device=cuda_device).manual_seed(12)
    x = (torch.rand((L, B, d), generator=g, device=cuda_device) ** 2
         ).to(dtype)
    U, ld, sz = _bases(g, cuda_device, L, k, d, _sizes(cuda_device, L, k))
    elig = torch.rand((L, B), generator=g, device=cuda_device) < 0.9
    tau = torch.where(torch.arange(L, device=cuda_device) % 4 == 3,
                      float("inf"), 0.0)
    bud = torch.randint(1, B + 1, (L,), generator=g, device=cuda_device,
                        dtype=torch.int32)
    before = tla.launches
    got = tla.logdet_accept(x, U, ld, sz, elig, tau, bud, 1.0, scale)
    torch.cuda.synchronize()
    assert tla.launches == before + 1
    want = ref.logdet_accept(x, U, ld, sz, elig, tau, bud, 1.0, scale=scale)
    assert torch.equal(got[0], want[0]) and torch.equal(got[3], want[3])
    for a, b in zip((got[1], got[2], got[4]), (want[1], want[2], want[4])):
        torch.testing.assert_close(a, b, rtol=LD_RTOL, atol=LD_ATOL)
    if L > 1:
        assert bool((want[3] > k).any())   # appends past k_max were dropped
    again = tla.logdet_accept(x, U, ld, sz, elig, tau, bud, 1.0, scale)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.cuda
def test_cuda_logdet_accept_refuses_a_basis_beyond_shared_memory(cuda_device):
    x = torch.rand((2, 8, 256), device=cuda_device)
    U = torch.zeros((2, 256, 256), device=cuda_device)
    ld = torch.zeros(2, device=cuda_device)
    sz = torch.zeros(2, dtype=torch.int32, device=cuda_device)
    elig = torch.ones((2, 8), dtype=torch.bool, device=cuda_device)
    before = tla.launches
    with pytest.raises(ValueError, match="shared memory"):
        tla.logdet_accept(x, U, ld, sz, elig, 0.0, 4)
    assert tla.launches == before
