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
cap), where masks, states and gains must be equal.
"""

import pytest
import torch

from repro_torch.kernels import coverage_accept as tca
from repro_torch.kernels import coverage_marginals as tcm
from repro_torch.kernels import facility_accept as tfa
from repro_torch.kernels import facility_marginals as tfm
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
