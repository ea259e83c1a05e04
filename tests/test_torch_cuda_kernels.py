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
alone and must be equal, and appends run into k_max.  The exemplar
marginals hold to ``ref.exemplar_gain_tol`` (the f32 rounding bound of the
three-term distance, summed over r), the exemplar sweep runs on dyadic
rows and references (a/8, b/8) with states m0 times quarters, where every
distance and gain is exact: masks, states and gains must be equal.  The
cost mode of every sweep runs on the same data as its cardinality test,
with dyadic costs (multiples of 1/8 in [0.5, 2)) and budgets that bind
inside the chunk in some lanes, so the spend and every tau * cost are
exact; it is held to the same tolerance as the cardinality mode.  The
wide instances of the sweeps (d > 2048 features, r > 4096 reference rows, a
log-det basis beyond shared memory) are held to the same rules, and, forced
at narrow shapes, must give the narrow instances' bits.  The facility and
exemplar marginals must equal their plain versions bit for bit on dyadic
data at ragged shapes of their 128 x 128 tile.  The log-det marginals with
each lane's size (only its live basis rows multiplied) must give the bits
of the same call without sizes, and the graph-cut and weighted-coverage
marginals' shared-x tile must equal the plain version bit for bit on
dyadic data at lane counts around its 8-lane groups and 64-lane tiles.
The log-det sweep's narrow instance must give the bits of its row-by-row
wide instance, forced at the same shape, and hold to the plain sweep with
its tolerance, masks parting only at a gain next to its threshold.  Every
instance of the lane walk (csrc/lane_rows.cuh: shared-x warp tiles of
4 x 8, 8 x 4, 16 x 2 and 32 x 1 rows x lanes, one-lane and per-lane tiles
of 16, 8 and 1 rows, a shared block shorter than a row tile) holds to the
plain versions of its four kernels with their tolerances, and a repeated
launch gives the same bits.  Every narrow instance of the feature walk
(csrc/feature_sweep.cuh, 1 to 16 features a thread) gives the plain
sweeps' bits on dyadic data in both modes.
"""

import pytest
import torch

from repro_torch.kernels import _wrap
from repro_torch.kernels import coverage_accept as tca
from repro_torch.kernels import coverage_marginals as tcm
from repro_torch.kernels import exemplar_accept as tea
from repro_torch.kernels import exemplar_marginals as tem
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
    ("per_lane", 1, 65, 33, 70), ("shared", 130, 70, 70, 8),
    ("shared", 37, 1000, 130, 130), ("per_lane", 100, 65, 300, 45),
    ("unbatched", 1, 1000, 100, 70), ("shared", 130, 1000, 300, 130)])
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
    ("per_lane", 3, 65, 1000), ("unbatched", 1, 98_560, 256),
    ("shared", 37, 20, 256)])
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


#: the reference sweeps' shapes: the path case, r = 1024, ragged ones, the
#: walk's window edges (B = 4, 5, 31, 32, 33) and the wide instance
REFERENCE_SWEEP_SHAPES = [(37, 128, 256, 256), (5, 128, 1024, 64),
                          (3, 70, 45, 17), (1, 1, 1, 1), (3, 64, 4097, 16),
                          (2, 40, 8192, 8), (37, 32, 256, 64),
                          (37, 33, 256, 64), (5, 31, 300, 16),
                          (4, 5, 45, 17), (3, 4, 2500, 8),
                          (2, 33, 4097, 8)]


def _reference_sweep_rule(g, dev, L, B, tau, rule):
    """(tau, budget, cost, cost_budget) of a reference sweep's case: the
    median-derived tau with budgets 1..B ("median"); tau = -inf with the
    budget B, so every eligible row is accepted ("-inf"); or the median's
    tau in the knapsack cost mode ("cost": dyadic costs, a budget of 4 in
    even lanes, so the spend is exact and binds inside the chunk)."""
    bud = torch.randint(1, B + 1, (L,), generator=g, device=dev,
                        dtype=torch.int32)
    if rule == "-inf":
        return (torch.full((L,), float("-inf"), device=dev),
                torch.full((L,), B, dtype=torch.int32, device=dev), None,
                None)
    cost, cb = _cost_operands(g, dev, L, B,
                              "cost" if rule == "cost" else "cardinality")
    return tau, bud, cost, cb


@pytest.mark.cuda
@pytest.mark.parametrize("rule", ["median", "-inf", "cost"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("L,B,r,d", REFERENCE_SWEEP_SHAPES)
def test_cuda_facility_accept_matches_plain(cuda_device, dtype, L, B, r, d,
                                            rule):
    """Dyadic inputs (cand (a/8)^2, ref b/8), exact in f32 in any order, so
    masks, states and gains must be equal, in both modes and at tau =
    -inf."""
    g = torch.Generator(device=cuda_device).manual_seed(4)
    cand = ((torch.randint(0, 8, (L, B, d), generator=g, device=cuda_device)
             / 8.0) ** 2).to(dtype)
    R = (torch.randint(0, 8, (r, d), generator=g, device=cuda_device)
         / 8.0).to(dtype)
    state = torch.randint(0, 4 * d, (L, r), generator=g,
                          device=cuda_device) / 64.0
    elig = torch.rand((L, B), generator=g, device=cuda_device) < 0.9
    g0 = ref.facility_marginals(cand, R, state)
    tau, bud, cost, cb = _reference_sweep_rule(
        g, cuda_device, L, B, (g0.median(dim=1).values * 0.05).contiguous(),
        rule)
    before = tfa.launches
    got = tfa.facility_accept(cand, R, state, elig, tau, bud, cost, cb)
    torch.cuda.synchronize()
    assert tfa.launches == before + 1
    want = ref.facility_accept(cand, R, state, elig, tau, bud, cost, cb)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    again = tfa.facility_accept(cand, R, state, elig, tau, bud, cost, cb)
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
@pytest.mark.parametrize("data", ["dyadic", "random"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d,C", [(3, 1001), (45, 257), (256, 1000)])
@pytest.mark.parametrize("L", [2, 8, 37, 40, 64, 65, 130])
def test_cuda_weighted_coverage_marginals_skinny_tile(cuda_device, L, d, C,
                                                      dtype, data):
    """The shared-x route (L >= 2, graph cut's skinny tile) at lane counts
    around its 8-wide lane groups and 64-lane tiles, features below, off
    and on its 32-deep slices, and odd C: on dyadic data (rows a/8, states
    b/8: every product and sum exact) bit for bit the plain version, on
    random data within rtol/atol 1e-5; a repeated launch gives the same
    bits."""
    g = torch.Generator(device=cuda_device).manual_seed(21)
    if data == "dyadic":
        x = (torch.randint(0, 9, (C, d), generator=g, device=cuda_device)
             / 8.0).to(dtype)
        state = torch.randint(0, 17, (L, d), generator=g,
                              device=cuda_device) / 8.0
    else:
        x = (torch.rand((C, d), generator=g, device=cuda_device) ** 2
             ).to(dtype)
        state = torch.rand((L, d), generator=g, device=cuda_device) * 2
    got = twm.weighted_coverage_marginals(x, state)
    torch.cuda.synchronize()
    want = ref.weighted_coverage_marginals(x, state)
    if data == "dyadic":
        assert torch.equal(got, want)
    else:
        torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
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


#: (L, C, d, per-lane x) running each instance of the lane walk: shared x
#: with lane groups of 8; 4; 2; 8 and 1; the 37-lane grid (8, 8, 8, 8, 4,
#: 1) with a ragged last row tile; shared x shorter than a row tile; one
#: lane over 16-row tiles (ragged); per-lane 8-row tiles; per-lane rows of
#: one
WALK_CASES = ((8, 1000, 45, False), (4, 1000, 257, False),
              (2, 70, 3, False), (9, 1000, 256, False),
              (37, 1001, 256, False), (9, 31, 45, False),
              (1, 70000, 45, False), (37, 130, 256, True),
              (37, 7, 257, True))


#: weighted coverage and graph cut take the walk for one lane or per-lane
#: x only (shared x with L >= 2 runs their skinny tile)
WALK_PARAMS = [(name, *case) for name in ("coverage", "saturated",
                                          "weighted", "graph_cut")
               for case in WALK_CASES
               if name in ("coverage", "saturated") or case[3] or case[0] == 1]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name,L,C,d,per_lane", WALK_PARAMS)
def test_cuda_lane_walk_instances_match_plain(cuda_device, name, L, C, d,
                                              per_lane, dtype):
    g = torch.Generator(device=cuda_device).manual_seed(L * 7 + d)
    shape = (L, C, d) if per_lane else (C, d)
    x = (torch.rand(shape, generator=g, device=cuda_device) ** 2).to(dtype)
    state = torch.rand((L, d), generator=g, device=cuda_device) * 3
    w = torch.rand(d, generator=g, device=cuda_device) + 0.5
    cap = torch.rand(d, generator=g, device=cuda_device) * 2 + 0.25
    if name == "coverage":
        kernel = lambda: tcm.coverage_marginals(x, state, w)  # noqa: E731
        want = ref.coverage_marginals(x, state, w)
    elif name == "saturated":
        f = torch.tensor([0.0, 0.5, 0.9, 1.0, 1.5], device=cuda_device)
        state = f[torch.randint(0, 5, (L, d), generator=g,
                                device=cuda_device)] * cap
        kernel = lambda: tsm.saturated_coverage_marginals(  # noqa: E731
            x, state, cap, w)
        want = ref.saturated_coverage_marginals(x, state, cap, w)
    elif name == "weighted":
        kernel = lambda: twm.weighted_coverage_marginals(x, state)  # noqa: E731
        want = ref.weighted_coverage_marginals(x, state)
    else:
        # dyadic rows, total and states, as in the graph-cut tests above:
        # every sum is exact, so the gains equal the plain version's
        x = (torch.randint(0, 9, shape, generator=g, device=cuda_device)
             / 8.0).to(dtype)
        t = torch.randint(0, 64, (d,), generator=g, device=cuda_device) / 2.0
        state = (t * torch.randint(0, 6, (L, 1), generator=g,
                                   device=cuda_device) / 4.0).contiguous()
        kernel = lambda: tgm.graph_cut_marginals(x, t, state, 0.5)  # noqa: E731
        want = ref.graph_cut_marginals(x, t, state, 0.5)
    got = kernel()
    torch.cuda.synchronize()
    if name == "graph_cut":
        assert torch.equal(got, want)
    else:
        torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
    assert torch.equal(got, kernel())


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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d,C", [(3, 1001), (45, 257), (256, 1000)])
@pytest.mark.parametrize("L", [2, 8, 37, 40, 64, 65, 130])
def test_cuda_graph_cut_marginals_skinny_tile_dyadic(cuda_device, dtype, L,
                                                     d, C):
    """The shared-x tile (L >= 2) at lane counts around its 8-wide lane
    groups and 64-lane tiles, features below, off and on its 32-deep
    slices, and rows past its 256-row items (C odd: scalar stores): on
    dyadic data every sum is exact, so the gains equal the plain version's
    bit for bit, and a repeated launch gives the same bits."""
    g = torch.Generator(device=cuda_device).manual_seed(18)
    x, total, state = _graph_cut_case(g, cuda_device, "shared", L, C, d,
                                      dtype)
    got = tgm.graph_cut_marginals(x, total, state, 0.5)
    torch.cuda.synchronize()
    assert torch.equal(got, ref.graph_cut_marginals(x, total, state, 0.5))
    assert torch.equal(got, tgm.graph_cut_marginals(x, total, state, 0.5))


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
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode,L,C,d,k", [
    ("unbatched", 1, 5000, 256, 64), ("shared", 37, 3000, 256, 64),
    ("per_lane", 37, 128, 256, 64), ("shared", 130, 333, 70, 7),
    ("shared", 100, 200, 45, 1), ("shared", 4, 300, 70, 100),
    ("per_lane", 3, 65, 45, 7), ("shared", 130, 300, 70, 100),
    ("shared", 300, 200, 45, 7)])
def test_cuda_logdet_marginals_size_gives_the_same_bits(cuda_device, dtype,
                                                        mode, L, C, d, k):
    """The kernel multiplies only each lane's first size rows; where the
    rows past size are zero (the oracle's state) that must give the bits of
    the call without sizes, at sizes 0, 1, k - 1, k, k + 1 (clamped to k)
    and a lane mix.  A lane's rows may cross the 128-column tiles (k = 100,
    the mix) and more than 256 lanes split into groups (L = 300)."""
    g = torch.Generator(device=cuda_device).manual_seed(17)
    x = (torch.rand((L, C, d) if mode == "per_lane" else (C, d), generator=g,
                    device=cuda_device) ** 2).to(dtype)
    full = torch.full((L,), k, dtype=torch.int32, device=cuda_device)
    U_full = _bases(g, cuda_device, L, k, d, full)[0]
    mix = (torch.arange(L, device=cuda_device) * 37 % (k + 3) - 1
           ).to(torch.int32)              # -1 .. k + 1
    rows = torch.arange(k, device=cuda_device)
    for sizes in (*(torch.full_like(full, s) for s in (0, 1, k - 1, k, k + 1)),
                  mix):
        # the basis of each lane's first size rows: U_full cut at size
        U = torch.where((rows < sizes.clamp(0, k)[:, None])[..., None],
                        U_full, 0.0)
        size = sizes
        if mode == "unbatched":
            U, size = U[-1].contiguous(), sizes[-1]
        before = tlm.launches
        got = tlm.logdet_marginals(x, U, 1.0, 1.0, size)
        torch.cuda.synchronize()
        assert tlm.launches == before + 1
        assert torch.equal(got, tlm.logdet_marginals(x, U, 1.0, 1.0))
        assert torch.equal(got, tlm.logdet_marginals(x, U, 1.0, 1.0, size))
        torch.testing.assert_close(
            got, ref.logdet_marginals(x, U, 1.0, size=size), rtol=LD_RTOL,
            atol=LD_ATOL)


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
@pytest.mark.parametrize("mode", ["cardinality", "cost"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k,d", [(64, 1024), (256, 256)])
def test_cuda_logdet_accept_takes_a_basis_beyond_shared_memory(
        cuda_device, dtype, mode, k, d):
    """A basis that outgrows shared memory (the wide instance, U in the
    output tensor) against the plain sweep, as the narrow test holds it;
    appends run into k_max."""
    assert tla.instance(k, d) == "global"
    g = torch.Generator(device=cuda_device).manual_seed(16)
    L, B = 5, 64
    x = (torch.rand((L, B, d), generator=g, device=cuda_device) ** 2
         ).to(dtype)
    sizes = _sizes(cuda_device, L, k)
    sizes[1] = k - 3
    U, ld, sz = _bases(g, cuda_device, L, k, d, sizes)
    elig = torch.rand((L, B), generator=g, device=cuda_device) < 0.9
    tau = torch.where(torch.arange(L, device=cuda_device) % 4 == 3,
                      float("inf"), 0.0)
    bud = torch.full((L,), B, dtype=torch.int32, device=cuda_device)
    cost = cb = None
    if mode == "cost":
        cost = (4 + torch.randint(0, 12, (L, B), generator=g,
                                  device=cuda_device)) / 8.0
        cb = torch.full((L,), 1e6, device=cuda_device)
        cb[2] = 4.0
    got = tla.logdet_accept(x, U, ld, sz, elig, tau, bud, 1.0, 1.0, cost, cb)
    torch.cuda.synchronize()
    want = ref.logdet_accept(x, U, ld, sz, elig, tau, bud, 1.0, cost=cost,
                             cost_budget=cb)
    assert torch.equal(got[0], want[0]) and torch.equal(got[3], want[3])
    for a, b in zip((got[1], got[2], got[4]), (want[1], want[2], want[4])):
        torch.testing.assert_close(a, b, rtol=LD_RTOL, atol=LD_ATOL)
    assert bool((want[3] > k).any())   # appends past k_max were dropped
    again = tla.logdet_accept(x, U, ld, sz, elig, tau, bud, 1.0, 1.0, cost,
                              cb)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["cardinality", "cost"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("L,B,d,k", [(37, 128, 256, 64), (37, 70, 256, 64),
                                     (12, 1, 256, 64), (1, 128, 256, 64),
                                     (130, 128, 256, 64), (9, 128, 45, 7),
                                     (9, 300, 45, 7), (5, 96, 2048, 16)])
def test_cuda_logdet_accept_walk_gives_the_loops_bits(cuda_device,
                                                      monkeypatch, L, B, d,
                                                      k, dtype, mode):
    """The narrow instance (projections formed for every row up front, a
    walk that reduces only on accept) against the row-by-row loop of the
    wide instance, forced at the same shape: masks, bases, logdets, sizes
    and gains bit for bit.  Lanes start at sizes 0, 1, k - 1 and k; a
    quarter take tau = 0 and accept every eligible row into k_max, the rest
    a quantile of their first gains, so accepts and rejects interleave;
    some budgets are 3; in the cost mode some spends bind.  B = 300 and
    d = 2048 run several row blocks.  Against the plain sweep: masks may
    part only at a gain within 1e-4 + 1e-5 |tau| of its threshold, gains
    to rtol 1e-5 / atol 1e-4 up to there."""
    assert tla.instance(k, d) == "shared"
    g = torch.Generator(device=cuda_device).manual_seed(22)
    x = (torch.rand((L, B, d), generator=g, device=cuda_device) ** 2
         ).to(dtype)
    lanes = torch.arange(L, device=cuda_device)
    sizes = torch.tensor([0, 1, k - 1, k], device=cuda_device)[lanes % 4]
    U, ld, sz = _bases(g, cuda_device, L, k, d, sizes.to(torch.int32))
    elig = torch.rand((L, B), generator=g, device=cuda_device) < 0.9
    first = ref.logdet_marginals(x, U, 1.0, size=sz)
    q = torch.linspace(0.1, 0.9, L, device=cuda_device)
    tau = torch.stack([first[l].float().quantile(q[l]) for l in range(L)])
    tau = torch.where(lanes % 4 == 3, 0.0, tau).contiguous()
    bud = torch.where(lanes % 5 == 2, 3, B).to(torch.int32)
    cost = cb = None
    if mode == "cost":
        cost = (4 + torch.randint(0, 12, (L, B), generator=g,
                                  device=cuda_device)) / 8.0
        cb = torch.where(lanes % 2 == 0, 6.0, 1e6).to(cuda_device)
    args = (x, U, ld, sz, elig, tau, bud, 1.0, 1.0, cost, cb)
    got = tla.logdet_accept(*args)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, tla.logdet_accept(*args)))
    with monkeypatch.context() as mp:
        mp.setattr(tla, "instance", lambda k, d: "global")
        loop = tla.logdet_accept(*args)
    for a, b in zip(got, loop):
        assert torch.equal(a, b)
    want = ref.logdet_accept(x, U, ld, sz, elig, tau, bud, 1.0, cost=cost,
                             cost_budget=cb)
    near = LD_ATOL + LD_RTOL * tau.abs()
    for l in range(L):
        diff = (got[0][l] != want[0][l]).nonzero()
        upto = B
        if len(diff):
            i = int(diff[0])
            t = float(tau[l] * (cost[l, i] if cost is not None else 1.0))
            assert abs(float(want[4][l, i]) - t) <= float(near[l])
            upto = i + 1
        else:
            assert torch.equal(got[3][l], want[3][l])
            torch.testing.assert_close(got[1][l], want[1][l], rtol=LD_RTOL,
                                       atol=LD_ATOL)
        torch.testing.assert_close(got[4][l, :upto], want[4][l, :upto],
                                   rtol=LD_RTOL, atol=LD_ATOL)
    if L >= 4 and B > k:
        assert bool((want[3] > k).any())   # appends past k_max were dropped


def _exemplar_inputs(g, dev, shape_c, r, d, dtype, dyadic=False):
    """Candidates and references U[0, 1) (dyadic: a/8 and b/8), and a state
    for each lane at m0 times U[0, 1) (dyadic: quarters of m0): a
    min-distance vector never exceeds m0."""
    if dyadic:
        cand = torch.randint(0, 8, shape_c + (d,), generator=g, device=dev) / 8.0
        R = torch.randint(0, 8, (r, d), generator=g, device=dev) / 8.0
    else:
        cand = torch.rand(shape_c + (d,), generator=g, device=dev)
        R = torch.rand((r, d), generator=g, device=dev)
    cand, R = cand.to(dtype), R.to(dtype)
    m0 = (R.float() ** 2).sum(-1)
    return cand, R, m0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode,L,C,r,d", [
    ("unbatched", 1, 1000, 256, 256), ("shared", 37, 700, 256, 256),
    ("per_lane", 37, 128, 256, 256), ("shared", 100, 333, 45, 17),
    ("per_lane", 1, 65, 33, 70), ("shared", 130, 70, 300, 45),
    ("shared", 37, 1000, 130, 130), ("per_lane", 100, 65, 100, 45),
    ("unbatched", 1, 65, 300, 70), ("shared", 130, 1000, 45, 130)])
def test_cuda_exemplar_marginals_matches_plain(cuda_device, dtype, mode, L, C,
                                               r, d):
    g = torch.Generator(device=cuda_device).manual_seed(13)
    cand, R, m0 = _exemplar_inputs(
        g, cuda_device, (L, C) if mode == "per_lane" else (C,), r, d, dtype)
    frac = torch.rand((r,) if mode == "unbatched" else (L, r), generator=g,
                      device=cuda_device)
    state = (m0 * frac).contiguous()
    before = tem.launches
    got = tem.exemplar_marginals(cand, R, state)
    torch.cuda.synchronize()
    assert tem.launches == before + 1
    tol = ref.exemplar_gain_tol(cand, R)
    _within(got, ref.exemplar_marginals(cand, R, state),
            tol if mode != "shared" else tol.expand(L, C))
    assert torch.equal(got, tem.exemplar_marginals(cand, R, state))


def _exemplar_sweep_case(g, dev, L, B, r, d, dtype):
    cand, R, m0 = _exemplar_inputs(g, dev, (L, B), r, d, dtype, dyadic=True)
    q = torch.randint(1, 5, (L, r), generator=g, device=dev) / 4.0
    state = (m0 * q).contiguous()
    elig = torch.rand((L, B), generator=g, device=dev) < 0.9
    tau = (ref.exemplar_marginals(cand, R, state).median(dim=1).values
           * 0.05).contiguous()
    return cand, R, state, elig, tau


@pytest.mark.cuda
@pytest.mark.parametrize("rule", ["median", "-inf", "cost"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("L,B,r,d", REFERENCE_SWEEP_SHAPES)
def test_cuda_exemplar_accept_matches_plain(cuda_device, dtype, L, B, r, d,
                                            rule):
    """Dyadic inputs, exact in f32 in any order: masks, states and gains
    must be equal, in both modes and at tau = -inf."""
    g = torch.Generator(device=cuda_device).manual_seed(14)
    cand, R, state, elig, tau = _exemplar_sweep_case(g, cuda_device, L, B, r,
                                                     d, dtype)
    tau, bud, cost, cb = _reference_sweep_rule(g, cuda_device, L, B, tau,
                                               rule)
    before = tea.launches
    got = tea.exemplar_accept(cand, R, state, elig, tau, bud, cost, cb)
    torch.cuda.synchronize()
    assert tea.launches == before + 1
    want = ref.exemplar_accept(cand, R, state, elig, tau, bud, cost, cb)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    again = tea.exemplar_accept(cand, R, state, elig, tau, bud, cost, cb)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


COST_SWEEPS = ("coverage", "weighted", "saturated", "graph_cut", "facility",
               "exemplar", "log_det", "mutual_information")


def _cost_sweep(name, g, dev, L, B, d, dtype):
    """(kernel call, plain call, exact) for one sweep on its cardinality
    test's data; each call takes (cost, cost_budget)."""
    elig = torch.rand((L, B), generator=g, device=dev) < 0.9
    bud = torch.full((L,), B, dtype=torch.int32, device=dev)
    if name == "coverage":
        x = (torch.rand((L, B, d), generator=g, device=dev) ** 2).to(dtype)
        state = torch.rand((L, d), generator=g, device=dev) * 3
        tau = ref.coverage_marginals(x, state).median(dim=1).values * 0.5
        args = (x, state, None, elig, tau.contiguous(), bud)
        return (lambda c, cb: tca.coverage_accept(*args, c, cb),
                lambda c, cb: ref.coverage_accept(*args, c, cb), False)
    if name in ("weighted", "saturated"):
        x, state, _, _, cap = _sweep_case(
            g, dev, L, B, d, dtype, "binary" if name == "weighted" else "dyadic")
        if name == "weighted":
            tau = ref.weighted_coverage_marginals(x, state).median(dim=1).values
            args = (x, state, elig, (tau * 0.5).contiguous(), bud)
            return (lambda c, cb: twa.weighted_coverage_accept(*args, c, cb),
                    lambda c, cb: ref.weighted_coverage_accept(*args, c, cb),
                    True)
        tau = ref.saturated_coverage_marginals(x, state, cap).median(
            dim=1).values
        args = (x, state, cap, None, elig, (tau * 0.5).contiguous(), bud)
        return (lambda c, cb: tsa.saturated_coverage_accept(*args, c, cb),
                lambda c, cb: ref.saturated_coverage_accept(*args, c, cb),
                True)
    if name == "graph_cut":
        x, total, state = _graph_cut_case(g, dev, "per_lane", L, B, d, dtype)
        state = state.expand(L, d).contiguous()
        tau = ref.graph_cut_marginals(x, total, state).median(dim=1).values
        args = (x, total, state, elig, (tau * 0.5).contiguous(), bud, 0.5)
        return (lambda c, cb: tga.graph_cut_accept(*args, c, cb),
                lambda c, cb: ref.graph_cut_accept(*args, c, cb), True)
    if name == "facility":
        cand = ((torch.randint(0, 8, (L, B, d), generator=g, device=dev)
                 / 8.0) ** 2).to(dtype)
        R = (torch.randint(0, 8, (256, d), generator=g, device=dev)
             / 8.0).to(dtype)
        state = torch.randint(0, 4 * d, (L, 256), generator=g,
                              device=dev) / 64.0
        tau = ref.facility_marginals(cand, R, state).median(dim=1).values
        args = (cand, R, state, elig, (tau * 0.05).contiguous(), bud)
        return (lambda c, cb: tfa.facility_accept(*args, c, cb),
                lambda c, cb: ref.facility_accept(*args, c, cb), True)
    if name == "exemplar":
        cand, R, state, elig, tau = _exemplar_sweep_case(g, dev, L, B, 256, d,
                                                         dtype)
        args = (cand, R, state, elig, tau, bud)
        return (lambda c, cb: tea.exemplar_accept(*args, c, cb),
                lambda c, cb: ref.exemplar_accept(*args, c, cb), True)
    scale = 1.0 if name == "log_det" else 0.5
    x = (torch.rand((L, B, d), generator=g, device=dev) ** 2).to(dtype)
    U, ld, sz = _bases(g, dev, L, 16, d, _sizes(dev, L, 16))
    tau = torch.zeros(L, device=dev)
    args = (x, U, ld, sz, elig, tau, bud, 1.0, scale)
    return (lambda c, cb: tla.logdet_accept(*args, c, cb),
            lambda c, cb: ref.logdet_accept(*args[:7], 1.0, scale=scale,
                                            cost=c, cost_budget=cb), None)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", COST_SWEEPS)
def test_cuda_sweep_cost_mode_matches_plain(cuda_device, name, dtype):
    """The knapsack cost mode: per-row dyadic costs and per-lane budgets,
    some of which bind inside the chunk (the spend test cuts accepts the
    cardinality rule would take); bitwise repeats."""
    g = torch.Generator(device=cuda_device).manual_seed(15)
    L, B, d = 37, 128, 256
    kern, plain, exact = _cost_sweep(name, g, cuda_device, L, B, d, dtype)
    cost = (4 + torch.randint(0, 12, (L, B), generator=g,
                              device=cuda_device)) / 8.0
    cb = torch.where(torch.arange(L, device=cuda_device) % 2 == 0,
                     torch.tensor(4.0, device=cuda_device),
                     torch.tensor(1e6, device=cuda_device))
    got = kern(cost, cb)
    torch.cuda.synchronize()
    want = plain(cost, cb)
    assert torch.equal(got[0], want[0])
    for a, b in zip(got[1:], want[1:]):
        if exact or a.dtype == torch.int32:
            assert torch.equal(a, b)
        else:
            torch.testing.assert_close(
                a, b, rtol=RTOL if exact is False else LD_RTOL,
                atol=ATOL if exact is False else LD_ATOL)
    spent = torch.where(got[0], cost, 0.0).sum(-1)
    assert bool((spent <= cb).all())
    free = kern(cost, torch.full_like(cb, 1e6))
    cut = free[0].sum(-1) - got[0].sum(-1)
    assert int(cut[0::2].max()) > 0 and int(cut[1::2].abs().max()) == 0
    again = kern(cost, cb)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    # the cardinality mode keeps its bits beside the cost mode
    card = kern(None, None)
    unit = kern(torch.ones_like(cost), torch.full_like(cb, 1e6))
    assert all(torch.equal(a, b) for a, b in zip(card, unit))


def _cost_operands(g, dev, L, B, mode):
    """(cost, cost_budget) of a sweep's mode: dyadic costs in [0.5, 2) with
    a budget of 4 in even lanes (it binds inside the chunk), or None."""
    if mode == "cardinality":
        return None, None
    cost = (4 + torch.randint(0, 12, (L, B), generator=g, device=dev)) / 8.0
    cb = torch.where(torch.arange(L, device=dev) % 2 == 0,
                     torch.tensor(4.0, device=dev),
                     torch.tensor(1e6, device=dev))
    return cost, cb


def _same_sweep(got, want, exact):
    assert torch.equal(got[0], want[0])
    for a, b in zip(got[1:], want[1:]):
        if exact or a.dtype == torch.int32:
            assert torch.equal(a, b)
        else:
            torch.testing.assert_close(
                a, b, rtol=RTOL if exact is False else LD_RTOL,
                atol=ATOL if exact is False else LD_ATOL)


#: d at each narrow instance of the feature walk: (d, features a thread)
FEATURE_WALK_D = ((100, 1), (200, 2), (500, 4), (1000, 8), (2000, 16))


def _feature_walk_case(name, g, dev, L, B, d, dtype):
    """(kernel call, plain call) of a feature sweep on dyadic data where
    every term, gain, state and spend is exact in f32 in any order; each
    call takes (cost, cost_budget).  Coverage: states c/64 (c = 1, 4, 16)
    and each feature non-zero in at most two rows of a lane, at 24 c/64, so
    a state runs through c/64, 25 c/64 and 49 c/64 and every root is exact;
    weighted coverage: binary rows, states k/8; saturated: (a/8)^2 rows,
    dyadic caps and weights, states straddling the caps; graph cut: a/8
    rows, totals k/2, lam 0.5.  Lanes take budgets 0, 1, 3 and B in turn,
    and lane 5 has no eligible row."""
    def ints(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=g, device=dev)

    elig = torch.rand((L, B), generator=g, device=dev) < 0.9
    elig[5] = False
    bud = torch.tensor([0, 1, 3, B], dtype=torch.int32,
                       device=dev).repeat(L // 4)
    if name == "coverage":
        c = 4.0 ** ints(0, 3, (L, 1, d))
        rows = torch.arange(B, device=dev)[None, :, None]
        on = torch.zeros((L, B, d), dtype=torch.bool, device=dev)
        for _ in range(2):
            on |= (rows == ints(0, B, (L, 1, d))) & (
                torch.rand((L, 1, d), generator=g, device=dev) < 0.7)
        x = torch.where(on, 24.0 * c / 64.0, 0.0).to(dtype)
        state = (c[:, 0] / 64.0).contiguous()
        w = ints(1, 8, (d,)) / 4.0
        tau = ref.coverage_marginals(x, state, w).median(dim=1).values
        args = (x, state, w, elig, (tau * 0.5).contiguous(), bud)
        return (lambda c_, cb: tca.coverage_accept(*args, c_, cb),
                lambda c_, cb: ref.coverage_accept(*args, c_, cb))
    if name in ("weighted", "saturated"):
        x, state, _, _, cap = _sweep_case(
            g, dev, L, B, d, dtype, "binary" if name == "weighted" else
            "dyadic")
        if name == "weighted":
            tau = ref.weighted_coverage_marginals(x, state).median(
                dim=1).values
            args = (x, state, elig, (tau * 0.5).contiguous(), bud)
            return (lambda c_, cb: twa.weighted_coverage_accept(*args, c_, cb),
                    lambda c_, cb: ref.weighted_coverage_accept(*args, c_,
                                                                cb))
        w = ints(1, 8, (d,)) / 4.0
        tau = ref.saturated_coverage_marginals(x, state, cap, w).median(
            dim=1).values
        args = (x, state, cap, w, elig, (tau * 0.5).contiguous(), bud)
        return (lambda c_, cb: tsa.saturated_coverage_accept(*args, c_, cb),
                lambda c_, cb: ref.saturated_coverage_accept(*args, c_, cb))
    x, total, state = _graph_cut_case(g, dev, "per_lane", L, B, d, dtype)
    state = state.expand(L, d).contiguous()
    tau = ref.graph_cut_marginals(x, total, state).median(dim=1).values
    args = (x, total, state, elig, (tau * 0.5).contiguous(), bud, 0.5)
    return (lambda c_, cb: tga.graph_cut_accept(*args, c_, cb),
            lambda c_, cb: ref.graph_cut_accept(*args, c_, cb))


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["walk", "row loop"])
@pytest.mark.parametrize("mode", ["cardinality", "cost"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d,per", FEATURE_WALK_D)
@pytest.mark.parametrize("name", ["coverage", "weighted", "saturated",
                                  "graph_cut"])
def test_cuda_feature_walk_dyadic_bitwise(cuda_device, monkeypatch, name, d,
                                          per, dtype, mode, route):
    """Each narrow instance of the feature walk (csrc/feature_sweep.cuh: 32,
    32, 16, 8 and 8 rows a pass at 1, 2, 4, 8 and 16 features a thread) and
    of the row loop, forced whichever the wrapper would pick, in both
    modes, on dyadic data: masks, states and gains bit for bit the plain
    sweep's, and a repeated launch the same bits."""
    assert _wrap.feature_sweep_per(d) == per
    sign = 1 if route == "walk" else -1
    monkeypatch.setattr(_wrap, "feature_sweep_instance",
                        lambda name, dtype, d: sign * per)
    g = torch.Generator(device=cuda_device).manual_seed(21)
    L, B = 8, 128
    kern, plain = _feature_walk_case(name, g, cuda_device, L, B, d, dtype)
    cost, cb = _cost_operands(g, cuda_device, L, B, mode)
    got = kern(cost, cb)
    torch.cuda.synchronize()
    want = plain(cost, cb)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert int(got[0].sum()) > 0
    assert all(torch.equal(a, b) for a, b in zip(got, kern(cost, cb)))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["cardinality", "cost"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [2049, 4096])
@pytest.mark.parametrize("name", ["coverage", "weighted", "saturated",
                                  "graph_cut"])
def test_cuda_feature_sweep_wide_matches_plain(cuda_device, name, d, dtype,
                                               mode):
    """Past 2048 features the wrapper picks the wide instance (the state in
    global memory), held to the narrow tests' rules; bitwise repeats."""
    assert _wrap.feature_sweep_per(d) == 0
    g = torch.Generator(device=cuda_device).manual_seed(17)
    L, B = 5, 64
    kern, plain, exact = _cost_sweep(name, g, cuda_device, L, B, d, dtype)
    cost, cb = _cost_operands(g, cuda_device, L, B, mode)
    got = kern(cost, cb)
    torch.cuda.synchronize()
    _same_sweep(got, plain(cost, cb), exact)
    assert all(torch.equal(a, b) for a, b in zip(got, kern(cost, cb)))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["cardinality", "cost"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("r", [4097, 8192])
@pytest.mark.parametrize("name", ["facility", "exemplar"])
def test_cuda_reference_sweep_wide_matches_plain(cuda_device, name, r, dtype,
                                                 mode):
    """Past 4096 reference rows the wrapper picks the wide instance (the
    state in global memory); dyadic data, so everything must be equal."""
    assert _wrap.reference_sweep_per(r) == 0
    g = torch.Generator(device=cuda_device).manual_seed(18)
    # d = 8 keeps every sum of up to 8192 dyadic residuals exact
    L, B, d = 3, 48, 8
    bud = torch.full((L,), B, dtype=torch.int32, device=cuda_device)
    if name == "facility":
        cand = ((torch.randint(0, 8, (L, B, d), generator=g,
                               device=cuda_device) / 8.0) ** 2).to(dtype)
        R = (torch.randint(0, 8, (r, d), generator=g, device=cuda_device)
             / 8.0).to(dtype)
        state = torch.randint(0, 4 * d, (L, r), generator=g,
                              device=cuda_device) / 64.0
        elig = torch.rand((L, B), generator=g, device=cuda_device) < 0.9
        tau = (ref.facility_marginals(cand, R, state).median(dim=1).values
               * 0.05).contiguous()
        kern, plain = tfa.facility_accept, ref.facility_accept
    else:
        cand, R, state, elig, tau = _exemplar_sweep_case(
            g, cuda_device, L, B, r, d, dtype)
        kern, plain = tea.exemplar_accept, ref.exemplar_accept
    cost, cb = _cost_operands(g, cuda_device, L, B, mode)
    got = kern(cand, R, state, elig, tau, bud, cost, cb)
    torch.cuda.synchronize()
    _same_sweep(got, plain(cand, R, state, elig, tau, bud, cost, cb), True)
    assert all(torch.equal(a, b) for a, b in zip(
        got, kern(cand, R, state, elig, tau, bud, cost, cb)))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["cardinality", "cost"])
@pytest.mark.parametrize("d", [45, 256, 2048])
@pytest.mark.parametrize("name", COST_SWEEPS)
def test_cuda_wide_instance_gives_the_narrow_bits(cuda_device, monkeypatch,
                                                  name, d, mode):
    """Each wide instance, forced at a width its narrow sibling takes, sums
    the same terms in the same order: masks, states and gains must be the
    narrow instance's bits."""
    g = torch.Generator(device=cuda_device).manual_seed(19)
    L, B = 9, 96
    kern, _, _ = _cost_sweep(name, g, cuda_device, L, B, d, torch.float32)
    cost, cb = _cost_operands(g, cuda_device, L, B, mode)
    narrow = kern(cost, cb)
    if name in ("facility", "exemplar"):
        monkeypatch.setattr(_wrap, "reference_sweep_per", lambda r: 0)
    elif name in ("log_det", "mutual_information"):
        monkeypatch.setattr(tla, "instance", lambda k, d: "global")
    else:
        monkeypatch.setattr(_wrap, "feature_sweep_per", lambda d: 0)
    wide = kern(cost, cb)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(narrow, wide))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode,L,C,r,d", [
    ("shared", 37, 1000, 256, 256), ("shared", 130, 1000, 130, 70),
    ("shared", 100, 65, 300, 130), ("unbatched", 1, 1000, 45, 45),
    ("per_lane", 37, 128, 100, 130), ("per_lane", 1, 65, 300, 45)])
@pytest.mark.parametrize("name", ["facility", "exemplar"])
def test_cuda_reference_marginals_dyadic_bitwise(cuda_device, name, dtype,
                                                 mode, L, C, r, d):
    """On dyadic data every product, distance and sum is exact in f32, so
    the marginals must equal the plain version bit for bit at every ragged
    edge of the 128 x 128 tile (rows past C, columns past r, d not a
    multiple of 16 or of 4, lane groups past 128)."""
    g = torch.Generator(device=cuda_device).manual_seed(20)
    shape_c = (L, C) if mode == "per_lane" else (C,)
    st_shape = (r,) if mode == "unbatched" else (L, r)
    if name == "facility":
        cand = ((torch.randint(0, 8, shape_c + (d,), generator=g,
                               device=cuda_device) / 8.0) ** 2).to(dtype)
        R = (torch.randint(0, 8, (r, d), generator=g, device=cuda_device)
             / 8.0)
        state = torch.randint(0, 4 * d, st_shape, generator=g,
                              device=cuda_device) / 64.0
        kern, plain = tfm.facility_marginals, ref.facility_marginals
    else:
        cand, R, m0 = _exemplar_inputs(g, cuda_device, shape_c, r, d, dtype,
                                       dyadic=True)
        q = torch.randint(1, 5, st_shape, generator=g, device=cuda_device)
        state = (m0 * q / 4.0).contiguous()
        kern, plain = tem.exemplar_marginals, ref.exemplar_marginals
    got = kern(cand, R, state)
    torch.cuda.synchronize()
    assert torch.equal(got, plain(cand, R, state))
    assert torch.equal(got, kern(cand, R, state))
