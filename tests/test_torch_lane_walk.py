"""The lane walk of csrc/lane_rows.cuh on the CPU: its summation order, and
the plain versions of the four kernels that run it against the JAX package.

The CUDA walk cannot run here, so the first half holds a numpy model of it
against a model of the first port's walk, bit for bit.  Both sum the same
float32 terms (computed once per Rule of feature_rules.cuh, in the
kernels' own expressions); both form, in thread t of a warp, one chain over
features t, t + 32, ... ascending from 0.0f.  The first port then adds each
output's 32 chains in the xor butterfly's pairs (16, 8, 4, 2, 1); the
register tile runs a warp tile of R rows x J lanes through a reduce-scatter
that keeps, each level, the half of a thread's outputs its lane bit
selects.  The model follows the launcher and both kernels (lane blocks,
lane groups of 8, 4, 2 and 1, R-row tiles, the last tile of a row range
moved back to end at row C - 1, the grid's strides), so it also shows
that every output is written exactly once.  Data are random non-dyadic
floats at d = 3, 45, 256 and 257 with ragged C and L.  (The square roots'
shared range test changes no term: sqrtf is correctly rounded, and
ab_compare.py holds the kernel's roots against sqrtf on every float on a
card.)

The second half holds the port's plain versions (``kernels.ops`` on CPU
tensors) against the JAX reference and the Pallas kernels in interpret
mode at the same odd widths, to rtol/atol 1e-5 (the sums over features run
in another order in each package).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch import interop
from repro_torch.kernels import ops

torch.set_num_threads(2)
jax.config.update("jax_platform_name", "cpu")

RTOL = ATOL = 1e-5
# lane_rows.cuh's constants
WARPS, TILE_ROWS, LANE_ROWS = 8, 32, 16
TWO_PER_SM, MAX_SMEM = 113 * 1024, 227 * 1024
#: per-feature operands of each Rule (Rule::kFeat)
KFEAT = {"coverage": 1, "saturated": 2, "weighted": 0, "graph_cut": 2}
LAM = np.float32(0.5)
F32 = np.float32


def _terms(rule, x, s, rng):
    """float32 terms (L, C, d) of ``rule`` for x (C, d) or (L, C, d) and
    states s (L, d), in the expressions of feature_rules.cuh."""
    d = s.shape[1]
    xl = np.broadcast_to(x, (s.shape[0],) + x.shape[-2:])
    s3 = s[:, None, :]
    if rule == "coverage":
        w = (rng.random(d) + 0.5).astype(F32)
        return (np.sqrt(s3 + xl) - np.sqrt(s3)) * w
    if rule == "saturated":
        cap = (rng.random(d) * 2 + 0.25).astype(F32)
        w = (rng.random(d) + 0.5).astype(F32)
        return (np.minimum(s3 + xl, cap) - np.minimum(s3, cap)) * w
    if rule == "weighted":
        return s3 * xl
    t = (rng.random(d) * 40).astype(F32)
    pre = t - (F32(2) * LAM) * s3
    return xl * pre - (LAM * xl) * xl


def _chains(terms):
    """(32, N) chains of terms (N, d): thread t sums features t, t + 32,
    ... ascending from 0.0f; no term past d enters a chain."""
    n, d = terms.shape
    t = np.arange(32)
    acc = np.zeros((32, n), F32)
    for k in range((d + 31) // 32):
        f = k * 32 + t
        ok = f < d
        acc = np.where(ok[:, None], acc + terms[:, np.minimum(f, d - 1)].T,
                       acc)
    return acc


def _butterfly(v):
    """The xor butterfly over axis 0 of v (32, ...): every thread ends
    with the same sum."""
    t = np.arange(32)
    for o in (16, 8, 4, 2, 1):
        v = v + v[t ^ o]
    return v


def _reduce_scatter(v):
    """lane_rows::Scatter on chains v (32, N): returns (value, output
    index) of each thread; thread t holds output t / (32 / N)."""
    t = np.arange(32)
    n, o = v.shape[1], 16
    copies = 32 // n
    while n > 1:
        h = n // 2
        up = ((t & o) != 0)[:, None]
        send = np.where(up, v[:, :h], v[:, h:])
        keep = np.where(up, v[:, h:], v[:, :h])
        v = keep + send[t ^ o]
        n, o = h, o // 2
    s = v[:, 0]
    while o > 0:
        s = s + s[t ^ o]
        o //= 2
    return s, t // copies


def first_port_order(terms):
    """Every output of terms (L, C, d) summed as the first port's walk
    does: strided chains, then the 5-level butterfly."""
    L, C, d = terms.shape
    return _butterfly(_chains(terms.reshape(L * C, d)))[0].reshape(L, C)


class _Out:
    """The outputs (L, C) and how often each was written."""

    def __init__(self, L, C):
        self.v = np.full((L, C), np.nan, F32)
        self.writes = np.zeros((L, C), np.int64)

    def tile(self, terms, R, J, lane0, row0, C):
        """One warp tile: the R rows from row0 (from C - R where they would
        pass the last row; the rows before row0 are not stored) against
        lanes lane0 .. lane0 + J - 1; outputs o = j R + r."""
        start = min(row0, C - R)
        tile_terms = terms[lane0:lane0 + J, start:start + R].reshape(R * J, -1)
        value, o = _reduce_scatter(_chains(tile_terms))
        copies = 32 // (R * J)
        for t in range(0, 32, copies):
            j, r = divmod(int(o[t]), R)
            if start + r >= row0:
                self.v[lane0 + j, start + r] = value[t]
                self.writes[lane0 + j, start + r] += 1


def register_tile_order(terms, kfeat, per_lane, sms):
    """Every output of terms (L, C, d) as lane_rows::launch computes it on
    a card of ``sms`` SMs: per-lane x, L = 1 or fewer rows than a row tile
    through lane_kernel, else shared_kernel.  Returns the outputs and their
    write counts."""
    L, C, d = terms.shape
    out = _Out(L, C)
    smem_of = lambda lanes: (2 * lanes + kfeat) * d * 4  # noqa: E731
    if per_lane or L == 1 or C < TILE_ROWS:
        resident = (2 if smem_of(1) <= TWO_PER_SM else 1) * sms
        big = L * ((C + LANE_ROWS - 1) // LANE_ROWS)
        R = (LANE_ROWS if C >= LANE_ROWS and big >= resident * WARPS
             else 8 if C >= 8 else 1)
        n_row_tiles = (C + R - 1) // R
        gy = min((n_row_tiles + WARPS - 1) // WARPS, max(resident // L, 1))
        for lane in range(L):
            for by in range(gy):
                for warp in range(WARPS):
                    for b in range(by * WARPS + warp, n_row_tiles,
                                   gy * WARPS):
                        out.tile(terms, R, 1, lane, b * R, C)
        return out
    budget = TWO_PER_SM if smem_of(1) <= TWO_PER_SM else MAX_SMEM
    fit = min((budget // (d * 4) - kfeat) // 2, L)
    n_tiles = (C + TILE_ROWS - 1) // TILE_ROWS
    want = (2 * sms + n_tiles - 1) // n_tiles
    blocks = max((L + fit - 1) // fit, min(want, (L + 7) // 8))
    lpc = (L + blocks - 1) // blocks
    blocks = (L + lpc - 1) // lpc
    resident = (2 if smem_of(lpc) <= TWO_PER_SM else 1) * sms
    gy = min(n_tiles, max(resident // blocks, 1))
    for bx in range(blocks):
        l0 = bx * lpc
        nl = min(lpc, L - l0)
        eights, rest = nl & ~7, nl & 7
        for by in range(gy):
            my_tiles = (n_tiles - by + gy - 1) // gy
            for warp in range(WARPS):
                for it in range(warp, my_tiles * nl, WARPS):
                    row_tile = by + (it // nl) * gy
                    i = it % nl
                    J, lo, sub = 8, i & ~7, i & 7
                    if i >= eights:
                        k, lo, J = i - eights, eights, 4
                        while J > 1:
                            if rest & J:
                                if k < J:
                                    break
                                k -= J
                                lo += J
                            J //= 2
                        sub = k
                    row0 = row_tile * TILE_ROWS + sub * (TILE_ROWS // J)
                    if row0 < C:
                        out.tile(terms, TILE_ROWS // J, J, l0 + lo, row0, C)
    return out


#: (L, C, per-lane x, SMs): lane groups 8, 8, 8, 8, 4, 1 over several row
#: tiles a CTA, the last one ragged; one group of 2; lane blocks spread
#: over a card for few row tiles (130 lanes, 40 rows); a shared block
#: shorter than a row tile (one CTA a lane); per-lane R = 16 with a ragged
#: tile, R = 8 and R = 1 (one row); one lane at R = 16 and R = 8
SHAPES = ((37, 100, False, 1), (2, 37, False, 132), (130, 40, False, 132),
          (9, 31, False, 132), (9, 33, True, 1), (9, 33, True, 132),
          (37, 1, True, 132), (1, 600, False, 1), (1, 70, False, 132))


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "L{}-C{}-{}-sm{}".format(
    s[0], s[1], "per_lane" if s[2] else "shared", s[3]))
@pytest.mark.parametrize("d", [3, 45, 256, 257])
@pytest.mark.parametrize("rule", list(KFEAT))
def test_register_tile_gives_the_first_ports_bits(rule, d, shape):
    L, C, per_lane, sms = shape
    rng = np.random.default_rng(d * 1000 + L + C)
    x = (rng.random((L, C, d) if per_lane else (C, d)) ** 2).astype(F32)
    s = (rng.random((L, d)) * 3).astype(F32)
    s[:, ::5] = 0.0
    terms = np.ascontiguousarray(_terms(rule, x, s, rng), dtype=F32)
    want = first_port_order(terms)
    got = register_tile_order(terms, KFEAT[rule], per_lane, sms)
    assert (got.writes == 1).all(), "an output is not written exactly once"
    np.testing.assert_array_equal(got.v.view(np.uint32), want.view(np.uint32))
    exact = terms.astype(np.float64).sum(-1)
    np.testing.assert_allclose(got.v, exact, rtol=1e-4,
                               atol=1e-4 * max(1.0, np.abs(exact).max()))


@pytest.mark.parametrize("n", [1, 2, 8, 32])
def test_reduce_scatter_is_the_butterfly_of_each_output(n):
    rng = np.random.default_rng(n)
    v = (rng.standard_normal((32, n)) * 10.0 ** rng.integers(-3, 4, (32, n))
         ).astype(F32)
    value, o = _reduce_scatter(v)
    want = _butterfly(v)[0]
    np.testing.assert_array_equal(value.view(np.uint32),
                                  want[o].view(np.uint32))
    assert sorted(set(o.tolist())) == list(range(n))


def _t(a):
    return None if a is None else interop.tensor(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


@pytest.mark.parametrize("per_lane", [False, True])
@pytest.mark.parametrize("d", [3, 45, 257])
@pytest.mark.parametrize("kernel", ["coverage", "saturated", "weighted",
                                    "graph_cut"])
def test_plain_versions_match_jax_at_odd_widths(kernel, d, per_lane):
    L, C = 9, 33
    rng = np.random.default_rng(d + 7 * per_lane)
    x = (rng.random((L, C, d) if per_lane else (C, d)) ** 2).astype(F32)
    s = (rng.random((L, d)) * 3).astype(F32)
    w = (rng.random(d) + 0.5).astype(F32)
    if kernel == "coverage":
        extra = (w,)
        port, jax_fns = ops.coverage_marginals, (jref.coverage_marginals,
                                                 jops.coverage_marginals)
    elif kernel == "saturated":
        cap = (rng.random(d) * 2 + 0.25).astype(F32)
        s = (rng.choice(np.array([0.0, 0.5, 0.9, 1.0, 1.5], F32), (L, d))
             * cap).astype(F32)
        extra = (cap, w)
        port, jax_fns = (ops.saturated_coverage_marginals,
                         (jref.saturated_coverage_marginals,
                          jops.saturated_coverage_marginals))
    elif kernel == "weighted":
        extra = ()
        port, jax_fns = (ops.weighted_coverage_marginals,
                         (jref.weighted_coverage_marginals,
                          jops.weighted_coverage_marginals))
    else:
        total = (rng.random(d) * C / 3).astype(F32)
    if kernel == "graph_cut":
        got = ops.graph_cut_marginals(_t(x), _t(total), _t(s), 0.5).numpy()
        calls = [(_j(x[lane] if per_lane else x), _j(total), _j(s[lane]), 0.5)
                 for lane in range(L)]
        jax_fns = (jref.graph_cut_marginals, jops.graph_cut_marginals)
    else:
        got = port(_t(x), _t(s), *map(_t, extra)).numpy()
        calls = [(_j(x[lane] if per_lane else x), _j(s[lane]),
                  *map(_j, extra)) for lane in range(L)]
    assert got.shape == (L, C)
    for fn in jax_fns:
        want = np.stack([np.asarray(fn(*c)) for c in calls])
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
