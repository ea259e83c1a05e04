"""The residual walk of csrc/facility_marginals.cu (``rwalk``) on the CPU:
its summation order, and the plain version against the JAX package.

    out[l, i] = sum_j max(aux[i, j] - state[l, j], 0)

The CUDA walk cannot run here, so the first half holds a numpy model of it
against a model of the first port's kernel, bit for bit.  Both sum the same
float32 column groups: a group is the columns of one load (four, as one
float4, when r % 4 == 0; else one), its residuals max(a - s, 0) added in
column order ((m0 + m1) + m2) + m3.  Both form, in thread t of a warp, one
chain over groups t, t + 32, ... ascending from 0.0f.  The first port then
adds each output's 32 chains in the xor butterfly's pairs (16, 8, 4, 2, 1);
the walk runs a warp's tile of R rows x J lanes through the reduce-scatter
of warp_scatter.cuh, which keeps each level the half of a thread's outputs
that its lane bit selects.  (The walk loads a tile's rows in blocks that fit
its registers, and a thread's groups past r are zeros that add +0; every
output's chain still takes its groups in ascending order, so neither
changes a bit.)  The model follows rwalk::launch (the one-lane route and
its 16-, 8- and 1-row tiles, the shared route's lane blocks and its 4-row
tiles (16 rows in floats) scored against a block's lanes 8 at a time, then
4, 2 and 1, the last tile of a row range moved back to end at row C - 1,
the grid's strides), so it also shows that every output is written exactly
once.  Data are random non-dyadic floats at r = 3, 45, 256, 257 and 1024
with ragged C, L = 1, 8, 37 and 100, shared and per-lane aux.

The second half holds the port's plain version (``kernels.ops`` on CPU
tensors) against the JAX reference and the Pallas kernel in interpret mode
at the same odd widths, within the kernels' tolerance 2 r 2^-24 sum(|aux| +
|state|) (the two packages sum the columns in other orders).
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
from test_torch_lane_walk import _Out, first_port_order

torch.set_num_threads(2)
jax.config.update("jax_platform_name", "cpu")

F32 = np.float32
# facility_marginals.cu's rwalk constants
WARPS, LANE_ROWS = 8, 16
TWO_PER_SM, MAX_SMEM = 113 * 1024, 227 * 1024


def groups(aux, state):
    """float32 (L, C, G) column-group sums of every (lane, row) for aux
    (C, r) or (L, C, r) and states (L, r), in the kernels' expressions."""
    L, r = state.shape
    a = np.broadcast_to(aux, (L,) + aux.shape[-2:])
    m = np.maximum(a - state[:, None, :], F32(0))
    if r % 4:
        return m
    m4 = m.reshape(m.shape[:2] + (r // 4, 4))
    return ((m4[..., 0] + m4[..., 1]) + m4[..., 2]) + m4[..., 3]


def walk_order(grp, r, per_lane, sms):
    """Every output of groups (L, C, G) as rwalk::launch computes it on a
    card of ``sms`` SMs: per-lane aux, one lane, fewer rows than a shared
    tile or a state row too wide for shared memory through lane_kernel,
    else shared_kernel.  Returns the outputs and their write counts."""
    L, C, _ = grp.shape
    out = _Out(L, C)
    smem_of = lambda lanes: lanes * r * 4  # noqa: E731
    R = 16 // (4 if r % 4 == 0 else 1)  # rows of a shared tile
    if per_lane or L == 1 or C < R or smem_of(1) > MAX_SMEM:
        resident = 2 * sms
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
                        out.tile(grp, R, 1, lane, b * R, C)
        return out
    budget = TWO_PER_SM if smem_of(1) <= TWO_PER_SM else MAX_SMEM
    fit = min(budget // (r * 4), L)
    n_row_tiles = (C + R - 1) // R
    ctas = (n_row_tiles + WARPS - 1) // WARPS
    want = (2 * sms + ctas - 1) // ctas
    blocks = max((L + fit - 1) // fit, min(want, (L + 7) // 8))
    lpc = (L + blocks - 1) // blocks
    blocks = (L + lpc - 1) // lpc
    resident = (2 if smem_of(lpc) <= TWO_PER_SM else 1) * sms
    gy = min(ctas, max(resident // blocks, 1))
    kJ = 32 // R  # lanes of a full chunk
    for bx in range(blocks):
        l0 = bx * lpc
        nl = min(lpc, L - l0)
        for by in range(gy):
            for warp in range(WARPS):
                for b in range(by * WARPS + warp, n_row_tiles, gy * WARPS):
                    # the tile against every lane of the block: kJ lanes at
                    # a time, then 4, 2 and 1
                    lo = 0
                    while lo + kJ <= nl:
                        out.tile(grp, R, kJ, l0 + lo, b * R, C)
                        lo += kJ
                    for J in (4, 2, 1):
                        if J < kJ and (nl - lo) & J:
                            out.tile(grp, R, J, l0 + lo, b * R, C)
                            lo += J
    return out


#: (L, C, per-lane aux, SMs): one lane in 16-row tiles with a ragged last
#: tile, in 8-row tiles, in 1-row tiles; a shared block of 8 lanes (one
#: chunk of 8); 37 lanes as chunks of 8, 8, 8, 8, 4, 1 over several tiles
#: a warp; 37 lanes over few rows, spread as blocks of 8, 8, 8, 8, 5 (the
#: last in chunks of 4 and 1); 100 lanes in lane blocks; a shared aux with
#: a ragged last tile; a shared aux shorter than a tile (one CTA a lane);
#: per-lane aux in 16-, 8- and 1-row tiles
SHAPES = ((1, 600, False, 1), (1, 70, False, 132), (1, 5, False, 132),
          (8, 100, False, 1), (37, 100, False, 1), (37, 40, False, 132),
          (100, 200, False, 132), (100, 31, False, 132), (9, 3, False, 132),
          (8, 17, True, 1), (37, 33, True, 132), (100, 1, True, 132))


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "L{}-C{}-{}-sm{}".format(
    s[0], s[1], "per_lane" if s[2] else "shared", s[3]))
@pytest.mark.parametrize("r", [3, 45, 256, 257, 1024])
def test_walk_gives_the_first_ports_bits(r, shape):
    L, C, per_lane, sms = shape
    rng = np.random.default_rng(r * 1000 + L + C)
    aux = (rng.random((L, C, r) if per_lane else (C, r)) * 40).astype(F32)
    state = (rng.random((L, r)) * 40).astype(F32)
    state[:, ::5] = 0.0
    grp = np.ascontiguousarray(groups(aux, state))
    want = first_port_order(grp)
    got = walk_order(grp, r, per_lane, sms)
    assert (got.writes == 1).all(), "an output is not written exactly once"
    np.testing.assert_array_equal(got.v.view(np.uint32), want.view(np.uint32))
    exact = np.maximum(np.broadcast_to(aux, (L, C, r)).astype(np.float64)
                       - state[:, None, :], 0.0).sum(-1)
    tol = 2 * r * 2.0 ** -24 * (np.abs(np.broadcast_to(aux, (L, C, r))).sum(-1)
                                + np.abs(state).sum(-1, keepdims=True))
    assert (np.abs(got.v - exact) <= tol).all()


def test_a_state_row_too_wide_for_shared_memory_takes_the_lane_route():
    """Past 58,112 columns one lane's state does not fit in a CTA's shared
    memory: a shared aux is then read once a lane, in the same order."""
    L, C, r = 2, 40, 58_113
    rng = np.random.default_rng(5)
    aux = (rng.random((C, r)) * 40).astype(F32)
    state = (rng.random((L, r)) * 40).astype(F32)
    grp = np.ascontiguousarray(groups(aux, state))
    got = walk_order(grp, r, False, 132)
    assert (got.writes == 1).all()
    np.testing.assert_array_equal(got.v.view(np.uint32),
                                  first_port_order(grp).view(np.uint32))


@pytest.mark.parametrize("mode", ["unbatched", "shared", "per_lane"])
@pytest.mark.parametrize("r", [3, 45, 257, 1024])
def test_plain_version_matches_jax_at_odd_widths(r, mode):
    L, C = 9, 33
    rng = np.random.default_rng(r + 7 * len(mode))
    aux = (rng.random((L, C, r) if mode == "per_lane" else (C, r)) * 40
           ).astype(F32)
    state = (rng.random(r) * 40).astype(F32) if mode == "unbatched" else \
        (rng.random((L, r)) * 40).astype(F32)
    got = ops.rectified_residual_sum(interop.tensor(aux),
                                     interop.tensor(state)).numpy()
    if mode == "unbatched":
        pairs, got = [(aux, state)], got[None]
    else:
        pairs = [(aux[lane] if mode == "per_lane" else aux, state[lane])
                 for lane in range(L)]
    assert got.shape == (len(pairs), C)
    tol = np.stack([2 * r * 2.0 ** -24 * (np.abs(a).sum(-1) + np.abs(s).sum())
                    for a, s in pairs])
    for fn in (jref.rectified_residual_sum, jops.rectified_residual_sum):
        want = np.stack([np.asarray(fn(jnp.asarray(a), jnp.asarray(s)))
                         for a, s in pairs])
        assert (np.abs(got - want) <= tol).all()
