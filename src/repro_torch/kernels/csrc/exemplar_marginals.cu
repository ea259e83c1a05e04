// ExemplarClustering marginal gains on Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/exemplar_marginals.py,
// exemplar_marginals (body _ex_kernel):
//
//     out[l, i] = sum_j max( state[l, j] - d2(i, j), 0 )
//     d2(i, j)  = max( (||ref_j||^2 - 2 <cand_i, ref_j>) + ||cand_i||^2, 0 )
//
// with an explicit lane axis L in place of the JAX engines' vmap: the
// candidate block is one (C, d) block shared by every lane (the filter, the
// max-singleton and top-singleton calls, dense phase 1) or one block per
// lane, (L, C, d) (the lazy chunks).  The state is each lane's current
// min squared distance to the reference rows.
//
// What bounds it on the H100: it is the distance twin of
// facility_marginals.cu.  At the filter shape (L = 37, C = 1,048,576,
// d = r = 256, f32) the product is 2CRd ~ 1.4e11 FLOP and the lanes'
// residuals 3LCR ~ 3.0e10 operations, 2.5 ms at 67 TFLOP/s of f32 FFMA
// against 0.37 ms for the bytes: bound by operations.  The distance tile
// does not depend on the lane, so it is computed once per (row tile,
// column tile) for up to kMaxLaneGroup lanes, not once per lane as the
// vmapped Pallas kernel computes it.
//
// Design: the register-blocked SIMT tile of marginals_tile.cuh with its
// Exemplar rule, shared with facility_marginals.cu.  A CTA owns 128
// candidate rows and up to 128 lanes; it takes the rows' squared norms
// once (reftile::row_sq), then walks the r columns in 128-wide product
// tiles (the same fmaf chains as sims::tile, so exemplar_accept sees the
// same distances), forms d2 = max((refsq_j - 2 acc) + sq_i, 0) once per
// (row, column) for all lanes, and adds max(s_lj - d2, 0) into the
// 4-lane x 4-row blocks of sums one thread owns, with no float atomics,
// so a repeated launch gives the same bits.  Ragged rows (past C) and
// columns (past r) are masked, not padded (the JAX kernel pads the state
// with -inf).
#include "marginals_tile.cuh"

// cand (C, d) shared or (L, C, d) per lane, f32 or bf16; ref (r, d) f32;
// refsq (r,) f32 = ||ref_j||^2; state (L, r) f32; out (L, C) f32.
extern "C" int exemplar_marginals_launch(const void* cand, int cand_is_bf16,
                                         int cand_per_lane, const void* ref,
                                         const void* refsq, const void* state,
                                         void* out, int L, long long C, int r,
                                         int d, void* stream) {
  return (int)mtile::launch(
      cand, cand_is_bf16, cand_per_lane, ref,
      reftile::Exemplar{static_cast<const float*>(refsq)}, state, out, L, C,
      r, d, static_cast<cudaStream_t>(stream));
}
