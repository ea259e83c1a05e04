// WeightedCoverage marginal gains on Hopper (sm_90a).
//
//   out[l, i] = sum_u s[l, u] * x[i, u]
//
// with s the lanes' remaining (uncovered) weight per universe item and x
// the candidates' incidence rows.  Replaces the TPU kernel
// src/repro/kernels/weighted_coverage_marginals.py,
// weighted_coverage_marginals (body _wc_kernel), with an explicit lane axis
// L in place of the JAX engines' vmap.
//
// What bounds it on the H100: with x (C, U) shared by L lanes it is the
// skinny product (C, U) x (U, L).  At the filter shape (L = 37,
// C = 1,048,576, U = 256, f32) the 1 GiB of x read once and the 155 MB
// (L, C) output take 0.37 ms at 3.35 TB/s and the 2 L C U = 1.99e10
// operations 0.30 ms at 67 TFLOP/s of f32, so it sits near both bounds:
// every x element read from device memory has to feed every lane from
// registers or shared memory.  With one x block per lane, (L, C, U), or a
// single lane, it is a batched GEMV, bound by its bytes.
//
// What held the first port back (a 64 x 64 sims_tile.cuh tile, 4 x 4 per
// thread): 27 of its 64 lane columns idle at L = 37, 2 bytes of shared
// memory per FMA, single-buffered loads, outputs scattered 4 bytes at a
// time.  The product is graph cut's without the norm term, so:
//
//  * Shared x, L >= 2: the persistent skinny tile of skinny_tile.cuh with
//    the WeightedCoverage policy: the lanes' states are the coefficient
//    rows (lanes rounded up to 8, 40 at L = 37), x streams once through a
//    cp.async ring, a thread keeps 8 rows x up to 8 lanes of sums in
//    registers, and the sums are the gains.  Every sum is one fmaf chain
//    over u = 0..U-1 from 0, as the first port's was, so a repeated launch
//    gives the same bits and the gains keep the first port's bits.
//  * Per-lane x, or one lane: the lane walk of lane_rows.cuh with the
//    rules::WeightedCoverage term, a warp tile of 16, 8 or 1 rows of one
//    lane streaming x once.
#include "lane_rows.cuh"
#include "skinny_tile.cuh"

extern "C" int weighted_coverage_marginals_launch(const void* x, int x_is_bf16,
                                                  int x_per_lane,
                                                  const void* state, void* out,
                                                  int L, long long C, int d,
                                                  void* stream) {
  if (L <= 0 || C <= 0 || d <= 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_per_lane || L == 1)
    return (int)lane_rows::launch_any(x, x_is_bf16, x_per_lane, state,
                                      rules::WeightedCoverage{}, out, L, C, d,
                                      s);
  return (int)skinny::launch<skinny::WeightedCoverage>(
      x, x_is_bf16, nullptr, static_cast<const float*>(state), 0.0f, out, L,
      C, d, s);
}
