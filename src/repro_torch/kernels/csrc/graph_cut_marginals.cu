// GraphCut marginal gains on Hopper (sm_90a).
//
//   out[l, i] = <x_i, t - 2 lam s_l> - lam ||x_i||^2
//
// with t the ground set's feature sum and s_l lane l's selected-row sum.
// Replaces the TPU kernel src/repro/kernels/graph_cut_marginals.py,
// graph_cut_marginals (body _gc_kernel), with an explicit lane axis L in
// place of the JAX engines' vmap: x is one (C, d) block shared by every
// lane (the filter, phase 1, the max-singleton and top-singleton calls) or
// one block per lane, (L, C, d) (the lazy chunks, phase 2).
//
// What bounds it on the H100: with x (C, d) shared by L lanes it is the
// skinny product (C, d) x (d, L) plus one squared norm per row.  At the
// filter shape (L = 37, C = 1,048,576, d = 256, f32) the 1 GiB of x read
// once and the 155 MB (L, C) output take 0.37 ms at 3.35 TB/s, and the
// 2 L C d + 2 C d = 2.0e10 operations 0.30 ms at 67 TFLOP/s of f32: both
// limits are near, so x has to stream at near the memory's rate while the
// FMAs keep up.  One lane, or one x block per lane, is a (batched) GEMV,
// bound by its bytes.
//
// What held the first port back (a 64 x 64 sims_tile.cuh tile, 4 x 4 per
// thread): 27 of 64 tile columns idle at L = 37, 2 bytes of shared memory
// per FMA, the coefficients t - 2 lam s formed anew by every CTA for every
// slice, x read twice (a norm pass, then the product), single-buffered
// loads, and outputs scattered 4 bytes at a time.
//
// What the design does about it:
//  * Shared x, L >= 2: the persistent skinny tile of skinny_tile.cuh with
//    the GraphCut policy: coefficient rows c_l = t - 2 lam s_l formed once
//    per CTA in shared memory, x streamed once through a cp.async ring,
//    8 rows x up to 8 lanes of fmaf chains a thread, ||x_i||^2 from the
//    staged slices, gains stored straight from registers (the header says
//    how).  weighted_coverage_marginals.cu runs the same tile with its own
//    coefficient rows and no norm term.
//  * Per-lane x, or one lane: the lane walk of lane_rows.cuh with
//    rules::GraphCut (pre = t - 2 lam s once per lane and feature), a warp
//    tile of 16, 8 or 1 rows of one lane streaming x once.
//
// Numbers it keeps: every sum is one fixed-order fmaf chain over features
// 0 .. d - 1 (the projection per (row, lane), ||x_i||^2 per row), with no
// atomics and no split over d, so a repeated launch gives the same bits,
// and on dyadic data (every product and sum exact) the gains equal the
// plain version's bit for bit.  The gain is acc - lam * sq with a rounded
// product, the plain version's order.
#include "lane_rows.cuh"
#include "skinny_tile.cuh"

extern "C" int graph_cut_marginals_launch(const void* x, int x_is_bf16,
                                          int x_per_lane, const void* state,
                                          const void* total, float lam,
                                          void* out, int L, long long C,
                                          int d, void* stream) {
  if (L <= 0 || C <= 0 || d <= 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* t = static_cast<const float*>(total);
  if (x_per_lane || L == 1)
    return (int)lane_rows::launch_any(x, x_is_bf16, x_per_lane, state,
                                      rules::GraphCut{t, lam}, out, L, C, d,
                                      s);
  return (int)skinny::launch<skinny::GraphCut>(
      x, x_is_bf16, t, static_cast<const float*>(state), lam, out, L, C, d,
      s);
}
