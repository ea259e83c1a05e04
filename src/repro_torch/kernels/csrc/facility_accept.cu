// Fused FacilityLocation chunk-accept sweep on Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/facility_accept.py,
// facility_accept (body _fa_kernel, on run_sweep in _accept_common.py), in
// both of its modes: cardinality (cost=None) and knapsack cost
// (accept_sweep.cuh).  One call serves L lanes, which is what the JAX
// engines got from vmapping the Pallas kernel over the tau grid.
//
// Two launches on the caller's stream (reference_tile.cuh's sweep with its
// Facility rule, shared with exemplar_accept.cu):
//  1. product_kernel: the (L, B, r) block sims = max(cand @ ref^T, 0) into
//     an (L, B, r) f32 workspace the wrapper allocates, one CTA of 256
//     threads a 64 x 64 tile (sims_tile.cuh: 4 x 4 sums a thread, 32-deep
//     slices double-buffered in shared memory), so the grid is every tile
//     of every lane (296 CTAs at the path case) and each value is the fmaf
//     chain over k = 0 .. d - 1 that facility_marginals' tile also forms;
//  2. walk_kernel: one CTA a lane walks its block in stream order: row i's
//     gain is sum_j max(sims[i, j] - s_j, 0) against the live cover vector
//     s, and an accepted row applies s = max(s, sims[i, :]).  A pass scores
//     32 rows against s at once, with the reduction tree of the row loop
//     (accept_sweep.cuh) batched over them, and a ballot takes the first
//     row that passes: one barrier a pass; after an accept close by, the
//     walk runs the row loop until two rows in a row are rejected.
//     The state stays in registers: thread t owns columns t, t + 256, ...,
//     so an accept is a thread-local max (past r = 4096 the wide instance
//     keeps the row loop with the state in global memory).
// Outputs: mask (L, B) bool, post-sweep state (L, r) f32, and each row's
// gain at scan time (L, B) f32, the bits of the one-CTA-a-lane row loop
// this design replaced.
//
// What bounds it on the H100: at (37, 128, 256), r = 256, the product is
// 2LBrd ~ 6.2e8 FLOP (9.3 us at 67 TFLOP/s) and the bytes ~1.5 us.  On an
// NVIDIA H100 80GB HBM3 at 700 W (PERF.md) the product takes ~39 us,
// against ~25 us for torch.matmul of it: its 296 CTAs put three on some
// SMs and two on the rest, and 264 CTAs (two an SM) take ~29 us.  The walk
// takes ~9 us when a lane accepts a row or none (4-5 wide passes of
// ~2,500 cycles), and ~40 us when it accepts every row (~510 cycles a row
// of its row loop, against ~400 for the one-CTA-a-lane row loop).
#include "reference_tile.cuh"

// cost (L, B) f32 and cost_budget (L,) f32 select the knapsack cost mode,
// nullptr the cardinality mode.
extern "C" int facility_accept_launch(const void* cand, int cand_is_bf16,
                                      const void* ref, const void* state,
                                      const void* eligible, const void* tau,
                                      const void* budget, const void* cost,
                                      const void* cost_budget, void* mask,
                                      void* state_out, void* gains,
                                      void* work, int L, int B, int r, int d,
                                      int per, void* stream) {
  return (int)reftile::launch_sweep(
      cand, cand_is_bf16, ref, reftile::Facility{nullptr}, state, eligible,
      tau, budget, cost, cost_budget, mask, state_out, gains, work, L, B, r,
      d, per, static_cast<cudaStream_t>(stream));
}
