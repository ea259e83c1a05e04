// Fused FacilityLocation chunk-accept sweep on Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/facility_accept.py,
// facility_accept (body _fa_kernel, on run_sweep in _accept_common.py), in
// both of its modes: cardinality (cost=None) and knapsack cost
// (accept_sweep.cuh).  One launch serves L lanes, one CTA each, which is
// what the JAX engines got from vmapping the Pallas kernel over the tau
// grid.
//
// Per lane, two phases:
//  1. the (B, r) block sims = max(cand @ ref^T, 0) of the lane's chunk,
//     computed with the same similarity tiles as facility_marginals
//     (sims_tile.cuh), so the product is off the sweep's dependent chain;
//  2. the sweep over its rows in order: row i's gain is
//         sum_j max(sims[i, j] - s_j, 0)
//     against the live cover vector s, and an accepted row applies
//     s = max(s, sims[i, :]).
// Outputs: mask (L, B) bool, post-sweep state (L, r) f32, and each row's
// gain at scan time (L, B) f32.
//
// Where the block lives: a (B, r) f32 block is 128 KB at B = 128, r = 256
// but 512 KB at r = 1024, beyond the 227 KB of shared memory a block can
// have.  So every r takes the same road: the wrapper allocates an (L, B, r)
// f32 workspace (4.8 MB for 37 lanes at B = 128, r = 256, resident in the
// 50 MB L2), phase 1 writes the lane's block there, and phase 2 streams it
// back one row ahead of the sweep.  The state stays in registers: thread t
// owns columns t, t + 256, ..., so an accept is a thread-local max (past
// r = 4096 the wide instance keeps the state in global memory).  The
// kernel is reference_tile.cuh's sweep with its Facility rule, shared with
// exemplar_accept.cu.
//
// What bounds it on the H100: at (37, 128, 256), r = 256, the product is
// 2LBrd ~ 6.2e8 FLOP (9.3 us at 67 TFLOP/s) and the bytes ~1.5 us; but
// only L CTAs run, so phase 1 uses 37 of 132 SMs, and phase 2 is the chain
// of B dependent block reductions (accept_sweep.cuh).  Both are far above
// the bound; the gap is recorded in PERF.md and left for a later change.
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
