// Fused ExemplarClustering chunk-accept sweep on Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/exemplar_accept.py,
// exemplar_accept (body _ea_kernel, on run_sweep in _accept_common.py), in
// both of its modes: cardinality (cost=None) and knapsack cost
// (accept_sweep.cuh).  One launch serves L lanes, one CTA each, in place of
// the JAX engines' vmap over the tau grid.
//
// Per lane, two phases (reference_tile.cuh's sweep with its Exemplar rule,
// shared with facility_accept.cu):
//  1. the (B, r) block d2 = max((refsq_j - 2 <cand_i, ref_j>) + sq_i, 0) of
//     the lane's chunk, from the same product tiles and epilogue as
//     exemplar_marginals.cu, written to an (L, B, r) f32 workspace the
//     wrapper allocates (a (B, r) block outgrows shared memory at
//     r = 1024);
//  2. the sweep over its rows in order (run_sweep): row i's gain is
//         sum_j max(s_j - d2[i, j], 0)
//     against the live min-distance vector s, and an accepted row applies
//     s = min(s, d2[i, :]).  s stays in registers: thread t owns columns
//     t, t + 256, ..., so an accept is a thread-local min (past r = 4096
//     the wide instance keeps s in global memory).
// Outputs: mask (L, B) bool, post-sweep state (L, r) f32, and each row's
// gain at scan time (L, B) f32.
//
// What bounds it on the H100: at (37, 128, 256), r = 256, the product is
// 2LBrd ~ 6.2e8 FLOP (9.3 us at 67 TFLOP/s) and the bytes ~1.5 us; but only
// L CTAs run, and phase 2 is the chain of B dependent block reductions
// (accept_sweep.cuh).  Both are far above the bound, as for facility_accept.
#include "reference_tile.cuh"

// cand (L, B, d) f32 or bf16; ref (r, d) f32; refsq (r,) f32; state (L, r)
// f32; eligible (L, B) bool; tau (L,) f32; budget (L,) int32; cost (L, B)
// f32 and cost_budget (L,) f32 for the knapsack cost mode, nullptr for the
// cardinality mode; work (L, B, r) f32 scratch.
extern "C" int exemplar_accept_launch(const void* cand, int cand_is_bf16,
                                      const void* ref, const void* refsq,
                                      const void* state, const void* eligible,
                                      const void* tau, const void* budget,
                                      const void* cost,
                                      const void* cost_budget, void* mask,
                                      void* state_out, void* gains,
                                      void* work, int L, int B, int r, int d,
                                      int per, void* stream) {
  return (int)reftile::launch_sweep(
      cand, cand_is_bf16, ref,
      reftile::Exemplar{static_cast<const float*>(refsq)}, state, eligible,
      tau, budget, cost, cost_budget, mask, state_out, gains, work, L, B, r,
      d, per, static_cast<cudaStream_t>(stream));
}
