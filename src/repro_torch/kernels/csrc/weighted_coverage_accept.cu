// Fused WeightedCoverage chunk-accept sweep on Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/weighted_coverage_accept.py,
// weighted_coverage_accept (its pallas_call is accept_call in
// src/repro/kernels/_accept_common.py), in both of its modes: cardinality
// (cost=None) and knapsack cost (accept_sweep.cuh).  One launch serves L
// lanes, one CTA each, in place of the JAX engines' vmap over the tau grid.
//
// Per lane: sweep the (B, U) incidence tile in order; row i's gain is
//     sum_u s_u * x_iu
// against the live remaining-weight vector s, and an accepted row applies
// s = s * (1 - x_i), written so (not s - s x) because on binary incidence
// rows it then gives exactly 0 or s, as the JAX package does.  Outputs:
// mask (L, B) bool, post-sweep state (L, U) f32, each row's gain at scan
// time (L, B) f32.
//
// What bounds it on the H100: 4.8 MB of rows at L = 37, B = 128, U = 256
// is about 1.5 us at 3.35 TB/s, and the operations are fewer still; the
// real cost is the chain of B dependent block reductions (accept_sweep.cuh).
// The design (feature_sweep.cuh with rules::WeightedCoverage) keeps each
// thread's slice of s in registers, so a row costs one multiply-add per
// feature and one block reduction, an accept one multiply per feature with
// no barrier, and row i + 1 is loaded while row i is being reduced (past
// 2048 features the wide instance keeps s in global memory).
#include "feature_sweep.cuh"

extern "C" int weighted_coverage_accept_launch(
    const void* x, int x_is_bf16, const void* state, const void* eligible,
    const void* tau, const void* budget, const void* cost,
    const void* cost_budget, void* mask, void* state_out, void* gains, int L,
    int B, int d, int per, void* stream) {
  const rules::WeightedCoverage rule{};
  return (int)feature_sweep::launch_any(x, x_is_bf16, state, rule, eligible,
                                        tau, budget, cost, cost_budget, mask,
                                        state_out, gains, L, B, d, per,
                                        static_cast<cudaStream_t>(stream));
}
