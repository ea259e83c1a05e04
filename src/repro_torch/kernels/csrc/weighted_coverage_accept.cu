// Fused WeightedCoverage chunk-accept sweep on Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/weighted_coverage_accept.py,
// weighted_coverage_accept (its pallas_call is accept_call in
// src/repro/kernels/_accept_common.py), in both of its modes: cardinality
// (cost=None) and knapsack cost (feature_sweep.cuh).  One launch serves L
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
// real cost is the chain of B dependent block reductions the order of the
// sweep asks for, which the first port paid a row at a time.  The design
// (feature_sweep.cuh's windowed walk with rules::WeightedCoverage) keeps
// each thread's slice of s in registers and scores 32 rows a pass (one
// multiply-add a feature and row), reduced by one reduce-scatter a warp
// and one barrier for all of them, a ballot for the first accept; an
// accept is one multiply a feature with no barrier.  The pass loads its
// rows together, so no row waits on a load scheduled behind the last
// row's barrier.  At 1025 to 2048 features the f32 sweep keeps the row
// loop, a row at a time, where the walk's 16 features a thread spill; past
// 2048 the wide instance keeps s in global memory.
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
