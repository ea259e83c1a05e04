// Fused FeatureCoverage chunk-accept sweep on Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/coverage_accept.py,
// coverage_accept (its pallas_call is accept_call in
// src/repro/kernels/_accept_common.py), in both of its modes: cardinality
// (cost=None) and knapsack cost (feature_sweep.cuh).  One launch serves L
// lanes, one CTA each, which is what the JAX engines got from vmapping the
// Pallas kernel over the tau grid.
//
// Per lane: sweep the (B, d) tile in order; row i's gain is
//     sum_f w_f * ( sqrt(s_f + x_if) - sqrt(s_f) )
// against the live state s, and an accepted row applies s += x_i.
// Outputs: mask (L, B) bool, post-sweep state (L, d) f32, and each row's
// gain at scan time (L, B) f32.
//
// What bounds it on the H100: the bytes are small (L*B*d*4 ~ 4.8 MB at
// L = 37, B = 128, d = 256, about 1.5 us at 3.35 TB/s) and so are the
// operations; the real cost is the chain of B dependent block reductions
// the order of the sweep asks for, which the first port paid a row at a
// time (one butterfly and one barrier a row, plus two roots through
// sqrtf's branchy slow-path test).  The design (feature_sweep.cuh's
// windowed walk with rules::Coverage) keeps the state and its square roots
// in registers (one thread owns up to 16 features) and scores 32 rows a
// pass: their 64 roots behind one range test (rules::sqrt_rn, sqrtf's
// bits), one reduce-scatter a warp and one barrier for all of them, a
// ballot for the first accept; sqrt(s) is recomputed only on an accept.
// Only L CTAs run, so the card is mostly idle during a sweep: the gap to
// the byte bound is recorded in PERF.md.  Past 2048 features the wrapper
// picks the sweep's wide instance, which keeps the state in global memory
// (feature_sweep.cuh).
#include "feature_sweep.cuh"

extern "C" int coverage_accept_launch(const void* x, int x_is_bf16,
                                      const void* state, const void* weights,
                                      const void* eligible, const void* tau,
                                      const void* budget, const void* cost,
                                      const void* cost_budget, void* mask,
                                      void* state_out, void* gains, int L,
                                      int B, int d, int per, void* stream) {
  const rules::Coverage rule{static_cast<const float*>(weights)};
  return (int)feature_sweep::launch_any(x, x_is_bf16, state, rule, eligible,
                                        tau, budget, cost, cost_budget, mask,
                                        state_out, gains, L, B, d, per,
                                        static_cast<cudaStream_t>(stream));
}
