// Fused FeatureCoverage chunk-accept sweep on Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/coverage_accept.py,
// coverage_accept (its pallas_call is accept_call in
// src/repro/kernels/_accept_common.py), in the cardinality mode
// (cost=None).  One launch serves L lanes, one CTA each, which is what the
// JAX engines got from vmapping the Pallas kernel over the tau grid.
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
// (accept_sweep.cuh).  The design (feature_sweep.cuh with rules::Coverage)
// keeps the state and its square roots in registers (one thread owns up to
// 16 features), recomputes sqrt(s) only on an accept, and loads row i + 1
// while row i is being reduced.  Only L CTAs run, so the card is mostly
// idle during a sweep: the gap to the byte bound is recorded in PERF.md and
// left for a later change.
#include "feature_sweep.cuh"

extern "C" int coverage_accept_launch(const void* x, int x_is_bf16,
                                      const void* state, const void* weights,
                                      const void* eligible, const void* tau,
                                      const void* budget, void* mask,
                                      void* state_out, void* gains, int L,
                                      int B, int d, void* stream) {
  const rules::Coverage rule{static_cast<const float*>(weights)};
  return (int)feature_sweep::launch_any(x, x_is_bf16, state, rule, eligible,
                                        tau, budget, mask, state_out, gains,
                                        L, B, d,
                                        static_cast<cudaStream_t>(stream));
}
