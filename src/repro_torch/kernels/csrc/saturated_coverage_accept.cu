// Fused SaturatedCoverage chunk-accept sweep on Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/saturated_coverage_accept.py,
// saturated_coverage_accept (its pallas_call is accept_call in
// src/repro/kernels/_accept_common.py), in the cardinality mode
// (cost=None).  One launch serves L lanes, one CTA each, in place of the
// JAX engines' vmap over the tau grid.
//
// Per lane: sweep the (B, d) tile in order; row i's gain is
//     sum_f w_f * ( min(s_f + x_if, cap_f) - min(s_f, cap_f) )
// against the live accumulator s, with cap = alpha * total from the
// caller, and an accepted row applies s += x_i.  Outputs: mask (L, B)
// bool, post-sweep state (L, d) f32, each row's gain at scan time (L, B)
// f32.
//
// What bounds it on the H100: 4.8 MB of rows at L = 37, B = 128, d = 256
// is about 1.5 us at 3.35 TB/s; the real cost is the chain of B dependent
// block reductions (accept_sweep.cuh).  The design (feature_sweep.cuh with
// rules::SaturatedCoverage) keeps each thread's slice of s, min(s, cap),
// cap and w in registers, recomputes min(s, cap) only on an accept, and
// loads row i + 1 while row i is being reduced.
#include "feature_sweep.cuh"

extern "C" int saturated_coverage_accept_launch(
    const void* x, int x_is_bf16, const void* state, const void* cap,
    const void* weights, const void* eligible, const void* tau,
    const void* budget, void* mask, void* state_out, void* gains, int L,
    int B, int d, void* stream) {
  const rules::SaturatedCoverage rule{static_cast<const float*>(cap),
                                      static_cast<const float*>(weights)};
  return (int)feature_sweep::launch_any(x, x_is_bf16, state, rule, eligible,
                                        tau, budget, mask, state_out, gains,
                                        L, B, d,
                                        static_cast<cudaStream_t>(stream));
}
