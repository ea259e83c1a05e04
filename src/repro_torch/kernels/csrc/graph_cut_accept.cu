// Fused GraphCut chunk-accept sweep on Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/graph_cut_accept.py,
// graph_cut_accept (its pallas_call is accept_call in
// src/repro/kernels/_accept_common.py), in the cardinality mode
// (cost=None).  One launch serves L lanes, one CTA each, in place of the
// JAX engines' vmap over the tau grid.
//
// Per lane: sweep the (B, d) tile in order; row i's gain is
//     sum_f ( x_if (t_f - 2 lam s_f) - lam x_if^2 )
// against the live selected-row sum s, with t the ground set's feature
// sum, and an accepted row applies s += x_i.  The JAX kernel bakes lam in
// at compile time; here it is an argument, and the arithmetic is the same.
// Outputs: mask (L, B) bool, post-sweep state (L, d) f32, each row's gain
// at scan time (L, B) f32.
//
// What bounds it on the H100: 4.8 MB of rows at L = 37, B = 128, d = 256
// is about 1.5 us at 3.35 TB/s, and the operations are fewer still; the
// real cost is the chain of B dependent block reductions
// (accept_sweep.cuh).  The design (feature_sweep.cuh with rules::GraphCut)
// keeps each thread's slice of s and of pre = t - 2 lam s in registers, so
// a row costs four rounded operations per feature and one block
// reduction, an accept recomputes pre for its features with no barrier,
// and row i + 1 is loaded while row i is being reduced.
#include "feature_sweep.cuh"

extern "C" int graph_cut_accept_launch(
    const void* x, int x_is_bf16, const void* state, const void* total,
    float lam, const void* eligible, const void* tau, const void* budget,
    void* mask, void* state_out, void* gains, int L, int B, int d,
    void* stream) {
  const rules::GraphCut rule{static_cast<const float*>(total), lam};
  return (int)feature_sweep::launch_any(x, x_is_bf16, state, rule, eligible,
                                        tau, budget, mask, state_out, gains,
                                        L, B, d,
                                        static_cast<cudaStream_t>(stream));
}
