// Fused GraphCut chunk-accept sweep on Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/graph_cut_accept.py,
// graph_cut_accept (its pallas_call is accept_call in
// src/repro/kernels/_accept_common.py), in both of its modes: cardinality
// (cost=None) and knapsack cost (feature_sweep.cuh).  One launch serves L
// lanes, one CTA each, in place of the JAX engines' vmap over the tau grid.
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
// real cost is the chain of B dependent block reductions the order of the
// sweep asks for.  The design (feature_sweep.cuh with rules::GraphCut)
// keeps each thread's slice of s and of pre = t - 2 lam s in registers, so
// a row costs four rounded operations per feature, and an accept
// recomputes pre for its features with no barrier.  Up to 256 features it
// runs the row loop, one block reduction a row with row i + 1 loaded while
// row i is reduced: its lanes accept about every other row, where the
// windowed walk measured slower on an H100, and so does the f32 sweep at
// 513 to 1024 features (its cost mode).  Elsewhere up to 2048 features it
// runs the walk, several rows a barrier; past 2048 the wide instance keeps
// s in global memory.
#include "feature_sweep.cuh"

extern "C" int graph_cut_accept_launch(
    const void* x, int x_is_bf16, const void* state, const void* total,
    float lam, const void* eligible, const void* tau, const void* budget,
    const void* cost, const void* cost_budget, void* mask, void* state_out,
    void* gains, int L, int B, int d, int per, void* stream) {
  const rules::GraphCut rule{static_cast<const float*>(total), lam};
  return (int)feature_sweep::launch_any(x, x_is_bf16, state, rule, eligible,
                                        tau, budget, cost, cost_budget, mask,
                                        state_out, gains, L, B, d, per,
                                        static_cast<cudaStream_t>(stream));
}
