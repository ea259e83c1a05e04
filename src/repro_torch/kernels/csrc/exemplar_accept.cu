// Fused ExemplarClustering chunk-accept sweep on Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/exemplar_accept.py,
// exemplar_accept (body _ea_kernel, on run_sweep in _accept_common.py), in
// both of its modes: cardinality (cost=None) and knapsack cost
// (accept_sweep.cuh).  One call serves L lanes, in place of the JAX
// engines' vmap over the tau grid.
//
// Two launches (reference_tile.cuh's sweep with its Exemplar rule, shared
// with facility_accept.cu):
//  1. product_kernel: the (L, B, r) block d2 = max((refsq_j - 2 <cand_i,
//     ref_j>) + sq_i, 0) into an (L, B, r) f32 workspace the wrapper
//     allocates, one CTA a 64 x 64 tile over the whole card, from the same
//     fmaf chains and epilogue as exemplar_marginals.cu; sq_i = ||cand_i||^2
//     is summed from the staged cand slices in row_sq's order, so it has
//     the marginals' bits and costs no pass of its own;
//  2. walk_kernel: one CTA a lane walks its block in stream order: row i's
//     gain is sum_j max(s_j - d2[i, j], 0) against the live min-distance
//     vector s, and an accepted row applies s = min(s, d2[i, :]).  A pass
//     scores a window of rows at once and a ballot takes the first that
//     passes (after an accept close by, the row loop runs until two rows
//     in a row are rejected); s stays in registers: thread t owns columns
//     t, t + 256, ..., so an accept is a thread-local min (past r = 4096
//     the wide instance keeps the row loop with s in global memory).
// Outputs: mask (L, B) bool, post-sweep state (L, r) f32, and each row's
// gain at scan time (L, B) f32.
//
// What bounds it on the H100: as for facility_accept.cu, the product's
// 296 CTAs on 132 SMs (~42 us on an NVIDIA H100 80GB HBM3 at 700 W,
// PERF.md; torch.matmul of it ~25 us) and the walk's chain of passes,
// one barrier a pass.
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
