// SaturatedCoverage marginal gains on Hopper (sm_90a).
//
//   out[l, i] = sum_f w_f * ( min(s[l, f] + x[i, f], cap_f) - min(s[l, f], cap_f) )
//
// with cap = alpha * total the per-feature saturation level, computed by
// the caller.  Replaces the TPU kernel
// src/repro/kernels/saturated_coverage_marginals.py,
// saturated_coverage_marginals (body _sat_kernel), with an explicit lane
// axis L in place of the JAX engines' vmap: x is one (C, d) block shared by
// every lane (the filter, phase 1, the max-singleton and top-singleton
// calls) or one block per lane, (L, C, d) (the lazy chunks, phase 2).
//
// What bounds it on the H100: at the full-width filter shape (L = 37,
// C = 1,048,576, d = 256, f32 x) it reads 1 GiB of x once (0.32 ms at
// 3.35 TB/s) and does an add, a min, a subtract and a multiply-add per
// (lane, row, feature), 5 operations counted as coverage's are: ~5e10
// operations, 0.74 ms at 67 TFLOP/s of f32.  Those are four FP32
// instructions a term, so the issue floor is 4 x 9.93e9 / (132 x 128 x
// 1.98e9) = 1.19 ms; the walk's loads and reductions come on top.
//
// What the design does about it: the register tile of lane_rows.cuh with
// the rules::SaturatedCoverage term.  min(s, cap) is computed once per lane
// and feature per CTA into shared memory, in place of coverage's sqrt(s),
// so each (lane, row, feature) costs the four instructions the formula
// needs, and a thread's (s, pre) pair and x value are each loaded once for
// 4 to 8 terms.  Padding is never materialised: the walk masks d and C.
#include "lane_rows.cuh"

extern "C" int saturated_coverage_marginals_launch(
    const void* x, int x_is_bf16, int x_per_lane, const void* state,
    const void* cap, const void* weights, void* out, int L, long long C,
    int d, void* stream) {
  if (L <= 0 || C <= 0 || d <= 0) return (int)cudaSuccess;
  const rules::SaturatedCoverage rule{static_cast<const float*>(cap),
                                      static_cast<const float*>(weights)};
  return (int)lane_rows::launch_any(x, x_is_bf16, x_per_lane, state, rule,
                                    out, L, C, d,
                                    static_cast<cudaStream_t>(stream));
}
