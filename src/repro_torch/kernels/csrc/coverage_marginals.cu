// FeatureCoverage marginal gains on Hopper (sm_90a).
//
//   out[l, i] = sum_f w_f * ( sqrt(s[l, f] + x[i, f]) - sqrt(s[l, f]) )
//
// Replaces the TPU kernel src/repro/kernels/coverage_marginals.py,
// coverage_marginals (body _cov_kernel), with an explicit lane axis L in
// place of the vmap the JAX engines put around it: x is either one (C, d)
// block shared by every lane (the filter, phase-1 and top-singleton calls)
// or one (C, d) block per lane, (L, C, d) (the lazy chunks, phase 2).
//
// What bounds it on the H100: at the full-width filter shape (L = 37,
// C = 1,048,576, d = 256, f32 x) the kernel reads 1 GiB of x once (0.32 ms
// at 3.35 TB/s) and forms L*C*d ~ 9.93e9 terms.  Counted as the bound of
// the kernel table counts them (an add, a square root, a subtract, a
// multiply and an add a term: ~5e10 operations over 67 TFLOP/s of f32),
// that is 0.74 ms.  The card's real floor is higher.  A correctly rounded
// sqrtf is one SFU reciprocal square root (MUFU.RSQ, 16 a clock an SM) plus
// a Newton step of four FP32 instructions: 9.93e9 MUFU at 132 SMs x 16 x
// 1.98 GHz is 2.38 ms, and the nine instructions a term issue in no less
// than 9 x 9.93e9 / (132 x 128 x 1.98e9) = 2.67 ms.  So it is bound by
// instruction issue and the SFU, not by bytes.
//
// What the design does about it: the register tile of lane_rows.cuh with
// the rules::Coverage term.  sqrt(s) is computed once per lane and feature
// per CTA (into shared memory), not once per row, so each (lane, row,
// feature) costs exactly one square root, the minimum the formula needs.
// A warp tile's 32 roots share one range test and branch
// (rules::sqrt_rn), where sqrtf has one a root with two convergence
// barriers, and a thread's (s, pre) pair and x value are each loaded once
// for 4 to 8 terms.  No --use_fast_math: parity with the plain version
// needs IEEE sqrtf.
#include "lane_rows.cuh"

extern "C" int coverage_marginals_launch(const void* x, int x_is_bf16,
                                         int x_per_lane, const void* state,
                                         const void* weights, void* out,
                                         int L, long long C, int d,
                                         void* stream) {
  if (L <= 0 || C <= 0 || d <= 0) return (int)cudaSuccess;
  const rules::Coverage rule{static_cast<const float*>(weights)};
  return (int)lane_rows::launch_any(x, x_is_bf16, x_per_lane, state, rule,
                                    out, L, C, d,
                                    static_cast<cudaStream_t>(stream));
}
