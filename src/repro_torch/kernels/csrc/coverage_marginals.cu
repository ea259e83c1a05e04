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
// C = 1,048,576, d = 256, f32 x) the kernel reads 1 GiB of x once and does
// L*C*d ~ 9.9e9 IEEE square roots.  1 GiB at 3.35 TB/s is 0.32 ms; the
// square roots (plus an add, a subtract, a multiply and an add each) are
// ~5e10 operations, 0.74 ms at 67 TFLOP/s of f32, and more in practice
// because a correctly rounded sqrtf is an SFU reciprocal square root plus
// a Newton step.  So it is bound by operations, not bytes.
//
// What the design does about it: the lane-blocked row walk of lane_rows.cuh
// with the rules::Coverage term.  sqrt(s) is computed once per lane and
// feature per CTA (into shared memory), not once per row, so each (lane,
// row, feature) costs exactly one square root, the minimum the formula
// needs; a shared x row is read from device memory once per block of up to
// 8 lanes.  No --use_fast_math: parity with the plain version needs IEEE
// sqrtf.
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
