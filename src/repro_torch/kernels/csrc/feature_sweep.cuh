// The accept sweep of the coverage-family oracles (coverage_accept.cu,
// weighted_coverage_accept.cu, saturated_coverage_accept.cu): a Step for
// the shared sweep in accept_sweep.cuh over an O(d) elementwise state, with
// a Rule from feature_rules.cuh.
//
// One CTA sweeps one lane's (B, d) tile.  Every thread owns kPer features:
// their state, pre = Rule::pre(s) and the Rule's operands stay in registers
// for the whole sweep, so an accept is a thread-local update (and pre is
// recomputed only then), and row i + 1 is loaded while row i is being
// reduced.  Outputs: mask (L, B) bool, post-sweep state (L, d) f32, and each
// row's gain at scan time (L, B) f32.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "accept_sweep.cuh"
#include "feature_rules.cuh"

namespace feature_sweep {

constexpr int kThreads = 128;
constexpr int kMaxPer = 16;  // features per thread: d <= 2048

__device__ __forceinline__ float load_f(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

template <typename T, int kPer, class Rule>
struct Step {
  const T* x;  // this lane's (B, d) tile
  int B, d;
  float s[kPer], pre[kPer], ops[kPer][Rule::kFeat + 1], cur[kPer], next[kPer];

  __device__ void load_row(int i, float* dst) const {
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int f = threadIdx.x + j * kThreads;
      dst[j] = (i < B && f < d) ? load_f(x + (long long)i * d + f) : 0.0f;
    }
  }

  __device__ float partial(int i) {
#pragma unroll
    for (int j = 0; j < kPer; ++j) cur[j] = next[j];
    load_row(i + 1, next);
    float p = 0.0f;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int f = threadIdx.x + j * kThreads;
      if (f < d) p += Rule::term(s[j], pre[j], cur[j], ops[j]);
    }
    return p;
  }

  __device__ void accept() {
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      s[j] = Rule::update(s[j], cur[j]);
      pre[j] = Rule::pre(s[j], ops[j]);
    }
  }
};

template <typename T, int kPer, class Rule>
__global__ void __launch_bounds__(kThreads)
kernel(const T* __restrict__ x, const float* __restrict__ state, Rule rule,
       const unsigned char* __restrict__ eligible,
       const float* __restrict__ tau, const int* __restrict__ budget,
       unsigned char* __restrict__ mask, float* __restrict__ state_out,
       float* __restrict__ gains, int B, int d) {
  const int l = blockIdx.x;
  Step<T, kPer, Rule> step;
  step.x = x + (long long)l * B * d;
  step.B = B;
  step.d = d;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int f = threadIdx.x + j * kThreads;
#pragma unroll
    for (int k = 0; k < Rule::kFeat; ++k)
      step.ops[j][k] = f < d ? rule.operand(k, f) : 0.0f;
    step.s[j] = f < d ? state[(long long)l * d + f] : 0.0f;
    step.pre[j] = Rule::pre(step.s[j], step.ops[j]);
  }
  step.load_row(0, step.next);
  run_sweep<kThreads>(step, B, eligible + (long long)l * B, tau[l], budget[l],
                      mask + (long long)l * B, gains + (long long)l * B);
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int f = threadIdx.x + j * kThreads;
    if (f < d) state_out[(long long)l * d + f] = step.s[j];
  }
}

template <typename T, int kPer, class Rule>
cudaError_t launch_per(const void* x, const void* state, const Rule& rule,
                       const void* eligible, const void* tau,
                       const void* budget, void* mask, void* state_out,
                       void* gains, int L, int B, int d, cudaStream_t stream) {
  kernel<T, kPer, Rule><<<L, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(state), rule,
      static_cast<const unsigned char*>(eligible),
      static_cast<const float*>(tau), static_cast<const int*>(budget),
      static_cast<unsigned char*>(mask), static_cast<float*>(state_out),
      static_cast<float*>(gains), B, d);
  return cudaGetLastError();
}

template <typename T, class Rule>
cudaError_t launch(const void* x, const void* state, const Rule& rule,
                   const void* eligible, const void* tau, const void* budget,
                   void* mask, void* state_out, void* gains, int L, int B,
                   int d, cudaStream_t stream) {
#define REPRO_SWEEP_CASE(P)                                                   \
  if (d <= (P) * kThreads)                                                    \
    return launch_per<T, P, Rule>(x, state, rule, eligible, tau, budget,      \
                                  mask, state_out, gains, L, B, d, stream);
  REPRO_SWEEP_CASE(1)
  REPRO_SWEEP_CASE(2)
  REPRO_SWEEP_CASE(4)
  REPRO_SWEEP_CASE(8)
  REPRO_SWEEP_CASE(kMaxPer)
#undef REPRO_SWEEP_CASE
  return cudaErrorInvalidValue;  // d > 2048: the wrappers refuse it first
}

// Launch L lane sweeps, one CTA each, dispatching on the dtype of x
// (float32 or bfloat16).  Nothing runs when L or d is 0.
template <class Rule>
cudaError_t launch_any(const void* x, int x_is_bf16, const void* state,
                       const Rule& rule, const void* eligible,
                       const void* tau, const void* budget, void* mask,
                       void* state_out, void* gains, int L, int B, int d,
                       cudaStream_t stream) {
  if (L <= 0 || d <= 0) return cudaSuccess;
  return x_is_bf16
      ? launch<__nv_bfloat16>(x, state, rule, eligible, tau, budget, mask,
                              state_out, gains, L, B, d, stream)
      : launch<float>(x, state, rule, eligible, tau, budget, mask, state_out,
                      gains, L, B, d, stream);
}

}  // namespace feature_sweep
