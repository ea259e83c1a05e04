// The accept sweep of the coverage-family oracles (coverage_accept.cu,
// weighted_coverage_accept.cu, saturated_coverage_accept.cu): a Step for
// the shared sweep in accept_sweep.cuh over an O(d) elementwise state, with
// a Rule from feature_rules.cuh, in the cardinality mode or the knapsack
// cost mode (a (L, B) row-cost matrix and an (L,) remaining budget; see
// accept_sweep.cuh).
//
// One CTA sweeps one lane's (B, d) tile; thread t owns features t, t + 128,
// ..., and its share of a row's gain sums them in that order.  Two
// instances, picked by the wrapper from d (kernels/_wrap.py,
// feature_sweep_per):
//  * narrow (d <= kMaxPer * kThreads = 2048): every thread holds its kPer
//    features' state, pre = Rule::pre(s) and the Rule's operands in
//    registers for the whole sweep, so an accept is a thread-local update
//    (and pre is recomputed only then), and row i + 1 is loaded while row i
//    is being reduced;
//  * wide (any d): the state lives in the lane's row of state_out (global
//    memory; 37 lanes x 4096 features x 4 B = 0.6 MB stay resident in L2),
//    and each row reads its features' state and operands and recomputes
//    pre from s, so no width is refused short of device memory.  A thread
//    reads and writes only its own features, so the state needs no barrier.
// Both sum the same terms in the same order, and pre is a function of s
// alone, so the wide instance gives the bits the narrow one would.
// Outputs: mask (L, B) bool, post-sweep state (L, d) f32, and each row's
// gain at scan time (L, B) f32.
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

template <typename T, int kPer, bool kCost, class Rule>
__global__ void __launch_bounds__(kThreads)
kernel(const T* __restrict__ x, const float* __restrict__ state, Rule rule,
       const unsigned char* __restrict__ eligible,
       const float* __restrict__ tau, const int* __restrict__ budget,
       const float* __restrict__ cost, const float* __restrict__ cost_budget,
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
  run_sweep<kThreads, kCost>(
      step, B, eligible + (long long)l * B, tau[l], budget[l],
      kCost ? cost + (long long)l * B : nullptr, kCost ? cost_budget[l] : 0.0f,
      mask + (long long)l * B, gains + (long long)l * B);
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int f = threadIdx.x + j * kThreads;
    if (f < d) state_out[(long long)l * d + f] = step.s[j];
  }
}

// The wide instance's Step: the state is this lane's row of state_out.
template <typename T, class Rule>
struct WideStep {
  const T* x;  // this lane's (B, d) tile
  float* s;    // this lane's (d,) state, in global memory
  Rule rule;
  int d, i;    // i: the row last scored

  __device__ float partial(int row) {
    i = row;
    const T* xr = x + (long long)row * d;
    float p = 0.0f;
    for (int f = threadIdx.x; f < d; f += kThreads) {
      float ops[Rule::kFeat + 1];
#pragma unroll
      for (int k = 0; k < Rule::kFeat; ++k) ops[k] = rule.operand(k, f);
      const float sf = s[f];
      p += Rule::term(sf, Rule::pre(sf, ops), load_f(xr + f), ops);
    }
    return p;
  }

  __device__ void accept() {
    const T* xr = x + (long long)i * d;
    for (int f = threadIdx.x; f < d; f += kThreads)
      s[f] = Rule::update(s[f], load_f(xr + f));
  }
};

template <typename T, bool kCost, class Rule>
__global__ void __launch_bounds__(kThreads)
wide_kernel(const T* __restrict__ x, const float* __restrict__ state,
            Rule rule, const unsigned char* __restrict__ eligible,
            const float* __restrict__ tau, const int* __restrict__ budget,
            const float* __restrict__ cost,
            const float* __restrict__ cost_budget,
            unsigned char* __restrict__ mask, float* __restrict__ state_out,
            float* __restrict__ gains, int B, int d) {
  const int l = blockIdx.x;
  WideStep<T, Rule> step{x + (long long)l * B * d,
                         state_out + (long long)l * d, rule, d, 0};
  for (int f = threadIdx.x; f < d; f += kThreads)
    step.s[f] = state[(long long)l * d + f];
  run_sweep<kThreads, kCost>(
      step, B, eligible + (long long)l * B, tau[l], budget[l],
      kCost ? cost + (long long)l * B : nullptr, kCost ? cost_budget[l] : 0.0f,
      mask + (long long)l * B, gains + (long long)l * B);
}

template <typename T, int kPer, class Rule>
cudaError_t launch_per(const void* x, const void* state, const Rule& rule,
                       const void* eligible, const void* tau,
                       const void* budget, const void* cost,
                       const void* cost_budget, void* mask, void* state_out,
                       void* gains, int L, int B, int d, cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  const float* st = static_cast<const float*>(state);
  const unsigned char* el = static_cast<const unsigned char*>(eligible);
  const float* ta = static_cast<const float*>(tau);
  const int* bu = static_cast<const int*>(budget);
  const float* co = static_cast<const float*>(cost);
  const float* cb = static_cast<const float*>(cost_budget);
  unsigned char* ma = static_cast<unsigned char*>(mask);
  float* so = static_cast<float*>(state_out);
  float* ga = static_cast<float*>(gains);
  if constexpr (kPer == 0) {
    if (co)
      wide_kernel<T, true, Rule><<<L, kThreads, 0, stream>>>(
          xt, st, rule, el, ta, bu, co, cb, ma, so, ga, B, d);
    else
      wide_kernel<T, false, Rule><<<L, kThreads, 0, stream>>>(
          xt, st, rule, el, ta, bu, co, cb, ma, so, ga, B, d);
  } else {
    if (co)
      kernel<T, kPer, true, Rule><<<L, kThreads, 0, stream>>>(
          xt, st, rule, el, ta, bu, co, cb, ma, so, ga, B, d);
    else
      kernel<T, kPer, false, Rule><<<L, kThreads, 0, stream>>>(
          xt, st, rule, el, ta, bu, co, cb, ma, so, ga, B, d);
  }
  return cudaGetLastError();
}

// per: the instance the wrapper picked (feature_sweep_per): features per
// thread of the narrow instance (1, 2, 4, 8 or 16, with d <= per *
// kThreads), or 0 for the wide instance.
template <typename T, class Rule>
cudaError_t launch(const void* x, const void* state, const Rule& rule,
                   const void* eligible, const void* tau, const void* budget,
                   const void* cost, const void* cost_budget, void* mask,
                   void* state_out, void* gains, int L, int B, int d, int per,
                   cudaStream_t stream) {
  if (per > 0 && d > per * kThreads) return cudaErrorInvalidValue;
#define REPRO_SWEEP_CASE(P)                                                   \
  case P:                                                                     \
    return launch_per<T, P, Rule>(x, state, rule, eligible, tau, budget,      \
                                  cost, cost_budget, mask, state_out, gains,  \
                                  L, B, d, stream);
  switch (per) {
    REPRO_SWEEP_CASE(0)
    REPRO_SWEEP_CASE(1)
    REPRO_SWEEP_CASE(2)
    REPRO_SWEEP_CASE(4)
    REPRO_SWEEP_CASE(8)
    REPRO_SWEEP_CASE(kMaxPer)
  }
#undef REPRO_SWEEP_CASE
  return cudaErrorInvalidValue;
}

// Launch L lane sweeps, one CTA each, dispatching on the dtype of x
// (float32 or bfloat16), on the instance (per, see launch) and on the
// mode: cost (L, B) f32 and cost_budget (L,) f32 select the cost mode,
// nullptr the cardinality mode.  Nothing runs when L or d is 0.
template <class Rule>
cudaError_t launch_any(const void* x, int x_is_bf16, const void* state,
                       const Rule& rule, const void* eligible,
                       const void* tau, const void* budget, const void* cost,
                       const void* cost_budget, void* mask, void* state_out,
                       void* gains, int L, int B, int d, int per,
                       cudaStream_t stream) {
  if (L <= 0 || d <= 0) return cudaSuccess;
  return x_is_bf16
      ? launch<__nv_bfloat16>(x, state, rule, eligible, tau, budget, cost,
                              cost_budget, mask, state_out, gains, L, B, d,
                              per, stream)
      : launch<float>(x, state, rule, eligible, tau, budget, cost,
                      cost_budget, mask, state_out, gains, L, B, d, per,
                      stream);
}

}  // namespace feature_sweep
