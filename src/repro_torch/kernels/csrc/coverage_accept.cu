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
// (accept_sweep.cuh).  The design keeps the state and its square roots in
// registers (one thread owns kPer features), recomputes sqrt(s) only on an
// accept, and loads row i + 1 while row i is being reduced.  Only L CTAs
// run, so the card is mostly idle during a sweep: the gap to the byte
// bound is recorded in PERF.md and left for a later change.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "accept_sweep.cuh"

namespace {

constexpr int kThreads = 128;

__device__ __forceinline__ float load_f(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

template <typename T, int kPer>
struct CoverageStep {
  const T* x;  // this lane's (B, d) tile
  int B, d;
  float s[kPer], rs[kPer], w[kPer], cur[kPer], next[kPer];

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
      if (f < d) p += (sqrtf(s[j] + cur[j]) - rs[j]) * w[j];
    }
    return p;
  }

  __device__ void accept() {
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      s[j] += cur[j];
      rs[j] = sqrtf(s[j]);
    }
  }
};

template <typename T, int kPer>
__global__ void __launch_bounds__(kThreads)
coverage_accept_kernel(const T* __restrict__ x, const float* __restrict__ state,
                       const float* __restrict__ weights,
                       const unsigned char* __restrict__ eligible,
                       const float* __restrict__ tau,
                       const int* __restrict__ budget,
                       unsigned char* __restrict__ mask,
                       float* __restrict__ state_out,
                       float* __restrict__ gains, int B, int d) {
  const int l = blockIdx.x;
  CoverageStep<T, kPer> step;
  step.x = x + (long long)l * B * d;
  step.B = B;
  step.d = d;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int f = threadIdx.x + j * kThreads;
    step.s[j] = f < d ? state[(long long)l * d + f] : 0.0f;
    step.rs[j] = sqrtf(step.s[j]);
    step.w[j] = f < d ? (weights ? weights[f] : 1.0f) : 0.0f;
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

template <typename T, int kPer>
cudaError_t launch_per(const void* x, const void* state, const void* weights,
                       const void* eligible, const void* tau,
                       const void* budget, void* mask, void* state_out,
                       void* gains, int L, int B, int d, cudaStream_t stream) {
  coverage_accept_kernel<T, kPer><<<L, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(state),
      static_cast<const float*>(weights),
      static_cast<const unsigned char*>(eligible),
      static_cast<const float*>(tau), static_cast<const int*>(budget),
      static_cast<unsigned char*>(mask), static_cast<float*>(state_out),
      static_cast<float*>(gains), B, d);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* x, const void* state, const void* weights,
                   const void* eligible, const void* tau, const void* budget,
                   void* mask, void* state_out, void* gains, int L, int B,
                   int d, cudaStream_t stream) {
#define REPRO_ACCEPT_CASE(P)                                                  \
  if (d <= (P) * kThreads)                                                    \
    return launch_per<T, P>(x, state, weights, eligible, tau, budget, mask,   \
                            state_out, gains, L, B, d, stream);
  REPRO_ACCEPT_CASE(1)
  REPRO_ACCEPT_CASE(2)
  REPRO_ACCEPT_CASE(4)
  REPRO_ACCEPT_CASE(8)
  REPRO_ACCEPT_CASE(16)
#undef REPRO_ACCEPT_CASE
  return cudaErrorInvalidValue;  // d > 2048: the wrapper refuses it first
}

}  // namespace

extern "C" int coverage_accept_launch(const void* x, int x_is_bf16,
                                      const void* state, const void* weights,
                                      const void* eligible, const void* tau,
                                      const void* budget, void* mask,
                                      void* state_out, void* gains, int L,
                                      int B, int d, void* stream) {
  if (L <= 0 || d <= 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = x_is_bf16
      ? launch<__nv_bfloat16>(x, state, weights, eligible, tau, budget, mask,
                              state_out, gains, L, B, d, s)
      : launch<float>(x, state, weights, eligible, tau, budget, mask,
                      state_out, gains, L, B, d, s);
  return (int)e;
}
