// Fused FacilityLocation chunk-accept sweep on Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/facility_accept.py,
// facility_accept (body _fa_kernel, on run_sweep in _accept_common.py), in
// the cardinality mode (cost=None).  One launch serves L lanes, one CTA
// each, which is what the JAX engines got from vmapping the Pallas kernel
// over the tau grid.
//
// Per lane, two phases:
//  1. the (B, r) block sims = max(cand @ ref^T, 0) of the lane's chunk,
//     computed with the same similarity tiles as facility_marginals
//     (sims_tile.cuh), so the product is off the sweep's dependent chain;
//  2. the sweep over its rows in order: row i's gain is
//         sum_j max(sims[i, j] - s_j, 0)
//     against the live cover vector s, and an accepted row applies
//     s = max(s, sims[i, :]).
// Outputs: mask (L, B) bool, post-sweep state (L, r) f32, and each row's
// gain at scan time (L, B) f32.
//
// Where the block lives: a (B, r) f32 block is 128 KB at B = 128, r = 256
// but 512 KB at r = 1024, beyond the 227 KB of shared memory a block can
// have.  So every r takes the same road: the wrapper allocates an (L, B, r)
// f32 workspace (4.8 MB for 37 lanes at B = 128, r = 256, resident in the
// 50 MB L2), phase 1 writes the lane's block there, and phase 2 streams it
// back one row ahead of the sweep.  The state stays in registers: thread t
// owns columns t, t + 256, ..., so an accept is a thread-local max.
//
// What bounds it on the H100: at (37, 128, 256), r = 256, the product is
// 2LBrd ~ 6.2e8 FLOP (9.3 us at 67 TFLOP/s) and the bytes ~1.5 us; but
// only L CTAs run, so phase 1 uses 37 of 132 SMs, and phase 2 is the chain
// of B dependent block reductions (accept_sweep.cuh).  Both are far above
// the bound; the gap is recorded in PERF.md and left for a later change.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "accept_sweep.cuh"
#include "sims_tile.cuh"

namespace {

constexpr int kThreads = sims::kThreads;

template <int kPer>
struct FacilityStep {
  const float* sims;  // this lane's (B, r) block in the workspace
  int B, r;
  float s[kPer], cur[kPer], next[kPer];

  // plain loads, not __ldg: the block was written earlier in this kernel
  __device__ void load_row(int i, float* dst) const {
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int c = threadIdx.x + j * kThreads;
      dst[j] = (i < B && c < r) ? sims[(long long)i * r + c] : 0.0f;
    }
  }

  __device__ float partial(int i) {
#pragma unroll
    for (int j = 0; j < kPer; ++j) cur[j] = next[j];
    load_row(i + 1, next);
    float p = 0.0f;
    // columns past r hold s = 0 and sims = 0 and add exactly 0
#pragma unroll
    for (int j = 0; j < kPer; ++j) p += fmaxf(cur[j] - s[j], 0.0f);
    return p;
  }

  __device__ void accept() {
#pragma unroll
    for (int j = 0; j < kPer; ++j) s[j] = fmaxf(s[j], cur[j]);
  }
};

template <typename TC, int kPer>
__global__ void __launch_bounds__(kThreads)
facility_accept_kernel(const TC* __restrict__ cand,
                       const float* __restrict__ ref,
                       const float* __restrict__ state,
                       const unsigned char* __restrict__ eligible,
                       const float* __restrict__ tau,
                       const int* __restrict__ budget,
                       unsigned char* __restrict__ mask,
                       float* __restrict__ state_out,
                       float* __restrict__ gains, float* work, int B, int r,
                       int d) {
  __shared__ __align__(16) sims::Stage stage;
  const int l = blockIdx.x;
  const TC* x = cand + (long long)l * B * d;
  float* block = work + (long long)l * B * r;

  // phase 1: the lane's rectified similarity block
  const int mr = sims::micro_row(), mc = sims::micro_col();
  for (int row0 = 0; row0 < B; row0 += sims::kTileRows) {
    for (int col0 = 0; col0 < r; col0 += sims::kTileCols) {
      float acc[sims::kMicro][sims::kMicro];
      sims::tile(x, B, ref, r, d, row0, col0, stage, acc);
#pragma unroll
      for (int m = 0; m < sims::kMicro; ++m)
#pragma unroll
        for (int n = 0; n < sims::kMicro; ++n) {
          const int i = row0 + mr + m, c = col0 + mc + n;
          if (i < B && c < r) block[(long long)i * r + c] = acc[m][n];
        }
    }
  }
  __syncthreads();   // the block is visible to every thread of the CTA

  // phase 2: the sweep
  FacilityStep<kPer> step;
  step.sims = block;
  step.B = B;
  step.r = r;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int c = threadIdx.x + j * kThreads;
    step.s[j] = c < r ? state[(long long)l * r + c] : 0.0f;
  }
  step.load_row(0, step.next);
  run_sweep<kThreads>(step, B, eligible + (long long)l * B, tau[l], budget[l],
                      mask + (long long)l * B, gains + (long long)l * B);
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int c = threadIdx.x + j * kThreads;
    if (c < r) state_out[(long long)l * r + c] = step.s[j];
  }
}

template <typename TC, int kPer>
cudaError_t launch_per(const void* cand, const void* ref, const void* state,
                       const void* eligible, const void* tau,
                       const void* budget, void* mask, void* state_out,
                       void* gains, void* work, int L, int B, int r, int d,
                       cudaStream_t stream) {
  facility_accept_kernel<TC, kPer><<<L, kThreads, 0, stream>>>(
      static_cast<const TC*>(cand), static_cast<const float*>(ref),
      static_cast<const float*>(state),
      static_cast<const unsigned char*>(eligible),
      static_cast<const float*>(tau), static_cast<const int*>(budget),
      static_cast<unsigned char*>(mask), static_cast<float*>(state_out),
      static_cast<float*>(gains), static_cast<float*>(work), B, r, d);
  return cudaGetLastError();
}

template <typename TC>
cudaError_t launch(const void* cand, const void* ref, const void* state,
                   const void* eligible, const void* tau, const void* budget,
                   void* mask, void* state_out, void* gains, void* work,
                   int L, int B, int r, int d, cudaStream_t stream) {
#define REPRO_ACCEPT_CASE(P)                                                   \
  if (r <= (P) * kThreads)                                                     \
    return launch_per<TC, P>(cand, ref, state, eligible, tau, budget, mask,    \
                             state_out, gains, work, L, B, r, d, stream);
  REPRO_ACCEPT_CASE(1)
  REPRO_ACCEPT_CASE(2)
  REPRO_ACCEPT_CASE(4)
  REPRO_ACCEPT_CASE(8)
  REPRO_ACCEPT_CASE(16)
#undef REPRO_ACCEPT_CASE
  return cudaErrorInvalidValue;  // r > 4096: the wrapper refuses it first
}

}  // namespace

extern "C" int facility_accept_launch(const void* cand, int cand_is_bf16,
                                      const void* ref, const void* state,
                                      const void* eligible, const void* tau,
                                      const void* budget, void* mask,
                                      void* state_out, void* gains,
                                      void* work, int L, int B, int r, int d,
                                      void* stream) {
  if (L <= 0 || r <= 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cand_is_bf16
      ? launch<__nv_bfloat16>(cand, ref, state, eligible, tau, budget, mask,
                              state_out, gains, work, L, B, r, d, s)
      : launch<float>(cand, ref, state, eligible, tau, budget, mask,
                      state_out, gains, work, L, B, r, d, s);
  return (int)e;
}
