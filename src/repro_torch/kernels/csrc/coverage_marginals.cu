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
// What the design does about it:
//  * sqrt(s) is computed once per lane and feature per CTA (into shared
//    memory), not once per row, so each (lane, row, feature) costs exactly
//    one square root, the minimum the formula needs.
//  * A CTA owns a block of up to 8 lanes and walks row tiles; one warp
//    scores one row against all lanes of its block with 8 register
//    accumulators, then reduces each with warp shuffles.  The shared x row
//    is read from device memory once per lane block, and the lane blocks
//    of one row tile are neighbouring CTAs (blockIdx.x), so the re-reads
//    hit L2.
//  * No --use_fast_math: parity with the plain version needs IEEE sqrtf.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;             // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kMaxLanes = 8;              // lanes per CTA (register accumulators)
constexpr int kRowsPerTile = 32;          // rows per CTA per tile (4 per warp)

__device__ __forceinline__ float load_f(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
coverage_marginals_kernel(const T* __restrict__ x, int x_per_lane,
                          const float* __restrict__ state,
                          const float* __restrict__ weights,
                          float* __restrict__ out, int L, long long C, int d,
                          int lanes_per_cta) {
  extern __shared__ float smem[];
  const int l0 = blockIdx.x * lanes_per_cta;
  const int nl = min(lanes_per_cta, L - l0);
  float* s_sm = smem;                          // [nl][d]
  float* rs_sm = smem + lanes_per_cta * d;     // [nl][d] sqrt(s)
  float* w_sm = smem + 2 * lanes_per_cta * d;  // [d]
  for (int t = threadIdx.x; t < nl * d; t += kThreads) {
    const float s = state[(long long)l0 * d + t];
    s_sm[t] = s;
    rs_sm[t] = sqrtf(s);
  }
  for (int f = threadIdx.x; f < d; f += kThreads)
    w_sm[f] = weights ? weights[f] : 1.0f;
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long n_tiles = (C + kRowsPerTile - 1) / kRowsPerTile;
  for (long long tile = blockIdx.y; tile < n_tiles; tile += gridDim.y) {
    for (int r = warp; r < kRowsPerTile; r += kWarps) {
      const long long row = tile * kRowsPerTile + r;
      if (row >= C) break;
      float acc[kMaxLanes];
#pragma unroll
      for (int j = 0; j < kMaxLanes; ++j) acc[j] = 0.0f;
      for (int f = lane; f < d; f += 32) {
        const float w = w_sm[f];
        const float xs = x_per_lane ? 0.0f : load_f(x + row * d + f);
#pragma unroll
        for (int j = 0; j < kMaxLanes; ++j) {
          if (j < nl) {
            const float xv = x_per_lane
                ? load_f(x + ((long long)(l0 + j) * C + row) * d + f) : xs;
            acc[j] += (sqrtf(s_sm[j * d + f] + xv) - rs_sm[j * d + f]) * w;
          }
        }
      }
#pragma unroll
      for (int j = 0; j < kMaxLanes; ++j) {
        float v = acc[j];
        for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
        if (lane == 0 && j < nl) out[(long long)(l0 + j) * C + row] = v;
      }
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, int x_per_lane, const void* state,
                   const void* weights, void* out, int L, long long C, int d,
                   cudaStream_t stream) {
  // lanes per CTA: as many as the register accumulators allow, fewer when
  // the lane block's s and sqrt(s) rows would not fit in shared memory
  const int max_smem = 227 * 1024;
  int lpc = kMaxLanes < L ? kMaxLanes : L;
  while (lpc > 1 && (size_t)(2 * lpc + 1) * d * sizeof(float) > (size_t)max_smem)
    --lpc;
  const size_t smem = (size_t)(2 * lpc + 1) * d * sizeof(float);
  if (smem > (size_t)max_smem) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        coverage_marginals_kernel<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const int lane_blocks = (L + lpc - 1) / lpc;
  const long long n_tiles = (C + kRowsPerTile - 1) / kRowsPerTile;
  const int tiles = (int)(n_tiles < 4096 ? n_tiles : 4096);
  dim3 grid(lane_blocks, tiles > 0 ? tiles : 1);
  coverage_marginals_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), x_per_lane, static_cast<const float*>(state),
      static_cast<const float*>(weights), static_cast<float*>(out), L, C, d,
      lpc);
  return cudaGetLastError();
}

}  // namespace

extern "C" int coverage_marginals_launch(const void* x, int x_is_bf16,
                                         int x_per_lane, const void* state,
                                         const void* weights, void* out,
                                         int L, long long C, int d,
                                         void* stream) {
  if (L <= 0 || C <= 0 || d <= 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = x_is_bf16
      ? launch<__nv_bfloat16>(x, x_per_lane, state, weights, out, L, C, d, s)
      : launch<float>(x, x_per_lane, state, weights, out, L, C, d, s);
  return (int)e;
}
