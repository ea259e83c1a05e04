// FacilityLocation marginal gains on Hopper (sm_90a): both kernels of
// src/repro/kernels/facility_marginals.py.
//
// facility_marginals (replaces facility_marginals, body _fm_kernel):
//
//     out[l, i] = sum_j max( max(<cand_i, ref_j>, 0) - state[l, j], 0 )
//
// rectified_residual_sum (replaces rectified_residual_sum, body _rrs_kernel):
//
//     out[l, i] = sum_j max( aux[i, j] - state[l, j], 0 )
//
// Both take an explicit lane axis L in place of the JAX engines' vmap: the
// candidate block is one (C, .) block shared by every lane (the filter,
// phase 1, the max-singleton and top-singleton calls) or one block per
// lane, (L, C, .) (the lazy chunks, the dense survivor phase).
//
// What bounds them on the H100:
//  * facility_marginals at the filter shape (L = 37, C = 1,048,576,
//    d = r = 256, f32) is a GEMM with an L-lane epilogue.  The vmap the JAX
//    engines put around it recomputes the product once per lane (37 x
//    2CRd ~ 5.1e12 FLOP); the similarity tile does not depend on the lane,
//    so here it is computed once per (row tile, column tile) and only the
//    epilogue runs per lane: 2CRd + 3LCR ~ 1.67e11 operations, 2.5 ms at
//    67 TFLOP/s of f32 FFMA, against 0.37 ms for its bytes.  Bound by
//    operations.
//  * rectified_residual_sum streams aux once: (2^20, 256) f32 is 1 GiB,
//    0.32 ms at 3.35 TB/s, and 3 operations per (lane, row, column).  At
//    one lane it is bound by bytes; with many lanes on a shared aux, by
//    operations.
//
// What the designs do about it:
//  * facility_marginals: the register-blocked SIMT tile of
//    marginals_tile.cuh (shared with exemplar_marginals.cu) with its
//    Facility rule: a CTA owns 128 candidate rows and up to 128 lanes,
//    computes each 128-column tile of rectified similarities once for all
//    of them (an 8 x 8 block of fmaf chains per thread, d staged 16 deep
//    and double-buffered), and sums the lanes' residuals in 4-lane x
//    4-row blocks that one thread owns, with no float atomics (a repeated
//    launch gives the same bits).
//  * rectified_residual_sum: a CTA owns up to kMaxLanes lanes and walks row
//    tiles; one warp reads an aux row once (coalesced, 16 bytes a thread
//    when r % 4 == 0, so enough loads are in flight to stream at the
//    memory's rate) and scores it against every lane of its block with
//    register accumulators, then reduces each with warp shuffles.  The
//    state is read through the read-only cache, so any r works.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

#include "marginals_tile.cuh"

namespace {

// ------------------------------------------------------------- residual
constexpr int kRThreads = 256;   // 8 warps
constexpr int kRWarps = kRThreads / 32;
constexpr int kMaxLanes = 8;     // lanes per CTA (register accumulators)
constexpr int kRowsPerTile = 32; // rows per CTA per tile (4 per warp)

// max(a - s, 0), summed over the columns of one load in column order
__device__ __forceinline__ float residual(float a, float s) {
  return fmaxf(a - s, 0.0f);
}
__device__ __forceinline__ float residual(float4 a, float4 s) {
  return ((fmaxf(a.x - s.x, 0.0f) + fmaxf(a.y - s.y, 0.0f)) +
          fmaxf(a.z - s.z, 0.0f)) + fmaxf(a.w - s.w, 0.0f);
}

// kVec: columns per load (4: float4 loads, for r % 4 == 0; else 1)
template <int kVec>
__global__ void __launch_bounds__(kRThreads)
rectified_residual_sum_kernel(const float* __restrict__ aux, int aux_per_lane,
                              const float* __restrict__ state,
                              float* __restrict__ out, int L, long long C,
                              int r, int lanes_per_cta) {
  using V = typename std::conditional<kVec == 4, float4, float>::type;
  const int l0 = blockIdx.x * lanes_per_cta;
  const int nl = min(lanes_per_cta, L - l0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rv = r / kVec;
  const V* aux_v = reinterpret_cast<const V*>(aux);
  const V* state_v = reinterpret_cast<const V*>(state);
  const long long n_tiles = (C + kRowsPerTile - 1) / kRowsPerTile;
  for (long long tile = blockIdx.y; tile < n_tiles; tile += gridDim.y) {
    for (int w = warp; w < kRowsPerTile; w += kRWarps) {
      const long long row = tile * kRowsPerTile + w;
      if (row >= C) break;
      float acc[kMaxLanes];
#pragma unroll
      for (int j = 0; j < kMaxLanes; ++j) acc[j] = 0.0f;
#pragma unroll 2
      for (int c = lane; c < rv; c += 32) {
        const V shared_v = aux_per_lane ? V{} : __ldg(aux_v + row * rv + c);
#pragma unroll
        for (int j = 0; j < kMaxLanes; ++j) {
          if (j < nl) {
            const V v = aux_per_lane
                ? __ldg(aux_v + ((long long)(l0 + j) * C + row) * rv + c)
                : shared_v;
            acc[j] += residual(v, __ldg(state_v + (long long)(l0 + j) * rv + c));
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

cudaError_t launch_rrs(const void* aux, int aux_per_lane, const void* state,
                       void* out, int L, long long C, int r,
                       cudaStream_t stream) {
  const int lpc = kMaxLanes < L ? kMaxLanes : L;
  const int lane_blocks = (L + lpc - 1) / lpc;
  const long long n_tiles = (C + kRowsPerTile - 1) / kRowsPerTile;
  const int tiles = (int)(n_tiles < 4096 ? n_tiles : 4096);
  dim3 grid(lane_blocks, tiles > 0 ? tiles : 1);
  const float* a = static_cast<const float*>(aux);
  const float* s = static_cast<const float*>(state);
  float* o = static_cast<float*>(out);
  // torch allocations are 16-byte aligned, and with r % 4 == 0 so is
  // every row
  if (r % 4 == 0)
    rectified_residual_sum_kernel<4><<<grid, kRThreads, 0, stream>>>(
        a, aux_per_lane, s, o, L, C, r, lpc);
  else
    rectified_residual_sum_kernel<1><<<grid, kRThreads, 0, stream>>>(
        a, aux_per_lane, s, o, L, C, r, lpc);
  return cudaGetLastError();
}

}  // namespace

extern "C" int facility_marginals_launch(const void* cand, int cand_is_bf16,
                                         int cand_per_lane, const void* ref,
                                         const void* state, void* out, int L,
                                         long long C, int r, int d,
                                         void* stream) {
  return (int)mtile::launch(cand, cand_is_bf16, cand_per_lane, ref,
                                        reftile::Facility{nullptr}, state, out,
                                        L, C, r, d,
                                        static_cast<cudaStream_t>(stream));
}

extern "C" int rectified_residual_sum_launch(const void* aux, int aux_per_lane,
                                             const void* state, void* out,
                                             int L, long long C, int r,
                                             void* stream) {
  if (L <= 0 || C <= 0) return (int)cudaSuccess;
  if (r <= 0) return (int)cudaErrorInvalidValue;
  return (int)launch_rrs(aux, aux_per_lane, state, out, L, C, r,
                         static_cast<cudaStream_t>(stream));
}
