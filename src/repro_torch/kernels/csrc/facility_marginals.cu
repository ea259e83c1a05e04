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
//  * facility_marginals: a CTA owns 64 candidate rows and a group of lanes
//    and walks the r columns in 64-wide tiles.  Each tile's rectified
//    similarities (sims_tile.cuh) land in shared memory beside the lanes'
//    64-column state slice; the threads then re-map onto (lane, 4 rows)
//    quads that add the tile's residuals into a per-(lane, row) sum that
//    the same thread owns for the whole kernel, so each output is written
//    once and no float atomics are used (a repeated launch gives the same
//    bits).  Lane groups hold up to kMaxLaneGroup lanes in shared memory;
//    a wider grid is split into groups, each recomputing the product.
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

#include "sims_tile.cuh"

namespace {

// ---------------------------------------------------------------- fused
constexpr int kMaxLaneGroup = 128;
constexpr int kQuadRows = sims::kTileRows / 4;   // a quad is rows i + 16m
constexpr int kSPitch = sims::kTileCols + 1;     // padded rows: no bank conflicts

size_t fm_smem_bytes(int lanes) {
  return sizeof(sims::Stage) +
         sizeof(float) * ((size_t)sims::kTileRows * kSPitch +   // sims tile
                          (size_t)lanes * kSPitch +             // state slice
                          (size_t)lanes * sims::kTileRows);     // sums
}

template <typename TC>
__global__ void __launch_bounds__(sims::kThreads)
facility_marginals_kernel(const TC* __restrict__ cand, int cand_per_lane,
                          const float* __restrict__ ref,
                          const float* __restrict__ state,
                          float* __restrict__ out, int L, long long C, int r,
                          int d, int group) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  sims::Stage& stage = *reinterpret_cast<sims::Stage*>(smem_raw);
  float* S = reinterpret_cast<float*>(smem_raw + sizeof(sims::Stage));
  float* st = S + sims::kTileRows * kSPitch;   // [nl][kSPitch]
  float* sums = st + group * kSPitch;          // [nl][kTileRows]

  int l0, nl;
  const TC* x = cand;
  if (cand_per_lane) {
    l0 = blockIdx.y;
    nl = 1;
    x = cand + (long long)l0 * C * d;
  } else {
    l0 = blockIdx.y * group;
    nl = min(group, L - l0);
  }
  const long long row0 = (long long)blockIdx.x * sims::kTileRows;
  const int tid = threadIdx.x;
  for (int t = tid; t < nl * sims::kTileRows; t += sims::kThreads) sums[t] = 0.0f;

  const int mr = sims::micro_row(), mc = sims::micro_col();
  for (int col0 = 0; col0 < r; col0 += sims::kTileCols) {
    float acc[sims::kMicro][sims::kMicro];
    sims::tile(x, C, ref, r, d, row0, col0, stage, acc);
#pragma unroll
    for (int m = 0; m < sims::kMicro; ++m)
#pragma unroll
      for (int n = 0; n < sims::kMicro; ++n)
        S[(mr + m) * kSPitch + mc + n] = acc[m][n];
    const int nc = min(sims::kTileCols, r - col0);
    for (int t = tid; t < nl * sims::kTileCols; t += sims::kThreads) {
      const int l = t / sims::kTileCols, c = t % sims::kTileCols;
      st[l * kSPitch + c] =
          c < nc ? __ldg(state + (long long)(l0 + l) * r + col0 + c) : 0.0f;
    }
    __syncthreads();
    for (int q = tid; q < nl * kQuadRows; q += sims::kThreads) {
      const int l = q / kQuadRows, i = q % kQuadRows;
      const float* sl = st + l * kSPitch;
      float p[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      for (int c = 0; c < nc; ++c) {
        const float s = sl[c];
#pragma unroll
        for (int m = 0; m < 4; ++m)
          p[m] += fmaxf(S[(i + kQuadRows * m) * kSPitch + c] - s, 0.0f);
      }
#pragma unroll
      for (int m = 0; m < 4; ++m)
        sums[l * sims::kTileRows + i + kQuadRows * m] += p[m];
    }
    __syncthreads();   // S and st are rewritten by the next column tile
  }
  for (int t = tid; t < nl * sims::kTileRows; t += sims::kThreads) {
    const int l = t / sims::kTileRows, i = t % sims::kTileRows;
    const long long row = row0 + i;
    if (row < C) out[(long long)(l0 + l) * C + row] = sums[t];
  }
}

template <typename TC>
cudaError_t launch_fm(const void* cand, int cand_per_lane, const void* ref,
                      const void* state, void* out, int L, long long C, int r,
                      int d, cudaStream_t stream) {
  const int group = cand_per_lane ? 1 : (L < kMaxLaneGroup ? L : kMaxLaneGroup);
  const size_t smem = fm_smem_bytes(group);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        facility_marginals_kernel<TC>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const long long row_tiles = (C + sims::kTileRows - 1) / sims::kTileRows;
  const int lane_blocks = cand_per_lane ? L : (L + group - 1) / group;
  if (row_tiles > 0x7fffffffLL || lane_blocks > 65535) return cudaErrorInvalidValue;
  dim3 grid((unsigned)row_tiles, lane_blocks);
  facility_marginals_kernel<TC><<<grid, sims::kThreads, smem, stream>>>(
      static_cast<const TC*>(cand), cand_per_lane,
      static_cast<const float*>(ref), static_cast<const float*>(state),
      static_cast<float*>(out), L, C, r, d, group);
  return cudaGetLastError();
}

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
  if (L <= 0 || C <= 0) return (int)cudaSuccess;
  if (r <= 0 || d < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cand_is_bf16
      ? launch_fm<__nv_bfloat16>(cand, cand_per_lane, ref, state, out, L, C,
                                 r, d, s)
      : launch_fm<float>(cand, cand_per_lane, ref, state, out, L, C, r, d, s);
  return (int)e;
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
