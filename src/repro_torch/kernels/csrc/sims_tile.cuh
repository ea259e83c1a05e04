// One similarity tile of the sims_tile users, the accept sweeps of
// facility_accept.cu and exemplar_accept.cu through reference_tile.cuh:
// the product of the chunk's candidates with the reference rows (the
// Hopper counterpart of the jnp.dot in _fa_kernel and _ea_kernel,
// src/repro/kernels/facility_accept.py and exemplar_accept.py), rectified
// for facility (kRectify) and not for exemplar:
//
//     tile[i][j] = max( sum_k cand[row0 + i][k] * ref[col0 + j][k], 0 )
//
// for a kTileRows x kTileCols block, computed by one CTA of kThreads
// threads with a plain f32 FFMA loop: d is staged through shared memory
// kDepth columns at a time (cand transposed to [k][row], ref to [k][col]),
// and each thread keeps a kMicro x kMicro block of sums in registers.
// bf16 operands are widened to f32 as they are staged; a bf16 x bf16
// product is exact in f32, which is what preferred_element_type=f32 gives
// on the TPU.  (The marginals of facility, exemplar and log-det moved to
// marginals_tile.cuh's 128 x 128 tile, graph cut and weighted coverage to
// skinny_tile.cuh.)
//
// Every sum runs over k = 0, 1, ..., d - 1 in that order as one fmaf
// chain, so a tile is bit-for-bit the same wherever and whenever it is
// computed: facility_marginals and facility_accept see the same
// similarities.  Rows at or past C and columns at or past r are read as 0
// (the caller drops them); nothing is padded in memory.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace sims {

constexpr int kThreads = 256;   // 16 x 16 threads, kMicro x kMicro each
constexpr int kTileRows = 64;
constexpr int kTileCols = 64;
constexpr int kDepth = 16;
constexpr int kMicro = 4;

struct Stage {
  float a[kDepth][kTileRows];   // cand slice, [k][row]
  float b[kDepth][kTileCols];   // ref slice, [k][col]
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Row and column of acc[0][0] within the tile for this thread.
__device__ __forceinline__ int micro_row() { return (threadIdx.x >> 4) * kMicro; }
__device__ __forceinline__ int micro_col() { return (threadIdx.x & 15) * kMicro; }

// acc[m][n] = tile[micro_row() + m][micro_col() + n].  cand is (C, d) and
// ref (r, d), both row-major.  Every thread of the CTA must call it; it
// ends with a barrier, so the stage may be reused at once.
template <typename TC, bool kRectify = true>
__device__ __forceinline__ void tile(const TC* __restrict__ cand, long long C,
                                     const float* __restrict__ ref, int r,
                                     int d, long long row0,
                                     int col0, Stage& st,
                                     float acc[kMicro][kMicro]) {
#pragma unroll
  for (int m = 0; m < kMicro; ++m)
#pragma unroll
    for (int n = 0; n < kMicro; ++n) acc[m][n] = 0.0f;
  // staging: thread t loads kDepth/4 = 4 consecutive k of one row and of
  // one column (64 rows x 16 k = 256 x 4)
  const int sr = threadIdx.x >> 2, sk = (threadIdx.x & 3) * 4;
  const long long row = row0 + sr;
  const int col = col0 + sr;
  const int mr = micro_row(), mc = micro_col();
  for (int k0 = 0; k0 < d; k0 += kDepth) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = k0 + sk + j;
      st.a[sk + j][sr] = (row < C && k < d) ? to_f(cand[row * d + k]) : 0.0f;
      st.b[sk + j][sr] = (col < r && k < d) ? ref[(long long)col * d + k] : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kDepth; ++kk) {
      const float4 av = *reinterpret_cast<const float4*>(&st.a[kk][mr]);
      const float4 bv = *reinterpret_cast<const float4*>(&st.b[kk][mc]);
      const float a4[kMicro] = {av.x, av.y, av.z, av.w};
      const float b4[kMicro] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int m = 0; m < kMicro; ++m)
#pragma unroll
        for (int n = 0; n < kMicro; ++n)
          acc[m][n] = fmaf(a4[m], b4[n], acc[m][n]);
    }
    __syncthreads();
  }
  if (kRectify) {
#pragma unroll
    for (int m = 0; m < kMicro; ++m)
#pragma unroll
      for (int n = 0; n < kMicro; ++n) acc[m][n] = fmaxf(acc[m][n], 0.0f);
  }
}

}  // namespace sims
