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
// kDepth columns at a time (cand transposed to [k][row], ref to [k][col],
// two slices, the next one's loads in flight while this one is
// multiplied), and each thread keeps a kMicroRows x kMicroCols block of
// sums in registers.  The accept sweeps launch one CTA a tile (reference_tile.cuh).
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

constexpr int kThreads = 256;   // 16 x 16 threads, 4 x 4 sums each
constexpr int kTileRows = 64;
constexpr int kTileCols = 64;
constexpr int kDepth = 32;
constexpr int kMicroRows = 4;
constexpr int kMicroCols = 4;

// Two slices, so the next slice's loads are in flight while this one is
// multiplied, and one barrier a slice.  A slice's k-th row holds element i
// at swizzle(k, i): the four 8-k groups of a staging warp land in four
// different bank octets, and a 4-wide fragment stays contiguous.
struct Stage {
  float a[2][kDepth][kTileRows];   // cand slices, [k][row]
  float b[2][kDepth][kTileCols];   // ref slices, [k][col]
};

__device__ __forceinline__ int swizzle(int k, int i) {
  return i ^ (((k >> 3) & 3) << 3);
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Row and column of acc[0][0] within the tile for this thread.
__device__ __forceinline__ int micro_row() {
  return (threadIdx.x >> 4) * kMicroRows;
}
__device__ __forceinline__ int micro_col() {
  return (threadIdx.x & 15) * kMicroCols;
}

// What a tile's caller does with each staged cand slice besides the
// product (nothing here; reftile::SliceNorms takes the row norms).
struct NoHook {
  __device__ __forceinline__ void slice(const float (*)[kTileRows], int,
                                        int) {}
};

// acc[m][n] = tile[micro_row() + m][micro_col() + n].  cand is (C, d) and
// ref (r, d), both row-major.  hook.slice(a, k0, d) sees each staged cand
// slice [k][swizzle(k, row)] of k0 .. k0 + kDepth - 1.  Every thread of the
// CTA must call it; it ends with a barrier, so the stage may be reused at
// once.
template <typename TC, bool kRectify, class Hook>
__device__ __forceinline__ void tile(const TC* __restrict__ cand, long long C,
                                     const float* __restrict__ ref, int r,
                                     int d, long long row0, int col0,
                                     Stage& st,
                                     float acc[kMicroRows][kMicroCols],
                                     Hook& hook) {
#pragma unroll
  for (int m = 0; m < kMicroRows; ++m)
#pragma unroll
    for (int n = 0; n < kMicroCols; ++n) acc[m][n] = 0.0f;
  // staging: thread t loads kDepth / 4 = 8 consecutive k of one row and of
  // one column (64 rows x 32 k = 256 x 8)
  constexpr int kPart = kDepth / 4;
  const int sr = threadIdx.x >> 2, sk = (threadIdx.x & 3) * kPart;
  const long long row = row0 + sr;
  const int col = col0 + sr;
  const int mr = micro_row(), mc = micro_col();
  float pa[kPart], pb[kPart];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int j = 0; j < kPart; ++j) {
      const int k = k0 + sk + j;
      pa[j] = (row < C && k < d) ? to_f(cand[row * d + k]) : 0.0f;
      pb[j] = (col < r && k < d) ? ref[(long long)col * d + k] : 0.0f;
    }
  };
  fetch(0);
  int buf = 0;
  for (int k0 = 0; k0 < d; k0 += kDepth, buf ^= 1) {
#pragma unroll
    for (int j = 0; j < kPart; ++j) {
      st.a[buf][sk + j][swizzle(sk + j, sr)] = pa[j];
      st.b[buf][sk + j][swizzle(sk + j, sr)] = pb[j];
    }
    // one barrier a slice: a thread writes this buffer again two slices
    // on, after the next slice's barrier, which every thread reaches only
    // when it is done with this slice
    __syncthreads();
    if (k0 + kDepth < d) fetch(k0 + kDepth);
#pragma unroll
    for (int kk = 0; kk < kDepth; ++kk) {
      const float4 av =
          *reinterpret_cast<const float4*>(&st.a[buf][kk][swizzle(kk, mr)]);
      const float4 bv =
          *reinterpret_cast<const float4*>(&st.b[buf][kk][swizzle(kk, mc)]);
      const float a4[kMicroRows] = {av.x, av.y, av.z, av.w};
      const float b4[kMicroCols] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int m = 0; m < kMicroRows; ++m)
#pragma unroll
        for (int n = 0; n < kMicroCols; ++n)
          acc[m][n] = fmaf(a4[m], b4[n], acc[m][n]);
    }
    hook.slice(st.a[buf], k0, d);
  }
  __syncthreads();
  if (kRectify) {
#pragma unroll
    for (int m = 0; m < kMicroRows; ++m)
#pragma unroll
      for (int n = 0; n < kMicroCols; ++n) acc[m][n] = fmaxf(acc[m][n], 0.0f);
  }
}

}  // namespace sims
