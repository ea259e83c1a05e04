// WeightedCoverage marginal gains on Hopper (sm_90a).
//
//   out[l, i] = sum_u s[l, u] * x[i, u]
//
// with s the lanes' remaining (uncovered) weight per universe item and x
// the candidates' incidence rows.  Replaces the TPU kernel
// src/repro/kernels/weighted_coverage_marginals.py,
// weighted_coverage_marginals (body _wc_kernel), with an explicit lane axis
// L in place of the JAX engines' vmap.
//
// What bounds it on the H100: with x (C, U) shared by L lanes it is the
// skinny product (C, U) x (U, L).  At the filter shape (L = 37,
// C = 1,048,576, U = 256, f32) the 1 GiB of x read once takes 0.32 ms at
// 3.35 TB/s and the 2 L C U = 1.99e10 operations 0.30 ms at 67 TFLOP/s of
// f32, so it sits near both bounds: every x element read from device
// memory has to feed every lane from registers or shared memory.  With one
// x block per lane, (L, C, U), or a single lane, it is a batched GEMV,
// bound by its bytes.
//
// What the design does about it:
//  * Shared x, L >= 2: the f32 FFMA tile of sims_tile.cuh with the lanes'
//    states as its "reference" rows and no rectify.  A CTA computes a
//    64-row x 64-lane block of out; every staged x value feeds 64 lanes
//    from shared memory and each thread keeps a 4 x 4 block of sums in
//    registers.  Lanes past L are read as 0 and dropped (at L = 37, 27 of
//    64 columns are idle: the price of the simple tile; tensor cores and
//    narrower lane tiles are left for a later change).  Every sum is one
//    fmaf chain over u = 0..U-1, so a repeated launch gives the same bits.
//  * Per-lane x, or one lane: the lane-blocked row walk of lane_rows.cuh
//    with the rules::WeightedCoverage term, one warp per row streaming x
//    once.
#include "lane_rows.cuh"
#include "sims_tile.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(sims::kThreads)
lanes_tile_kernel(const T* __restrict__ x, const float* __restrict__ state,
                  float* __restrict__ out, int L, long long C, int d) {
  __shared__ __align__(16) sims::Stage stage;
  const long long row0 = (long long)blockIdx.x * sims::kTileRows;
  const int col0 = blockIdx.y * sims::kTileCols;
  float acc[sims::kMicro][sims::kMicro];
  sims::tile<T, false>(x, C, state, L, d, row0, col0, stage, acc);
  const int mr = sims::micro_row(), mc = sims::micro_col();
#pragma unroll
  for (int n = 0; n < sims::kMicro; ++n) {
    const int l = col0 + mc + n;
    if (l >= L) continue;
#pragma unroll
    for (int m = 0; m < sims::kMicro; ++m) {
      const long long row = row0 + mr + m;
      if (row < C) out[(long long)l * C + row] = acc[m][n];
    }
  }
}

template <typename T>
cudaError_t launch_tile(const void* x, const void* state, void* out, int L,
                        long long C, int d, cudaStream_t stream) {
  const long long row_tiles = (C + sims::kTileRows - 1) / sims::kTileRows;
  const int lane_tiles = (L + sims::kTileCols - 1) / sims::kTileCols;
  if (row_tiles > 0x7fffffffLL || lane_tiles > 65535) return cudaErrorInvalidValue;
  dim3 grid((unsigned)row_tiles, lane_tiles);
  lanes_tile_kernel<T><<<grid, sims::kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(state),
      static_cast<float*>(out), L, C, d);
  return cudaGetLastError();
}

}  // namespace

extern "C" int weighted_coverage_marginals_launch(const void* x, int x_is_bf16,
                                                  int x_per_lane,
                                                  const void* state, void* out,
                                                  int L, long long C, int d,
                                                  void* stream) {
  if (L <= 0 || C <= 0 || d <= 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_per_lane || L == 1)
    return (int)lane_rows::launch_any(x, x_is_bf16, x_per_lane, state,
                                      rules::WeightedCoverage{}, out, L, C, d,
                                      s);
  cudaError_t e = x_is_bf16
      ? launch_tile<__nv_bfloat16>(x, state, out, L, C, d, s)
      : launch_tile<float>(x, state, out, L, C, d, s);
  return (int)e;
}
