// GraphCut marginal gains on Hopper (sm_90a).
//
//   out[l, i] = <x_i, t - 2 lam s_l> - lam ||x_i||^2
//
// with t the ground set's feature sum and s_l lane l's selected-row sum.
// Replaces the TPU kernel src/repro/kernels/graph_cut_marginals.py,
// graph_cut_marginals (body _gc_kernel), with an explicit lane axis L in
// place of the JAX engines' vmap: x is one (C, d) block shared by every
// lane (the filter, phase 1, the max-singleton and top-singleton calls) or
// one block per lane, (L, C, d) (the lazy chunks, phase 2).
//
// What bounds it on the H100: with x (C, d) shared by L lanes it is the
// skinny product (C, d) x (d, L) plus one squared norm per row.  At the
// filter shape (L = 37, C = 1,048,576, d = 256, f32) the 1 GiB of x read
// once and the 155 MB (L, C) output take 0.37 ms at 3.35 TB/s, and the
// 2 L C d + 2 C d = 2.0e10 operations 0.30 ms at 67 TFLOP/s of f32: bound
// by bytes.  One lane, or one x block per lane, is a (batched) GEMV, bound
// by its bytes.
//
// What the design does about it:
//  * Shared x, L >= 2: the f32 FFMA tile of sims_tile.cuh (kRectify =
//    false) computes a 64-row x 64-lane block of <x_i, c_l> with the
//    coefficient rows c_l = t - 2 lam s_l as its "reference" rows, as
//    weighted_coverage_marginals.cu does with remaining weights.  Each
//    c_l element is formed as the tile stages it (CoefRows below), so no
//    (L, d) workspace and no second launch are needed.
//    ||x_i||^2 is computed once per row (one warp per row of the CTA's
//    tile, before the product) and shared by every lane of the tile.
//    Every sum is one fixed-order chain, so a repeated launch gives the
//    same bits.  Lanes past L are read as 0 and dropped (27 of 64 columns
//    idle at L = 37).
//  * Per-lane x, or one lane: the lane-blocked row walk of lane_rows.cuh
//    with rules::GraphCut (pre = t - 2 lam s once per lane and feature),
//    one warp per row streaming x once.
#include "lane_rows.cuh"
#include "sims_tile.cuh"

namespace {

// The coefficient rows c_l = t - 2 lam s_l, read element by element by
// sims::tile: total (d,) and state (L, d) f32, two_lam = 2 lam.
struct CoefRows {
  const float* __restrict__ total;
  const float* __restrict__ state;
  float two_lam;
};

__device__ __forceinline__ float ref_at(const CoefRows& c, int col, int k,
                                        int d) {
  return __fsub_rn(c.total[k],
                   __fmul_rn(c.two_lam, c.state[(long long)col * d + k]));
}

template <typename T>
__global__ void __launch_bounds__(sims::kThreads)
lanes_tile_kernel(const T* __restrict__ x, CoefRows coef, float lam,
                  float* __restrict__ out, int L, long long C, int d) {
  __shared__ __align__(16) sims::Stage stage;
  __shared__ float sq[sims::kTileRows];
  const long long row0 = (long long)blockIdx.x * sims::kTileRows;
  const int col0 = blockIdx.y * sims::kTileCols;
  // ||x_i||^2 of the tile's rows: one warp per row, squares rounded and
  // summed in a fixed order; the tile's first barrier publishes them
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < sims::kTileRows; r += sims::kThreads / 32) {
    const long long row = row0 + r;
    float p = 0.0f;
    if (row < C)
      for (int f = lane; f < d; f += 32) {
        const float v = sims::to_f(x[row * d + f]);
        p = __fadd_rn(p, __fmul_rn(v, v));
      }
    for (int o = 16; o > 0; o >>= 1) p += __shfl_xor_sync(0xffffffffu, p, o);
    if (lane == 0) sq[r] = p;
  }
  float acc[sims::kMicro][sims::kMicro];
  sims::tile<T, false>(x, C, coef, L, d, row0, col0, stage, acc);
  const int mr = sims::micro_row(), mc = sims::micro_col();
#pragma unroll
  for (int n = 0; n < sims::kMicro; ++n) {
    const int l = col0 + mc + n;
    if (l >= L) continue;
#pragma unroll
    for (int m = 0; m < sims::kMicro; ++m) {
      const long long row = row0 + mr + m;
      if (row < C)
        out[(long long)l * C + row] =
            __fsub_rn(acc[m][n], __fmul_rn(lam, sq[mr + m]));
    }
  }
}

template <typename T>
cudaError_t launch_tile(const void* x, CoefRows coef, float lam,
                        void* out, int L, long long C, int d,
                        cudaStream_t stream) {
  const long long row_tiles = (C + sims::kTileRows - 1) / sims::kTileRows;
  const int lane_tiles = (L + sims::kTileCols - 1) / sims::kTileCols;
  if (row_tiles > 0x7fffffffLL || lane_tiles > 65535) return cudaErrorInvalidValue;
  dim3 grid((unsigned)row_tiles, lane_tiles);
  lanes_tile_kernel<T><<<grid, sims::kThreads, 0, stream>>>(
      static_cast<const T*>(x), coef, lam, static_cast<float*>(out), L, C, d);
  return cudaGetLastError();
}

}  // namespace

extern "C" int graph_cut_marginals_launch(const void* x, int x_is_bf16,
                                          int x_per_lane, const void* state,
                                          const void* total, float lam,
                                          void* out, int L, long long C,
                                          int d, void* stream) {
  if (L <= 0 || C <= 0 || d <= 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_per_lane || L == 1)
    return (int)lane_rows::launch_any(
        x, x_is_bf16, x_per_lane, state,
        rules::GraphCut{static_cast<const float*>(total), lam}, out, L, C, d,
        s);
  const CoefRows c{static_cast<const float*>(total),
                   static_cast<const float*>(state), 2.0f * lam};
  return (int)(x_is_bf16
                   ? launch_tile<__nv_bfloat16>(x, c, lam, out, L, C, d, s)
                   : launch_tile<float>(x, c, lam, out, L, C, d, s));
}
