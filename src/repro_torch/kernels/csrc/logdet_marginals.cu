// LogDetDiversity / MutualInformationGaussian marginal gains on Hopper
// (sm_90a).
//
//   out[l, i] = scale * log(max(1 + alpha ||x_i||^2
//                               - alpha^2 ||U_l x_i||^2, eps))
//
// with U_l (k, d) lane l's whitened basis (rows at or past |S| are zero).
// Replaces the TPU kernel src/repro/kernels/logdet_marginals.py,
// logdet_marginals (body _ld_kernel), with an explicit lane axis L in place
// of the JAX engines' vmap: x is one (C, d) block shared by every lane
// (the filter, phase 1; an unbatched call is one lane: the max-singleton
// and top-singleton calls) or one block per lane, (L, C, d) (the lazy
// chunks, phase 2).  scale = 0.5 is mutual information.
//
// What bounds it on the H100: the product (C, d) x (d, L k).  At the
// filter shape (L = 37, k = 64, C = 1,048,576, d = 256, f32) that is
// 2 C d L k = 1.27e12 operations, 19 ms at 67 TFLOP/s of f32, against
// 0.37 ms for the bytes (x read once, the (L, C) output written once):
// bound by operations.  This kernel multiplies every row of U, the zero
// rows past |S| too, so the bound counts all k rows.
//
// What the design does about it (simple first; tensor cores and skipping
// U's zero rows are left for a later change):
//  * The f32 FFMA tile of sims_tile.cuh (kRectify = false) with the lanes'
//    stacked basis rows as its "reference" rows.  A CTA takes 64 rows of x
//    and a group of lanes: 64 / k lanes (64 columns) when k <= 64, so at
//    k = 64 one lane fills one tile; one lane whose k rows are walked 64
//    columns at a time when k > 64.  The lane groups of one row tile are
//    neighbouring CTAs (blockIdx.x), so x is re-read from L2.
//  * The (C, L k) projection never reaches device memory: each tile's
//    squares go to shared memory, and one thread per (row, lane) sums its
//    lane's columns in order, then writes the gain.  ||x_i||^2 is computed
//    once per row (one warp per row of the tile) for every lane.  Every sum
//    is a fixed-order chain and no atomics are used, so a repeated launch
//    gives the same bits.
//  * resid is formed as the plain version forms it, with rounded products
//    (no contraction into an fma); logf is the IEEE-accurate one (no
//    --use_fast_math).
#include "sims_tile.cuh"

namespace {

struct Params {
  float alpha, alpha2, scale, eps;
};

__device__ __forceinline__ float gain_of(const Params& p, float xsq,
                                         float psq) {
  const float resid = __fsub_rn(__fadd_rn(1.0f, __fmul_rn(p.alpha, xsq)),
                                __fmul_rn(p.alpha2, psq));
  const float g = logf(fmaxf(resid, p.eps));
  return p.scale == 1.0f ? g : __fmul_rn(p.scale, g);
}

// grid (lane groups, row tiles); lanes_per_cta = 64 / k for k <= 64 with a
// shared x, else 1.
template <typename T>
__global__ void __launch_bounds__(sims::kThreads)
kernel(const T* __restrict__ x, int x_per_lane, const float* __restrict__ U,
       float* __restrict__ out, int L, int k, long long C, int d,
       int lanes_per_cta, Params p) {
  __shared__ __align__(16) sims::Stage stage;
  __shared__ float sq[sims::kTileRows][sims::kTileCols + 1];
  __shared__ float xsq[sims::kTileRows];
  const int l0 = blockIdx.x * lanes_per_cta;
  const int nl = min(lanes_per_cta, L - l0);
  const T* xb = x_per_lane ? x + (long long)l0 * C * d : x;
  const float* Ub = U + (long long)l0 * k * d;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int mr = sims::micro_row(), mc = sims::micro_col();
  const long long row_tiles = (C + sims::kTileRows - 1) / sims::kTileRows;
  for (long long tile = blockIdx.y; tile < row_tiles; tile += gridDim.y) {
    const long long row0 = tile * sims::kTileRows;
    // ||x_i||^2, one warp per row; the first barrier of sims::tile
    // publishes it
    for (int r = warp; r < sims::kTileRows; r += sims::kThreads / 32) {
      const long long row = row0 + r;
      float s = 0.0f;
      if (row < C)
        for (int f = lane; f < d; f += 32) {
          const float v = sims::to_f(xb[row * d + f]);
          s = __fadd_rn(s, __fmul_rn(v, v));
        }
      for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
      if (lane == 0) xsq[r] = s;
    }
    float run = 0.0f;  // k > 64: thread r < 64 sums row r across chunks
    const int cols = k <= sims::kTileCols ? nl * k : sims::kTileCols;
    for (int c0 = 0; c0 < k; c0 += cols) {
      const int ncols = k <= sims::kTileCols ? cols : min(cols, k - c0);
      float acc[sims::kMicro][sims::kMicro];
      sims::tile<T, false>(xb, C, Ub + (long long)c0 * d, ncols, d, row0, 0,
                           stage, acc);
#pragma unroll
      for (int m = 0; m < sims::kMicro; ++m)
#pragma unroll
        for (int n = 0; n < sims::kMicro; ++n)
          sq[mr + m][mc + n] = __fmul_rn(acc[m][n], acc[m][n]);
      __syncthreads();
      if (k <= sims::kTileCols) {
        // one (row, lane) per item: sum the lane's k columns in order
        for (int item = threadIdx.x; item < sims::kTileRows * nl;
             item += sims::kThreads) {
          const int r = item % sims::kTileRows, j = item / sims::kTileRows;
          float s = 0.0f;
          for (int c = 0; c < k; ++c) s = __fadd_rn(s, sq[r][j * k + c]);
          const long long row = row0 + r;
          if (row < C) out[(long long)(l0 + j) * C + row] = gain_of(p, xsq[r], s);
        }
      } else if (threadIdx.x < sims::kTileRows) {
        for (int c = 0; c < ncols; ++c)
          run = __fadd_rn(run, sq[threadIdx.x][c]);
      }
      __syncthreads();  // before the next chunk or tile rewrites sq, xsq
    }
    if (k > sims::kTileCols && threadIdx.x < sims::kTileRows) {
      const long long row = row0 + threadIdx.x;
      if (row < C) out[(long long)l0 * C + row] = gain_of(p, xsq[threadIdx.x], run);
    }
    __syncthreads();
  }
}

template <typename T>
cudaError_t launch(const void* x, int x_per_lane, const void* U, void* out,
                   int L, int k, long long C, int d, const Params& p,
                   cudaStream_t stream) {
  const int lpc = (!x_per_lane && k <= sims::kTileCols)
      ? min(sims::kTileCols / k, L) : 1;
  const int groups = (L + lpc - 1) / lpc;
  const long long row_tiles = (C + sims::kTileRows - 1) / sims::kTileRows;
  const unsigned ty = (unsigned)(row_tiles < 65535 ? row_tiles : 65535);
  if (groups > 0x7fffffff) return cudaErrorInvalidValue;
  dim3 grid((unsigned)groups, ty);
  kernel<T><<<grid, sims::kThreads, 0, stream>>>(
      static_cast<const T*>(x), x_per_lane, static_cast<const float*>(U),
      static_cast<float*>(out), L, k, C, d, lpc, p);
  return cudaGetLastError();
}

}  // namespace

// x (C, d) shared or (L, C, d) per lane, f32 or bf16; U (L, k, d) f32
// (an unbatched call is L = 1); out (L, C) f32.
extern "C" int logdet_marginals_launch(const void* x, int x_is_bf16,
                                       int x_per_lane, const void* U,
                                       void* out, int L, int k, long long C,
                                       int d, float alpha, float alpha2,
                                       float scale, float eps, void* stream) {
  if (L <= 0 || C <= 0 || d <= 0) return (int)cudaSuccess;
  const Params p{alpha, alpha2, scale, eps};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k <= 0) return (int)cudaErrorInvalidValue;  // the wrapper refuses it
  return (int)(x_is_bf16
      ? launch<__nv_bfloat16>(x, x_per_lane, U, out, L, k, C, d, p, s)
      : launch<float>(x, x_per_lane, U, out, L, k, C, d, p, s));
}
