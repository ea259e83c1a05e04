// LogDetDiversity / MutualInformationGaussian marginal gains on Hopper
// (sm_90a).
//
//   out[l, i] = scale * log(max(1 + alpha ||x_i||^2
//                               - alpha^2 ||U_l x_i||^2, eps))
//
// with U_l (k, d) lane l's whitened basis, of which only the first size_l
// rows count (the oracle keeps the others zero).  Replaces the TPU kernel
// src/repro/kernels/logdet_marginals.py, logdet_marginals (body
// _ld_kernel), with an explicit lane axis L in place of the JAX engines'
// vmap: x is one (C, d) block shared by every lane (the filter, phase 1;
// an unbatched call is one lane: the max-singleton and top-singleton
// calls) or one block per lane, (L, C, d) (the lazy chunks, phase 2).
// scale = 0.5 is mutual information.
//
// What bounds it on the H100: the product of x with the lanes' live basis
// rows, sum_l size_l of them.  At the filter shape (L = 37, k = 64,
// C = 1,048,576, d = 256, f32) with every row live that is 2 C d L k =
// 1.27e12 operations, 19 ms at 67 TFLOP/s of f32; at the lane sizes of a
// select in progress (974 of 2368 rows) 7.8 ms; either way far above the
// 0.37 ms of its bytes (x read once, the (L, C) output written once):
// bound by operations.  Multiplying U's zero rows (59 % of the FMAs at
// those sizes, all of them in the singleton passes at size 0) is the
// first waste; a 4 x 4 micro tile that needs 2 B of shared memory per FMA
// is the second.
//
// What the design does about it:
//  * Only live rows are multiplied.  The wrapper passes each lane's size
//    as a device tensor (no host sync); the kernel clamps it to [0, k] and
//    each CTA scans its lane group's sizes into a prefix, so the group's
//    live rows form one compacted column list: column c is basis row
//    c - pre[l] of the lane l with pre[l] <= c < pre[l + 1].  A lane of
//    size 0 does no product.
//  * The product is marginals_tile.cuh's, shared with facility and
//    exemplar marginals: 128 rows x 128 columns a CTA, an 8 x 8 block of
//    fmaf chains a thread (1 B of shared memory per FMA), d staged 16 deep
//    and double-buffered, two CTAs per SM.  A thread finds the basis rows
//    of its two staged columns by a binary search over the prefix.  A
//    shared x serves a group of up to kMaxGroup lanes (more lanes: more
//    groups, each re-reading x from L2); a per-lane x gives one lane per
//    CTA.
//  * A segmented epilogue: each tile's squares go to shared memory over
//    the stage ([col][row], XOR-swizzled as the facility tile's values),
//    and one thread per (row, lane) adds its lane's columns of the tile in
//    basis-row order to the lane's running sum.  A lane whose columns go
//    on into the next tile leaves its sums in a shared carry (at most one
//    lane crosses each tile edge; two carry buffers, so the lane that
//    reads one and the lane that writes the other never race); a lane
//    that ends in the tile writes its gains at once.
//
// Numbers it keeps: each projection is one fmaf chain over features 0 ..
// d - 1, each lane adds its rounded squares in basis-row order from +0,
// ||x_i||^2 is one warp per row, lane-strided, in a fixed shuffle tree,
// and resid is formed with rounded products (no contraction into an fma),
// logf the IEEE-accurate one (no --use_fast_math).  A skipped zero row
// would only have added +0, so a call with sizes gives the bits of the
// same call without them; no atomics, so a repeated launch gives the same
// bits.
#include "marginals_tile.cuh"

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

constexpr int kMaxGroup = mtile::kThreads;  // lanes one CTA scans
// Shared memory after the tile: the prefix pre[0 .. kMaxGroup] of the
// group's live rows (padded to 16 bytes), ||x_i||^2 [kRows] and the two
// carries [2][kRows].
constexpr int kPrefixInts = (kMaxGroup + 1 + 3) & ~3;
constexpr size_t kSmemBytes = mtile::kTileBytes + sizeof(int) * kPrefixInts +
                              sizeof(float) * 3 * mtile::kRows;

// grid (row tiles, lane groups); group lanes per CTA with a shared x, 1
// with a per-lane x.  size: (L,) int32, or nullptr (k for every lane).
template <typename T, bool kVec>
__global__ void __launch_bounds__(mtile::kThreads, 2)
kernel(const T* __restrict__ x, int x_per_lane, const float* __restrict__ U,
       const int* __restrict__ size, float* __restrict__ out, int L, int k,
       long long C, int d, int group, Params p) {
  using namespace mtile;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Stage& stage = *reinterpret_cast<Stage*>(smem_raw);
  float* V = reinterpret_cast<float*>(smem_raw);  // over the stage
  int* pre = reinterpret_cast<int*>(smem_raw + kTileBytes);
  float* xsq = reinterpret_cast<float*>(pre + kPrefixInts);
  float* carry = xsq + kRows;  // [2][kRows]
  __shared__ int warp_sum[kThreads / 32];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int l0 = blockIdx.y * group;
  const int nl = min(group, L - l0);
  const T* xb = x_per_lane ? x + (long long)l0 * C * d : x;
  const long long row0 = (long long)blockIdx.x * kRows;

  // the lanes' live rows, clamped to [0, k], and their prefix (an
  // inclusive scan: warp shuffles, then the warps' sums)
  int n = 0;
  if (tid < nl) n = size ? min(max(__ldg(size + l0 + tid), 0), k) : k;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(0xffffffffu, n, o);
    if (lane >= o) n += u;
  }
  if (lane == 31) warp_sum[warp] = n;
  // ||x_i||^2, one warp per row, lane-strided, a fixed shuffle tree
  for (int r = warp; r < kRows; r += kThreads / 32) {
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
  __syncthreads();
  for (int w = 0; w < warp; ++w) n += warp_sum[w];
  pre[tid + 1] = n;
  if (tid == 0) pre[0] = 0;
  __syncthreads();
  const int total = pre[nl];

  // the basis row of compacted column c, nullptr past the group's rows
  auto column_row = [&](int c) -> const float* {
    if (c >= total) return nullptr;
    int lo = 0, hi = nl - 1;  // the last lane l with pre[l] <= c
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (pre[mid] <= c) lo = mid; else hi = mid - 1;
    }
    return U + ((long long)(l0 + lo) * k + (c - pre[lo])) * d;
  };

  const int ty = grid_row(), tx = grid_col(), q = tid >> 2;
  for (int col0 = 0, t = 0; col0 < total; col0 += kCols, ++t) {
    {
      float v[kMicro][kMicro];
      product<T, kVec>(xb, C,
                       RowPair{column_row(col0 + q), column_row(col0 + q + 64)},
                       d, row0, col0, stage, v);
#pragma unroll
      for (int nn = 0; nn < kMicro; ++nn) {
        const int c = micro_at(tx, nn);
#pragma unroll
        for (int h = 0; h < 2; ++h)
          *reinterpret_cast<float4*>(V + value_at(c, h * 16 + ty)) =
              make_float4(__fmul_rn(v[4 * h][nn], v[4 * h][nn]),
                          __fmul_rn(v[4 * h + 1][nn], v[4 * h + 1][nn]),
                          __fmul_rn(v[4 * h + 2][nn], v[4 * h + 2][nn]),
                          __fmul_rn(v[4 * h + 3][nn], v[4 * h + 3][nn]));
      }
    }
    // the lanes with columns in [col0, end) are lo .. hi; the counts'
    // barriers publish the squares
    const int end = min(col0 + kCols, total);
    const int lo = __syncthreads_count(tid < nl && pre[tid + 1] <= col0);
    const int hi = __syncthreads_count(tid < nl && pre[tid + 1] < end);
    const float* cin = carry + (t & 1) * kRows;
    float* cout = carry + ((t + 1) & 1) * kRows;
    for (int it = tid; it < (hi - lo + 1) * kRows; it += kThreads) {
      const int r = it % kRows, l = lo + it / kRows;
      const int b = pre[l], e = pre[l + 1];
      if (b == e) continue;  // no live row: written after the tiles
      float s = b < col0 ? cin[r] : 0.0f;
      const int c_end = min(e, end) - col0;
      for (int c = max(b, col0) - col0; c < c_end; ++c)
        s = __fadd_rn(s, V[value_at(c, r >> 2) + (r & 3)]);
      if (e > end) {
        cout[r] = s;
        continue;
      }
      const long long row = row0 + r;
      if (row < C) out[(long long)(l0 + l) * C + row] = gain_of(p, xsq[r], s);
    }
    __syncthreads();  // V (the next stage) and the carries are rewritten
  }
  // lanes with no live row: ||U x||^2 = 0
  for (int it = tid; it < nl * kRows; it += kThreads) {
    const int r = it % kRows, l = it / kRows;
    const long long row = row0 + r;
    if (pre[l] == pre[l + 1] && row < C)
      out[(long long)(l0 + l) * C + row] = gain_of(p, xsq[r], 0.0f);
  }
}

template <typename T, bool kVec>
cudaError_t launch_t(const void* x, int x_per_lane, const void* U,
                     const void* size, void* out, int L, int k, long long C,
                     int d, const Params& p, cudaStream_t stream) {
  const int group = x_per_lane ? 1 : (L < kMaxGroup ? L : kMaxGroup);
  cudaError_t e = cudaFuncSetAttribute(
      kernel<T, kVec>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kSmemBytes);
  if (e != cudaSuccess) return e;
  const long long row_tiles = (C + mtile::kRows - 1) / mtile::kRows;
  const int lane_blocks = (L + group - 1) / group;
  if (row_tiles > 0x7fffffffLL || lane_blocks > 65535)
    return cudaErrorInvalidValue;
  dim3 grid((unsigned)row_tiles, lane_blocks);
  kernel<T, kVec><<<grid, mtile::kThreads, kSmemBytes, stream>>>(
      static_cast<const T*>(x), x_per_lane, static_cast<const float*>(U),
      static_cast<const int*>(size), static_cast<float*>(out), L, k, C, d,
      group, p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dtype(const void* x, int x_per_lane, const void* U,
                         const void* size, void* out, int L, int k,
                         long long C, int d, const Params& p,
                         cudaStream_t stream) {
  // 16-byte loads of the basis rows and 4-element loads of the x rows
  // need d % 4 == 0 and aligned bases
  const bool vec = d % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(x) % (4 * sizeof(T)) == 0 &&
                   reinterpret_cast<uintptr_t>(U) % 16 == 0;
  return vec ? launch_t<T, true>(x, x_per_lane, U, size, out, L, k, C, d, p,
                                 stream)
             : launch_t<T, false>(x, x_per_lane, U, size, out, L, k, C, d, p,
                                  stream);
}

}  // namespace

// x (C, d) shared or (L, C, d) per lane, f32 or bf16; U (L, k, d) f32
// (an unbatched call is L = 1); size (L,) int32 live rows per lane, or
// null for k; out (L, C) f32.
extern "C" int logdet_marginals_launch(const void* x, int x_is_bf16,
                                       int x_per_lane, const void* U,
                                       const void* size, void* out, int L,
                                       int k, long long C, int d, float alpha,
                                       float alpha2, float scale, float eps,
                                       void* stream) {
  if (L <= 0 || C <= 0 || d <= 0) return (int)cudaSuccess;
  if (k <= 0) return (int)cudaErrorInvalidValue;  // the wrapper refuses it
  const Params p{alpha, alpha2, scale, eps};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(x_is_bf16
      ? launch_dtype<__nv_bfloat16>(x, x_per_lane, U, size, out, L, k, C, d,
                                    p, s)
      : launch_dtype<float>(x, x_per_lane, U, size, out, L, k, C, d, p, s));
}
